"""internvl2-26b [vlm] — InternViT frontend (stubbed: precomputed patch
embeddings, 3200-d) + InternLM2-20B-class backbone.

48L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]. 256 patch tokens prefix per image.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=92553,
    act="swiglu",
    input_mode="patches+tokens",
    frontend_dim=3200,
    n_prefix=256,
)
