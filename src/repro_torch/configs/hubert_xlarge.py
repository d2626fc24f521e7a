"""hubert-xlarge [audio] — encoder-only; conv stem stubbed per brief
(input_specs provides precomputed 512-d frame embeddings).

48L d_model=1280 16H (kv=16, d_head=80) d_ff=5120 vocab=504 (codebook)
[arXiv:2106.07447; unverified]. LayerNorm + GELU (wav2vec2 family).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab=504,
    attn_type="bidir",
    norm_type="layernorm",
    act="gelu",
    input_mode="frames",
    frontend_dim=512,
)
