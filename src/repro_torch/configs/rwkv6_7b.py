"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536, head_dim=64 (64 heads)
[arXiv:2404.05892; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    full_attention=False,
)
