"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared.

61L d_model=7168 64H (GQA kv=8, d_head=128) expert d_ff=2048 vocab=163840
[arXiv:2501.kimi2; unverified]. ~1T total / ~32B active params.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab=163840,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    shared_d_ff=2048,
    act="swiglu",
)
