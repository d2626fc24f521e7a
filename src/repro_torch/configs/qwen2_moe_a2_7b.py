"""qwen2-moe-a2.7b [moe] — 60 routed top-4 + 4 shared experts, QKV bias.

24L d_model=2048 16H (kv=16, d_head=128) expert d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. shared_d_ff = 4 x 1408 = 5632.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    qkv_bias=True,
    act="swiglu",
)
