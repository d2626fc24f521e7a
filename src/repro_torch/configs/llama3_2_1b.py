"""llama3.2-1b [dense] — small llama3, tied embeddings.

16L d_model=2048 32H (GQA kv=8, d_head=64) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab=128256,
    act="swiglu",
    tie_embeddings=True,
    rope_theta=5e5,
)
