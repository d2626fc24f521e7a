"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1, d_head=256) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]. The width-4 temporal conv in every recurrent
block runs the paper's quantized 1-D Toom-Cook (Legendre base, F(4,4))
when use_winograd_conv is enabled (on by default for this arch — it is
the one live convolution in the assigned LM pool).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    window=2048,
    full_attention=False,
    block_pattern=("rec", "rec", "attn"),
    d_rnn=2560,
    conv_width=4,
    act="geglu",
    tie_embeddings=True,
    rope_theta=1e4,
    use_winograd_conv=True,
    winograd=WinogradSpec(m=4, r=4, base="legendre",
                          quant=QuantConfig(hadamard_bits=9)),
)
