"""Model and run configuration dataclasses (the port's counterpart of
``repro.configs.base``): the same fields and defaults. ``dtype`` is a
``torch.dtype``; ``winograd`` holds the port's ``WinogradSpec``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.winograd import WinogradSpec

__all__ = ["ModelConfig", "RunConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field defaults suit dense LLaMA-style decoders."""

    name: str
    family: str                       # dense|moe|hybrid|ssm|audio|vlm|cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    # attention
    attn_type: str = "causal"         # causal | bidir (encoder)
    window: Optional[int] = None      # sliding-window size (local attn)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    full_attention: bool = True       # False → sub-quadratic (window/ssm)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0               # dispatch groups (launcher: DP extent)
    # hybrid (RG-LRU) blocks — pattern entries: "attn" | "rec"
    block_pattern: Tuple[str, ...] = ("attn",)
    d_rnn: int = 0
    conv_width: int = 4
    rnn_heads: int = 0
    # rwkv
    rwkv_head_dim: int = 64
    # norms / acts
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | geglu | gelu
    tie_embeddings: bool = False
    # modality frontends (stubs: precomputed embeddings)
    input_mode: str = "tokens"        # tokens | frames | patches+tokens
    frontend_dim: int = 0             # frame/patch embedding dim
    n_prefix: int = 0                 # prefix (patch) tokens for VLM
    # numerics
    param_dtype: str = "bfloat16"
    # paper substrate
    quantize_linears: bool = False    # w8a8 fake-quant on projections
    winograd: Optional[WinogradSpec] = None   # for conv layers (1-D here)
    use_winograd_conv: bool = False
    # compile / memory (read by the JAX package's scan and remat; the
    # port walks the layers in a Python loop and keeps no activations)
    remat: bool = True
    scan_layers: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def is_encoder(self) -> bool:
        return self.attn_type == "bidir"

    @property
    def moe_every(self) -> int:
        return 1 if self.n_experts else 0

    def param_count_dense_proxy(self) -> int:
        """6·N·D bookkeeping helper (see roofline)."""
        d, L = self.d_model, self.n_layers
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * \
            self.d_head + self.n_heads * self.d_head * d
        if self.n_experts:
            ff = 3 * d * self.moe_d_ff * self.n_experts + \
                3 * d * self.shared_d_ff + d * self.n_experts
        else:
            ff = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff) + emb


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything a launcher needs besides the model itself."""

    model: ModelConfig
    seq_len: int = 4096
    global_batch: int = 256
    microbatch: Optional[int] = None      # grad-accumulation chunk
    # optimizer
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    moment_dtype: str = "float32"         # bfloat16 for the ≥32B archs
    # distribution
    fsdp: bool = False                    # shard params over "data" too
    grad_compression: bool = False        # int8 cross-pod all-reduce
    # checkpoint / data
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    seed: int = 0
