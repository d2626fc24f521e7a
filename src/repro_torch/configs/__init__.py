"""Architecture registry: the 10 assigned configs (+ the paper's own
ResNet18-CIFAR10) and the shared input-shape sets, the port's
counterpart of ``repro.configs`` with the same entries.

Every entry carries its public-literature source tag in its module's
docstring. ``tiny_variant`` produces the reduced same-family config the
CPU tests run; the full configs run on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.configs import (command_r_plus_104b, hubert_xlarge,
                                 internvl2_26b, kimi_k2_1t_a32b,
                                 llama3_2_1b, minitron_4b, qwen1_5_32b,
                                 qwen2_moe_a2_7b, recurrentgemma_2b,
                                 resnet18_cifar10, rwkv6_7b)

__all__ = ["ARCHS", "RESNET", "SHAPES", "cells", "all_cells",
           "tiny_variant", "run_config", "ModelConfig", "RunConfig"]

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (recurrentgemma_2b, command_r_plus_104b, minitron_4b,
              llama3_2_1b, qwen1_5_32b, kimi_k2_1t_a32b, qwen2_moe_a2_7b,
              hubert_xlarge, rwkv6_7b, internvl2_26b)
}

RESNET = resnet18_cifar10.CONFIG

# (seq_len, global_batch, kind) — kind ∈ train|prefill|decode
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def cells(arch: str) -> list[str]:
    """Valid shape cells for an arch: encoders do not decode, and only
    the sub-quadratic archs take the 500k cell."""
    cfg = ARCHS[arch]
    out = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder:
        out.append("decode_32k")
        if not cfg.full_attention:
            out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in cells(a)]


def tiny_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    changes = dict(
        name=cfg.name + "-tiny",
        n_layers=min(cfg.n_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
        param_dtype="float32",
    )
    if cfg.n_heads:
        changes["n_heads"] = 4
        changes["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2)) \
            if cfg.n_kv_heads < cfg.n_heads else 4
        changes["d_head"] = 16
    if cfg.n_experts:
        changes["n_experts"] = 8
        changes["top_k"] = min(cfg.top_k, 2)
        changes["moe_d_ff"] = 32
        changes["shared_d_ff"] = 64 if cfg.shared_d_ff else 0
        changes["d_ff"] = 0
    if cfg.family == "hybrid":
        changes["d_rnn"] = 64
        changes["window"] = 16
        changes["n_layers"] = 4      # (rec,rec,attn) + 1 remainder
    if cfg.window and cfg.family != "hybrid":
        changes["window"] = 16
    if cfg.frontend_dim:
        changes["frontend_dim"] = 32
    if cfg.n_prefix:
        changes["n_prefix"] = 8
    if cfg.family == "ssm":
        changes["rwkv_head_dim"] = 16
    return dataclasses.replace(cfg, **changes)


def run_config(arch: str, shape: str, multi_pod: bool = False) -> RunConfig:
    """Production RunConfig for a shape cell (per-arch distribution
    choices: FSDP + bf16 moments for the ≥15B archs, microbatching), as
    the JAX package sets it."""
    cfg = ARCHS[arch]
    if cfg.n_experts:
        # grouped (data-local) MoE dispatch: one group per DP shard
        dp_extent = 32 if multi_pod else 16
        cfg = dataclasses.replace(cfg, moe_groups=dp_extent)
    seq, gb, kind = SHAPES[shape]
    n_params = cfg.param_count_dense_proxy()
    big = n_params >= 15e9
    if kind == "train":
        micro = 16 if n_params >= 50e9 else (32 if big else 64)
        micro = min(micro, gb)
    else:
        micro = None
    return RunConfig(
        model=cfg,
        seq_len=seq,
        global_batch=gb,
        microbatch=micro,
        fsdp=big,
        moment_dtype="bfloat16" if big else "float32",
    )
