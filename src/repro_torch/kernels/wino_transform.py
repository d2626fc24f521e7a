"""Winograd input and output transforms: the CUDA kernels K1 and K3
(``csrc/wino_transform.cu``) and their plain PyTorch versions.

Input transform:  tiles (T, C, n, n) fp32 → C⁻ᵀ·X·C⁻¹ (when the base
changes) → B_Cᵀ·(·)·B_C → / s[p] → round half-even → clip ±127
→ Xq (n², T, C) int8, position-major for the GEMM.

Output transform: H (n², T, C) int32 → ·s[p] → C⁻ᵀ·(·)·C⁻¹ (when the
base changes) → A_Cᵀ·(·)·A_C → (T, C, m, m) fp32.

The transform matrices are operands (flex makes them learnable), never
constants of the kernel. Each wrapper runs the plain version on a CPU
tensor and launches its kernel on a CUDA tensor; there is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["input_transform", "output_transform", "input_transform_plain",
           "input_domain_plain", "output_transform_plain", "sandwich",
           "UNROLL_MAX_N"]

#: Largest window the unrolled sandwich is used for; larger windows
#: (F(6,3): n = 8) run as two contractions, as in the JAX kernels.
UNROLL_MAX_N = 6

_N_SUPPORTED = (4, 6, 8)

# C signature of both entries: five pointers, T, C, n, changes_base, stream
_ARGS = (_build.PTR,) * 5 + (_build.LONG,) * 2 + (_build.INT,) * 2 + \
    (_build.PTR,)


def sandwich(mat_l: torch.Tensor, mat_r_t: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """out[..., a, b] = Σ_{j,k} L[a,j]·x[..., j, k]·Rᵀ[b,k].

    The arithmetic order of the kernels (``csrc/common.cuh``), so that a
    kernel and its plain version agree bit for bit: for n ≤ 6 the terms
    x[j,k]·(L[a,j]·Rᵀ[b,k]) summed j outer, k inner, the order of the JAX
    kernels' ``_sandwich_unrolled``; for larger windows the two
    contractions t = L·x then t·Rᵀ, each summed in ascending index order.
    Every product and sum is its own rounded fp32 operation.
    """
    n_in = x.shape[-1]
    if n_in <= UNROLL_MAX_N:
        term = mat_l[:, None, :, None] * mat_r_t[None, :, None, :]
        acc = None
        for j in range(n_in):
            for k in range(n_in):
                c = x[..., j, k, None, None] * term[:, :, j, k]
                acc = c if acc is None else acc + c
        return acc
    t = None
    for j in range(n_in):
        c = mat_l[:, j, None] * x[..., None, j, :]          # (..., a, k)
        t = c if t is None else t + c
    out = None
    for k in range(n_in):
        c = t[..., :, k, None] * mat_r_t[:, k]              # (..., a, b)
        out = c if out is None else out + c
    return out


def input_domain_plain(tiles: torch.Tensor, cinvt: torch.Tensor,
                       bpt: torch.Tensor, *,
                       changes_base: bool = True) -> torch.Tensor:
    """K1's values before quantization, in its order: tiles (T,C,n,n)
    fp32 → (n², T, C) fp32."""
    T, C, n, _ = tiles.shape
    x = tiles
    if changes_base:
        x = sandwich(cinvt, cinvt, x)
    return sandwich(bpt, bpt, x).reshape(T, C, n * n).movedim(-1, 0)


def input_transform_plain(tiles: torch.Tensor, cinvt: torch.Tensor,
                          bpt: torch.Tensor, pos_scale: torch.Tensor, *,
                          changes_base: bool = True) -> torch.Tensor:
    """Plain version of K1: tiles (T,C,n,n) fp32 → (n², T, C) int8."""
    v = input_domain_plain(tiles, cinvt, bpt, changes_base=changes_base)
    q = torch.clamp(torch.round(v / pos_scale[:, :, None]), -127, 127)
    return q.to(torch.int8)


def output_transform_plain(h: torch.Tensor, pos_scale: torch.Tensor,
                           cinvt: torch.Tensor, apt: torch.Tensor, *,
                           m: int, changes_base: bool = True
                           ) -> torch.Tensor:
    """Plain version of K3: H (n², T, C) int32 → (T, C, m, m) fp32."""
    P, T, C = h.shape
    n = _side(P)
    hf = h.to(torch.float32) * pos_scale[:, :, None]
    hf = hf.movedim(0, -1).reshape(T, C, n, n)
    if changes_base:
        hf = sandwich(cinvt, cinvt, hf)
    return sandwich(apt, apt, hf)


def _side(P: int) -> int:
    n = int(round(P ** 0.5))
    if n * n != P:
        raise ValueError(f"{P} positions is not an n x n window")
    return n


def input_transform(tiles: torch.Tensor, cinvt: torch.Tensor,
                    bpt: torch.Tensor, pos_scale: torch.Tensor, *,
                    changes_base: bool = True) -> torch.Tensor:
    """tiles (T, C, n, n) fp32 → (n², T, C) int8 (position-major).

    ``pos_scale``: (n², 1) fp32 per-position quantization scales."""
    if tiles.device.type == "cpu":
        return input_transform_plain(tiles, cinvt, bpt, pos_scale,
                                     changes_base=changes_base)
    dev = _build.cuda_device(tiles, "input_transform")
    T, C, n, n2 = tiles.shape
    if n != n2 or n not in _N_SUPPORTED:
        raise ValueError(f"tiles {tuple(tiles.shape)}: the kernel takes "
                         f"n x n windows with n in {_N_SUPPORTED}")
    f32 = torch.float32
    _build.require(tiles, "tiles", f32, (T, C, n, n), dev, aligned=True)
    _build.require(cinvt, "cinvt", f32, (n, n), dev)
    _build.require(bpt, "bpt", f32, (n, n), dev)
    _build.require(pos_scale, "pos_scale", f32, (n * n, 1), dev)
    out = torch.empty((n * n, T, C), dtype=torch.int8, device=dev)
    _build.launch("wino_transform", "wino_input_transform", _ARGS,
                  tiles, cinvt, bpt, pos_scale, out, T, C, n,
                  int(changes_base), _build.stream(dev))
    _build.LAUNCHES["input_transform"] += 1
    return out


def output_transform(h: torch.Tensor, pos_scale: torch.Tensor,
                     cinvt: torch.Tensor, apt: torch.Tensor, *, m: int,
                     changes_base: bool = True) -> torch.Tensor:
    """H (n², T, C) int32 (+ per-position dequant scales (n², 1))
    → (T, C, m, m) fp32."""
    if h.device.type == "cpu":
        return output_transform_plain(h, pos_scale, cinvt, apt, m=m,
                                      changes_base=changes_base)
    dev = _build.cuda_device(h, "output_transform")
    P, T, C = h.shape
    n = _side(P)
    if n not in _N_SUPPORTED or m != n - 2:
        raise ValueError(f"the kernel takes F(m, 3) with n = m + 2 in "
                         f"{_N_SUPPORTED}; got n={n}, m={m}")
    f32 = torch.float32
    _build.require(h, "h", torch.int32, (P, T, C), dev)
    _build.require(pos_scale, "pos_scale", f32, (P, 1), dev)
    _build.require(cinvt, "cinvt", f32, (n, n), dev)
    _build.require(apt, "apt", f32, (m, n), dev)
    out = torch.empty((T, C, m, m), dtype=f32, device=dev)
    _build.launch("wino_transform", "wino_output_transform", _ARGS,
                  h, pos_scale, cinvt, apt, out, T, C, n,
                  int(changes_base), _build.stream(dev))
    _build.LAUNCHES["output_transform"] += 1
    return out
