"""Plain PyTorch oracles, the counterparts of ``repro.kernels.ref``.

Each mirrors its JAX oracle's contract (dtypes, layouts, quantization
semantics) with einsum contractions, as the JAX oracles do. They run on
any device. The kernels' own plain versions, which repeat each kernel's
arithmetic order, live beside the kernels (``wino_transform``,
``wino_gemm``, ``fused_serve``).
"""
from __future__ import annotations

import torch

__all__ = ["wino_gemm_ref", "input_transform_fp", "input_transform_ref",
           "output_transform_ref", "q8_matmul_ref"]


def wino_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(P,M,K) int8 · (P,K,N) int8 → (P,M,N) int32, exact.

    Runs in float64 because PyTorch's batched product takes no integer
    operands on CUDA: every product of two int8 values and every partial
    sum below 2⁵³ is exact in float64, so the result is the exact
    integer product for any K below 2⁵³ / 127² ≈ 5.6e11."""
    acc = torch.bmm(x.to(torch.float64), w.to(torch.float64))
    return acc.to(torch.int32)


def _sandwich(M, X, N=None):
    if N is None:
        N = M
    return torch.einsum("ij,...jk,lk->...il", M, X, N)


def input_transform_fp(tiles: torch.Tensor, cinvt: torch.Tensor,
                       bpt: torch.Tensor,
                       changes_base: bool = True) -> torch.Tensor:
    """tiles (T,C,n,n) fp32 → Winograd-domain (n²,T,C) fp32, unquantized.
    Calibration reduces over this tensor."""
    T, C, n, _ = tiles.shape
    x = tiles.to(torch.float32)
    if changes_base:
        x = _sandwich(cinvt, x)
    v = _sandwich(bpt, x)                                   # (T, C, n, n)
    return v.reshape(T, C, n * n).movedim(-1, 0)            # (n², T, C)


def input_transform_ref(tiles: torch.Tensor, cinvt: torch.Tensor,
                        bpt: torch.Tensor, pos_scale: torch.Tensor,
                        changes_base: bool = True) -> torch.Tensor:
    """tiles (T,C,n,n) fp32 → (n²,T,C) int8."""
    v = input_transform_fp(tiles, cinvt, bpt, changes_base)
    q = torch.clamp(torch.round(v / pos_scale[:, :, None]), -127, 127)
    return q.to(torch.int8)


def output_transform_ref(h: torch.Tensor, pos_scale: torch.Tensor,
                         cinvt: torch.Tensor, apt: torch.Tensor, m: int,
                         changes_base: bool = True) -> torch.Tensor:
    """H (n²,T,C) int32 → (T,C,m,m) fp32."""
    P, T, C = h.shape
    n = int(round(P ** 0.5))
    hf = h.to(torch.float32) * pos_scale[:, :, None]
    hf = hf.movedim(0, -1).reshape(T, C, n, n)
    if changes_base:
        hf = _sandwich(cinvt, hf)
    return _sandwich(apt, hf)                                # (T, C, m, m)


def q8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                  s_w: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 with the symmetric dequant epilogue
    ``f32(acc) · s_x · s_w[col]``, cast to ``out_dtype``. The int32
    accumulator is exact: the product runs in float64 (see
    ``wino_gemm_ref``), |acc| ≤ K·127² < 2⁵³."""
    acc = torch.mm(x_q.to(torch.float64), w_q.to(torch.float64))
    acc = acc.to(torch.int32).to(torch.float32)
    return (acc * s_x * s_w[None, :]).to(out_dtype)
