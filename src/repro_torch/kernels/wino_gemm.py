"""Winograd-domain batched int8 GEMM (+ optional Hadamard-requant
epilogue): the CUDA kernel K2 (``csrc/wino_gemm.cu``) and its plain
PyTorch version.

For each of the P = n² Winograd positions, an independent GEMM over
channels: out[p] = x[p] @ w[p] with x (P, M, K) int8, w (P, K, N) int8,
out (P, M, N) int32. With ``requant_bits`` set, the epilogue requantizes
each accumulator onto the signed ``2^bits``-level grid with the
calibrated per-position scales (``requant_plane``), bit for bit the
staged formula.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import qmax
from repro_torch.kernels import _build
from repro_torch.kernels.ref import wino_gemm_ref

__all__ = ["wino_gemm", "wino_gemm_plain", "requant_plane",
           "INT32_ACC_LIMIT", "FP32_EXACT_INT_LIMIT"]

#: Largest magnitude the int32 accumulator of K2 and K4 can hold.
INT32_ACC_LIMIT = 2 ** 31 - 1

#: Largest integer magnitude fp32 represents exactly (24-bit mantissa).
#: ``requant_plane`` casts the int32 accumulator to fp32; beyond this the
#: cast itself rounds. With int8 operands, |acc| ≤ Cin·127², so the cast
#: is exact for Cin ≤ 1040.
FP32_EXACT_INT_LIMIT = 2 ** 24

# The kernel's grid puts M / 64 on its y axis (at most 65535 blocks).
_MAX_M = 65535 * 64


def requant_plane(acc: torch.Tensor, deq: torch.Tensor, rq: torch.Tensor,
                  qm: int) -> torch.Tensor:
    """Hadamard requant: int32 accumulator → fp32 values on the signed
    ``qm``-grid (fp32 multiply → IEEE divide → round half-even → clip).
    ``deq``/``rq`` broadcast against ``acc``."""
    hf = acc.to(torch.float32) * deq
    return torch.clamp(torch.round(hf / rq), -qm, qm)


def wino_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                    requant_bits: Optional[int] = None,
                    deq: Optional[torch.Tensor] = None,
                    rq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2 (see ``wino_gemm``)."""
    acc = wino_gemm_ref(x, w)
    if requant_bits is None:
        return acc
    q = requant_plane(acc, deq[:, :, None], rq[:, :, None],
                      qmax(requant_bits))
    return q.to(torch.int32)


def wino_gemm(x: torch.Tensor, w: torch.Tensor,
              requant_bits: Optional[int] = None,
              deq: Optional[torch.Tensor] = None,
              rq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched per-position GEMM. x: (P,M,K) int8, w: (P,K,N) int8 →
    (P,M,N) int32.

    With ``requant_bits`` set, ``deq`` (P, 1) fp32 dequant scales
    (in_scale·w_scale) and ``rq`` (P, 1) fp32 requant scales must be
    passed, and the output lands on the signed ``2^bits``-level grid.
    """
    P, M, K = x.shape
    P2, K2, N = w.shape
    if (P, K) != (P2, K2):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do "
                         f"not chain")
    if requant_bits is not None and (deq is None or rq is None):
        raise ValueError("requant epilogue needs deq and rq scales")
    if x.device.type == "cpu":
        return wino_gemm_plain(x, w, requant_bits, deq, rq)
    dev = _build.cuda_device(x, "wino_gemm")
    if M > _MAX_M:
        raise ValueError(f"M = {M} exceeds the kernel's grid ({_MAX_M})")
    _build.require(x, "x", torch.int8, (P, M, K), dev)
    _build.require(w, "w", torch.int8, (P, K, N), dev)
    qm = 0
    if requant_bits is not None:
        qm = qmax(requant_bits)
        _build.require(deq, "deq", torch.float32, (P, 1), dev)
        _build.require(rq, "rq", torch.float32, (P, 1), dev)
    out = torch.empty((P, M, N), dtype=torch.int32, device=dev)
    I, Pt = _build.INT, _build.PTR
    _build.launch("wino_gemm", "wino_gemm",
                  (Pt, Pt, Pt, I, I, I, I, Pt, Pt, I, Pt),
                  x, w, out, P, M, N, K, deq, rq, qm, _build.stream(dev))
    _build.LAUNCHES["wino_gemm"] += 1
    return out
