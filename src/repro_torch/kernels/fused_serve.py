"""Single-pass fused int8 serving: the CUDA kernel K4
(``csrc/fused_serve.cu``) and its plain PyTorch version.

GEMM → Hadamard requant → output transform in one launch: reads Xq and
u_q once and writes the (T, Cout, m, m) fp32 output once, with no
intermediate in device memory. The requant is ``requant_plane`` and the
sandwiches are ``wino_transform.sandwich``, in the same order as the
staged kernels, so the fused output equals the staged one: the integer
Hadamard plane exactly, and the fp32 output bit for bit.

Requant needs *calibrated* Hadamard statistics: the dynamic requant
reduction spans the whole (T, Cout) plane, which a tiled kernel cannot
see, so calibration and dynamic requant stay on the staged path
(``kernels.ops`` routes them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import qmax
from repro_torch.kernels import _build
from repro_torch.kernels.ref import wino_gemm_ref
from repro_torch.kernels.wino_gemm import requant_plane
from repro_torch.kernels.wino_transform import _N_SUPPORTED, _side, sandwich

__all__ = ["fused_gemm_output", "fused_gemm_output_plain",
           "hadamard_plane_plain"]

# The kernel's grid puts Cout / 32 on its y axis (at most 65535 blocks).
_MAX_COUT = 65535 * 32


def hadamard_plane_plain(xq: torch.Tensor, u_q: torch.Tensor,
                         deq: torch.Tensor, rq: torch.Tensor,
                         requant_bits: Optional[int]) -> torch.Tensor:
    """K4's fp32 Hadamard plane (P, T, Cout) before the output transform:
    the requantized grid value · rq[p], or with the stage off the
    accumulator · deq[p]."""
    acc = wino_gemm_ref(xq, u_q)                         # (P, T, N) int32
    if requant_bits is None:
        return acc.to(torch.float32) * deq[:, :, None]
    q = requant_plane(acc, deq[:, :, None], rq[:, :, None],
                      qmax(requant_bits))
    return q * rq[:, :, None]


def fused_gemm_output_plain(xq: torch.Tensor, u_q: torch.Tensor,
                            deq: torch.Tensor, rq: torch.Tensor,
                            cinvt: torch.Tensor, apt: torch.Tensor, *,
                            m: int, requant_bits: Optional[int] = None,
                            changes_base: bool = True) -> torch.Tensor:
    """Plain version of K4 (see ``fused_gemm_output``)."""
    P, T, _ = xq.shape
    N = u_q.shape[2]
    n = _side(P)
    h = hadamard_plane_plain(xq, u_q, deq, rq, requant_bits)
    h = h.movedim(0, -1).reshape(T, N, n, n)
    if changes_base:
        h = sandwich(cinvt, cinvt, h)
    return sandwich(apt, apt, h)


def fused_gemm_output(xq: torch.Tensor, u_q: torch.Tensor,
                      deq: torch.Tensor, rq: torch.Tensor,
                      cinvt: torch.Tensor, apt: torch.Tensor, *, m: int,
                      requant_bits: Optional[int] = None,
                      changes_base: bool = True) -> torch.Tensor:
    """Fused GEMM → Hadamard requant → output transform.

    xq: (P, T, Cin) int8, u_q: (P, Cin, Cout) int8, deq/rq: (P, 1) fp32
    per-position dequant / requant scales (``rq`` unused when
    ``requant_bits`` is None — pass ones), cinvt (n, n) / apt (m, n)
    → (T, Cout, m, m) fp32 spatial output tiles.
    """
    P, T, K = xq.shape
    P2, K2, N = u_q.shape
    if (P, K) != (P2, K2):
        raise ValueError(f"xq {tuple(xq.shape)} and u_q {tuple(u_q.shape)} "
                         f"do not chain")
    n = _side(P)
    if xq.device.type == "cpu":
        return fused_gemm_output_plain(xq, u_q, deq, rq, cinvt, apt, m=m,
                                       requant_bits=requant_bits,
                                       changes_base=changes_base)
    dev = _build.cuda_device(xq, "fused_gemm_output")
    if n not in _N_SUPPORTED or m != n - 2:
        raise ValueError(f"the kernel takes F(m, 3) with n = m + 2 in "
                         f"{_N_SUPPORTED}; got n={n}, m={m}")
    if K < 1 or N > _MAX_COUT:
        raise ValueError(f"Cin = {K}, Cout = {N}: the kernel takes Cin >= 1 "
                         f"and Cout <= {_MAX_COUT}")
    f32 = torch.float32
    _build.require(xq, "xq", torch.int8, (P, T, K), dev)
    _build.require(u_q, "u_q", torch.int8, (P, K, N), dev)
    _build.require(deq, "deq", f32, (P, 1), dev)
    _build.require(rq, "rq", f32, (P, 1), dev)
    _build.require(cinvt, "cinvt", f32, (n, n), dev)
    _build.require(apt, "apt", f32, (m, n), dev)
    qm = 0 if requant_bits is None else qmax(requant_bits)
    out = torch.empty((T, N, m, m), dtype=f32, device=dev)
    I, Pt = _build.INT, _build.PTR
    _build.launch("fused_serve", "fused_gemm_output",
                  (Pt,) * 7 + (I,) * 6 + (Pt,),
                  xq, u_q, deq, rq, cinvt, apt, out, n, T, K, N, qm,
                  int(changes_base), _build.stream(dev))
    _build.LAUNCHES["fused_gemm_output"] += 1
    return out
