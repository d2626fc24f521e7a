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

import math
from typing import Optional

import torch

from repro_torch.core.quantization import qmax
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMS
from repro_torch.kernels.ref import wino_gemm_ref
from repro_torch.kernels.wino_gemm import mainloop_smem_bytes, requant_plane
from repro_torch.kernels.wino_transform import _N_SUPPORTED, _side, sandwich

__all__ = ["fused_gemm_output", "fused_gemm_output_plain",
           "hadamard_plane_plain", "fused_tile", "fused_smem_bytes"]

# The kernel's grid puts Cout / BC on its y axis (at most 65535 blocks).
_MAX_COUT = 65535 * 32
#: The kernel's block tiles (tiles, output channels), largest first, and
#: the threads of each (one warp per 16 x 8 .. 16 x 16 piece).
TILES = ((32, 32), (16, 32))
THREADS = {(32, 32): 256, (16, 32): 128}
#: Shared memory one block may use on an H100, and the stash size that
#: still lets two blocks share an SM (one block's GEMM then overlaps
#: another's epilogue).
SMEM_LIMIT = 232448
STASH_BUDGET = 96 * 1024
_UNROLL_MAX_N = 6       # common.cuh kUnrollMaxN


def _operand_floats(ni: int, no: int) -> int:
    return no * no * ni * ni if ni <= _UNROLL_MAX_N else 2 * no * ni


def fused_smem_bytes(n: int, bt: int, bc: int, requant: bool) -> int:
    """Dynamic shared memory of one K4 block (``fused_serve.cu``
    smem_bytes): term tables, deq and rq, the int8 mainloop's staging
    (the ring of Xq slabs and of raw u_q blocks, two K-major u_q slabs),
    and the stash of all n² positions (int16 grid values with the requant
    on, fp32 with it off)."""
    m = n - 2
    tables = 4 * (_operand_floats(n, n) + _operand_floats(n, m) + 2 * n * n)
    tables = -(-tables // 16) * 16
    return (tables + mainloop_smem_bytes(bt, bc, THREADS[(bt, bc)])
            + n * n * bt * bc * (2 if requant else 4))


def fused_tile(n: int, T: int, cout: int, requant: bool) -> tuple:
    """K4's block tile for one shape: the largest tile whose stash stays
    within ``STASH_BUDGET`` and whose grid fills the card's SMs; where no
    tile does both, the one of those that fit shared memory with the most
    blocks."""
    fits = [t for t in TILES
            if fused_smem_bytes(n, *t, requant) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no K4 tile fits shared memory at n = {n}")

    def blocks(t):
        return math.ceil(T / t[0]) * math.ceil(cout / t[1])
    for t in fits:
        stash = n * n * t[0] * t[1] * (2 if requant else 4)
        if stash <= STASH_BUDGET and blocks(t) >= SMS:
            return t
    return max(fits, key=lambda t: (blocks(t), -t[0] * t[1]))


def _terms(L: torch.Tensor, ni: int) -> torch.Tensor:
    """One sandwich operand as the kernel takes it: for ni <= 6 the
    products L[a][j] · L[b][k] (the same fp32 products as ``__fmul_rn``)
    laid out [j][k][a][b], so that a 16-byte load holds four outputs'
    terms; else L twice (common.cuh kOperandFloats)."""
    if ni <= _UNROLL_MAX_N:
        no = L.shape[0]
        out = torch.empty((ni, ni, no, no), dtype=L.dtype, device=L.device)
        return torch.mul(L.T[:, None, :, None], L.T[None, :, None, :],
                         out=out)
    return torch.cat([L.reshape(-1), L.reshape(-1)])


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
    _build.require(xq, "xq", torch.int8, (P, T, K), dev, aligned=True)
    _build.require(u_q, "u_q", torch.int8, (P, K, N), dev, aligned=True)
    _build.require(deq, "deq", f32, (P, 1), dev)
    _build.require(rq, "rq", f32, (P, 1), dev)
    _build.require(cinvt, "cinvt", f32, (n, n), dev)
    _build.require(apt, "apt", f32, (m, n), dev)
    qm = 0 if requant_bits is None else qmax(requant_bits)
    # made once a call by two small multiplies, not by every block
    tbase, ta = _terms(cinvt, n), _terms(apt, n)
    bt, bc = fused_tile(n, T, N, qm > 0)
    out = torch.empty((T, N, m, m), dtype=f32, device=dev)
    I, Pt = _build.INT, _build.PTR
    _build.launch("fused_serve", "fused_gemm_output",
                  (Pt,) * 7 + (I,) * 8 + (Pt,),
                  xq, u_q, deq, rq, tbase, ta, out, n, T, K, N, qm,
                  int(changes_base), bt, bc, _build.stream(dev))
    _build.LAUNCHES["fused_gemm_output"] += 1
    return out
