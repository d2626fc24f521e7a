"""Winograd-domain batched int8 GEMM (+ optional Hadamard-requant
epilogue): the CUDA kernel K2 (``csrc/wino_gemm.cu``, on the int8 tensor
cores through the mainloop it shares with K4, ``csrc/int8_mma.cuh``) and
its plain PyTorch version.

For each of the P = n² Winograd positions, an independent GEMM over
channels: out[p] = x[p] @ w[p] with x (P, M, K) int8, w (P, K, N) int8,
out (P, M, N) int32. With ``requant_bits`` set, the epilogue requantizes
each accumulator onto the signed ``2^bits``-level grid with the
calibrated per-position scales (``requant_plane``), bit for bit the
staged formula.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quantization import qmax
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMS
from repro_torch.kernels.ref import wino_gemm_ref

__all__ = ["wino_gemm", "wino_gemm_plain", "requant_plane",
           "gemm_positions", "gemm_grid", "mainloop_smem_bytes",
           "INT32_ACC_LIMIT", "FP32_EXACT_INT_LIMIT"]

#: Largest magnitude the int32 accumulator of K2 and K4 can hold.
INT32_ACC_LIMIT = 2 ** 31 - 1

#: Largest integer magnitude fp32 represents exactly (24-bit mantissa).
#: ``requant_plane`` casts the int32 accumulator to fp32; beyond this the
#: cast itself rounds. With int8 operands, |acc| ≤ Cin·127², so the cast
#: is exact for Cin ≤ 1040.
FP32_EXACT_INT_LIMIT = 2 ** 24

#: K2's block tile (rows of x, columns of w), 8 warps (256 threads).
TILE = (128, 64)
THREADS = 256
#: Positions a block may take in turn, most first, and the depth of K a
#: block should walk at most (four of the mainloop's 64-deep slabs): past
#: that, a block that takes fewer positions fills more SMs sooner.
POSITIONS = (4, 2, 1)
MAX_K = 4 * 64
#: Blocks a grid should have at the least: two rounds of two blocks an SM,
#: so the last round's tail stays short.
MIN_BLOCKS = 4 * SMS
# The kernel indexes rows and columns as 32-bit ints, a block tile past
# the last one included, and its grid's x holds every (row, column) tile
# of one position (at most 2^31 - 1 blocks), its y the groups of
# positions.
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535


def mainloop_smem_bytes(bt: int, bc: int, threads: int) -> int:
    """Shared memory of the int8 mainloop K2 and K4 share
    (``int8_mma.cuh`` mainloop_bytes): a ring of Xq slabs, a ring of each
    thread's raw 4 x 4 u_q blocks, and two K-major u_q slabs."""
    bk, row, stages = 64, 64 + 16, 4   # k per slab, padded row, in flight
    u_raw = -(-(bk // 4) * (bc // 4) // threads) * threads * 16
    return stages * (bt * row + u_raw) + 2 * bc * row


def gemm_grid(P: int, M: int, N: int, pb: int) -> tuple:
    """K2's grid for one shape, ``pb`` positions a block: (row tiles ×
    column tiles, groups of positions)."""
    return math.ceil(M / TILE[0]) * math.ceil(N / TILE[1]), math.ceil(P / pb)


def gemm_positions(P: int, M: int, N: int, K: int) -> int:
    """Positions a K2 block takes in turn for one shape: the most that
    keep its walk within ``MAX_K`` of K and the grid at ``MIN_BLOCKS``
    or more; one where none does."""
    for pb in POSITIONS:
        if pb * K <= MAX_K and \
                math.prod(gemm_grid(P, M, N, pb)) >= MIN_BLOCKS:
            return pb
    return 1


def _check_grid(P: int, M: int, N: int, pb: int) -> None:
    """Refuse a shape past the kernel's grid or its 32-bit indices."""
    bt, bc = TILE
    x_blocks, y_blocks = gemm_grid(P, M, N, pb)
    if M + bt > _INT_MAX or N + bc > _INT_MAX or x_blocks > _INT_MAX \
            or y_blocks > _MAX_GRID_Y:
        raise ValueError(f"P = {P}, M = {M}, N = {N}: past the kernel's "
                         f"grid (at most {_INT_MAX} row x column tiles of "
                         f"{bt} x {bc}, {_MAX_GRID_Y} groups of positions) "
                         f"or its 32-bit indices (M <= {_INT_MAX - bt})")


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
    pb = gemm_positions(P, M, N, K)
    _check_grid(P, M, N, pb)
    if K < 1:
        raise ValueError(f"K = {K}: the kernel takes K >= 1")
    # the mainloop reads x rows with 16-byte and w rows with 4-byte cp.async
    _build.require(x, "x", torch.int8, (P, M, K), dev, aligned=True)
    _build.require(w, "w", torch.int8, (P, K, N), dev, aligned=True)
    qm = 0
    if requant_bits is not None:
        qm = qmax(requant_bits)
        _build.require(deq, "deq", torch.float32, (P, 1), dev)
        _build.require(rq, "rq", torch.float32, (P, 1), dev)
    out = torch.empty((P, M, N), dtype=torch.int32, device=dev)
    I, Pt = _build.INT, _build.PTR
    _build.launch("wino_gemm", "wino_gemm",
                  (Pt, Pt, Pt, I, I, I, I, Pt, Pt, I, I, Pt),
                  x, w, out, P, M, N, K, deq, rq, qm, pb, _build.stream(dev))
    _build.LAUNCHES["wino_gemm"] += 1
    return out
