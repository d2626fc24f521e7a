"""w8a8 quantized matmul with the dequant epilogue: the CUDA kernel K5
(``csrc/q8_matmul.cu``) and its plain PyTorch version.

``y = f32(x_q @ w_q) · s_x · s_w[col]`` cast to ``out_dtype``, with
x_q (M, K) int8, w_q (K, N) int8, int32 accumulation, a per-tensor
``s_x`` and a per-output-column ``s_w``: the paper's symmetric int8
scheme applied to transformer projections (``ops.q8_linear``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import q8_matmul_ref

__all__ = ["q8_matmul", "q8_matmul_plain", "q8_splits"]

# The kernel's grid puts M / 128 on its y axis (at most 65535 blocks).
_MAX_M = 65535 * 128
_OUT_DTYPES = (torch.float32, torch.bfloat16)
#: The kernel's block tile (rows, columns, k per stage) and the card's SMs.
TILE = (128, 128, 128)
SMS = 132


def q8_splits(M: int, N: int, K: int) -> int:
    """How many blocks share one output tile's K range: 1 where the
    (M, N) grid of 128 x 128 tiles fills the card's SMs; else (a decode
    M, or few columns) enough to reach ``SMS`` blocks, each with a whole
    number of 128-deep steps."""
    bm, bn, bk = TILE
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    steps = math.ceil(K / bk)
    if tiles >= SMS or steps <= 1:
        return 1
    per = math.ceil(steps / min(steps, math.ceil(SMS / tiles)))
    return math.ceil(steps / per)


# Split-K workspaces per (device, stream): int32 partial sums and per-tile
# arrival counters, zero between calls (the kernel leaves them so), grown
# as needed. Keyed by stream so that calls on two streams never share one.
_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int, sums: int, tiles: int):
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < sums or ws[1].numel() < tiles:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.zeros(max(sums, old[0]), dtype=torch.int32, device=dev),
              torch.zeros(max(tiles, old[1]), dtype=torch.int32, device=dev))
        _WORKSPACES[key] = ws
    return ws


def q8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                    s_w: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K5 (see ``q8_matmul``): the exact integer product
    in float64, then the kernel's epilogue operations in its order."""
    return q8_matmul_ref(x_q, w_q, s_x.reshape(()), s_w, out_dtype)


def q8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
              s_w: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x_q (M,K) int8 · w_q (K,N) int8, s_x one fp32 value (shape () or
    (1,)), s_w (N,) fp32 → (M,N) ``out_dtype`` (fp32 or bf16).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which reads ``s_x`` from device memory (no host sync)."""
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    if s_x.numel() != 1 or tuple(s_w.shape) != (N,):
        raise ValueError(f"s_x must hold one value and s_w be ({N},), got "
                         f"{tuple(s_x.shape)} and {tuple(s_w.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: the kernel writes "
                         f"{_OUT_DTYPES}")
    if x_q.device.type == "cpu":
        return q8_matmul_plain(x_q, w_q, s_x, s_w, out_dtype)
    dev = _build.cuda_device(x_q, "q8_matmul")
    if M > _MAX_M or K < 1:
        raise ValueError(f"M = {M}, K = {K}: the kernel takes 1 <= K and "
                         f"M <= {_MAX_M}")
    _build.require(x_q, "x_q", torch.int8, (M, K), dev, aligned=True)
    _build.require(w_q, "w_q", torch.int8, (K, N), dev, aligned=True)
    _build.require(s_x.reshape(1), "s_x", torch.float32, (1,), dev)
    _build.require(s_w, "s_w", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    splits = q8_splits(M, N, K)
    stream = _build.stream(dev)
    ws = counters = None
    if splits > 1:
        bm, bn, _ = TILE
        ws, counters = _workspace(dev, stream.value, M * N,
                                  math.ceil(M / bm) * math.ceil(N / bn))
    I, Pt = _build.INT, _build.PTR
    _build.launch("q8_matmul", "q8_matmul",
                  (Pt,) * 7 + (I,) * 5 + (Pt,),
                  x_q, w_q, s_x, s_w, out, ws, counters, M, N, K, splits,
                  int(out_dtype == torch.bfloat16), stream)
    _build.LAUNCHES["q8_matmul"] += 1
    return out
