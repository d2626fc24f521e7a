"""Per-(spec, shape) choice of K4's block tile for int8 Winograd serving
(the port's counterpart of ``repro.conv.autotune``).

K4 (``kernels.fused_serve``, ``csrc/fused_serve.cu``) is compiled for a
few block tiles ``(tiles, output channels)``, ``fused_serve.TILES``. A
larger tile reads each operand fewer times; a smaller one puts more
blocks on the card's SMs and leaves room for two blocks an SM, and which
wins moves with the layer's shape. ``fused_serve.fused_tile`` is the
static rule; this module finds the actual winner offline:

1. ``candidate_tiles`` keeps the compiled tiles whose shared memory
   (``fused_serve.fused_smem_bytes``, the kernel's own ``smem_bytes``)
   fits one block on an H100 (``SMEM_LIMIT``), the default always among
   them.
2. ``autotune_blocks`` times K4 on synthetic int8 operands of exactly
   the serving shape at each candidate with CUDA events, after warm-up,
   and returns the fastest with the whole timing table.

The engine runs it at calibration (``ConvEngine(autotune=True)``), at
the calibration batch's tile geometry, and keeps each winner in the
packed state with the T it was timed at (``PackedWinogradWeights.blocks``),
so the tile rides through checkpoints; ``ConvEngine.warmup`` runs it at
each serving geometry's T before that geometry's capture, so serving
never tunes. A call takes the tile tuned at its own T, else
``fused_tile``'s choice for its shape. Results are also memoised per
(spec, shape) in-process, so same-shaped layers are timed once.

Tuning changes time only: K4's output is the same bits at every tile.
Without a card there is no kernel to time, and the result is the default
tile, marked unmeasured.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.quantization import qmax
from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels.fused_serve import (SMEM_LIMIT, TILES,
                                             fused_gemm_output,
                                             fused_smem_bytes, fused_tile)

__all__ = ["TuneResult", "candidate_tiles", "autotune_blocks",
           "clear_cache"]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one (spec, shape) search.

    ``tile``/``us``: the winner and its median µs a call.
    ``default_tile``/``default_us``: ``fused_tile``'s choice on the same
    shape. ``timings``: every candidate as ``(tile, us)``, fastest first;
    empty, with NaN times, where nothing was measured (no card).
    """

    tile: tuple
    us: float
    default_tile: tuple
    default_us: float
    timings: tuple

    @property
    def measured(self) -> bool:
        return bool(self.timings)


def candidate_tiles(n: int, T: int, cout: int, requant: bool) -> list:
    """K4's compiled tiles whose shared memory fits one block on an H100
    at this n, default first, then by size."""
    fits = [t for t in TILES
            if fused_smem_bytes(n, *t, requant) <= SMEM_LIMIT]
    d = fused_tile(n, T, cout, requant)
    return [d] + [t for t in fits if t != d]


#: (spec, T, cin, cout, hadamard_bits, device, iters, warmup) → TuneResult.
_CACHE: dict = {}


def clear_cache():
    _CACHE.clear()


def autotune_blocks(spec: WinogradSpec, T: int, cin: int, cout: int, *,
                    hadamard_bits: Optional[int] = None,
                    device=None, iters: int = 5, warmup: int = 2
                    ) -> TuneResult:
    """Time K4 at each candidate tile for ``(spec, T, cin, cout)`` and
    return the winner.

    Operands are synthetic int8/fp32 tensors of the serving shape from a
    fixed seed: time depends on shapes only. ``device`` is where the
    engine serves (a CUDA device to measure; on the CPU the default tile
    comes back unmeasured). Memoised per (spec, shape, bits, device,
    options).
    """
    dev = torch.device("cuda" if device is None else device)
    key = (spec, T, cin, cout, hadamard_bits, dev, iters, warmup)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    n, requant = spec.n, hadamard_bits is not None
    cands = candidate_tiles(n, T, cout, requant)
    default = cands[0]
    if dev.type != "cuda":
        res = TuneResult(default, math.nan, default, math.nan, ())
        _CACHE[key] = res
        return res

    from repro_torch.conv.planner import time_call_us
    from repro_torch.kernels.ops import _operands
    P = n * n
    gen = torch.Generator(device=dev).manual_seed(0)
    xq = torch.randint(-127, 128, (P, T, cin), generator=gen, device=dev,
                       dtype=torch.int8)
    uq = torch.randint(-127, 128, (P, cin, cout), generator=gen,
                       device=dev, dtype=torch.int8)
    deq = torch.rand((P, 1), generator=gen, device=dev) * 1e-3 + 1e-5
    rq = (torch.rand((P, 1), generator=gen, device=dev) * cin * 1e-1
          / (qmax(hadamard_bits) if requant else 1) + 1e-4)
    ops = _operands(spec, dev)
    timings = []
    for tile in cands:
        us = time_call_us(lambda: fused_gemm_output(
            xq, uq, deq, rq, ops["CinvT"], ops["APT"], m=spec.m,
            requant_bits=hadamard_bits, changes_base=spec.changes_base,
            tile=tile), dev, iters, warmup)
        timings.append((tile, us))
    timings.sort(key=lambda t: t[1])
    default_us = next(us for t, us in timings if t == default)
    res = TuneResult(timings[0][0], timings[0][1], default, default_us,
                     tuple(timings))
    _CACHE[key] = res
    return res
