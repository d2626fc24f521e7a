"""Shape bucketing for online serving: a small fixed set of batch
geometries, each captured once, that ragged request traffic is padded
into (the port's counterpart of ``repro.serving.buckets``).

Why buckets: the serving forward runs one CUDA graph per input shape
(``serving.graphs``). An online queue coalesces whatever arrived in the
last few milliseconds, so the natural batch size changes at every
dispatch; rounding each batch up to the nearest registered bucket keeps
the number of graphs equal to the number of buckets, all captured at
start-up by ``ConvEngine.warmup``.

Why padding is safe: a prepared + calibrated int8 engine has no
batch-wide reduction on its serving path (the scales are calibrated
constants, K1 and K4 work per tile, BatchNorm uses its running
statistics, the head works per row), so a request's rows depend on its
own data only, and a request served in a zero-padded bucket is bit for
bit the same request served alone at that bucket's kernels. Dynamic
requant layers would break this (their abs-max spans the batch): serve
only calibrated state, which ``ConvEngine.export_state`` enforces.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["DEFAULT_BUCKETS", "validate_buckets", "bucket_for",
           "pad_batch", "slice_batch", "serve_padded", "device_put",
           "to_numpy"]

#: Powers of two up to the default largest batch: cheap to warm up, and
#: padding wastes less than half of any dispatch.
DEFAULT_BUCKETS = (1, 2, 4, 8)


def validate_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Normalize a bucket set: unique positive ints, ascending."""
    if not buckets:
        raise ValueError("at least one bucket size is required")
    out = sorted({int(b) for b in buckets})
    if out[0] < 1:
        raise ValueError(f"bucket sizes must be >= 1, got {buckets}")
    if any(int(b) != b for b in buckets):
        raise ValueError(f"bucket sizes must be integers, got {buckets}")
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest registered bucket that holds ``n`` requests (``n``
    past the largest is an error: the queue caps coalescing there)."""
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{max(buckets)} — the queue must cap coalescing")


def pad_batch(x: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad the leading (batch) axis of ``x`` up to ``bucket``."""
    n = x.shape[0]
    if n > bucket:
        raise ValueError(f"batch {n} does not fit bucket {bucket}")
    if n == bucket:
        return x
    pad = np.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def slice_batch(y, n: int):
    """The first ``n`` rows of a bucketed result: the real requests."""
    return y[:n]


def device_put(x, device=None) -> torch.Tensor:
    """Host batch → tensor on ``device`` (the engine's; the CPU when
    None). To a card it goes through pinned host memory as a
    ``non_blocking`` copy on the current stream, so the dispatcher goes
    on while it moves; the pinned block is not reused before the copy
    has run. Warm-up, the dispatch loop and the serve-alone baseline all
    come through here."""
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return t.to(dev)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def to_numpy(y) -> np.ndarray:
    """A forward's result on the host (a device tensor is copied back,
    which waits for the work that made it)."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def serve_padded(forward, x: np.ndarray, bucket: int,
                 device: Optional[torch.device] = None) -> np.ndarray:
    """Run ``forward`` on ``x`` padded to ``bucket``; return the real
    rows on the host. On a calibrated serving path, for any
    ``0 < n <= bucket``, ``serve_padded(f, x[:n], bucket)[i]`` is bit for
    bit ``serve_padded(f, x[i:i+1], bucket)[0]``."""
    n = x.shape[0]
    y = forward(device_put(pad_batch(x, bucket), device))
    return to_numpy(slice_batch(y, n))
