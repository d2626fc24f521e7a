"""Near misses that must stay clean under every rule of the port's
linter."""
import functools
import time

import torch


def timed_with_sync(f, x):
    t0 = time.perf_counter()
    y = f(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, y


def timed_with_events(f, x):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    y = f(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), time.perf_counter() - t0, y


def _sync(stream):
    stream.synchronize()


def timed_with_a_local_barrier(f, x, stream):
    t0 = time.perf_counter()
    y = f(x)
    _sync(stream)
    return time.perf_counter() - t0, y


def deadline_left(deadline):
    # one-sided: a deadline, not a measurement
    return deadline - time.perf_counter()


def host_only(n):
    t0 = time.perf_counter()
    total = sum(range(n))
    return time.perf_counter() - t0, total  # lint: waive=cuda-unsynced-timing


@functools.lru_cache(maxsize=None)
def divisor(q: float, dtype: torch.dtype, device: torch.device):
    return torch.full((), q, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def matrices(spec: "WinogradSpec"):     # a named (hashable) type
    return spec
