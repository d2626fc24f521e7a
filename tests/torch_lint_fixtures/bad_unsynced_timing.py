"""Known-bad: a host-clock window over CUDA launches with no barrier.
Expected finding: cuda-unsynced-timing."""
import time

import torch


def bench(f, x):
    t0 = time.perf_counter()
    for _ in range(10):
        y = f(x)           # launches return before the kernels end
    return time.perf_counter() - t0, y   # <-- finding: times launches
