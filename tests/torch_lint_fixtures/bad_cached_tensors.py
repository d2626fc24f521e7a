"""Known-bad: lru_cache on a function taking tensors (hashed by
identity: an in-place write leaves the cached result stale). Expected
findings: cached-tensor-args, twice."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def gram(x):          # unannotated: could be a tensor  <-- finding
    return x @ x.T


@functools.cache
def scale(w: torch.Tensor, bits: int):      # <-- finding
    return w.abs().amax() / (2 ** (bits - 1) - 1)
