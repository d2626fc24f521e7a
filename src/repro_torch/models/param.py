"""Parameter declarations: one ``ParamSpec`` per tensor → initial values
(the port's counterpart of ``repro.models.param``).

Initial values come from a ``torch.Generator``: the same structure as
the JAX package's init, its own numbers. To compute the same network as
the JAX package, carry its weights across (``resnet.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

__all__ = ["ParamSpec", "init_params"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]     # logical axis name per dim
    init: str = "normal"                # normal | zeros | ones
    scale: float = 1.0                  # stddev multiplier
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _materialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    if spec.init == "normal":
        # fan-in scaled normal, fan-in read as in the JAX package
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return (torch.randn(spec.shape, generator=gen) * std).to(spec.dtype)
    raise ValueError(spec.init)


def _leaves(specs, prefix=()):
    if isinstance(specs, ParamSpec):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from _leaves(specs[k], prefix + (k,))


def init_params(specs: dict, gen: torch.Generator) -> dict:
    """Materialize a tree of ParamSpec (nested dicts) on the CPU, drawing
    from ``gen`` leaf by leaf in sorted-key order."""
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _materialize(spec, gen)
    return out

