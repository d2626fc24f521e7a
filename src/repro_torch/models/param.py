"""Parameter declarations: one ``ParamSpec`` per tensor → initial values
(the port's counterpart of ``repro.models.param``).

Initial values come from a seeded ``torch.Generator``: the same
structure as the JAX package's init, its own numbers, so a run of the
port starts from weights of its own, drawn on the generator's device (a
full-width LM is drawn on the card). To compute the same network as the
JAX package, carry its weights across (``resnet.params_from_jax`` for
the ResNet, ``params_from_jax`` here for the LMs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "param_count", "params_from_jax",
           "tree_paths", "tree_map", "tree_leaves", "unstack"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]     # logical axis name per dim
    init: str = "normal"                # normal | zeros | ones | embed
    scale: float = 1.0                  # stddev multiplier
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _materialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "normal":
        # fan-in scaled normal, fan-in read as in the JAX package
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "embed":
        std = spec.scale
    else:
        raise ValueError(spec.init)
    x = torch.randn(spec.shape, generator=gen, device=dev)
    return x.mul_(std).to(spec.dtype)


def tree_paths(tree, prefix=()):
    """(key path, leaf) of a tree of nested dicts (anything else is a
    leaf), keys in sorted order: JAX's flattening order, and the one
    order in which every tree walk of the port visits leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def init_params(specs: dict, gen: torch.Generator) -> dict:
    """Materialize a tree of ParamSpec (nested dicts) on ``gen``'s device
    (a ``torch.Generator("cuda")`` draws on the card), drawing leaf by
    leaf in sorted-key order."""
    out: dict = {}
    for path, spec in tree_paths(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _materialize(spec, gen)
    return out


def param_count(specs: dict) -> int:
    """Number of scalars a ParamSpec tree declares."""
    return sum(math.prod(s.shape) for _, s in tree_paths(specs))


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of nested dicts, called in
    ``tree_paths``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, in ``tree_paths``' order."""
    return [leaf for _, leaf in tree_paths(tree)]


def unstack(tree) -> list:
    """The layers of a tree whose leaves are stacked along a leading
    ``layers`` axis, in order (views, no copy). One ``unbind`` a leaf, so
    backward stacks a leaf's layer gradients in one pass."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: no numpy kind
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree_np, device=None):
    """The JAX package's LM parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) → the port's (tensors on
    ``device``, default CPU). The port keeps JAX's layout, the stacked
    leading ``layers`` axis included, so the carry is leaf by leaf; a
    bfloat16 leaf goes across bit for bit."""
    return tree_map(lambda a: _tensor_from_numpy(a).to(device), tree_np)
