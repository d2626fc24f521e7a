"""AdamW with global-norm clipping and a cosine schedule, as plain
functions on trees of tensors (the port's counterpart of
``repro.optim.optimizer``).

``params``, ``grads`` and the moments are trees of nested dicts with the
same keys, e.g. ``dict(model.named_parameters())`` or an LM's parameter
tree; leaves are visited in sorted-key order, JAX's flattening order.
The moments may be bfloat16 (``moment_dtype``, as the JAX package sets
for the >= 15B archs); the arithmetic runs in fp32 either way.

``adamw_update_`` writes the new parameters and moments into the
tensors it was given, the port's counterpart of JAX's donated buffers: a
step then holds no second copy of the parameters and moments.
``adamw_update`` is the functional form of the JAX version, the same
update on copies. Every quantity stays a tensor on the parameters'
device, so a step never waits on the host.

A leaf may be ``distributed.sharding.Sharded``: the update then runs
block by block where each block lives, and ``global_norm`` sums every
distinct block once (on the first block's device).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import map_blocks, moving, tree_blocks

__all__ = ["adamw_init", "adamw_update", "adamw_update_", "cosine_schedule",
           "global_norm"]

#: Elements of a leaf updated at once by ``adamw_update_``: its fp32
#: temporaries stay near 256 MB each however large the leaf (the update
#: is elementwise, so slicing changes no value).
_SLICE = 1 << 26


def adamw_init(params: dict, moment_dtype: torch.dtype = torch.float32
               ) -> dict:
    """Zero first and second moments of ``moment_dtype`` and a step
    count."""
    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype)
    return {"m": map_blocks(zeros, params), "v": map_blocks(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_blocks(params)[0].device)}


def global_norm(tree: dict) -> torch.Tensor:
    blocks = tree_blocks(tree)
    home = blocks[0].device
    with moving("all-reduce"):
        return torch.sqrt(sum(torch.sum(torch.square(
            g.to(torch.float32))).to(home) for g in blocks))


def _leaf_update(g, m, v, p, *, lr, b1, b2, eps, weight_decay, c1, c2):
    """JAX's ``upd``: one leaf's new (param, m, v) in their own dtypes."""
    gf = g.to(torch.float32)
    m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
    v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(gf)
    mhat = m_new / c1
    vhat = v_new / c2
    step = mhat / (torch.sqrt(vhat) + eps) + \
        weight_decay * p.to(torch.float32)
    p_new = p.to(torch.float32) - lr * step
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


@torch.no_grad()
def adamw_update_(grads: dict, opt_state: dict, params: dict, *, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1,
                  grad_clip: Optional[float] = 1.0) -> dict:
    """One AdamW step written into ``params`` and ``opt_state`` (the
    gradients are read, not kept). Returns the metrics."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = None
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9),
                            max=1.0)
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    for p, g, m, v in zip(*map(tree_blocks, (params, grads, opt_state["m"],
                                             opt_state["v"])), strict=True):
        dev = p.device
        sc = None if scale is None else scale.to(dev)
        d1, d2 = c1.to(dev), c2.to(dev)
        n = p.shape[0] if p.dim() else 1
        rows = max(1, _SLICE * n // max(1, p.numel()))
        for i in range(0, n, rows):
            sl = slice(i, i + rows) if p.dim() else ...
            gs = g[sl] if sc is None else g[sl] * sc.to(g.dtype)
            out = _leaf_update(gs, m[sl], v[sl], p[sl], lr=lr, b1=b1,
                               b2=b2, eps=eps, weight_decay=weight_decay,
                               c1=d1, c2=d2)
            for dst, src in zip((p, m, v), out):
                dst[sl] = src
    opt_state["count"].copy_(count)
    return {"grad_norm": gnorm}


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, **kw
                 ) -> tuple[dict, dict, dict]:
    """``adamw_update_`` (same keywords) on copies of ``params`` and
    ``opt_state``. Returns (new_params, new_opt_state, metrics)."""
    params, opt_state = map_blocks(torch.clone, params), \
        map_blocks(torch.clone, opt_state)
    return params, opt_state, adamw_update_(grads, opt_state, params, **kw)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``base_lr``, then cosine decay to
    ``min_frac·base_lr`` at ``total``. Computed in float32 in the JAX
    version's order of operations (its ``jnp`` schedule is float32);
    returns that float32 value as a Python float."""
    f32 = torch.float32

    def lr(step: int) -> float:
        s = torch.tensor(float(step), dtype=f32)
        if step < warmup:
            return float(base_lr * s / max(warmup, 1))
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(torch.tensor(math.pi, dtype=f32)
                                        * prog)))
        return float(cos)
    return lr
