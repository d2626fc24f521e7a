"""AdamW with global-norm clipping and a cosine schedule, as plain
functions on dicts of tensors (the port's counterpart of
``repro.optim.optimizer``).

``params``, ``grads`` and the moments are dicts name → tensor with the
same keys, e.g. ``dict(model.named_parameters())``. ``adamw_update`` is
functional like the JAX version: it returns new tensors and the caller
copies them into its parameters. Every quantity stays a tensor on the
parameters' device, so a step never waits on the host.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "global_norm"]


def adamw_init(params: dict) -> dict:
    """fp32 first and second moments, zero, and a step count."""
    first = next(iter(params.values()))
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=first.device)}


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0
                 ) -> tuple[dict, dict, dict]:
    """One AdamW step. Returns (new_params, new_opt_state, metrics)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9),
                            max=1.0)
        grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
    c1 = 1 - b1 ** count
    c2 = 1 - b2 ** count
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        new_m[k] = b1 * opt_state["m"][k] + (1 - b1) * g
        new_v[k] = b2 * opt_state["v"][k] + (1 - b2) * torch.square(g)
        mhat = new_m[k] / c1
        vhat = new_v[k] / c2
        step = mhat / (torch.sqrt(vhat) + eps) + \
            weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * step).to(p.dtype)
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``base_lr``, then cosine decay to
    ``min_frac·base_lr`` at ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + math.cos(math.pi * prog)))
    return lr
