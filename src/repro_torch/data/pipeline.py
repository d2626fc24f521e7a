"""Deterministic synthetic CIFAR10-like images (the counterpart of
``repro.data.pipeline.cifar_batch_at``): a pure function of
(seed, step), the same structure as the JAX pipeline with its own
numbers (drawn from a ``torch.Generator``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["cifar_batch_at"]


def _fold(seed: int, *vals: int) -> int:
    return int(np.random.SeedSequence([seed, *vals]).generate_state(1)[0])


def cifar_batch_at(step: int, batch: int, seed: int = 0,
                   device=None) -> dict:
    """Synthetic CIFAR10-like batch with class-dependent structure: class
    k tints channel k%3. Images (batch, 32, 32, 3) NHWC fp32, labels
    (batch,) int64, on ``device`` (default CPU)."""
    gen = torch.Generator().manual_seed(_fold(seed, step, 7))
    labels = torch.randint(0, 10, (batch,), generator=gen)
    imgs = torch.randn((batch, 32, 32, 3), generator=gen) * 0.3
    tint = (F.one_hot(labels % 3, 3).to(torch.float32)
            * (labels[:, None] / 10.0 + 0.3))
    imgs = imgs + tint[:, None, None, :]
    return {"images": imgs.to(device), "labels": labels.to(device)}
