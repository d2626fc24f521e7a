"""Deterministic synthetic data: LM batches (tokens, frames,
patches+tokens) and CIFAR10-like images, the counterparts of
``repro.data.pipeline.batch_at`` and ``cifar_batch_at``. Each is a pure
function of (seed, step), the same structure as the JAX pipeline with its
own numbers (drawn from a ``torch.Generator``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["batch_at", "input_specs", "cifar_batch_at"]


def _fold(seed: int, *vals: int) -> int:
    return int(np.random.SeedSequence([seed, *vals]).generate_state(1)[0])


def _synth_tokens(gen, batch, seq, vocab):
    """Markov-ish synthetic tokens: each repeats the previous one with
    p = 0.5 (learnable bigram structure; iid-uniform tokens give a flat
    loss)."""
    base = torch.randint(0, vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    rep = torch.rand((batch, seq), generator=gen) < 0.5
    shifted = torch.cat([base[:, :1], base[:, :-1]], dim=1)
    return torch.where(rep, shifted, base)


def batch_at(model_cfg, seq_len: int, global_batch: int, step: int,
             seed: int = 0, mode: str = "train", device=None) -> dict:
    """The full logical batch for ``step``, on ``device`` (default CPU):
    the leaves of ``input_specs(model_cfg, ...)`` in train mode (tokens
    and next-token labels int32; frames or patches fp32), or without the
    labels in prefill mode."""
    gen = torch.Generator().manual_seed(_fold(seed, step))
    vocab = model_cfg.vocab
    if model_cfg.input_mode == "tokens":
        toks = _synth_tokens(gen, global_batch, seq_len + 1, vocab)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    elif model_cfg.input_mode == "frames":
        frames = torch.randn((global_batch, seq_len, model_cfg.frontend_dim),
                             generator=gen)
        labels = torch.randint(0, vocab, (global_batch, seq_len),
                               generator=gen, dtype=torch.int32)
        out = {"frames": frames, "labels": labels}
    elif model_cfg.input_mode == "patches+tokens":
        n_text = seq_len - model_cfg.n_prefix
        toks = _synth_tokens(gen, global_batch, n_text + 1, vocab)
        patches = torch.randn(
            (global_batch, model_cfg.n_prefix, model_cfg.frontend_dim),
            generator=gen)
        out = {"patches": patches, "tokens": toks[:, :-1],
               "labels": toks[:, 1:]}
    else:
        raise ValueError(model_cfg.input_mode)
    if mode == "prefill":
        out.pop("labels")
    return {k: v.to(device) for k, v in out.items()}


def input_specs(model_cfg, seq_len: int, global_batch: int,
                mode: str = "train") -> dict:
    """(shape, dtype) of every model input, as the JAX package's
    ``input_specs`` declares them: ``train``/``prefill`` full-sequence
    batches (prefill without labels); ``decode`` one new token and its
    position (the cache comes from ``init_cache``)."""
    B, S = global_batch, seq_len
    i32, f32 = torch.int32, torch.float32
    if mode == "decode":
        return {"tokens": ((B, 1), i32), "pos": ((B,), i32)}
    if model_cfg.input_mode == "tokens":
        specs = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    elif model_cfg.input_mode == "frames":
        specs = {"frames": ((B, S, model_cfg.frontend_dim), f32),
                 "labels": ((B, S), i32)}
    elif model_cfg.input_mode == "patches+tokens":
        n_text = S - model_cfg.n_prefix
        specs = {"patches": ((B, model_cfg.n_prefix,
                              model_cfg.frontend_dim), f32),
                 "tokens": ((B, n_text), i32),
                 "labels": ((B, n_text), i32)}
    else:
        raise ValueError(model_cfg.input_mode)
    if mode == "prefill":
        specs.pop("labels")
    return specs


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
