"""LM steps on one device (the port's counterpart of
``repro.launch.steps``): the train step with microbatched gradient
accumulation and its initial state; the prefill and decode step
functions, and the one loop that runs prefill → grow the cache → greedy
decode, which the example and ``chip_smoke.py`` both call.

The JAX steps are jitted with parameter, batch and cache shardings and
donate their state; here the steps run eagerly on one device. The train
step writes the new parameters and moments into the tensors it was given
(JAX donates them), and the decode step writes the cache in place; the
serving steps run under ``torch.inference_mode``. LM sharding is a later
slice.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.param import init_params, tree_leaves, tree_map
from repro_torch.optim.optimizer import (adamw_init, adamw_update_,
                                         cosine_schedule)

__all__ = ["TrainSetup", "make_train_setup", "init_train_state",
           "make_serve_setup", "init_lm_params", "grow_cache", "generate"]


def _check_on(dev: torch.device, what: str, tree) -> None:
    """Raise unless every tensor of ``tree`` lies on ``dev``: a step built
    for one device does not run on another."""
    for t in tree_leaves(tree):
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"{what} on {t.device}; this step runs on "
                             f"{dev}")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class TrainSetup:
    """The train step of a run on one device: ``step_fn(params,
    opt_state, batch, step) → (params, opt_state, metrics)`` with
    metrics ``loss`` and ``grad_norm`` (0-d fp32 tensors on the device);
    ``lr_fn`` is the run's schedule."""

    def __init__(self, step_fn: Callable, lr_fn: Callable):
        self.step_fn = step_fn
        self.lr_fn = lr_fn


def _value_and_grad(model, cfg, params: dict, batch: dict):
    """The loss and the gradient of every parameter leaf (a tree like
    ``params``, each leaf in its parameter's dtype; zeros for a leaf the
    loss does not reach). Autograd runs on detached aliases of the
    leaves, so ``params`` need not require gradients and may be written
    in place once this returns."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = model.loss_fn(alias, batch, cfg)
        grads = iter(torch.autograd.grad(loss, tree_leaves(alias),
                                         allow_unused=True))

    def grad_of(t):                     # tree_map visits tree_leaves' order
        g = next(grads)
        return torch.zeros_like(t) if g is None else g
    return loss.detach(), tree_map(grad_of, params)


def _loss_with_microbatch(model, cfg, run) -> Callable:
    """``(params, batch) → (loss, grads)``; with ``run.microbatch`` below
    the global batch, accumulated over its microbatches in order as the
    JAX scan does: ``loss / n_micro`` and ``g / n_micro`` (in the
    gradient's dtype) added to fp32 zeros."""
    def plain(params, batch):
        return _value_and_grad(model, cfg, params, batch)

    if not run.microbatch or run.microbatch >= run.global_batch:
        return plain
    mb = run.microbatch
    if run.global_batch % mb:
        raise ValueError(f"global batch {run.global_batch} is not a "
                         f"multiple of the microbatch {mb}")
    n_micro = run.global_batch // mb

    def accum(params, batch):
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = plain(params, micro)
            loss_acc = loss_acc + loss / n_micro
            for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
                a.add_(b / n_micro)
            del g
        return loss_acc, g_acc
    return accum


def make_train_setup(run, device=None) -> TrainSetup:
    """The train step of ``run`` on ``device`` (resolved: a request for
    the card without one raises): microbatched loss and gradients, then
    AdamW on the cosine schedule (``run``'s lr, warm-up, total steps,
    betas, weight decay and clip), written into ``params`` and
    ``opt_state``. The step raises unless its parameters, optimizer state
    and batch lie on that device."""
    cfg = run.model
    model = registry.get_model(cfg)
    dev = resolve_device(device)
    lr_fn = cosine_schedule(run.lr, run.warmup_steps, run.total_steps)
    loss_grad = _loss_with_microbatch(model, cfg, run)

    def train_step(params, opt_state, batch, step: int):
        _check_on(dev, "train state", {"params": params, "opt": opt_state})
        _check_on(dev, "batch", batch)
        loss, grads = loss_grad(params, batch)
        metrics = adamw_update_(grads, opt_state, params,
                                lr=lr_fn(int(step)), b1=run.adam_b1,
                                b2=run.adam_b2,
                                weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return TrainSetup(train_step, lr_fn)


def init_train_state(run, seed: int = 0, device=None) -> tuple:
    """(params, opt_state) of ``run``: random weights drawn on ``device``
    (default: the card) from ``seed``, as ``init_lm_params``, and zero
    moments of ``run.moment_dtype``."""
    params = init_lm_params(run.model, seed, device)
    return params, adamw_init(params, getattr(torch, run.moment_dtype))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_serve_setup(run, mode: str, device=None) -> Callable:
    """mode ∈ {"prefill", "decode"} → the step on ``device`` (resolved:
    a request for the card without one raises). The step raises unless
    its parameters and inputs lie on that device.

    prefill: ``step(params, batch) → (cache, last logits)``;
    decode: ``step(params, cache, tokens, pos) → (logits, cache)``, the
    cache written in place.

    The step checks a parameter tree and slices its stacked layers once,
    the first time it is given that tree, and reuses both while it is
    given the same tree (weights are not swapped between steps; a new
    tree is checked and sliced anew). It holds that tree until it is
    given another or is itself dropped."""
    cfg = run.model
    model = registry.get_model(cfg)
    dev = resolve_device(device)
    held: dict = {}

    def layers(params):
        if held.get("params") is not params:
            _check_on(dev, "parameters", params)
            held.update(params=params,
                        layers=model.layer_params(params, cfg))
        return held["layers"]

    if mode == "prefill":
        def prefill_step(params, batch):
            _check_on(dev, "batch", batch)
            with torch.inference_mode():
                return model.prefill(params, batch, cfg,
                                     layers=layers(params))
        return prefill_step
    if mode != "decode":
        raise ValueError(f"mode {mode!r}: prefill or decode")

    def decode_step(params, cache, tokens, pos):
        _check_on(dev, "decode inputs", {"cache": cache, "tokens": tokens,
                                         "pos": pos})
        with torch.inference_mode():
            return model.decode_step(params, cache, tokens, pos, cfg,
                                     layers=layers(params))
    return decode_step


def init_lm_params(cfg, seed: int = 0, device=None) -> dict:
    """Random weights of ``cfg`` drawn on ``device`` (default: the card)
    by a generator of that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(registry.get_model(cfg).param_specs(cfg), gen)


def grow_cache(cfg, cache: dict, batch: int, max_len: int) -> dict:
    """A prefill cache (sized to the prompt) zero-padded at the end of
    every axis to the decode cache of ``max_len`` positions (JAX's
    ``jnp.pad`` to ``init_cache``'s shapes)."""
    dev = next(iter(cache.values())).device
    full = registry.get_model(cfg).init_cache(cfg, batch, max_len,
                                              device=dev)
    for name, small in cache.items():
        full[name][tuple(slice(0, s) for s in small.shape)] = small
    return full


def _prompt_len(cfg, inputs: dict) -> int:
    n = inputs["tokens"].shape[1]
    return n + cfg.n_prefix if cfg.input_mode == "patches+tokens" else n


def generate(run, params: dict, inputs: dict, decode_len: int, *,
             device=None, teacher: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> dict:
    """Prefill ``inputs`` (a prefill batch), grow the cache to
    ``prompt + decode_len`` positions, then decode ``decode_len`` steps:
    greedy, or fed ``teacher[:, i]`` at step i (teacher forcing).

    Returns ``tokens`` (B, decode_len + 1): the prefill's greedy pick and
    every step's; ``cache``; ``logits`` (prefill's, then each step's) if
    ``keep_logits``; and times: ``prefill_ms`` and ``decode_ms`` (one a
    step), from CUDA events on the card (``timer`` "cuda_events") or the
    host clock on the CPU ("host_clock", not a device time)."""
    cfg = run.model
    dev = resolve_device(device)
    B = next(iter(inputs.values())).shape[0]
    prompt = _prompt_len(cfg, inputs)
    prefill = make_serve_setup(run, "prefill", dev)
    decode = make_serve_setup(run, "decode", dev)
    cuda = dev.type == "cuda"

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(a, b):
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    t0 = mark()
    cache, logits = prefill(params, inputs)
    t1 = mark()
    cache = grow_cache(cfg, cache, B, prompt + decode_len)
    kept = [logits] if keep_logits else []
    tokens = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out_tokens = [tokens]
    marks = [mark()]
    for i in range(decode_len):
        feed = tokens if teacher is None else teacher[:, i:i + 1]
        pos = torch.full((B,), prompt + i, dtype=torch.int32, device=dev)
        logits, cache = decode(params, cache, feed, pos)
        tokens = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out_tokens.append(tokens)
        if keep_logits:
            kept.append(logits)
        marks.append(mark())
    if cuda:
        torch.cuda.synchronize(dev)
    out = {"tokens": torch.cat(out_tokens, dim=1), "cache": cache,
           "prefill_ms": ms(t0, t1),
           "decode_ms": [ms(a, b) for a, b in zip(marks, marks[1:])],
           "timer": "cuda_events" if cuda else "host_clock"}
    if keep_logits:
        out["logits"] = kept
    return out
