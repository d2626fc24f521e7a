"""LM steps on one device or over a mesh (the port's counterpart of
``repro.launch.steps``): the train step with microbatched gradient
accumulation and its initial state; the prefill and decode step
functions, and the one loop that runs prefill → grow the cache → greedy
decode, which the example and ``chip_smoke.py`` both call.

The JAX steps are jitted with parameter, batch and cache shardings and
donate their state; here the steps run eagerly. The train step writes
the new parameters and moments into the tensors it was given (JAX
donates them), and the decode step writes the cache in place; the
serving steps run under ``torch.inference_mode``.

With ``mesh=`` (a ``distributed.sharding.Mesh``) one process drives the
mesh, as the sharded conv serving does: every parameter and moment
leaf is ``Sharded`` under ``pspec`` of its logical axes and
``sharding.rules(fsdp=run.fsdp, multi_pod=)``, ``multi_pod`` read off
the mesh (a "pod" axis); a step takes a batch of whole tensors, cuts it
into rows as ``_batch_shardings`` places it (dim 0 over
``_dp_for_dim``'s data axes) and runs the model under those ``Rows``;
gradients reach each block through autograd, and AdamW updates each
block where it lives. The step computes the function the one-device
step computes on the whole batch (on a 1 × 1 mesh, bit for bit). The
decode cache is placed as ``_cache_pspec`` says: each model block
attends with its own KV heads (or head-dim slice) and keeps their cache
(``layers.attention``), and the other leaves are cut along their
channels.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import (NamedSharding, P, Rows,
                                              Sharded, from_blocks,
                                              map_blocks, tree_blocks)
from repro_torch.models import registry
from repro_torch.models.param import init_params, tree_leaves, tree_map
from repro_torch.optim.optimizer import (adamw_init, adamw_update_,
                                         cosine_schedule)

__all__ = ["TrainSetup", "make_train_setup", "init_train_state",
           "make_serve_setup", "init_lm_params", "param_shardings",
           "grow_cache", "generate"]


def _check_on(dev: torch.device, what: str, tree) -> None:
    """Raise unless every tensor of ``tree`` lies on ``dev``: a step built
    for one device does not run on another."""
    for t in tree_leaves(tree):
        if isinstance(t, Sharded):
            raise ValueError(f"{what} sharded over a mesh; this step runs "
                             f"on {dev}")
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"{what} on {t.device}; this step runs on "
                             f"{dev}")


def _check_over(mesh, what: str, tree) -> None:
    """Raise unless every leaf of ``tree`` is ``Sharded`` over ``mesh``."""
    for t in tree_leaves(tree):
        if not isinstance(t, Sharded) or t.mesh is not mesh:
            raise ValueError(f"{what} not placed over this step's mesh "
                             f"{mesh.shape}")


# ---------------------------------------------------------------------------
# Placement (the JAX package's ``steps.py`` helpers)
# ---------------------------------------------------------------------------

def _dp_for_dim(size: int, mesh, rule_map):
    """The largest data-parallel mapping that divides ``size`` (the
    batch's rule, then its last axis, then its first; None: whole)."""
    dp = rule_map["batch"]
    cands = [dp] if not isinstance(dp, tuple) else \
        [dp, dp[-1:], dp[:1], None]
    for c in ([dp, None] if not isinstance(dp, tuple) else cands):
        if c is None:
            return None
        ext = 1
        for a in (c if isinstance(c, tuple) else (c,)):
            ext *= mesh.shape[a]
        if size % ext == 0:
            return c
    return None


def _batch_shardings(mesh, batch_tree, rule_map):
    """A ``NamedSharding`` a batch leaf: dim 0 over ``_dp_for_dim``."""
    return tree_map(lambda x: NamedSharding(mesh, P(
        _dp_for_dim(x.shape[0], mesh, rule_map),
        *([None] * (len(x.shape) - 1)))), batch_tree)


def _cache_pspec(cfg, cache_abstract: dict, mesh, rule_map) -> dict:
    """A ``NamedSharding`` a decode-cache leaf, as the JAX package's:
    the batch (dim 1) over the data axes; k/v's heads (else their head
    dim), RWKV's state heads, and any other leaf's trailing channels
    over "model" where they divide (``sharding.cache_model_dim``)."""
    msize = mesh.shape["model"]

    def leaf(name, x):
        shape = tuple(x.shape)
        if len(shape) < 2:
            return NamedSharding(mesh, P())
        spec = [None] * len(shape)
        spec[1] = _dp_for_dim(shape[1], mesh, rule_map)
        d = shd.cache_model_dim(name, shape, msize)
        if d is not None:
            spec[d] = "model"
        return NamedSharding(mesh, P(*spec))
    return {name: leaf(name, x) for name, x in cache_abstract.items()}


def _rules(mesh, fsdp: bool) -> Optional[dict]:
    """The rules over ``mesh``: the batch (and with ``fsdp`` the embed
    dims) over ("pod", "data") where the mesh has a "pod" axis, else over
    "data" (None without a mesh)."""
    if mesh is None:
        return None
    return shd.rules(fsdp=fsdp, multi_pod="pod" in mesh.axis_names)


def param_shardings(cfg, mesh, *, fsdp: bool = False) -> dict:
    """The ``NamedSharding`` of every parameter leaf of ``cfg`` over
    ``mesh``: ``tree_shardings`` of its logical axes under the rules."""
    specs = registry.get_model(cfg).param_specs(cfg)
    return shd.tree_shardings(mesh, tree_map(lambda s: s.axes, specs),
                              _rules(mesh, fsdp), specs)


def _rows(mesh, batch: dict, rule_map, cfg=None,
          first_only: bool = False) -> Rows:
    """The rows ``batch`` (whole tensors of one batch size) runs as over
    ``mesh``: dim 0 cut as ``_batch_shardings`` places it (one row
    without a mesh); in lockstep where ``cfg`` fake-quantizes its
    linears (their activation scales span the rows); ``first_only``:
    see ``make_train_setup``."""
    if mesh is None:
        return Rows()
    dp = {s.spec[0] for s in tree_leaves(
        _batch_shardings(mesh, batch, rule_map))}
    if len(dp) != 1:
        raise ValueError(f"batch leaves cut {dp} ways: one batch size")
    return Rows(mesh, dp.pop(), first_only=first_only,
                lockstep=bool(cfg is not None and cfg.quantize_linears))


def _check_cache(cfg, cache: dict, mesh, rule_map) -> None:
    """Raise unless every leaf of a prefill's cache is placed as
    ``_cache_pspec`` places it."""
    for name, sh in _cache_pspec(cfg, cache, mesh, rule_map).items():
        t = cache[name]
        n = len(t.shape)
        if not isinstance(t, Sharded) or \
                tuple(t.spec) + (None,) * (n - len(t.spec)) != \
                tuple(sh.spec) + (None,) * (n - len(sh.spec)):
            raise ValueError(f"cache leaf {name!r} placed "
                             f"{getattr(t, 'spec', None)}, not {sh.spec}")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class TrainSetup:
    """The train step of a run on one device: ``step_fn(params,
    opt_state, batch, step) → (params, opt_state, metrics)`` with
    metrics ``loss`` and ``grad_norm`` (0-d fp32 tensors on the device);
    ``lr_fn`` is the run's schedule. The step is ``loss_grad(params,
    batch) → (loss, grads)`` then ``update(grads, opt_state, params,
    step) → metrics``, after its checks (the dry run counts the two
    apart)."""

    def __init__(self, step_fn: Callable, lr_fn: Callable,
                 loss_grad: Optional[Callable] = None,
                 update: Optional[Callable] = None):
        self.step_fn = step_fn
        self.lr_fn = lr_fn
        self.loss_grad = loss_grad
        self.update = update


def _value_and_grad(model, cfg, params: dict, batch: dict,
                    rows: Optional[Rows] = None):
    """The loss and the gradient of every parameter leaf (a tree like
    ``params``, each leaf in its parameter's dtype and layout; zeros for
    a block the loss does not reach). Autograd runs on detached aliases
    of the leaves (of each block of a ``Sharded`` leaf), so ``params``
    need not require gradients and may be written in place once this
    returns. ``rows``: the batch's rows over a mesh, installed for the
    forward and for the backward's recomputations."""
    alias = map_blocks(lambda t: t.detach().requires_grad_(), params)
    blocks = tree_blocks(alias)
    with torch.enable_grad(), shd.running(rows or Rows()):
        loss = model.loss_fn(alias, batch, cfg)
        grads = torch.autograd.grad(loss, blocks, allow_unused=True)
    return loss.detach(), from_blocks(params, [
        torch.zeros_like(t) if g is None else g
        for t, g in zip(blocks, grads)])


def _loss_with_microbatch(model, cfg, run, mesh=None, rule_map=None,
                          first_only: bool = False) -> Callable:
    """``(params, batch) → (loss, grads)``; with ``run.microbatch`` below
    the global batch, accumulated over its microbatches in order as the
    JAX scan does: ``loss / n_micro`` and ``g / n_micro`` (in the
    gradient's dtype) added to fp32 zeros. Over ``mesh`` each
    (micro)batch's rows are cut over the data axes (JAX constrains the
    microbatch rows so)."""
    def plain(params, batch):
        return _value_and_grad(model, cfg, params, batch,
                               _rows(mesh, batch, rule_map, cfg, first_only))

    if not run.microbatch or run.microbatch >= run.global_batch:
        return plain
    mb = run.microbatch
    if run.global_batch % mb:
        raise ValueError(f"global batch {run.global_batch} is not a "
                         f"multiple of the microbatch {mb}")
    n_micro = run.global_batch // mb

    def accum(params, batch):
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=tree_blocks(params)[0].device)
        g_acc = map_blocks(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = plain(params, micro)
            loss_acc = loss_acc + loss / n_micro
            for a, b in zip(tree_blocks(g_acc), tree_blocks(g)):
                a.add_(b / n_micro)
            del g
        return loss_acc, g_acc
    return accum


def make_train_setup(run, device=None, *, mesh=None,
                     first_only: bool = False) -> TrainSetup:
    """The train step of ``run`` on ``device`` (resolved: a request for
    the card without one raises), or over ``mesh``: microbatched loss
    and gradients, then AdamW on the cosine schedule (``run``'s lr,
    warm-up, total steps, betas, weight decay and clip), written into
    ``params`` and ``opt_state``. On one device the step raises unless
    its parameters, optimizer state and batch lie on that device; over a
    mesh, unless the state is placed over that mesh
    (``init_train_state(mesh=)``); the batch is whole tensors on any of
    its devices; a mesh with a "pod" axis cuts the batch (and with
    ``run.fsdp`` the embed dims) over ("pod", "data"), else over "data".
    ``first_only`` (the dry run, ``launch.dryrun``, under fake tensors):
    the step computes only mesh position 0's work, the other rows and
    blocks standing in (``sharding.Rows(first_only=True)``)."""
    cfg = run.model
    model = registry.get_model(cfg)
    lr_fn = cosine_schedule(run.lr, run.warmup_steps, run.total_steps)
    if mesh is None:
        dev = resolve_device(device)
    loss_grad = _loss_with_microbatch(model, cfg, run, mesh,
                                      _rules(mesh, run.fsdp), first_only)

    def train_step(params, opt_state, batch, step: int):
        if mesh is None:
            _check_on(dev, "train state", {"params": params,
                                           "opt": opt_state})
            _check_on(dev, "batch", batch)
        else:
            _check_over(mesh, "train state", {"params": params,
                                              "m": opt_state["m"],
                                              "v": opt_state["v"]})
        loss, grads = loss_grad(params, batch)
        metrics = update(grads, opt_state, params, step)
        metrics["loss"] = loss
        return params, opt_state, metrics

    def update(grads, opt_state, params, step: int):
        return adamw_update_(grads, opt_state, params, lr=lr_fn(int(step)),
                             b1=run.adam_b1, b2=run.adam_b2,
                             weight_decay=run.weight_decay,
                             grad_clip=run.grad_clip)
    return TrainSetup(train_step, lr_fn, loss_grad, update)


def init_train_state(run, seed: int = 0, device=None, *,
                     mesh=None) -> tuple:
    """(params, opt_state) of ``run``: random weights drawn on ``device``
    (default: the card, or over a mesh its first device) from ``seed``,
    as ``init_lm_params``, and zero moments of ``run.moment_dtype``. Over
    ``mesh`` each leaf is drawn whole, in the one-device order from the
    same generator, and placed before the next is drawn: the blocks hold
    the one-device values bit for bit, and the peak is one leaf."""
    params = init_lm_params(run.model, seed, device, mesh=mesh,
                            fsdp=run.fsdp)
    return params, adamw_init(params, getattr(torch, run.moment_dtype))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_serve_setup(run, mode: str, device=None, *, mesh=None,
                     first_only: bool = False) -> Callable:
    """mode ∈ {"prefill", "decode"} → the step on ``device`` (resolved:
    a request for the card without one raises), or over ``mesh``. On one
    device the step raises unless its parameters and inputs lie on that
    device; over a mesh, unless the parameters are placed over it. Its
    inputs are whole tensors; its batch runs as rows over the data axes
    (``first_only``: as ``make_train_setup``).

    prefill: ``step(params, batch) → (cache, last logits)``;
    decode: ``step(params, cache, tokens, pos) → (logits, cache)``, the
    cache written in place. Over a mesh the cache's leaves are
    ``Sharded`` as ``_cache_pspec`` says (``_check_cache`` holds the
    prefill's to it) and the logits whole on the mesh's first device.

    The step checks a parameter tree and slices its stacked layers once,
    the first time it is given that tree, and reuses both while it is
    given the same tree (weights are not swapped between steps; a new
    tree is checked and sliced anew). It holds that tree until it is
    given another or is itself dropped."""
    cfg = run.model
    model = registry.get_model(cfg)
    if mesh is None:
        dev = resolve_device(device)
    rule_map = _rules(mesh, run.fsdp)
    held: dict = {}

    def layers(params):
        if held.get("params") is not params:
            if mesh is None:
                _check_on(dev, "parameters", params)
            else:
                _check_over(mesh, "parameters", params)
            held.update(params=params,
                        layers=model.layer_params(params, cfg))
        return held["layers"]

    if mode == "prefill":
        def prefill_step(params, batch):
            if mesh is None:
                _check_on(dev, "batch", batch)
            with torch.inference_mode(), \
                    shd.running(_rows(mesh, batch, rule_map, cfg,
                                      first_only)):
                cache, logits = model.prefill(params, batch, cfg,
                                              layers=layers(params))
                if mesh is not None:
                    _check_cache(cfg, cache, mesh, rule_map)
            return cache, logits
        return prefill_step
    if mode != "decode":
        raise ValueError(f"mode {mode!r}: prefill or decode")

    def decode_step(params, cache, tokens, pos):
        if mesh is None:
            _check_on(dev, "decode inputs", {"cache": cache,
                                             "tokens": tokens, "pos": pos})
        with torch.inference_mode(), shd.running(
                _rows(mesh, {"tokens": tokens}, rule_map, cfg, first_only)):
            return model.decode_step(params, cache, tokens, pos, cfg,
                                     layers=layers(params))
    return decode_step


def init_lm_params(cfg, seed: int = 0, device=None, *, mesh=None,
                   fsdp: bool = False) -> dict:
    """Random weights of ``cfg`` drawn on ``device`` (default: the card,
    or over a mesh its first device) by a generator of that device
    seeded with ``seed``; over ``mesh`` each leaf placed by
    ``param_shardings`` as it is drawn."""
    dev = resolve_device(mesh.first if device is None and mesh is not None
                         else device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = registry.get_model(cfg).param_specs(cfg)
    if mesh is None:
        return init_params(specs, gen)
    sh = param_shardings(cfg, mesh, fsdp=fsdp)

    def place(path, t):
        node = sh
        for k in path:
            node = node[k]
        return Sharded.place(t, node)
    return init_params(specs, gen, place)


def grow_cache(cfg, cache: dict, batch: int, max_len: int) -> dict:
    """A prefill cache (sized to the prompt) zero-padded at the end of
    every axis to the decode cache of ``max_len`` positions (JAX's
    ``jnp.pad`` to ``init_cache``'s shapes); a ``Sharded`` cache block by
    block."""
    first = next(iter(cache.values()))
    if isinstance(first, Sharded):
        want = registry.get_model(cfg).init_cache(cfg, batch, max_len,
                                                  device="meta")
        out = {}
        for name, v in cache.items():
            shape = list(want[name].shape)
            blocks = {}
            for key, t in v.blocks.items():
                bshape = [s // n for s, n in zip(shape, v.counts())]
                g = torch.zeros(bshape, dtype=t.dtype, device=t.device)
                g[tuple(slice(0, s) for s in t.shape)] = t
                blocks[key] = g
            out[name] = Sharded(v.sharding, shape, blocks)
        return out
    dev = first.device
    full = registry.get_model(cfg).init_cache(cfg, batch, max_len,
                                              device=dev)
    for name, small in cache.items():
        full[name][tuple(slice(0, s) for s in small.shape)] = small
    return full


def _prompt_len(cfg, inputs: dict) -> int:
    n = inputs["tokens"].shape[1]
    return n + cfg.n_prefix if cfg.input_mode == "patches+tokens" else n


def generate(run, params: dict, inputs: dict, decode_len: int, *,
             device=None, mesh=None, teacher: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> dict:
    """Prefill ``inputs`` (a prefill batch), grow the cache to
    ``prompt + decode_len`` positions, then decode ``decode_len`` steps:
    greedy, or fed ``teacher[:, i]`` at step i (teacher forcing).

    Returns ``tokens`` (B, decode_len + 1): the prefill's greedy pick and
    every step's; ``cache``; ``logits`` (prefill's, then each step's) if
    ``keep_logits``; and times: ``prefill_ms`` and ``decode_ms`` (one a
    step), from CUDA events on the card (``timer`` "cuda_events") or the
    host clock on the CPU ("host_clock", not a device time). Over
    ``mesh`` (parameters placed by ``init_lm_params(mesh=)``) the steps
    run sharded, timed on the mesh's first device."""
    cfg = run.model
    dev = resolve_device(mesh.first if mesh is not None else device)
    B = next(iter(inputs.values())).shape[0]
    prompt = _prompt_len(cfg, inputs)
    prefill = make_serve_setup(run, "prefill", dev, mesh=mesh)
    decode = make_serve_setup(run, "decode", dev, mesh=mesh)
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
