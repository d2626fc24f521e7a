"""Decoder/encoder transformer LM covering the dense, MoE, audio-encoder
and VLM-backbone members of the assigned pool (the port's counterpart of
``repro.models.transformer``).

Layer parameters are stacked along a leading "layers" axis, the JAX
layout, and the stack is walked by a Python loop over that axis.

Supports GQA with optional QKV bias (qwen1.5), RoPE, blockwise
attention; encoder (bidirectional) mode (hubert); MoE blocks (shared +
routed experts; qwen2-moe, kimi-k2); stub modality frontends
(precomputed frame/patch embeddings); the w8a8 fake-quant substrate via
``cfg.quantize_linears``. Training: ``loss_fn`` (chunked CE, the
encoder's frame targets, the MoE's load-balancing term), with each layer
under activation checkpointing where ``cfg.remat`` (JAX's
``jax.checkpoint`` of its scan body).

Every function runs the batch as the running rows' slabs
(``distributed.sharding.Rows``; one row without a mesh): a layer's
row-local work row by row, its MoE over all rows at once (``layers.moe``)
and a checkpointed layer over all rows, so that its recomputation runs
them too. The entry points take and return whole tensors; a decode cache
over a mesh is ``Sharded`` over its batch dim.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding
from repro_torch.models import layers as L
from repro_torch.models.losses import chunked_ce
from repro_torch.models.param import ParamSpec, unstack

__all__ = ["param_specs", "layer_params", "hidden_forward", "forward",
           "loss_fn", "prefill", "init_cache", "decode_step"]


def _norm_spec(cfg, shape_prefix=()):
    d = cfg.d_model
    la = ("layers",) * len(shape_prefix)
    if cfg.norm_type == "layernorm":
        return {"scale": ParamSpec(shape_prefix + (d,), la + (None,),
                                   init="ones", dtype=cfg.dtype),
                "bias": ParamSpec(shape_prefix + (d,), la + (None,),
                                  init="zeros", dtype=cfg.dtype)}
    return {"scale": ParamSpec(shape_prefix + (d,), la + (None,),
                               init="zeros", dtype=cfg.dtype)}


def _apply_norm(p, x, cfg):
    if cfg.norm_type == "layernorm":
        return L.layer_norm(x, p["scale"], p["bias"])
    return L.rms_norm(x, p["scale"])


def _attn_specs(cfg, lead):
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    la = ("layers",) * len(lead)
    s = {
        "wq": ParamSpec(lead + (d, H * dh), la + ("embed", "heads"),
                        dtype=cfg.dtype),
        "wk": ParamSpec(lead + (d, Hkv * dh), la + ("embed", "kv_heads"),
                        dtype=cfg.dtype),
        "wv": ParamSpec(lead + (d, Hkv * dh), la + ("embed", "kv_heads"),
                        dtype=cfg.dtype),
        "wo": ParamSpec(lead + (H * dh, d), la + ("heads", "embed"),
                        dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(lead + (H * dh,), la + ("heads",), init="zeros",
                            dtype=cfg.dtype)
        s["bk"] = ParamSpec(lead + (Hkv * dh,), la + ("kv_heads",),
                            init="zeros", dtype=cfg.dtype)
        s["bv"] = ParamSpec(lead + (Hkv * dh,), la + ("kv_heads",),
                            init="zeros", dtype=cfg.dtype)
    return s


def _mlp_specs(cfg, lead, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    la = ("layers",) * len(lead)
    s = {"w_up": ParamSpec(lead + (d, f), la + ("embed", "mlp"),
                           dtype=cfg.dtype),
         "w_down": ParamSpec(lead + (f, d), la + ("mlp", "embed"),
                             dtype=cfg.dtype)}
    if cfg.act in ("swiglu", "geglu"):
        s["w_gate"] = ParamSpec(lead + (d, f), la + ("embed", "mlp"),
                                dtype=cfg.dtype)
    return s


def _moe_specs(cfg, lead):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    la = ("layers",) * len(lead)
    s = {
        "w_router": ParamSpec(lead + (d, E), la + ("embed", None),
                              dtype=torch.float32),
        "w_gate": ParamSpec(lead + (E, d, f),
                            la + ("experts", "embed", "expert_mlp"),
                            dtype=cfg.dtype),
        "w_up": ParamSpec(lead + (E, d, f),
                          la + ("experts", "embed", "expert_mlp"),
                          dtype=cfg.dtype),
        "w_down": ParamSpec(lead + (E, f, d),
                            la + ("experts", "expert_mlp", "embed"),
                            dtype=cfg.dtype),
    }
    if cfg.n_shared_experts:
        s["shared"] = _mlp_specs(cfg, lead, d_ff=cfg.shared_d_ff or
                                 cfg.moe_d_ff * cfg.n_shared_experts)
    return s


def param_specs(cfg) -> dict:
    """Full parameter tree (ParamSpec leaves)."""
    lead = (cfg.n_layers,)
    block = {
        "ln_attn": _norm_spec(cfg, lead),
        "attn": _attn_specs(cfg, lead),
        "ln_mlp": _norm_spec(cfg, lead),
    }
    if cfg.n_experts:
        block["moe"] = _moe_specs(cfg, lead)
    else:
        block["mlp"] = _mlp_specs(cfg, lead)
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02, dtype=cfg.dtype),
        "blocks": block,
        "ln_f": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"), scale=1.0,
                                     dtype=cfg.dtype)
    if cfg.input_mode in ("frames", "patches+tokens"):
        specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, cfg.d_model),
                                           (None, "embed"), dtype=cfg.dtype)
    if cfg.is_encoder:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                  ("embed", "vocab"), dtype=cfg.dtype)
        specs.pop("embed", None)
        specs.pop("unembed", None)
    return specs


def _block(cfg, p, xs, positions, collect_kv: bool = False):
    """One layer over the rows' slabs ``xs`` → (xs, aux, per-row kv)."""
    rows = sharding.rows()

    def mix(lp, x):
        h = _apply_norm(lp["ln_attn"], x, cfg)
        a = L.attention(lp["attn"], h, cfg, window=cfg.window or None,
                        causal=not cfg.is_encoder,
                        positions=positions.to(x.device),
                        return_kv=collect_kv)
        kv = None
        if collect_kv:
            a, kv = a
        x = x + a
        return x, _apply_norm(lp["ln_mlp"], x, cfg), kv
    out = rows.each(mix, p, xs)
    xs, hs = [o[0] for o in out], [o[1] for o in out]
    if cfg.n_experts:
        ys, aux = L.moe(p["moe"], hs, cfg)
    else:
        ys, aux = rows.each(lambda lp, h: L.mlp(lp["mlp"], h, cfg), p,
                            hs), 0.0
    return [x + y for x, y in zip(xs, ys)], aux, [o[2] for o in out]


def _frontend(feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 features @ the frontend projection, promoted to fp32 as JAX
    promotes a float32 @ bfloat16 product."""
    return feats.float() @ w.float()


def _embed_inputs(params, batch, cfg):
    """Token / frame / patch embedding (stub frontends) of one row."""
    if cfg.input_mode == "tokens":
        x = L.whole(params["embed"])[batch["tokens"]]
    elif cfg.input_mode == "frames":
        x = _frontend(batch["frames"], params["frontend_proj"])
    elif cfg.input_mode == "patches+tokens":
        pre = _frontend(batch["patches"], params["frontend_proj"])
        tok = L.whole(params["embed"])[batch["tokens"]]
        x = torch.cat([pre.to(tok.dtype), tok], dim=1)
    else:
        raise ValueError(cfg.input_mode)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x.to(cfg.dtype), positions


def layer_params(params: dict, cfg) -> list:
    """The stacked block parameters sliced layer by layer (views), in
    depth order: what a serving step slices once and passes as
    ``layers``."""
    return unstack(params["blocks"])


def _embed_rows(params, batch, cfg):
    """The rows' embedded slabs and the positions (1, S)."""
    rows = sharding.rows()
    front = {k: params[k] for k in ("embed", "frontend_proj") if k in params}
    out = rows.each(lambda p, b: _embed_inputs(p, b, cfg), front,
                    L.split_batch(batch))
    return [o[0] for o in out], out[0][1]


def hidden_forward(params: dict, batch: dict, cfg,
                   collect_kv: bool = False, layers=None):
    """Run the block stack → (the rows' final normed hiddens, aux,
    per-row kv-or-None); a row's kv = (k, v), each (L, B_r, S, Hkv, dh),
    or its model blocks (``layers.attention``).
    ``layers``: ``layer_params`` of ``params``, if the caller holds it."""
    rows = sharding.rows()
    xs, positions = _embed_rows(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    kvs = [([], []) for _ in xs]
    remat = cfg.remat and not collect_kv and torch.is_grad_enabled()
    for lp in layers or layer_params(params, cfg):
        if remat:
            xs, a, kv = checkpoint(_block, cfg, lp, xs, positions,
                                   collect_kv, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            xs, a, kv = _block(cfg, lp, xs, positions, collect_kv)
        aux = aux + a
        if collect_kv:
            for (ks, vs), (k, v) in zip(kvs, kv):
                ks.append(k)
                vs.append(v)
    xs = rows.each(lambda p, x: _apply_norm(p, x, cfg), params["ln_f"], xs)
    if not collect_kv:
        return xs, aux, None
    return xs, aux, [(L.stack_kv(ks), L.stack_kv(vs)) for ks, vs in kvs]


def _unembed_matrix(params, cfg):
    if cfg.is_encoder:
        return params["head"]
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _logits(params, xs, cfg):
    """The rows' logits (fp32), joined on row 0's device."""
    return sharding.rows().join(sharding.rows().each(
        lambda w, x: L.linear(x, w).float(), _unembed_matrix(params, cfg),
        xs))


def forward(params: dict, batch: dict, cfg):
    """→ (logits (B, S_out, vocab) fp32, aux). Builds the full logits:
    small-scale use (checks, the encoder)."""
    xs, aux, _ = hidden_forward(params, batch, cfg)
    return _logits(params, xs, cfg), aux


def loss_fn(params: dict, batch: dict, cfg) -> torch.Tensor:
    """Next-token (decoder) or frame-target (encoder) chunked CE, on the
    text positions of a VLM batch; plus 0.01 × the MoE's aux loss."""
    xs, aux, _ = hidden_forward(params, batch, cfg)
    labels = sharding.rows().split(batch["labels"])
    if cfg.input_mode == "patches+tokens":          # loss on text positions
        xs = [x[:, -lab.shape[1]:, :] for x, lab in zip(xs, labels)]
    nll = chunked_ce(xs, _unembed_matrix(params, cfg), labels)
    return nll + 0.01 * aux


def prefill(params: dict, batch: dict, cfg, layers=None):
    """Process a full prompt → (kv cache (L,B,S,Hkv,dh), last logits)."""
    xs, _, kv = hidden_forward(params, batch, cfg, collect_kv=True,
                               layers=layers)
    logits = _logits(params, [x[:, -1] for x in xs], cfg)
    rows = sharding.rows()
    d = L.kv_cache_dim(cfg)
    return {"k": rows.stitch_cache("k", [k for k, _ in kv], d),
            "v": rows.stitch_cache("v", [v for _, v in kv], d)}, logits


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None):
    """KV cache tree: (L, B, Smax, Hkv, dh) stacks of zeros."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg, layers=None):
    """One token for every sequence. tokens: (B, 1) int; pos: (B,).

    Returns (logits (B, vocab) fp32, cache); the cache is written in
    place (JAX's decode step donates it)."""
    rows = sharding.rows()
    caches = rows.cache_rows(cache)
    poss = rows.split(pos)
    xs = rows.each(lambda p, t: L.whole(p)[t].to(cfg.dtype),
                   params["embed"], rows.split(tokens))      # (B, 1, d)
    for i, lp in enumerate(layers or layer_params(params, cfg)):
        def mix(p, x, c, ps):
            hn = _apply_norm(p["ln_attn"], x, cfg)
            a, _ = L.attention_decode(p["attn"], hn,
                                      {"k": c["k"][i], "v": c["v"][i]},
                                      ps, cfg, window=cfg.window or None)
            x = x + a
            return x, _apply_norm(p["ln_mlp"], x, cfg)
        out = rows.each(mix, lp, xs, caches, poss)
        xs, hs = [o[0] for o in out], [o[1] for o in out]
        if cfg.n_experts:
            ys, _ = L.moe(lp["moe"], hs, cfg)
        else:
            ys = rows.each(lambda p, h: L.mlp(p["mlp"], h, cfg), lp, hs)
        xs = [x + y for x, y in zip(xs, ys)]
    xs = rows.each(lambda p, x: _apply_norm(p, x, cfg), params["ln_f"], xs)
    return _logits(params, [x[:, 0] for x in xs], cfg), cache
