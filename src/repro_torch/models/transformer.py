"""Decoder/encoder transformer LM covering the dense, MoE, audio-encoder
and VLM-backbone members of the assigned pool (the port's counterpart of
``repro.models.transformer``, serving half).

Layer parameters are stacked along a leading "layers" axis, the JAX
layout, and the stack is walked by a Python loop over that axis.

Supports GQA with optional QKV bias (qwen1.5), RoPE, blockwise
attention; encoder (bidirectional) mode (hubert); MoE blocks (shared +
routed experts; qwen2-moe, kimi-k2); stub modality frontends
(precomputed frame/patch embeddings); the w8a8 fake-quant substrate via
``cfg.quantize_linears``. ``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, at_layer

__all__ = ["param_specs", "layer_params", "hidden_forward", "forward",
           "prefill", "init_cache", "decode_step"]


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


def _block(cfg, p, x, positions, collect_kv: bool = False):
    h = _apply_norm(p["ln_attn"], x, cfg)
    a = L.attention(p["attn"], h, cfg, window=cfg.window or None,
                    causal=not cfg.is_encoder, positions=positions,
                    return_kv=collect_kv)
    kv = None
    if collect_kv:
        a, kv = a
    x = x + a
    h = _apply_norm(p["ln_mlp"], x, cfg)
    if cfg.n_experts:
        y, aux = L.moe(p["moe"], h, cfg)
    else:
        y, aux = L.mlp(p["mlp"], h, cfg), 0.0
    return x + y, aux, kv


def _frontend(feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 features @ the frontend projection, promoted to fp32 as JAX
    promotes a float32 @ bfloat16 product."""
    return feats.float() @ w.float()


def _embed_inputs(params, batch, cfg):
    """Token / frame / patch embedding (stub frontends)."""
    if cfg.input_mode == "tokens":
        x = params["embed"][batch["tokens"]]
    elif cfg.input_mode == "frames":
        x = _frontend(batch["frames"], params["frontend_proj"])
    elif cfg.input_mode == "patches+tokens":
        pre = _frontend(batch["patches"], params["frontend_proj"])
        tok = params["embed"][batch["tokens"]]
        x = torch.cat([pre.to(tok.dtype), tok], dim=1)
    else:
        raise ValueError(cfg.input_mode)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x.to(cfg.dtype), positions


def layer_params(params: dict, cfg) -> list:
    """The stacked block parameters sliced layer by layer (views), in
    depth order: what a serving step slices once and passes as
    ``layers``."""
    return [at_layer(params["blocks"], i) for i in range(cfg.n_layers)]


def hidden_forward(params: dict, batch: dict, cfg,
                   collect_kv: bool = False, layers=None):
    """Run the block stack → (final normed hiddens, aux, kv-or-None);
    kv = (k, v), each (L, B, S, Hkv, dh). ``layers``: ``layer_params``
    of ``params``, if the caller holds it."""
    x, positions = _embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for lp in layers or layer_params(params, cfg):
        x, a, kv = _block(cfg, lp, x, positions, collect_kv)
        aux = aux + a
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = _apply_norm(params["ln_f"], x, cfg)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, aux, kvs


def _unembed_matrix(params, cfg):
    if cfg.is_encoder:
        return params["head"]
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def forward(params: dict, batch: dict, cfg):
    """→ (logits (B, S_out, vocab) fp32, aux). Builds the full logits:
    small-scale use (checks, the encoder)."""
    x, aux, _ = hidden_forward(params, batch, cfg)
    logits = x @ _unembed_matrix(params, cfg)
    return logits.float(), aux


def prefill(params: dict, batch: dict, cfg, layers=None):
    """Process a full prompt → (kv cache (L,B,S,Hkv,dh), last logits)."""
    x, _, (k, v) = hidden_forward(params, batch, cfg, collect_kv=True,
                                  layers=layers)
    logits = (x[:, -1] @ _unembed_matrix(params, cfg)).float()
    return {"k": k, "v": v}, logits


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
    x = params["embed"][tokens].to(cfg.dtype)            # (B, 1, d)
    for i, lp in enumerate(layers or layer_params(params, cfg)):
        hn = _apply_norm(lp["ln_attn"], x, cfg)
        a, _ = L.attention_decode(lp["attn"], hn,
                                  {"k": cache["k"][i], "v": cache["v"][i]},
                                  pos, cfg, window=cfg.window or None)
        x = x + a
        hn = _apply_norm(lp["ln_mlp"], x, cfg)
        if cfg.n_experts:
            y, _ = L.moe(lp["moe"], hn, cfg)
        else:
            y = L.mlp(lp["mlp"], hn, cfg)
        x = x + y
    x = _apply_norm(params["ln_f"], x, cfg)
    logits = x @ _unembed_matrix(params, cfg)
    return logits[:, 0].float(), cache
