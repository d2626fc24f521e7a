"""RWKV-6 "Finch": attention-free LM with data-dependent per-channel decay
(the port's counterpart of ``repro.models.rwkv6``).

Time mixing is a diagonal-decay matrix-state recurrence per head:
    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)
computed in the chunked form (parallel intra-chunk products, then a loop
across chunks carrying S); decode is one O(1) state update.

Data-dependent pieces follow the Finch paper: ddlerp token-shift mixing
with low-rank adapters, and w_t from a LoRA on the shifted mix. Channel
mix is the RWKV squared-ReLU MLP with token shift. Training: ``loss_fn``,
each layer under activation checkpointing where ``cfg.remat``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.losses import chunked_ce
from repro_torch.models.param import ParamSpec, unstack
from repro_torch.models.transformer import _apply_norm, _norm_spec

__all__ = ["param_specs", "layer_params", "hidden_forward", "forward",
           "loss_fn", "prefill", "init_cache", "decode_step"]

_LORA = 64        # low-rank adapter width for ddlerp / decay
_CHUNK = 8        # time-mix chunk: with the decay clamp below, intra-chunk
                  # 1/decay products stay within fp32 range (e^±64)
_MIX = ("r", "k", "v", "w", "g")


def _tm_specs(cfg, lead):
    d = cfg.d_model
    la = ("layers",) * len(lead)
    s = {
        "mu_x": ParamSpec(lead + (len(_MIX), d), la + (None, "embed"),
                          init="zeros", dtype=cfg.dtype),
        "lora_A": ParamSpec(lead + (len(_MIX), d, _LORA),
                            la + (None, "embed", None), dtype=cfg.dtype),
        "lora_B": ParamSpec(lead + (len(_MIX), _LORA, d),
                            la + (None, None, "embed"), dtype=cfg.dtype),
        "w0": ParamSpec(lead + (d,), la + (None,), init="zeros",
                        dtype=torch.float32),
        "u": ParamSpec(lead + (d,), la + (None,), init="zeros",
                       dtype=torch.float32),
    }
    for z in ("r", "k", "v", "g"):
        s[f"w_{z}"] = ParamSpec(lead + (d, d), la + ("embed", "heads"),
                                dtype=cfg.dtype)
    s["w_o"] = ParamSpec(lead + (d, d), la + ("heads", "embed"),
                         dtype=cfg.dtype)
    s["ln_x"] = ParamSpec(lead + (d,), la + (None,), init="ones",
                          dtype=torch.float32)
    return s


def _cm_specs(cfg, lead):
    d, f = cfg.d_model, cfg.d_ff
    la = ("layers",) * len(lead)
    return {
        "mu_k": ParamSpec(lead + (d,), la + ("embed",), init="zeros",
                          dtype=cfg.dtype),
        "mu_r": ParamSpec(lead + (d,), la + ("embed",), init="zeros",
                          dtype=cfg.dtype),
        "w_k": ParamSpec(lead + (d, f), la + ("embed", "mlp"),
                         dtype=cfg.dtype),
        "w_v": ParamSpec(lead + (f, d), la + ("mlp", "embed"),
                         dtype=cfg.dtype),
        "w_r": ParamSpec(lead + (d, d), la + ("embed", "embed"),
                         dtype=cfg.dtype),
    }


def param_specs(cfg) -> dict:
    lead = (cfg.n_layers,)
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02, dtype=cfg.dtype),
        "blocks": {
            "ln_tm": _norm_spec(cfg, lead),
            "tm": _tm_specs(cfg, lead),
            "ln_cm": _norm_spec(cfg, lead),
            "cm": _cm_specs(cfg, lead),
        },
        "ln_f": _norm_spec(cfg),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                             dtype=cfg.dtype),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / ``last`` at t=0). x: (B, T, d)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """Finch data-dependent lerp → the five mixed streams (B,T,5,d), in
    fp32 (x, xx fp32; the bf16 adapters promote)."""
    dx = xx - x
    mu = p["mu_x"].float()[None, None]
    base = x[:, :, None] + dx[:, :, None] * mu
    lo = torch.tanh(torch.einsum("btzd,zdr->btzr", base,
                                 p["lora_A"].float()))
    adapt = torch.einsum("btzr,zrd->btzd", lo, p["lora_B"].float())
    return x[:, :, None] + dx[:, :, None] * (mu + adapt)


def _time_mix_chunked(r, k, v, w, u, state0=None):
    """Chunked linear attention with per-channel decay.

    r,k,v,w: (B, T, H, dh) fp32 with w ∈ (0,1) the decay; u: (H, dh).
    Returns (out, state_end); state: (B, H, dh, dh) (k-major)."""
    B, T, H, dh = r.shape
    c = min(_CHUNK, T)
    if T % c:
        raise ValueError(f"RWKV-6 time mix needs T a multiple of the chunk "
                         f"({_CHUNK}), got T = {T}")
    n = T // c
    rc = r.reshape(B, n, c, H, dh)
    kc = k.reshape(B, n, c, H, dh)
    vc = v.reshape(B, n, c, H, dh)
    wc = w.reshape(B, n, c, H, dh)

    logw = torch.log(torch.clamp_min(wc, 1e-8))
    # D[t] = Π_{s<=t} w_s within the chunk (inclusive); Dm = D[t-1]
    cum = torch.cumsum(logw, dim=2)
    D = torch.exp(cum)                       # (B,n,c,H,dh)
    Dm = torch.exp(cum - logw)               # exclusive
    Dtot = torch.exp(cum[:, :, -1])          # (B,n,H,dh)

    # intra-chunk: A[t,i] = (r_t ⊙ Dm_t) · (k_i / D_i) for i<t; diag u·r·k
    r_d = rc * Dm
    k_d = kc / torch.clamp_min(D, 1e-30)
    att = torch.einsum("bnthd,bnihd->bnhti", r_d, k_d)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     -1)
    att = torch.where(tri[None, None, None], att, 0.0)
    diag = torch.einsum("bnthd,bnthd->bnth", rc * u[None, None, None], kc)
    intra = torch.einsum("bnhti,bnihd->bnthd", att, vc) + \
        diag[..., None] * vc

    # Across chunks: S_end = diag(Dtot)·S0 + Σ_i diag(Dtot/D_i)·k_i v_iᵀ;
    # a chunk's inter-chunk outputs read the carried state:
    # o_t += (r_t ⊙ Dm_t)·S.
    S = state0 if state0 is not None else torch.zeros(
        (B, H, dh, dh), dtype=torch.float32, device=r.device)
    inter = []
    for j in range(n):
        inter.append(torch.einsum("bthd,bhde->bthe", r_d[:, j], S))
        kw = kc[:, j] * (Dtot[:, j, None] / torch.clamp_min(D[:, j], 1e-30))
        S = S * Dtot[:, j, ..., None] + torch.einsum("bthd,bthe->bhde", kw,
                                                      vc[:, j])
    out = (intra + torch.stack(inter, 1)).reshape(B, T, H, dh)
    return out, S


def _time_mix(p, x, cfg, last=None, state0=None):
    B, T, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    dt = cfg.dtype
    xx = _shift(x, last)
    mixed = _ddlerp(p, x.float(), xx.float())
    mr, mk, mv, mw, mg = (mixed[:, :, i] for i in range(5))
    r = (mr.to(dt) @ p["w_r"]).reshape(B, T, H, dh)
    k = (mk.to(dt) @ p["w_k"]).reshape(B, T, H, dh)
    v = (mv.to(dt) @ p["w_v"]).reshape(B, T, H, dh)
    g = F.silu((mg.to(dt) @ p["w_g"]).float())
    lw = torch.tanh(torch.einsum("btd,dr->btr", mw, p["lora_A"][3].float())
                    ) @ p["lora_B"][3].float()
    # Clamp the decay rate (as the JAX package does): the chunked form's
    # intra-chunk 1/decay products stay within fp32 (e^±64 at clamp 4,
    # chunk 8).
    w = torch.exp(-torch.clamp_max(torch.exp(p["w0"][None, None] + lw), 4.0))
    out, S = _time_mix_chunked(r.float(), k.float(), v.float(),
                               w.reshape(B, T, H, dh), p["u"].reshape(H, dh),
                               state0)
    # group-norm per head (ln_x), then gate and project
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    o = (out - mu) * torch.rsqrt(var + 1e-5)
    o = o.reshape(B, T, d) * p["ln_x"][None, None]
    o = (o * g).to(dt) @ p["w_o"]
    return o, (x[:, -1], S)


def _channel_mix(p, x, cfg, last=None):
    xx = _shift(x, last)
    xk = x + (xx - x) * p["mu_k"][None, None].to(x.dtype)
    xr = x + (xx - x) * p["mu_r"][None, None].to(x.dtype)
    k = torch.square(torch.relu((xk @ p["w_k"]).float()))
    kv = k.to(cfg.dtype) @ p["w_v"]
    return torch.sigmoid((xr @ p["w_r"]).float()).to(cfg.dtype) * kv, \
        x[:, -1]


def _layer(lp, h, cfg, S=None, tml=None, cml=None):
    """One RWKV block → (h, (S, tm_last, cm_last))."""
    hn = _apply_norm(lp["ln_tm"], h, cfg)
    o, (tm_last, S) = _time_mix(lp["tm"], hn, cfg, last=tml, state0=S)
    h = h + o
    hn = _apply_norm(lp["ln_cm"], h, cfg)
    o, cm_last = _channel_mix(lp["cm"], hn, cfg, last=cml)
    return h + o, (S, tm_last, cm_last)


def _layer_out(lp, h, cfg):
    return _layer(lp, h, cfg)[0]


def layer_params(params, cfg) -> list:
    """The stacked block parameters sliced layer by layer (views): what a
    serving step slices once and passes as ``layers``."""
    return unstack(params["blocks"])


def hidden_forward(params, batch, cfg, collect_state: bool = False,
                   layers=None):
    x = params["embed"][batch["tokens"]].to(cfg.dtype)
    states = []
    remat = cfg.remat and not collect_state and torch.is_grad_enabled()
    for lp in layers or layer_params(params, cfg):
        if remat:
            x = checkpoint(_layer_out, lp, x, cfg, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        x, st = _layer(lp, x, cfg)
        if collect_state:
            states.append(st)
    x = _apply_norm(params["ln_f"], x, cfg)
    if not collect_state:
        return x, None
    return x, tuple(torch.stack(s) for s in zip(*states))


def forward(params, batch, cfg):
    x, _ = hidden_forward(params, batch, cfg)
    return (x @ params["unembed"]).float(), 0.0


def loss_fn(params, batch, cfg):
    x, _ = hidden_forward(params, batch, cfg)
    return chunked_ce(x, params["unembed"], batch["labels"])


def prefill(params, batch, cfg, layers=None):
    """Prompt → (O(1) decode cache, last-token logits). The prompt length
    must be a multiple of the time-mix chunk (8)."""
    x, (S, tml, cml) = hidden_forward(params, batch, cfg,
                                      collect_state=True, layers=layers)
    logits = (x[:, -1] @ params["unembed"]).float()
    return {"S": S, "tm_last": tml, "cm_last": cml}, logits


# ---------------------------------------------------------------------------
# Decode: O(1) state (matrix state + token-shift memories)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None):
    dh = cfg.rwkv_head_dim
    H = cfg.d_model // dh
    Lyr = cfg.n_layers
    return {
        "S": torch.zeros((Lyr, batch, H, dh, dh), dtype=torch.float32,
                         device=device),
        "tm_last": torch.zeros((Lyr, batch, cfg.d_model), dtype=cfg.dtype,
                               device=device),
        "cm_last": torch.zeros((Lyr, batch, cfg.d_model), dtype=cfg.dtype,
                               device=device),
    }


def decode_step(params, cache, tokens, pos, cfg, layers=None):
    """One-token decode, the cache written in place."""
    x = params["embed"][tokens].to(cfg.dtype)           # (B, 1, d)
    for i, lp in enumerate(layers or layer_params(params, cfg)):
        x, (S, tml, cml) = _layer(lp, x, cfg, cache["S"][i],
                                  cache["tm_last"][i], cache["cm_last"][i])
        cache["S"][i] = S
        cache["tm_last"][i] = tml
        cache["cm_last"][i] = cml
    x = _apply_norm(params["ln_f"], x, cfg)
    logits = (x @ params["unembed"])[:, 0]
    return logits.float(), cache
