"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA
(the port's counterpart of ``repro.models.rglru``).

Block pattern is (rec, rec, attn) repeating (the 1:2 ratio of the
config). The temporal conv1d (width 4) inside every recurrent block is
the one live convolution in the assigned LM pool: with
``cfg.use_winograd_conv`` it runs the paper's quantized 1-D Toom-Cook
pipeline, F(4,4) in the Legendre base with the 9-bit Hadamard stage.

The RG-LRU recurrence  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)
is a diagonal linear recurrence, scanned in log depth by
``_associative_scan``, which pairs the elements as
``jax.lax.associative_scan`` does. Decode keeps O(1) state per layer:
(rnn state, conv tail, window-bounded ring-buffer KV). Training:
``loss_fn``, each (rec, rec, attn) group under activation checkpointing
where ``cfg.remat`` (the remainder layers without, as in the JAX
package); the conv's gradients pass its fake-quant casts by the
saturating straight-through estimator, so the network trains
Winograd-aware, the paper's method.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import winograd as W
from repro_torch.core.quantization import divide, fake_quant, qmax
from repro_torch.models import layers as L
from repro_torch.models.losses import chunked_ce
from repro_torch.models.param import ParamSpec, unstack
from repro_torch.models.transformer import (_apply_norm, _attn_specs,
                                            _mlp_specs, _norm_spec)

__all__ = ["param_specs", "layer_params", "hidden_forward", "forward",
           "loss_fn", "prefill", "init_cache", "decode_step",
           "split_pattern"]

_RG_C = 8.0  # Griffin's recurrence sharpness constant


def split_pattern(cfg):
    """layer index → ("rec"|"attn"); groups of full periods + remainder."""
    pat = cfg.block_pattern                     # e.g. ("rec","rec","attn")
    p = len(pat)
    n_full = cfg.n_layers // p
    rem = tuple(pat[i] for i in range(cfg.n_layers - n_full * p))
    return pat, n_full, rem


def _rec_specs(cfg, lead):
    d, dr = cfg.d_model, cfg.d_rnn
    la = ("layers",) * len(lead)
    return {
        "w_x": ParamSpec(lead + (d, dr), la + ("embed", "mlp"),
                         dtype=cfg.dtype),
        "w_y": ParamSpec(lead + (d, dr), la + ("embed", "mlp"),
                         dtype=cfg.dtype),
        "conv_w": ParamSpec(lead + (cfg.conv_width, dr),
                            la + (None, "mlp"), dtype=cfg.dtype),
        "conv_b": ParamSpec(lead + (dr,), la + ("mlp",), init="zeros",
                            dtype=cfg.dtype),
        # RG-LRU gates (per-channel, block-diagonal simplified to dense)
        "w_a": ParamSpec(lead + (dr, dr), la + ("mlp", None),
                         dtype=cfg.dtype),
        "b_a": ParamSpec(lead + (dr,), la + (None,), init="zeros",
                         dtype=cfg.dtype),
        "w_i": ParamSpec(lead + (dr, dr), la + ("mlp", None),
                         dtype=cfg.dtype),
        "b_i": ParamSpec(lead + (dr,), la + (None,), init="zeros",
                         dtype=cfg.dtype),
        "lam": ParamSpec(lead + (dr,), la + (None,), init="ones",
                         dtype=torch.float32),
        "w_out": ParamSpec(lead + (dr, d), la + ("mlp", "embed"),
                           dtype=cfg.dtype),
    }


def _block_specs(cfg, lead, kind):
    s = {"ln_mix": _norm_spec(cfg, lead), "ln_mlp": _norm_spec(cfg, lead),
         "mlp": _mlp_specs(cfg, lead)}
    if kind == "attn":
        s["attn"] = _attn_specs(cfg, lead)
    else:
        s["rec"] = _rec_specs(cfg, lead)
    return s


def param_specs(cfg) -> dict:
    pat, n_full, rem = split_pattern(cfg)
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02, dtype=cfg.dtype),
        "groups": {f"{i}_{kind}": _block_specs(cfg, (n_full,), kind)
                   for i, kind in enumerate(pat)},
        "rem": {f"{i}_{kind}": _block_specs(cfg, (), kind)
                for i, kind in enumerate(rem)},
        "ln_f": _norm_spec(cfg),
    }


def layer_params(params, cfg) -> list:
    """[(block params, kind)] in depth order: the groups' periods (views
    of the stacks), then the remainder; what a serving step slices once
    and passes as ``layers``."""
    pat, n_full, rem = split_pattern(cfg)
    stacks = [unstack(params["groups"][f"{i}_{kind}"])
              for i, kind in enumerate(pat)]
    return [(stacks[i][g], kind)
            for g in range(n_full) for i, kind in enumerate(pat)] + \
        [(params["rem"][f"{i}_{kind}"], kind) for i, kind in enumerate(rem)]


# ---------------------------------------------------------------------------
# The temporal conv: direct, or the quantized 1-D Toom-Cook pipeline
# ---------------------------------------------------------------------------

def _conv1d(p, x, cfg):
    """Causal width-r depthwise temporal conv. x: (B, T, dr)."""
    w, b = p["conv_w"], p["conv_b"]
    if cfg.use_winograd_conv and cfg.winograd is not None:
        spec = cfg.winograd
        mats = W.make_matrices(spec)
        U = _depthwise_wino_weights(w, spec, mats)      # (C, n)
        return _depthwise_wino_conv(x, U, spec, mats) + b
    r = w.shape[0]
    xp = F.pad(x, (0, 0, r - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(r))
    return y + b


def _depthwise_wino_weights(w, spec, mats):
    """(r, C) depthwise weights → (C, n) transformed weights.

    The JAX package ``vmap``s ``transform_weights_1d`` over the channels,
    so every cast of a channel's (r, 1, 1) kernel has that channel's own
    abs-max scale; here the same casts run on all channels at once with a
    scale per row."""
    q = spec.quant

    def cast_dom(U):
        # ``_q_dom`` of one (1, 1, n) kernel: one scale, or with position
        # scales one a position, i.e. an element
        if q.position_scales and q.trans_bits is not None:
            return fake_quant(U, q.trans_bits, scale=divide(
                torch.clamp_min(U.detach().abs(), 1e-12), qmax(q.trans_bits)))
        return fake_quant(U, q.trans_bits, axis=(1,))
    wt = w.transpose(0, 1)                               # (C, r)
    wt = fake_quant(wt, q.weight_bits, axis=(1,))
    Gm, _, _, back, _ = W._resolve(mats, None, spec, wt.float())
    U = W._apply(Gm, wt.to(Gm.dtype))
    if spec.changes_base:
        if q.cast_between_stages:
            U = cast_dom(U)
        U = W._apply(back, U)
    return cast_dom(U)


def _depthwise_wino_conv(x, U, spec, mats):
    """The quantized depthwise 1-D Toom-Cook conv, causal. x: (N, T, C),
    U: (C, n) → (N, T, C) in x's dtype. The transforms run in fp32 on
    tiles cast in x's dtype, as the JAX package's float32 matrices
    promote them."""
    q = spec.quant
    N, T, C = x.shape
    m, r, n = spec.m, spec.r, spec.n

    def mat(name):
        return torch.as_tensor(getattr(mats, name), device=x.device)
    lo, hi, nt, To = W._pad_amounts(T, m, r, "same", causal=True)
    xp = F.pad(x, (0, 0, lo, hi))
    tiles = W._extract_tiles_1d_axis(xp, m, n, axis=1)  # (N, nt, C, n)
    tiles = fake_quant(tiles, q.act_bits).float()
    if spec.changes_base:
        V = W._apply(mat("CinvT"), tiles)
        V = fake_quant(V, q.trans_bits)
        V = W._apply(mat("BPT"), V)
    else:
        V = W._apply(mat("BT"), tiles)
    V = fake_quant(V, q.trans_bits)
    H = V * U[None, None]                               # depthwise Hadamard
    H = fake_quant(H, q.hadamard_bits)
    if spec.changes_base:
        Y = W._apply(mat("CinvT"), H)
        Y = fake_quant(Y, q.trans_bits)
        Y = W._apply(mat("APT"), Y)
    else:
        Y = W._apply(mat("AT"), H)
    # (N, nt, C, m) → (N, nt, m, C) before flattening the tile grid
    Y = Y.permute(0, 1, 3, 2).reshape(N, nt * m, C)[:, :To, :]
    return Y.to(x.dtype)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(e, o):
    """e at the even positions of dim 1, o at the odd ones."""
    out = e.new_empty((e.shape[0], e.shape[1] + o.shape[1]) + e.shape[2:])
    out[:, 0::2] = e
    out[:, 1::2] = o
    return out


def _associative_scan(a, b):
    """Inclusive scan of (a, b) pairs along dim 1 under
    (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2), with the pairing and
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan those, then fill the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], 1)
    eb = torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _gates(p, xf):
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"].float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn's form
    log_a = -_RG_C * softplus * r                        # (…, dr), < 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * xf)
    return a, gated


def _rg_lru(p, x):
    """x: (B, T, dr) → same; associative scan over the recurrence."""
    a, gated = _gates(p, x.float())
    _, h = _associative_scan(a, gated)
    return h.to(x.dtype)


def _rg_lru_step(p, x, h_prev):
    """Single decode step. x: (B, dr); h_prev: (B, dr) fp32."""
    a, gated = _gates(p, x.float())
    return a * h_prev + gated


def _rec_block(p, x, cfg):
    q8 = cfg.quantize_linears
    h = _apply_norm(p["ln_mix"], x, cfg)
    gate = L._gelu(L.linear(h, p["rec"]["w_y"], q8=q8).float()).to(x.dtype)
    u = L.linear(h, p["rec"]["w_x"], q8=q8)
    u = _conv1d(p["rec"], u, cfg)
    u = _rg_lru(p["rec"], u)
    y = L.linear((gate * u.to(gate.dtype)).to(x.dtype), p["rec"]["w_out"],
                 q8=q8)
    x = x + y
    h = _apply_norm(p["ln_mlp"], x, cfg)
    return x + L.mlp(p["mlp"], h, cfg)


def _attn_block(p, x, cfg, positions):
    h = _apply_norm(p["ln_mix"], x, cfg)
    x = x + L.attention(p["attn"], h, cfg, window=cfg.window, causal=True,
                        positions=positions)
    h = _apply_norm(p["ln_mlp"], x, cfg)
    return x + L.mlp(p["mlp"], h, cfg)


def _run_blocks(blocks, x, cfg, positions):
    for p, kind in blocks:
        x = (_attn_block(p, x, cfg, positions) if kind == "attn"
             else _rec_block(p, x, cfg))
    return x


def hidden_forward(params, batch, cfg):
    x = params["embed"][batch["tokens"]].to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    pat, n_full, _ = split_pattern(cfg)
    blocks = layer_params(params, cfg)
    k = len(pat)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(n_full):
        group = blocks[g * k:(g + 1) * k]
        x = (checkpoint(_run_blocks, group, x, cfg, positions,
                        use_reentrant=False, preserve_rng_state=False)
             if remat else _run_blocks(group, x, cfg, positions))
    x = _run_blocks(blocks[n_full * k:], x, cfg, positions)
    return _apply_norm(params["ln_f"], x, cfg)


def forward(params, batch, cfg):
    x = hidden_forward(params, batch, cfg)
    logits = x @ params["embed"].T                      # tied embeddings
    return logits.float(), 0.0


def loss_fn(params, batch, cfg):
    x = hidden_forward(params, batch, cfg)
    return chunked_ce(x, params["embed"].T, batch["labels"])


def prefill(params, batch, cfg, layers=None):
    """Prompt → (decode cache, last-token logits).

    Runs each block collecting its terminal state: windowed KV (laid out
    ring-buffer-compatibly), final RG-LRU state, conv tail. As in the JAX
    package, the projections here do not fake-quantize."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)[None, :]
    w = min(S, cfg.window or S)
    ks, vs, hs, convs = [], [], [], []

    def ring_layout(kv):
        # logical position p lives at slot p % w (matches decode_step)
        return torch.roll(kv[:, -w:], S % w, dims=1)

    for p, kind in layers or layer_params(params, cfg):
        h = _apply_norm(p["ln_mix"], x, cfg)
        if kind == "attn":
            a, (k, v) = L.attention(p["attn"], h, cfg, window=cfg.window,
                                    causal=True, positions=positions,
                                    return_kv=True)
            ks.append(ring_layout(k))
            vs.append(ring_layout(v))
            x = x + a
        else:
            gate = L._gelu(L.linear(h, p["rec"]["w_y"]).float()).to(x.dtype)
            u = L.linear(h, p["rec"]["w_x"])
            convs.append(u[:, -(cfg.conv_width - 1):])  # pre-conv tail
            u = _conv1d(p["rec"], u, cfg)
            hfull = _rg_lru(p["rec"], u)
            hs.append(hfull[:, -1].float())
            x = x + L.linear((gate * hfull.to(gate.dtype)).to(x.dtype),
                             p["rec"]["w_out"])
        h = _apply_norm(p["ln_mlp"], x, cfg)
        x = x + L.mlp(p["mlp"], h, cfg)

    x = _apply_norm(params["ln_f"], x, cfg)
    logits = (x[:, -1] @ params["embed"].T).float()
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "h": torch.stack(hs), "conv": torch.stack(convs)}
    return cache, logits


# ---------------------------------------------------------------------------
# Decode: O(1) state per layer (rnn h, conv tail, windowed KV)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None):
    pat, n_full, rem = split_pattern(cfg)
    kv_len = min(max_len, cfg.window or max_len)
    n_attn = sum(k == "attn" for k in pat) * n_full + \
        sum(k == "attn" for k in rem)
    n_rec = cfg.n_layers - n_attn
    kv = (n_attn, batch, kv_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "h": torch.zeros((n_rec, batch, cfg.d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_rec, batch, cfg.conv_width - 1, cfg.d_rnn),
                            dtype=cfg.dtype, device=device),
    }


def decode_step(params, cache, tokens, pos, cfg, layers=None):
    """One-token decode, the cache written in place. Window attention
    uses a ring-buffer KV cache; the conv runs direct on its tail."""
    x = params["embed"][tokens].to(cfg.dtype)           # (B, 1, d)
    kv_len = cache["k"].shape[2]
    ring_pos = pos % kv_len
    ai = ri = 0
    for p, kind in layers or layer_params(params, cfg):
        hn = _apply_norm(p["ln_mix"], x, cfg)
        if kind == "attn":
            # The ring buffer bounds the window; once full, every slot is
            # valid.
            a, _ = L.attention_decode(
                p["attn"], hn, {"k": cache["k"][ai], "v": cache["v"][ai]},
                ring_pos, cfg, window=None, rope_pos=pos,
                mask_pos=torch.clamp_max(pos, kv_len - 1))
            x = x + a
            ai += 1
        else:
            gate = L._gelu(L.linear(hn, p["rec"]["w_y"]).float()).to(x.dtype)
            u = L.linear(hn, p["rec"]["w_x"])           # (B, 1, dr)
            win = torch.cat([cache["conv"][ri], u], dim=1)   # (B, r, dr)
            y = torch.einsum("brd,rd->bd", win, p["rec"]["conv_w"]) + \
                p["rec"]["conv_b"]
            h = _rg_lru_step(p["rec"], y, cache["h"][ri])
            cache["h"][ri] = h
            cache["conv"][ri] = win[:, 1:]
            x = x + L.linear((gate[:, 0] * h.to(gate.dtype)).to(
                x.dtype)[:, None], p["rec"]["w_out"])
            ri += 1
        hn = _apply_norm(p["ln_mlp"], x, cfg)
        x = x + L.mlp(p["mlp"], hn, cfg)
    x = _apply_norm(params["ln_f"], x, cfg)
    logits = (x @ params["embed"].T)[:, 0]
    return logits.float(), cache
