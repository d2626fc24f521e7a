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

The batch runs as the running rows' slabs
(``distributed.sharding.Rows``; one row without a mesh), as in
``transformer``. The quantized conv's dynamic per-tensor scales are each
the abs-max over every row's tensor: over a mesh the rows run that conv
in lockstep (``_conv1d_rows``), each stage's scale taken over all rows
before any row quantizes, so that a row computes what it computes in
the whole batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import winograd as W
from repro_torch.core.quantization import divide, fake_quant, qmax
from repro_torch.distributed import sharding
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
    w, b = L.whole(p["conv_w"]), L.whole(p["conv_b"])
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


def _fq_rows(ts: list, bits) -> list:
    """``fake_quant`` of the rows' parts of one tensor with its one
    dynamic per-tensor scale: the abs-max over every row's part."""
    if bits is None or len(ts) == 1:
        return [fake_quant(t, bits) for t in ts]
    amax = ts[0].detach().abs().amax()
    with sharding.moving("all-reduce"):
        for t in ts[1:]:
            amax = torch.maximum(amax,
                                 t.detach().abs().amax().to(amax.device))
    scale = divide(torch.clamp_min(amax, 1e-12), qmax(bits))
    return [fake_quant(t, bits, scale=scale.to(t.device)) for t in ts]


def _depthwise_wino_conv_rows(xs, U, spec, mats):
    """The quantized depthwise 1-D Toom-Cook conv, causal, of the rows'
    slabs in lockstep. x: (N, T, C) a row, U: (C, n) → (N, T, C) a row
    in x's dtype. The transforms run in fp32 on tiles cast in x's dtype,
    as the JAX package's float32 matrices promote them."""
    q = spec.quant
    T, C = xs[0].shape[1:]
    m, r, n = spec.m, spec.r, spec.n

    def apply(name, ts):
        return [W._apply(torch.as_tensor(getattr(mats, name),
                                         device=t.device), t) for t in ts]
    lo, hi, nt, To = W._pad_amounts(T, m, r, "same", causal=True)
    tiles = [W._extract_tiles_1d_axis(F.pad(x, (0, 0, lo, hi)), m, n,
                                      axis=1) for x in xs]  # (N, nt, C, n)
    tiles = [t.float() for t in _fq_rows(tiles, q.act_bits)]
    if spec.changes_base:
        V = _fq_rows(apply("CinvT", tiles), q.trans_bits)
        V = apply("BPT", V)
    else:
        V = apply("BT", tiles)
    V = _fq_rows(V, q.trans_bits)
    H = _fq_rows([v * U.to(v.device)[None, None] for v in V],
                 q.hadamard_bits)                       # depthwise Hadamard
    if spec.changes_base:
        Y = _fq_rows(apply("CinvT", H), q.trans_bits)
        Y = apply("APT", Y)
    else:
        Y = apply("AT", H)
    # (N, nt, C, m) → (N, nt, m, C) before flattening the tile grid
    return [y.permute(0, 1, 3, 2).reshape(y.shape[0], nt * m, C)[:, :To, :]
            .to(x.dtype) for y, x in zip(Y, xs)]


def _depthwise_wino_conv(x, U, spec, mats):
    """``_depthwise_wino_conv_rows`` of one tensor."""
    return _depthwise_wino_conv_rows([x], U, spec, mats)[0]


def _conv1d_rows(p, us, cfg):
    """``_conv1d`` of the running rows' slabs: row by row, except the
    quantized conv over several rows, which runs them in lockstep."""
    rows = sharding.rows()
    if len(us) == 1 or not (cfg.use_winograd_conv and
                            cfg.winograd is not None):
        return rows.each(lambda lp, u: _conv1d(lp, u, cfg), p, us)
    spec = cfg.winograd
    mats = W.make_matrices(spec)
    U, = rows.each(lambda lp, _: _depthwise_wino_weights(
        L.whole(lp["conv_w"]), spec, mats), p, us[:1])
    ys = _depthwise_wino_conv_rows(us, U, spec, mats)
    return rows.each(lambda lp, y: y + L.whole(lp["conv_b"]), p, ys)


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
    r = torch.sigmoid(xf @ L.whole(p["w_a"]).float() + p["b_a"].float())
    i = torch.sigmoid(xf @ L.whole(p["w_i"]).float() + p["b_i"].float())
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


def _rec_gate_u(p, x, cfg, q8):
    """A recurrent block's gate branch and its pre-conv input, one row.
    ``w_x`` multiplies whole (``layers.whole``), as ``_gates``' weights
    do: its product feeds the conv's fake-quant casts, where a
    column-parallel product's last-bit differences flip roundings."""
    h = _apply_norm(p["ln_mix"], x, cfg)
    gate = L._gelu(L.linear(h, p["rec"]["w_y"], q8=q8).float()).to(x.dtype)
    return gate, L.linear(h, L.whole(p["rec"]["w_x"]), q8=q8)


def _rec_out(p, x, gate, h, cfg, q8):
    """A recurrent block's output projection, residual and MLP, one row."""
    x = x + L.linear((gate * h.to(gate.dtype)).to(x.dtype),
                     p["rec"]["w_out"], q8=q8)
    return x + L.mlp(p["mlp"], _apply_norm(p["ln_mlp"], x, cfg), cfg)


def _rec_block(p, xs, cfg):
    rows = sharding.rows()
    q8 = cfg.quantize_linears
    gu = rows.each(lambda lp, x: _rec_gate_u(lp, x, cfg, q8), p, xs)
    us = _conv1d_rows(p["rec"], [u for _, u in gu], cfg)
    return rows.each(lambda lp, x, g, u: _rec_out(
        lp, x, g, _rg_lru(lp["rec"], u), cfg, q8), p, xs,
        [g for g, _ in gu], us)


def _attn_block(p, xs, cfg, positions):
    def one(lp, x):
        h = _apply_norm(lp["ln_mix"], x, cfg)
        x = x + L.attention(lp["attn"], h, cfg, window=cfg.window,
                            causal=True, positions=positions.to(x.device))
        h = _apply_norm(lp["ln_mlp"], x, cfg)
        return x + L.mlp(lp["mlp"], h, cfg)
    return sharding.rows().each(one, p, xs)


def _run_blocks(blocks, xs, cfg, positions):
    for p, kind in blocks:
        xs = (_attn_block(p, xs, cfg, positions) if kind == "attn"
              else _rec_block(p, xs, cfg))
    return xs


def _embed_rows(params, tokens_rows, cfg):
    return sharding.rows().each(
        lambda e, t: L.whole(e)[t].to(cfg.dtype), params["embed"],
        tokens_rows)


def hidden_forward(params, batch, cfg):
    """The rows' final normed hiddens."""
    rows = sharding.rows()
    xs = _embed_rows(params, rows.split(batch["tokens"]), cfg)
    positions = torch.arange(xs[0].shape[1], device=xs[0].device)[None, :]
    pat, n_full, _ = split_pattern(cfg)
    blocks = layer_params(params, cfg)
    k = len(pat)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(n_full):
        group = blocks[g * k:(g + 1) * k]
        xs = (checkpoint(_run_blocks, group, xs, cfg, positions,
                         use_reentrant=False, preserve_rng_state=False)
              if remat else _run_blocks(group, xs, cfg, positions))
    xs = _run_blocks(blocks[n_full * k:], xs, cfg, positions)
    return rows.each(lambda p, x: _apply_norm(p, x, cfg), params["ln_f"], xs)


def _logits(params, xs):
    """The rows' logits (tied embeddings, fp32), joined on row 0's."""
    return sharding.rows().join(sharding.rows().each(
        lambda w, x: L.linear(x, w).float(), params["embed"].T, xs))


def forward(params, batch, cfg):
    return _logits(params, hidden_forward(params, batch, cfg)), 0.0


def loss_fn(params, batch, cfg):
    xs = hidden_forward(params, batch, cfg)
    return chunked_ce(xs, params["embed"].T,
                      sharding.rows().split(batch["labels"]))


def prefill(params, batch, cfg, layers=None):
    """Prompt → (decode cache, last-token logits).

    Runs each block collecting its terminal state: windowed KV (laid out
    ring-buffer-compatibly), final RG-LRU state, conv tail. As in the JAX
    package, the projections here do not fake-quantize."""
    rows = sharding.rows()
    tokens = batch["tokens"]
    S = tokens.shape[1]
    xs = _embed_rows(params, rows.split(tokens), cfg)
    positions = torch.arange(S, device=xs[0].device)[None, :]
    w = min(S, cfg.window or S)
    state = [{"k": [], "v": [], "h": [], "conv": []} for _ in xs]

    def ring_layout(kv):
        # logical position p lives at slot p % w (matches decode_step)
        return torch.roll(kv[:, -w:], S % w, dims=1)

    def attn(p, x):
        h = _apply_norm(p["ln_mix"], x, cfg)
        a, (k, v) = L.attention(p["attn"], h, cfg, window=cfg.window,
                                causal=True, positions=positions.to(x.device),
                                return_kv=True)
        return x + a, {"k": L.kv_map(ring_layout, k),
                       "v": L.kv_map(ring_layout, v)}

    def pre(p, x):
        gate, u = _rec_gate_u(p, x, cfg, False)
        return gate, u, {"conv": u[:, -(cfg.conv_width - 1):]}  # the tail

    def post(p, x, gate, u):
        hfull = _rg_lru(p["rec"], u)
        return x + L.linear((gate * hfull.to(gate.dtype)).to(x.dtype),
                            p["rec"]["w_out"]), {"h": hfull[:, -1].float()}

    def mlp(p, x):
        return x + L.mlp(p["mlp"], _apply_norm(p["ln_mlp"], x, cfg), cfg)

    def keep(outs):
        for st, o in zip(state, outs):
            for k, v in o[-1].items():
                st[k].append(v)

    for p, kind in layers or layer_params(params, cfg):
        if kind == "attn":
            out = rows.each(attn, p, xs)
            keep(out)
            xs = [o[0] for o in out]
        else:
            gu = rows.each(pre, p, xs)
            keep(gu)
            us = _conv1d_rows(p["rec"], [u for _, u, _ in gu], cfg)
            out = rows.each(post, p, xs, [g for g, _, _ in gu], us)
            keep(out)
            xs = [o[0] for o in out]
        xs = rows.each(mlp, p, xs)

    xs = rows.each(lambda p, x: _apply_norm(p, x, cfg), params["ln_f"], xs)
    logits = _logits(params, [x[:, -1] for x in xs])
    cache = {k: rows.stitch_cache(k, [L.stack_kv(st[k]) for st in state],
                                  L.kv_cache_dim(cfg))
             for k in ("k", "v", "h", "conv")}
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
    rows = sharding.rows()
    blocks = layers or layer_params(params, cfg)

    def row(lps, x, c, pos):
        kv_len = c["k"].shape[2]
        ring_pos = pos % kv_len
        ai = ri = 0
        for p, kind in lps:
            if kind == "attn":
                hn = _apply_norm(p["ln_mix"], x, cfg)
                # The ring buffer bounds the window; once full, every slot
                # is valid.
                a, _ = L.attention_decode(
                    p["attn"], hn, {"k": c["k"][ai], "v": c["v"][ai]},
                    ring_pos, cfg, window=None, rope_pos=pos,
                    mask_pos=torch.clamp_max(pos, kv_len - 1))
                x = x + a
                ai += 1
            else:
                gate, u = _rec_gate_u(p, x, cfg, False)     # (B, 1, dr)
                win = torch.cat([c["conv"][ri].whole(), u], dim=1)
                y = torch.einsum("brd,rd->bd", win,         # (B, r, dr)
                                 L.whole(p["rec"]["conv_w"])) + \
                    L.whole(p["rec"]["conv_b"])
                h = _rg_lru_step(p["rec"], y, c["h"][ri].whole())
                c["h"][ri].write(h)
                c["conv"][ri].write(win[:, 1:])
                x = x + L.linear((gate[:, 0] * h.to(gate.dtype)).to(
                    x.dtype)[:, None], p["rec"]["w_out"])
                ri += 1
            hn = _apply_norm(p["ln_mlp"], x, cfg)
            x = x + L.mlp(p["mlp"], hn, cfg)
        return x

    xs = _embed_rows(params, rows.split(tokens), cfg)   # (B, 1, d)
    xs = rows.each(row, blocks, xs, rows.cache_rows(cache), rows.split(pos))
    xs = rows.each(lambda p, x: _apply_norm(p, x, cfg), params["ln_f"], xs)
    return _logits(params, [x[:, 0] for x in xs]), cache
