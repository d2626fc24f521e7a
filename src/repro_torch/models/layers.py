"""Shared LM building blocks (pure functions over parameter trees), the
port's counterpart of ``repro.models.layers``.

Attention is blockwise (a running softmax over KV chunks, as
``_chunked_attn`` in the JAX package) so a 32k prefill never holds an
S×S score matrix, and a sliding window visits only the KV chunks that
overlap it. The score and value products take bf16 operands exactly
(cast to fp32, fp32 sums), as JAX's ``preferred_element_type=float32``
einsums do; ``scaled_dot_product_attention`` is not used, so the order
of the reference's arithmetic is kept.

The paper's quantization plugs in through ``linear(..., q8=True)``:
symmetric w8a8 fake-quant, as in the JAX package (the true-int8 K5 path
is ``kernels.ops.q8_linear``, which the JAX LM does not call either).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import fake_quant

__all__ = ["DEFAULT_CHUNK", "grad_cast", "constrain_leading_dp",
           "rms_norm", "layer_norm", "linear", "rope", "attention",
           "attention_decode", "mlp", "moe"]

DEFAULT_CHUNK = 1024


def constrain_leading_dp(x: torch.Tensor, *trailing) -> torch.Tensor:
    """JAX's pins dim 0 to the data-parallel mesh axes (``moe`` calls it
    on its dispatch tensors). On one device it does nothing, so nothing
    here calls it; LM sharding is a later slice."""
    return x


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity in forward, as JAX's. (Its backward casts the cotangent
    to x's dtype on attention's q, k, v; serving takes no gradient, so
    nothing here calls it; the LM training slice will.)"""
    return x


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, q8: bool = False):
    """x @ w (+ b); optional symmetric w8a8 fake-quant (per-tensor
    activations, per-output-column weights)."""
    if q8:
        x = fake_quant(x, 8)
        w = fake_quant(w, 8, axis=tuple(range(w.ndim - 1)))
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding. x: (..., S, H, dh), positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                    # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention
# ---------------------------------------------------------------------------

def _chunked_attn(q, k, v, *, causal: bool, chunk: int,
                  window: Optional[int] = None):
    """Running-softmax attention. q: (B,S,Hkv,G,dh); k,v: (B,S,Hkv,dh).

    Walks the KV chunks with an (acc, m, l) carry per query chunk.
    ``window`` visits only the chunks overlapping the sliding window (the
    JAX band of ``window // ck + 1`` chunks; a band chunk before the
    sequence start, which JAX clamps and masks out whole, is skipped: it
    leaves the carry exactly as the next chunk would).
    """
    B, S, Hkv, G, dh = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk, S), min(chunk, Sk)
    if S % cq or Sk % ck:
        raise ValueError(f"sequence lengths {S}, {Sk} are not multiples "
                         f"of the chunk {chunk}")
    nq, nk = S // cq, Sk // ck
    scale = dh ** -0.5
    nband = min(nk, window // ck + 1) if window is not None else nk
    dev = q.device
    ar_q = torch.arange(cq, device=dev)
    ar_k = torch.arange(ck, device=dev)
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * cq:(qi + 1) * cq].float()
        q_pos = qi * cq + ar_q
        acc = torch.zeros((B, Hkv, G, cq, dh), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, Hkv, G, cq), -torch.inf, device=dev)
        l = torch.zeros((B, Hkv, G, cq), device=dev)
        for j in range(nband):
            jj = j if window is None else qi - (nband - 1) + j
            if jj < 0:
                continue
            kblk = k[:, jj * ck:(jj + 1) * ck]
            vblk = v[:, jj * ck:(jj + 1) * ck]
            k_pos = jj * ck + ar_k
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk.float()) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              p.to(vblk.dtype).float(), vblk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    # nq × (B, Hkv, G, cq, dh) → (B, S, Hkv, G, dh)
    o = torch.stack(outs, 1).permute(0, 1, 4, 2, 3, 5)
    return o.reshape(B, S, Hkv, G, dh).to(q.dtype)


def attention(params: dict, x: torch.Tensor, cfg, *, window=None,
              causal=True, positions=None, return_kv: bool = False):
    """GQA multi-head attention over a full sequence (prefill)."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    q8 = cfg.quantize_linears
    q = linear(x, params["wq"], params.get("bq"), q8=q8)
    k = linear(x, params["wk"], params.get("bk"), q8=q8).reshape(
        B, S, Hkv, dh)
    v = linear(x, params["wv"], params.get("bv"), q8=q8).reshape(
        B, S, Hkv, dh)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q.reshape(B, S, H, dh), positions, cfg.rope_theta
             ).reshape(B, S, Hkv, G, dh)
    k = rope(k, positions, cfg.rope_theta)
    o = _chunked_attn(q, k, v, causal=causal, window=window,
                      chunk=min(DEFAULT_CHUNK, S))
    out = linear(o.reshape(B, S, H * dh), params["wo"], q8=q8)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg, *, window=None, rope_pos=None, mask_pos=None):
    """One-token decode. x: (B, 1, d); cache: {"k","v"}: (B, Smax, Hkv,
    dh), written in place at ``pos`` (the JAX step donates its cache).

    Returns (out, cache). ``pos``: (B,) physical write slot;
    ``rope_pos``/``mask_pos`` default to ``pos`` and differ for a
    ring-buffer (sliding-window) cache, where the logical and physical
    positions diverge.
    """
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    if rope_pos is None:
        rope_pos = pos
    if mask_pos is None:
        mask_pos = pos
    q8 = cfg.quantize_linears
    q = linear(x, params["wq"], params.get("bq"), q8=q8).reshape(B, 1, H, dh)
    k = linear(x, params["wk"], params.get("bk"), q8=q8).reshape(
        B, 1, Hkv, dh)
    v = linear(x, params["wv"], params.get("bv"), q8=q8).reshape(
        B, 1, Hkv, dh)
    q = rope(q, rope_pos[:, None], cfg.rope_theta).reshape(B, Hkv, G, dh)
    k = rope(k, rope_pos[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(B, device=x.device)
    ck[rows, pos.long()] = k[:, 0]
    cv[rows, pos.long()] = v[:, 0]
    k_pos = torch.arange(ck.shape[1], device=x.device)[None, :]
    valid = k_pos <= mask_pos[:, None]
    if window is not None:
        valid &= k_pos > mask_pos[:, None] - window
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), ck.float()) * dh ** -0.5
    s = torch.where(valid[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(cv.dtype).float(), cv.float())
    o = o.reshape(B, 1, H * dh).to(x.dtype)
    return linear(o, params["wo"], q8=q8), cache


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def mlp(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    q8 = cfg.quantize_linears
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu if cfg.act == "swiglu" else _gelu
        g = linear(x, params["w_gate"], params.get("b_gate"), q8=q8)
        u = linear(x, params["w_up"], params.get("b_up"), q8=q8)
        h = act(g.float()).to(x.dtype) * u
    else:
        h = linear(x, params["w_up"], params.get("b_up"), q8=q8)
        h = _gelu(h.float()).to(x.dtype)
    return linear(h, params["w_down"], params.get("b_down"), q8=q8)


def _dispatch(probs: torch.Tensor, k: int, cap: int):
    """Top-k routing and capacity dispatch of (G, Tg, E) router
    probabilities → (idx, gate) of the top k (G, Tg, k), and per group
    the (token, choice) pairs sorted by expert (stable): ``order`` into
    the flattened pairs, ``sorted_e``, ``pos`` within the expert and
    ``keep`` = pos < cap (G, Tg·k)."""
    G, Tg, E = probs.shape
    dev = probs.device
    # lax.top_k: descending, ties to the lower index
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)   # jnp.argsort
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(sorted_e, experts)       # left side
    pos = torch.arange(Tg * k, device=dev)[None] - torch.gather(
        start, 1, sorted_e)
    return idx, gate, order, sorted_e, pos, pos < cap


def moe(params: dict, x: torch.Tensor, cfg):
    """Top-k MoE with grouped capacity-based sort dispatch (the JAX
    package's ``layers.moe``, step for step). x: (B, S, d) → (out, aux).

    Tokens fold into ``cfg.moe_groups`` groups and each group sorts its
    (token, choice) pairs by expert into a (G, E, cap, d) buffer; pairs
    past an expert's capacity are dropped (they land in a spare row that
    is cut off, as JAX's ``mode="drop"`` write discards them).
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = cfg.moe_groups or 1
    if T % G:
        G = 1
    Tg = T // G
    cap = min(int(cfg.capacity_factor * Tg * k / E + 1), Tg)
    dev = x.device
    xg = x.reshape(G, Tg, d)

    logits = torch.einsum("gtd,de->gte", xg.float(),
                          params["w_router"].float())
    probs = torch.softmax(logits, -1)                   # (G, Tg, E)
    idx, gate, order, sorted_e, pos, keep = _dispatch(probs, k, cap)

    # Switch-style load-balancing aux loss (global statistics).
    density = F.one_hot(idx[..., 0], E).float().mean((0, 1))
    aux = E * torch.sum(density * probs.mean((0, 1)))

    tok = order // k                                     # (G, Tg·k)
    safe_pos = torch.where(keep, pos, cap)

    gi = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    buf = torch.zeros((G, E, cap + 1, d), dtype=x.dtype, device=dev)
    buf[gi, sorted_e, safe_pos] = torch.gather(
        xg, 1, tok[..., None].expand(G, Tg * k, d))
    buf = buf[:, :, :cap]

    h1 = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    h2 = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    h = F.silu(h1.float()).to(x.dtype) * h2
    y_e = torch.einsum("gecf,efd->gecd", h, params["w_down"])

    # a dropped pair reads a clamped row (JAX's gather clamps) times 0
    y_tok = y_e[gi, sorted_e, torch.clamp_max(safe_pos, cap - 1)]
    w = torch.where(keep, torch.gather(gate.reshape(G, Tg * k), 1, order),
                    0.0)
    out = torch.zeros((G, Tg, d), dtype=torch.float32, device=dev)
    out.index_put_((gi, tok), y_tok.float() * w[..., None], accumulate=True)
    if "shared" in params:
        out = out + mlp(params["shared"], xg, cfg).float()
    return out.reshape(B, S, d).to(x.dtype), aux
