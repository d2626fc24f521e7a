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

Over a mesh (``distributed.sharding.Rows``, installed by the sharded
step) the model code runs once a row of the batch, on the row's device,
and a weight cut over "model" stays a ``Sharded`` leaf in the row's view
of the parameters: ``linear`` and the MoE's expert einsums then run block
by block (``_per_block``), and ``whole`` gathers such a leaf where it is
used otherwise. Without a mesh there is one row and both are plain.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import fake_quant
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Sharded

__all__ = ["DEFAULT_CHUNK", "grad_cast", "constrain_leading_dp", "whole",
           "split_batch",
           "rms_norm", "layer_norm", "linear", "rope", "attention",
           "attention_decode", "mlp", "moe"]

DEFAULT_CHUNK = 1024


def constrain_leading_dp(x: torch.Tensor, *trailing):
    """``x`` placed with dim 0 over the data axes ("pod", "data") of the
    running step's mesh, and ``trailing`` naming mesh axes of the next
    dims, as the JAX package's: ``x`` itself without a mesh or a data
    axis, or when dim 0 does not divide; a trailing axis the mesh lacks
    or that does not divide its dim is dropped."""
    mesh = sharding.rows().mesh
    if mesh is None:
        return x
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not dp or x.shape[0] % sharding.axis_extent(mesh, dp):
        return x
    rest = list(trailing) + [None] * (x.dim() - 1 - len(trailing))
    for i, r in enumerate(rest):
        if r is not None and (r not in mesh.shape or
                              x.shape[i + 1] % mesh.shape[r]):
            rest[i] = None
    return sharding.constrain(x, mesh, dp, *rest)


def split_batch(batch: dict) -> list:
    """A batch of whole tensors as one dict a running row, each leaf's
    row slab on its row's device."""
    rows = sharding.rows()
    parts = {k: rows.split(v) for k, v in batch.items()}
    return [{k: v[r] for k, v in parts.items()} for r in range(rows.n)]


def whole(t):
    """A parameter leaf as one tensor: a ``Sharded`` leaf gathered on the
    running row's device; a tensor itself."""
    if isinstance(t, Sharded):
        return t.gather(sharding.rows().device())
    return t


def _per_block(x: torch.Tensor, w: Sharded, fn, x_dim, out_dim):
    """``fn(x, w)`` run block by block of ``w``'s model cut, block b on
    the running row's device of block b, the parts back on ``x``'s
    device: concatenated along ``out_dim`` of the output, or (None: the
    cut dim is contracted) summed in block order. ``x_dim``: the dim of
    ``x`` that the cut dim pairs with, sliced alike (None: none)."""
    rows = sharding.rows()
    md = w.model_dim
    m = w.counts()[md]
    size = w.shape[md] // m
    outs = []
    for k in range(m):
        dev = rows.device(k)
        xk = x if x_dim is None else x.narrow(x_dim, k * size, size)
        outs.append(fn(xk.to(dev), w.gather(dev, at=(md, k))).to(x.device))
    if out_dim is not None:
        return torch.cat(outs, out_dim)
    y = outs[0]
    for o in outs[1:]:
        y = y + o
    return y


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward casts the cotangent to x's dtype, as
    JAX's: attention's fp32 score and value products then hand bf16
    gradients back to the q, k, v projections. Without autograd (serving)
    it returns ``x`` itself."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradCast.apply(x)


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
    activations, per-output-column weights). A 2-D ``w`` cut over
    "model" multiplies block by block: column-parallel where the output
    dim is cut (the blocks' outputs concatenated), row-parallel where the
    input dim is (the partial products summed on ``x``'s device)."""
    if isinstance(w, Sharded):
        if q8:
            raise NotImplementedError(
                "q8 linears over a mesh: the per-tensor activation scale "
                "spans the rows (ROADMAP, Queue A 7.2)")
        row_parallel = w.model_dim == 0
        y = _per_block(x, w, torch.matmul, -1 if row_parallel else None,
                       None if row_parallel else -1)
    else:
        if q8:
            x = fake_quant(x, 8)
            w = fake_quant(w, 8, axis=tuple(range(w.ndim - 1)))
        y = x @ w
    if b is not None:
        y = y + whole(b).to(y.dtype)
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
    q, k, v = grad_cast(q), grad_cast(k), grad_cast(v)
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


def _einsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum(eq, x, w)``; a ``w`` cut over "model" runs block by
    block (``_per_block``): the cut letter sliced in ``x`` where it
    appears there, concatenated in the output where it appears there,
    else summed."""
    if not isinstance(w, Sharded):
        return torch.einsum(eq, x, w)
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    c = ws[w.model_dim]
    return _per_block(x, w, lambda a, b: torch.einsum(eq, a, b),
                      xs.index(c) if c in xs else None,
                      out.index(c) if c in out else None)


def _moe_groups(params: dict, xg: torch.Tensor, cfg, cap: int):
    """Dispatch, experts and combine of (G, Tg, d) token groups →
    (out (G, Tg, d) in x's dtype, router probs (G, Tg, E), top-1 expert
    (G, Tg)). The expert einsums run per block of a weight cut over
    "experts" (or, re-placed by ``pspec``, over "expert_mlp")."""
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    logits = torch.einsum("gtd,de->gte", xg.float(),
                          params["w_router"].float())
    probs = torch.softmax(logits, -1)                   # (G, Tg, E)
    idx, gate, order, sorted_e, pos, keep = _dispatch(probs, k, cap)

    tok = order // k                                     # (G, Tg·k)
    safe_pos = torch.where(keep, pos, cap)

    gi = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    buf = torch.zeros((G, E, cap + 1, d), dtype=xg.dtype, device=dev)
    buf[gi, sorted_e, safe_pos] = torch.gather(
        xg, 1, tok[..., None].expand(G, Tg * k, d))
    buf = buf[:, :, :cap]

    h1 = _einsum("gecd,edf->gecf", buf, params["w_gate"])
    h2 = _einsum("gecd,edf->gecf", buf, params["w_up"])
    h = F.silu(h1.float()).to(xg.dtype) * h2
    y_e = _einsum("gecf,efd->gecd", h, params["w_down"])

    # a dropped pair reads a clamped row (JAX's gather clamps) times 0
    y_tok = y_e[gi, sorted_e, torch.clamp_max(safe_pos, cap - 1)]
    w = torch.where(keep, torch.gather(gate.reshape(G, Tg * k), 1, order),
                    0.0)
    out = torch.zeros((G, Tg, d), dtype=torch.float32, device=dev)
    out.index_put_((gi, tok), y_tok.float() * w[..., None], accumulate=True)
    if "shared" in params:
        out = out + mlp(params["shared"], xg, cfg).float()
    return out.to(xg.dtype), probs, idx[..., 0]


def moe(params: dict, x, cfg):
    """Top-k MoE with grouped capacity-based sort dispatch (the JAX
    package's ``layers.moe``, step for step). x: (B, S, d), or the
    running rows' slabs (a list) → (out alike, aux).

    Tokens fold into ``cfg.moe_groups`` groups of the whole batch and
    each group sorts its (token, choice) pairs by expert into a
    (G, E, cap, d) buffer; pairs past an expert's capacity are dropped
    (they land in a spare row that is cut off, as JAX's ``mode="drop"``
    write discards them). Over rows: where each row holds whole groups
    (G a multiple of the rows), each row dispatches its own; else row 0
    dispatches every row's tokens in one sort (one group spans rows).
    The load-balancing loss is taken over every row's tokens.
    """
    if isinstance(x, torch.Tensor):
        outs, aux = moe(params, [x], cfg)
        return outs[0], aux
    rows = sharding.rows()
    S, d = x[0].shape[1:]
    E, k = cfg.n_experts, cfg.top_k
    T = sum(t.shape[0] for t in x) * S
    G = cfg.moe_groups or 1
    if T % G:
        G = 1
    Tg = T // G
    cap = min(int(cfg.capacity_factor * Tg * k / E + 1), Tg)
    if G % len(x) == 0:
        parts = rows.each(lambda p, t: _moe_groups(
            p, t.reshape(G // len(x), Tg, d), cfg, cap), params, x)
        outs = [o.reshape(t.shape) for (o, _, _), t in zip(parts, x)]
    else:
        whole_x = rows.join(x)
        parts = rows.each(lambda p, t: _moe_groups(
            p, t.reshape(G, Tg, d), cfg, cap), params, [whole_x])
        outs = rows.split(parts[0][0].reshape(whole_x.shape))
    probs = rows.join([p for _, p, _ in parts])
    top1 = rows.join([t for _, _, t in parts])
    # Switch-style load-balancing aux loss (global statistics).
    density = F.one_hot(top1, E).float().mean((0, 1))
    aux = E * torch.sum(density * probs.mean((0, 1)))
    return outs, aux
