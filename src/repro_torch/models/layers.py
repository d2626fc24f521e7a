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
used otherwise. Attention runs per model block as the decode cache is
cut (``kv_cut``): each block with its own KV heads, or with its slice of
every head's dims, the blocks' partial scores summed. Without a mesh
there is one row and every one of these is plain.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import divide, fake_quant, qmax
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Sharded

__all__ = ["DEFAULT_CHUNK", "grad_cast", "constrain_leading_dp", "whole",
           "split_batch", "kv_cut", "kv_cache_dim", "kv_map", "stack_kv",
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
        with sharding.moving("all-gather"):
            return t.gather(sharding.rows().device())
    return t


def _per_block(x, w: Sharded, fn, x_dim, out_dim, after=None):
    """``fn(x, w)`` run block by block of ``w``'s model cut, block b on
    the running row's device of block b, the parts back on ``x``'s
    device: concatenated along ``out_dim`` of the output, or (None: the
    cut dim is contracted) summed in block order; ``out_dim="blocks"``:
    the parts as they lie. ``x_dim``: the dim of ``x`` that the cut dim
    pairs with, sliced alike (None: none); ``x`` may be given as those
    blocks already (a list, block b on block b's device). ``after(b,
    y)``: applied to block b's part where it lies."""
    rows = sharding.rows()
    md = w.model_dim
    m = w.counts()[md]
    size = w.shape[md] // m

    def x_of(k):
        if isinstance(x, list):
            return x[k]
        return x if x_dim is None else x.narrow(x_dim, k * size, size)

    def block(k, dev):
        y = fn(x_of(k).to(dev), w.gather(dev, at=(md, k)))
        return y if after is None else after(k, y)
    parts = rows.per_block(block, m, lambda k: [x_of(k)])
    if out_dim == "blocks":
        return parts
    home = x[0].device if isinstance(x, list) else x.device
    with sharding.moving("all-gather" if out_dim is not None
                         else "all-reduce"):
        outs = [o.to(home) for o in parts]
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


def linear(x, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           q8: bool = False, blocks: bool = False):
    """x @ w (+ b); optional symmetric w8a8 fake-quant (per-tensor
    activations, per-output-column weights). A 2-D ``w`` cut over
    "model" multiplies block by block: column-parallel where the output
    dim is cut (the blocks' outputs concatenated, or with ``blocks`` left
    as a list where they lie), row-parallel where the input dim is (the
    partial products summed on ``x``'s device; ``x`` may be the list of
    its blocks along the cut, each where it lies).

    Over several rows the activation scale is the abs-max over every
    row's slab (``Rows.lockstep_max``: the rows run in lockstep), as the
    whole batch's; a weight cut over "model" takes each column's scale
    from its column block, or, cut along its input dim, the maximum of
    the blocks' column maxima: the scales the JAX function takes."""
    if q8:
        xs = x if isinstance(x, list) else [x]
        with sharding.moving("all-reduce"):
            amax = xs[0].detach().abs().amax()
            for t in xs[1:]:
                amax = torch.maximum(amax, t.detach().abs().amax().to(
                    amax.device))
        amax = sharding.rows().lockstep_max(amax)
        scale = divide(torch.clamp_min(amax, 1e-12), qmax(8))
        xs = [fake_quant(t, 8, scale=scale.to(t.device)) for t in xs]
        x = xs if isinstance(x, list) else xs[0]
    if isinstance(w, Sharded):
        row_parallel = w.model_dim == 0
        fn = torch.matmul
        if q8 and row_parallel:
            sw = _column_scale(w, (x[0] if isinstance(x, list) else x)
                               .device)
            fn = (lambda a, wb: a @ fake_quant(wb, 8,
                                               scale=sw.to(wb.device)))
        elif q8:
            fn = (lambda a, wb: a @ fake_quant(
                wb, 8, axis=tuple(range(wb.ndim - 1))))
        if blocks and not row_parallel:
            return _per_block(x, w, fn, None, "blocks", None if b is None
                              else lambda k, y: y + _bias_block(
                                  b, k, w.counts()[1], y))
        y = _per_block(x, w, fn, -1 if row_parallel else None,
                       None if row_parallel else -1)
    else:
        if q8:
            w = fake_quant(w, 8, axis=tuple(range(w.ndim - 1)))
        y = x @ w
    if b is not None:
        y = y + whole(b).to(y.dtype)
    return y


def _bias_block(b, k: int, m: int, y: torch.Tensor) -> torch.Tensor:
    """Block k of m of a bias cut as a column-parallel weight's output,
    on ``y``'s device in its dtype."""
    if isinstance(b, Sharded) and b.model_dim == 0 and b.counts()[0] == m:
        t = b.gather(y.device, at=(0, k))
    else:
        s = b.shape[0] // m
        with sharding.moving("all-gather"):
            t = whole(b).narrow(0, k * s, s).to(y.device)
    return t.to(y.dtype)


def _column_scale(w: Sharded, home: torch.device) -> torch.Tensor:
    """The per-column 8-bit scale of a weight cut along its input dim:
    each block's column abs-maxima, their maximum on ``home``."""
    m = w.counts()[0]
    parts = sharding.rows().per_block(
        lambda b, d: w.gather(d, at=(0, b)).detach().abs().amax(
            dim=0, keepdim=True), m)
    with sharding.moving("all-reduce"):
        amax = parts[0].to(home)
        for p in parts[1:]:
            amax = torch.maximum(amax, p.to(home))
    return divide(torch.clamp_min(amax, 1e-12), qmax(8))


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
    return _chunked_attn_parts([q], [k], [v], causal=causal, chunk=chunk,
                               window=window)


def _chunked_attn_parts(qs, ks, vs, *, causal: bool, chunk: int,
                        window: Optional[int] = None):
    """``_chunked_attn`` of q, k, v given as their head-dim blocks (block
    b on the running row's device of model block b): each chunk's scores
    are the blocks' partial dot products summed in block order on block
    0's device, where the softmax runs; each block multiplies the
    probabilities by its own v block. One block: ``_chunked_attn``."""
    rows = sharding.rows()
    nb = len(qs)
    B, S, Hkv, G, _ = qs[0].shape
    dh = sum(t.shape[-1] for t in qs)
    Sk = ks[0].shape[1]
    cq, ck = min(chunk, S), min(chunk, Sk)
    if S % cq or Sk % ck:
        raise ValueError(f"sequence lengths {S}, {Sk} are not multiples "
                         f"of the chunk {chunk}")
    nq, nk = S // cq, Sk // ck
    scale = dh ** -0.5
    nband = min(nk, window // ck + 1) if window is not None else nk
    dev = qs[0].device
    ar_q = torch.arange(cq, device=dev)
    ar_k = torch.arange(ck, device=dev)
    outs = []
    for qi in range(nq):
        qblk = [q[:, qi * cq:(qi + 1) * cq].float() for q in qs]
        q_pos = qi * cq + ar_q
        acc = [torch.zeros((B, Hkv, G, cq, q.shape[-1]), dtype=torch.float32,
                           device=q.device) for q in qs]
        m = torch.full((B, Hkv, G, cq), -torch.inf, device=dev)
        l = torch.zeros((B, Hkv, G, cq), device=dev)
        for j in range(nband):
            jj = j if window is None else qi - (nband - 1) + j
            if jj < 0:
                continue
            k_pos = jj * ck + ar_k
            sl = slice(jj * ck, (jj + 1) * ck)
            if nb == 1:
                s = torch.einsum("bqhgd,bkhd->bhgqk", qblk[0],
                                 ks[0][:, sl].float())
            else:
                part = rows.per_block(lambda b, _: torch.einsum(
                    "bqhgd,bkhd->bhgqk", qblk[b], ks[b][:, sl].float()), nb,
                    lambda b: [qblk[b], ks[b]])
                with sharding.moving("all-reduce"):
                    s = part[0]
                    for t in part[1:]:
                        s = s + t.to(dev)
            s = s * scale
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
            pq = p.to(vs[0].dtype).float()

            def pv(b, d):
                with sharding.moving("all-gather"):
                    pb, ab = pq.to(d), alpha.to(d)
                return acc[b] * ab[..., None] + torch.einsum(
                    "bhgqk,bkhd->bhgqd", pb, vs[b][:, sl].float())
            acc = [pv(0, dev)] if nb == 1 else rows.per_block(
                pv, nb, lambda b: [pq, alpha, acc[b], vs[b]])
            m = m_new
        lc = torch.clamp_min(l[..., None], 1e-30)
        with sharding.moving("all-gather"):
            o = acc[0] / lc if nb == 1 else torch.cat(
                [a.to(dev) / lc for a in acc], -1)
        outs.append(o)
    # nq × (B, Hkv, G, cq, dh) → (B, S, Hkv, G, dh)
    o = torch.stack(outs, 1).permute(0, 1, 4, 2, 3, 5)
    return o.reshape(B, S, Hkv, G, dh).to(qs[0].dtype)


def kv_cut(cfg):
    """How the running rows cut attention over their model blocks: (the
    dim of a (B, S, Hkv, dh) k/v cut, blocks), as the decode cache is
    placed (``sharding.cache_model_dim``): 2 by KV head, 3 by head dim,
    or None (one block: whole)."""
    m = sharding.rows().m
    if m == 1:
        return None
    d = sharding.cache_model_dim("k", (1, 1, 1, cfg.n_kv_heads,
                                       cfg.d_head), m)
    return None if d is None else (d - 1, m)


def kv_cache_dim(cfg) -> Optional[int]:
    """The dim of a stacked (L, B, S, Hkv, dh) k/v cache leaf along which
    ``attention`` returns its blocks (None: whole)."""
    cut = kv_cut(cfg)
    return None if cut is None else cut[0] + 1


def kv_map(fn, kv):
    """``fn`` over a k or v that ``attention`` returned: a tensor, or the
    list of its model blocks (each where it lies)."""
    return [fn(t) for t in kv] if isinstance(kv, list) else fn(kv)


def stack_kv(items: list):
    """The layers' k (or v) stacked along a new dim 0: per model block
    where ``attention`` returned blocks."""
    if isinstance(items[0], list):
        return [torch.stack([it[b] for it in items])
                for b in range(len(items[0]))]
    return torch.stack(items)


def _blocks(t: torch.Tensor, dim: int, m: int) -> list:
    """``t`` cut along ``dim`` into ``m`` blocks, block b on the running
    row's device of block b (the blocks of a model axis that stand in
    with ``first_only`` are not made): attention's q, k and v where the
    blocks take a slice of every head's dims, which the projections'
    head blocks do not give."""
    s = t.shape[dim] // m
    return sharding.rows().per_block(
        lambda b, d: t.narrow(dim, b * s, s).to(d), m,
        lambda b: [t.narrow(dim, b * s, s)])


def _by_heads(params: dict, m: int) -> None:
    """Raise unless q, k and v's projections are cut by heads into ``m``
    column blocks and wo into ``m`` row blocks (as the KV-head cut of
    ``kv_cut`` implies): each block's products then feed its own
    attention."""
    for name, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)):
        w = params[name]
        if not (isinstance(w, Sharded) and w.model_dim == dim and
                w.counts()[dim] == m):
            raise ValueError(f"{name} is not cut by heads into {m} blocks")


def attention(params: dict, x: torch.Tensor, cfg, *, window=None,
              causal=True, positions=None, return_kv: bool = False):
    """GQA multi-head attention over a full sequence (prefill). Cut by KV
    head over the model blocks (``kv_cut``), each block projects,
    rotates and attends with its own heads where its weights lie, and wo
    takes each block's output as its row block."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    q8 = cfg.quantize_linears
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    chunk = min(DEFAULT_CHUNK, S)
    cut = kv_cut(cfg)
    if cut is not None and cut[0] == 2:
        m = cut[1]
        _by_heads(params, m)
        qs, ks, vs = (linear(x, params[w], params.get(b), q8=q8, blocks=True)
                      for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))

        def heads(b, dev):
            pos = positions.to(dev)
            q = rope(qs[b].reshape(B, S, H // m, dh), pos, cfg.rope_theta
                     ).reshape(B, S, Hkv // m, G, dh)
            k = rope(ks[b].reshape(B, S, Hkv // m, dh), pos, cfg.rope_theta)
            v = vs[b].reshape(B, S, Hkv // m, dh)
            q, k, v = grad_cast(q), grad_cast(k), grad_cast(v)
            o = _chunked_attn(q, k, v, causal=causal, window=window,
                              chunk=chunk)
            return o.reshape(B, S, H // m * dh), k, v
        parts = sharding.rows().per_block(heads, m,
                                          lambda b: [qs[b], ks[b], vs[b]])
        out = linear([o for o, _, _ in parts], params["wo"], q8=q8)
        if return_kv:
            return out, ([k for _, k, _ in parts], [v for _, _, v in parts])
        return out
    q = linear(x, params["wq"], params.get("bq"), q8=q8)
    k = linear(x, params["wk"], params.get("bk"), q8=q8).reshape(
        B, S, Hkv, dh)
    v = linear(x, params["wv"], params.get("bv"), q8=q8).reshape(
        B, S, Hkv, dh)
    q = rope(q.reshape(B, S, H, dh), positions, cfg.rope_theta
             ).reshape(B, S, Hkv, G, dh)
    k = rope(k, positions, cfg.rope_theta)
    q, k, v = grad_cast(q), grad_cast(k), grad_cast(v)
    if cut is None:
        o = _chunked_attn(q, k, v, causal=causal, window=window,
                          chunk=chunk)
    else:
        # cut by head dim: each block holds its slice of every head's
        # dims, and the blocks' partial scores are summed
        m = cut[1]
        k, v = _blocks(k, 3, m), _blocks(v, 3, m)
        o = _chunked_attn_parts(_blocks(q, 4, m), k, v, causal=causal,
                                window=window, chunk=chunk)
    out = linear(o.reshape(B, S, H * dh), params["wo"], q8=q8)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg, *, window=None, rope_pos=None, mask_pos=None):
    """One-token decode. x: (B, 1, d); cache: {"k","v"}: (B, Smax, Hkv,
    dh) tensors, or a row's ``sharding.CacheRow``s (the blocks of a
    cache cut over "model" as ``kv_cut`` says), written in place at
    ``pos`` (the JAX step donates its cache); each block attends on its
    block's device, cut by KV head end to end as in ``attention``.

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
    ck, cv = cache["k"], cache["v"]
    if isinstance(ck, torch.Tensor):
        ck, cv = sharding.CacheRow([ck], None), sharding.CacheRow([cv], None)
    k_pos = torch.arange(ck.shape[1], device=x.device)[None, :]
    valid = k_pos <= mask_pos[:, None]
    if window is not None:
        valid &= k_pos > mask_pos[:, None] - window
    nb, d = len(ck.parts), ck.dim
    rows = sharding.rows()
    slot = pos.long()

    def write(b, dev, k, v):
        idx = (torch.arange(B, device=dev), slot.to(dev))
        ck.parts[b][idx] = k[:, 0]
        cv.parts[b][idx] = v[:, 0]

    def scores(b, q):
        return torch.einsum("bhgd,bshd->bhgs", q.float(),
                            ck.parts[b].float())

    def probs(s):
        s = torch.where(valid.to(s.device)[:, None, None], s * dh ** -0.5,
                        -1e30)
        return torch.softmax(s, dim=-1)

    def values(b, p):
        return torch.einsum("bhgs,bshd->bhgd", p.to(cv.parts[b].dtype)
                            .float(), cv.parts[b].float())

    if nb > 1 and d == 2:
        _by_heads(params, nb)
        qs, ks, vs = (linear(x, params[w], params.get(b), q8=q8, blocks=True)
                      for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))

        def heads(b, dev):
            rp = rope_pos[:, None].to(dev)
            q = rope(qs[b].reshape(B, 1, H // nb, dh), rp, cfg.rope_theta
                     ).reshape(B, Hkv // nb, G, dh)
            write(b, dev, rope(ks[b].reshape(B, 1, Hkv // nb, dh), rp,
                               cfg.rope_theta),
                  vs[b].reshape(B, 1, Hkv // nb, dh))
            o = values(b, probs(scores(b, q)))
            return o.reshape(B, 1, H // nb * dh).to(x.dtype)
        parts = rows.per_block(heads, nb, lambda b: [qs[b], ks[b], vs[b]])
        return linear(parts, params["wo"], q8=q8), cache
    q = linear(x, params["wq"], params.get("bq"), q8=q8).reshape(B, 1, H, dh)
    k = linear(x, params["wk"], params.get("bk"), q8=q8).reshape(
        B, 1, Hkv, dh)
    v = linear(x, params["wv"], params.get("bv"), q8=q8).reshape(
        B, 1, Hkv, dh)
    q = rope(q, rope_pos[:, None], cfg.rope_theta).reshape(B, Hkv, G, dh)
    k = rope(k, rope_pos[:, None], cfg.rope_theta)
    if nb == 1:
        write(0, x.device, k, v)
        o = values(0, probs(scores(0, q)))
    else:
        # cut by head dim: the blocks' partial scores summed on block 0
        qs, ks, vs = _blocks(q, 3, nb), _blocks(k, 3, nb), _blocks(v, 3, nb)

        def score(b, dev):
            write(b, dev, ks[b], vs[b])
            return scores(b, qs[b])
        part = rows.per_block(score, nb)
        with sharding.moving("all-reduce"):
            s = part[0]
            for t in part[1:]:
                s = s + t.to(x.device)
        p = probs(s)

        def pv(b, dev):
            with sharding.moving("all-gather"):
                pb = p.to(dev)
            return values(b, pb)
        parts = rows.per_block(pv, nb)
        with sharding.moving("all-gather"):
            o = torch.cat([t.to(x.device) for t in parts], -1)
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


def _router(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The router's probabilities (fp32) of (G, Tg, d) tokens."""
    return torch.softmax(torch.einsum("gtd,de->gte", x.float(),
                                      params["w_router"].float()), -1)


def _shared(params: dict, out: torch.Tensor, x: torch.Tensor, cfg):
    """The routed experts' fp32 ``out`` plus the shared expert of the
    tokens ``x`` (where the config has one), in x's dtype."""
    if "shared" in params:
        out = out + mlp(params["shared"], x, cfg).float()
    return out.to(x.dtype)


def _moe_groups(params: dict, xg: torch.Tensor, probs: torch.Tensor, cfg,
                cap: int):
    """Dispatch, experts and combine of (G, Tg, d) token groups with
    their router probabilities (G, Tg, E) → (the routed experts' out
    (G, Tg, d), fp32; top-1 expert (G, Tg)). The expert einsums run per
    block of a weight cut over "experts" (or, re-placed by ``pspec``,
    over "expert_mlp")."""
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xg.device
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
    return out, idx[..., 0]


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
    dispatches every row's tokens in one sort (one group spans rows),
    while the router and the shared expert, which act token by token,
    run on each row's own tokens. The load-balancing loss is taken over
    every row's tokens.
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
        def own(p, t):
            xg = t.reshape(G // len(x), Tg, d)
            probs = _router(p, xg)
            out, top1 = _moe_groups(p, xg, probs, cfg, cap)
            return _shared(p, out, xg, cfg).reshape(t.shape), probs, top1
        parts = rows.each(own, params, x)
        outs = [o for o, _, _ in parts]
        probs = rows.join([p for _, p, _ in parts])
        top1 = rows.join([t for _, _, t in parts])
    else:
        probs = rows.join(rows.each(
            lambda p, t: _router(p, t.reshape(1, -1, d)), params, x), 1)
        (out, top1), = rows.each(lambda p, t, pr: _moe_groups(
            p, t.reshape(G, Tg, d), pr.reshape(G, Tg, E), cfg, cap),
            params, [rows.join(x)], [probs])
        outs = rows.each(lambda p, o, t: _shared(p, o.reshape(t.shape), t,
                                                 cfg),
                         params, rows.split(out.reshape(-1, S, d)), x)
    # Switch-style load-balancing aux loss (global statistics).
    density = F.one_hot(top1, E).float().mean((0, 1))
    aux = E * torch.sum(density * probs.mean((0, 1)))
    return outs, aux
