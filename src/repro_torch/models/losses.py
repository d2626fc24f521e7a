"""Loss utilities shared by all LM families (the port's counterpart of
``repro.models.losses``).

``chunked_ce``: cross-entropy that walks the sequence in chunks, so the
(B, S, vocab) logits tensor is never materialized: each chunk's logits
live only inside its step, which runs under activation checkpointing, so
backward recomputes them a chunk at a time too (JAX's
``jax.checkpoint`` of its scan step).

Over a mesh it takes the running rows' slabs, and the NLL and the label
count are summed over every row before the one division: a mean of the
rows' means would weigh rows with fewer labels more. An unembedding cut
over "vocab" keeps each chunk's logits vocab-split (JAX's
``_constrain_vocab_sharded``): each block's logsumexp on the block's
device, combined by a logsumexp of the blocks', and the label's logit
from the block that holds it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Sharded
from repro_torch.models import layers as L

__all__ = ["chunked_ce", "CE_CHUNK"]

CE_CHUNK = 256


def _constrain_vocab_sharded(xc: torch.Tensor, lc: torch.Tensor,
                             unembed: Sharded):
    """One chunk against an unembedding cut over "vocab" (its dim 1):
    (the masked NLL's sum, the count of labels >= 0), block by block."""
    m = unembed.counts()[1]
    vb = unembed.shape[1] // m
    target = torch.clamp_min(lc, 0)

    def block(k, dev):
        logits = (xc.to(dev) @ unembed.gather(dev, at=(1, k))).float()
        pick = torch.arange(k * vb, (k + 1) * vb, device=dev) == \
            target.to(dev)[..., None]
        return (torch.logsumexp(logits, -1),
                torch.where(pick, logits, 0.0).sum(-1))
    parts = sharding.rows().per_block(block, m, lambda k: [xc])
    with sharding.moving("all-gather"):
        lses = [lse.to(xc.device) for lse, _ in parts]
        picks = [pick.to(xc.device) for _, pick in parts]
    lse = torch.logsumexp(torch.stack(lses, -1), -1)
    onehot_ll = picks[0]
    for p in picks[1:]:
        onehot_ll = onehot_ll + p
    mask = (lc >= 0).float()
    return ((lse - onehot_ll) * mask).sum(), mask.sum()


def _chunk_nll(xc: torch.Tensor, lc: torch.Tensor, unembed):
    """One chunk: (sum of the masked NLL, count of labels >= 0), fp32. An
    unembedding cut over "model" along its vocab dim runs vocab-split;
    along its embed dim (``pspec`` moves the cut there when the vocab
    does not divide) its product is row-parallel (``layers.linear``)."""
    if isinstance(unembed, Sharded) and unembed.model_dim == 1:
        return _constrain_vocab_sharded(xc, lc, unembed)
    logits = L.linear(xc, unembed).float()
    lse = torch.logsumexp(logits, -1)
    pick = torch.arange(logits.shape[-1], device=logits.device) == \
        torch.clamp_min(lc, 0)[..., None]
    onehot_ll = torch.where(pick, logits, 0.0).sum(-1)
    mask = (lc >= 0).float()
    return ((lse - onehot_ll) * mask).sum(), mask.sum()


def _chunk_rows(xcs: list, lcs: list, unembed):
    """One chunk of every row: the rows' sums added in row order."""
    out = sharding.rows().each(lambda w, xc, lc: _chunk_nll(xc, lc, w),
                               unembed, xcs, lcs)
    nll, count = out[0]
    with sharding.moving("all-reduce"):
        for s, n in out[1:]:
            nll, count = nll + s.to(nll.device), count + n.to(count.device)
    return nll, count


def chunked_ce(x, unembed, labels, chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean next-token CE. x: (B, S, d) final hiddens; unembed: (d, V);
    labels: (B, S) with −1 = masked; or ``x`` and ``labels`` the running
    rows' slabs (lists). Walks S in chunks of ``chunk``, summing the NLL
    and the count chunk by chunk in JAX's scan order."""
    xs, ls = (x, labels) if isinstance(x, list) else ([x], [labels])
    S = xs[0].shape[1]
    c = min(chunk, S)
    if S % c:
        pad = c - S % c          # pad to a chunk multiple, labels masked
        xs = [F.pad(t, (0, 0, 0, pad)) for t in xs]
        ls = [F.pad(t, (0, pad), value=-1) for t in ls]
        S += pad
    nll = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    count = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for i in range(0, S, c):
        xcs = [t[:, i:i + c] for t in xs]
        lcs = [t[:, i:i + c] for t in ls]
        if torch.is_grad_enabled():
            s, n = checkpoint(_chunk_rows, xcs, lcs, unembed,
                              use_reentrant=False)
        else:
            s, n = _chunk_rows(xcs, lcs, unembed)
        nll = nll + s
        count = count + n
    return nll / torch.clamp_min(count, 1.0)
