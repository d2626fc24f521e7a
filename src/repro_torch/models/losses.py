"""Loss utilities shared by all LM families (the port's counterpart of
``repro.models.losses``).

``chunked_ce``: cross-entropy that walks the sequence in chunks, so the
(B, S, vocab) logits tensor is never materialized: each chunk's logits
live only inside its step, which runs under activation checkpointing, so
backward recomputes them a chunk at a time too (JAX's
``jax.checkpoint`` of its scan step). On one device the JAX package's
vocab-sharding constraint of a chunk (``_constrain_vocab_sharded``) is an
identity; it comes with LM sharding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_ce", "CE_CHUNK"]

CE_CHUNK = 256


def _chunk_nll(xc: torch.Tensor, lc: torch.Tensor, unembed: torch.Tensor):
    """One chunk: (sum of the masked NLL, count of labels >= 0), fp32."""
    logits = (xc @ unembed).float()
    lse = torch.logsumexp(logits, -1)
    pick = torch.arange(logits.shape[-1], device=logits.device) == \
        torch.clamp_min(lc, 0)[..., None]
    onehot_ll = torch.where(pick, logits, 0.0).sum(-1)
    mask = (lc >= 0).float()
    return ((lse - onehot_ll) * mask).sum(), mask.sum()


def chunked_ce(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
               chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean next-token CE. x: (B, S, d) final hiddens; unembed: (d, V);
    labels: (B, S) with −1 = masked. Walks S in chunks of ``chunk``,
    summing the NLL and the count chunk by chunk in JAX's scan order."""
    B, S, d = x.shape
    c = min(chunk, S)
    if S % c:
        pad = c - S % c          # pad to a chunk multiple, labels masked
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        S += pad
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, c):
        if torch.is_grad_enabled():
            s, n = checkpoint(_chunk_nll, x[:, i:i + c], labels[:, i:i + c],
                              unembed, use_reentrant=False)
        else:
            s, n = _chunk_nll(x[:, i:i + c], labels[:, i:i + c], unembed)
        nll = nll + s
        count = count + n
    return nll / torch.clamp_min(count, 1.0)
