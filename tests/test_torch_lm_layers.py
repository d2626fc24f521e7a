"""The port's LM building blocks (``repro_torch.models.layers``) against
the JAX package's, on the CPU, with the same numpy inputs on both sides.

Tier: fp32 outputs to ``rtol = atol = 1e-4`` (docs/parity.md), except
``linear(q8=True)``, held at the fake-quant tier of
``tests/test_torch_conv1d.py``: within one step of the activation grid
on at most 0.5 % of the outputs, ``1e-4`` elsewhere (a product on a
rounding boundary can round either way in the two packages). The MoE
case drops tokens, and the dropped (token, choice) pairs must be the
same set.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, tiny_variant as jtiny
from repro.models import layers as JL
from repro_torch.configs import ARCHS, tiny_variant
from repro_torch.models import layers as L

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **changes):
    return (dataclasses.replace(jtiny(JARCHS[arch]), **changes),
            dataclasses.replace(tiny_variant(ARCHS[arch]), **changes))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    """fn_j on jnp arrays and fn_t on tensors of the same numpy arrays."""
    return (np.asarray(fn_j(*map(jnp.asarray, arrays))),
            fn_t(*map(torch.from_numpy, arrays)))


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, want, **(tol or TOL))


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x, s, b = _rand(rng, 2, 5, 64, scale=3.0), _rand(rng, 64), _rand(rng, 64)
    _close(*_both(JL.rms_norm, L.rms_norm, x, s)[::-1])
    _close(*_both(JL.layer_norm, L.layer_norm, x, s, b)[::-1])


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 40, 4, 16)
    pos = np.stack([np.arange(40), np.arange(100, 140)]).astype(np.int32)
    for theta in (1e4, 5e5):
        want, got = _both(lambda a, p: JL.rope(a, p, theta),
                          lambda a, p: L.rope(a, p, theta), x, pos)
        _close(got, want)


@pytest.mark.parametrize("q8", [False, True])
def test_linear_matches_jax(q8):
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, 2, 7, 64), _rand(rng, 64, 48, scale=0.2), \
        _rand(rng, 48)
    want, got = _both(lambda a, c, d: JL.linear(a, c, d, q8=q8),
                      lambda a, c, d: L.linear(a, c, d, q8=q8), x, w, b)
    got = got.numpy()
    if not q8:
        _close(got, want)
        return
    d = np.abs(got - want)
    flipped = d > 1e-4 * (1 + np.abs(want))
    assert flipped.sum() <= 0.005 * d.size, int(flipped.sum())
    # one step of the activation grid through one weight column
    step = np.abs(x).max() / 127 * np.abs(w).sum(0).max()
    assert d.max() <= step, (d.max(), step)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, None, 8), (False, None, 8), (True, 12, 8), (True, 20, 8),
    (True, None, 32)])
def test_chunked_attention_matches_jax(causal, window, chunk):
    """Several KV chunks (chunk 8 over S = 32), causal and bidirectional,
    and sliding windows whose band spans two and three chunks."""
    rng = np.random.default_rng(3)
    q = _rand(rng, 2, 32, 2, 2, 16)
    k, v = _rand(rng, 2, 32, 2, 16), _rand(rng, 2, 32, 2, 16)
    want, got = _both(
        lambda a, b, c: JL._chunked_attn(a, b, c, causal=causal,
                                         chunk=chunk, window=window),
        lambda a, b, c: L._chunked_attn(a, b, c, causal=causal,
                                        chunk=chunk, window=window),
        q, k, v)
    assert got.shape == (2, 32, 2, 2, 16)
    _close(got, want)


@pytest.mark.parametrize("ring", [True, False])
def test_attention_decode_matches_jax(ring):
    """One token into a (B, 16, Hkv, dh) cache: a ring buffer whose
    logical positions (rope) are past its length, with every slot valid;
    and a linear cache under a window of 8."""
    jcfg, tcfg = _cfgs("llama3.2-1b", qkv_bias=True)
    rng = np.random.default_rng(4)
    d, H, Hkv, dh = 64, 4, 2, 16
    p = {"wq": _rand(rng, d, H * dh, scale=0.125),
         "wk": _rand(rng, d, Hkv * dh, scale=0.125),
         "wv": _rand(rng, d, Hkv * dh, scale=0.125),
         "wo": _rand(rng, H * dh, d, scale=0.125),
         "bq": _rand(rng, H * dh), "bk": _rand(rng, Hkv * dh),
         "bv": _rand(rng, Hkv * dh)}
    x = _rand(rng, 2, 1, d)
    cache = {"k": _rand(rng, 2, 16, Hkv, dh), "v": _rand(rng, 2, 16, Hkv, dh)}
    if ring:
        pos = np.array([3, 15], np.int32)
        kw = dict(window=None, rope_pos=np.array([19, 31], np.int32),
                  mask_pos=np.array([15, 15], np.int32))
    else:
        pos = np.array([9, 12], np.int32)
        kw = dict(window=8)
    jout, jc = JL.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos),
        jcfg, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                 for k, v in kw.items()})
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tc2 = L.attention_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tc, torch.from_numpy(pos), tcfg,
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert tc2 is tc                          # written in place
    _close(tout, np.asarray(jout))
    for name in ("k", "v"):
        _close(tc[name], np.asarray(jc[name]))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    jcfg, tcfg = _cfgs("llama3.2-1b", act=act)
    rng = np.random.default_rng(5)
    p = {"w_up": _rand(rng, 64, 128, scale=0.125),
         "w_down": _rand(rng, 128, 64, scale=0.09)}
    if act != "gelu":
        p["w_gate"] = _rand(rng, 64, 128, scale=0.125)
    x = _rand(rng, 2, 6, 64)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), jcfg)
    got = L.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), tcfg)
    _close(got, np.asarray(want))


def _jax_dropped(xg, w_router, k, cap):
    """The (token, choice) pairs JAX's dispatch drops: the routing lines
    of ``repro.models.layers.moe`` (softmax, top_k, stable argsort,
    searchsorted) on its own router probabilities."""
    import jax
    G, Tg, _ = xg.shape
    E = w_router.shape[1]
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(xg),
                                      jnp.asarray(w_router)), -1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(G, Tg * k)
    order = jnp.argsort(flat_e, axis=1)
    sorted_e = jnp.take_along_axis(flat_e, order, 1)
    start = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(E)))(
        sorted_e)
    pos = jnp.arange(Tg * k)[None] - jnp.take_along_axis(start, sorted_e, 1)
    order, keep = np.asarray(order), np.asarray(pos < cap)
    return {(g, int(order[g, i])) for g in range(G)
            for i in range(Tg * k) if not keep[g, i]}


@pytest.mark.parametrize("groups", [0, 2])
def test_moe_with_dropped_tokens_matches_jax(groups):
    """Capacity factor 0.5: a quarter or more of the (token, choice)
    pairs overflow their expert and are dropped, the same pairs in both
    packages; one and two dispatch groups; the shared expert on."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.5,
                       moe_groups=groups)
    rng = np.random.default_rng(6)
    E, d, f = 8, 64, 32
    p = {"w_router": _rand(rng, d, E, scale=0.5),
         "w_gate": _rand(rng, E, d, f, scale=0.125),
         "w_up": _rand(rng, E, d, f, scale=0.125),
         "w_down": _rand(rng, E, f, d, scale=0.18),
         "shared": {"w_gate": _rand(rng, d, 64, scale=0.125),
                    "w_up": _rand(rng, d, 64, scale=0.125),
                    "w_down": _rand(rng, 64, d, scale=0.125)}}
    x = _rand(rng, 2, 16, d)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in p.items()}
    tp = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p.items()}
    jout, jaux = JL.moe(jp, jnp.asarray(x), jcfg)
    tout, taux = L.moe(tp, torch.from_numpy(x), tcfg)
    _close(tout, np.asarray(jout))
    _close(taux, np.asarray(jaux))

    G = max(groups, 1)
    Tg, k = 32 // G, tcfg.top_k
    cap = min(int(tcfg.capacity_factor * Tg * k / E + 1), Tg)
    xg = x.reshape(G, Tg, d)
    probs = torch.softmax(torch.einsum(
        "gtd,de->gte", torch.from_numpy(xg),
        torch.from_numpy(p["w_router"])), -1)
    _, _, order, _, _, keep = L._dispatch(probs, k, cap)
    dropped = {(g, int(order[g, i])) for g in range(G)
               for i in range(Tg * k) if not keep[g, i]}
    assert len(dropped) >= Tg * k * G // 4, len(dropped)
    assert dropped == _jax_dropped(xg, p["w_router"], k, cap)
