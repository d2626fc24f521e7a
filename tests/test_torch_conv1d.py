"""The port's 1-D Toom-Cook pipeline and ``condition_number`` against the
JAX package, on the CPU, with the same numpy inputs on both sides.

Tiers (those of the 2-D pipeline, ``tests/test_torch_train.py``):
* fp pipeline (quantization off), forward and gradients with respect to
  x, w and the flex matrices: ``rtol = atol = 1e-4``;
* fake-quant pipeline (8-bit casts, 9-bit Hadamard stage), flex on:
  forward within one step of the output cast on at most 0.5 % of the
  outputs and ``1e-4`` elsewhere; gradients within 0.25 of each
  gradient's largest value on at most 25 % of its elements and ``1e-4``
  elsewhere (the straight-through mask of a stage's abs-max element can
  pass in one package and stop in the other). The JAX reference is
  compiled with XLA's algebraic simplifier off, as there: under ``jit``
  it rewrites the scale's ``amax / 127`` into ``amax · (1/127)``;
* ``transform_weights_1d`` (fake-quant, eager on both sides): ``1e-6``;
  ``direct_conv1d``: ``1e-5``; ``condition_number``: equal to float64
  rounding (``rtol = 1e-12``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import winograd as jw
from repro.core.quantization import QuantConfig as JQuantConfig
from repro_torch.core import winograd as tw
from repro_torch.core.quantization import QuantConfig

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

CASES = [(quant, m, base, causal) for quant in ("fp", "fakequant")
         for m in (2, 4) for base in ("canonical", "legendre")
         for causal in (True, False)]
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}


def _specs(quant, m, base):
    jq = JQuantConfig.off() if quant == "fp" else JQuantConfig(
        hadamard_bits=9)
    tq = QuantConfig.off() if quant == "fp" else QuantConfig(hadamard_bits=9)
    return (jw.WinogradSpec(m=m, r=3, base=base, quant=jq),
            tw.WinogradSpec(m=m, r=3, base=base, quant=tq))


def _inputs(case):
    quant, m, base, _ = case
    rng = np.random.default_rng(CASES.index(case))
    x = rng.normal(size=(2, 61, 4)).astype(np.float32)        # ragged T
    w = (rng.normal(size=(3, 4, 6)) * 0.3).astype(np.float32)
    r = rng.normal(size=(2, 61, 6)).astype(np.float32)
    fx = {k: (np.asarray(v) + 0.01 * rng.normal(size=v.shape))
          .astype(np.float32)
          for k, v in jw.flex_init(_specs(quant, m, base)[0]).items()}
    return x, w, r, fx


@pytest.fixture(scope="module")
def jax_results():
    """Forward and gradients of every case from one JAX compile."""
    def run(args):
        res = []
        for (quant, m, base, causal), (x, w, r, fx) in zip(CASES, args):
            js = _specs(quant, m, base)[0]

            def f(x, w, fx):
                y = jw.winograd_conv1d(x, w, js, flex=fx, causal=causal)
                return jnp.sum(y * r), y
            res.append(jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(x, w, fx))
        return res
    args = [_inputs(c) for c in CASES]
    compiled = jax.jit(run).lower(args).compile(compiler_options=ALGSIMP_OFF)
    out = {}
    for case, ((_, y), g) in zip(CASES, compiled(args)):
        out[case] = (np.asarray(y), [np.asarray(g[0]), np.asarray(g[1]),
                                     {k: np.asarray(v)
                                      for k, v in g[2].items()}])
    return out


@pytest.mark.parametrize("quant,m,base,causal", CASES)
def test_winograd_conv1d_and_its_flex_gradients_match_jax(
        quant, m, base, causal, jax_results):
    case = (quant, m, base, causal)
    ts = _specs(quant, m, base)[1]
    x, w, r, fx = _inputs(case)
    jy, jg = jax_results[case]
    tx = torch.tensor(x, requires_grad=True)
    twt = torch.tensor(w, requires_grad=True)
    tfx = {k: torch.tensor(v, requires_grad=True) for k, v in fx.items()}
    ty = tw.winograd_conv1d(tx, twt, ts, flex=tfx, causal=causal)
    (ty * torch.from_numpy(r)).sum().backward()
    ty = ty.detach().numpy()
    assert ty.shape == jy.shape == (2, 61, 6)
    if quant == "fp":
        np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
    else:
        d = np.abs(ty - jy)
        flipped = d > 1e-4 * (1 + np.abs(jy))
        assert flipped.sum() <= 0.005 * d.size, int(flipped.sum())
        assert d.max() <= np.abs(jy).max() / 127 * (1 + 1e-4) + 1e-4
    pairs = [("x", tx.grad, jg[0]), ("w", twt.grad, jg[1])]
    pairs += [(k, tfx[k].grad, jg[2][k]) for k in sorted(tfx)]
    for name, got, want in pairs:
        got = got.numpy()
        if quant == "fp":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            continue
        d = np.abs(got - want)
        flipped = d > 1e-4 * (1 + np.abs(want))
        assert flipped.sum() <= 0.25 * d.size, (name, int(flipped.sum()))
        assert d.max() <= 0.25 * np.abs(want).max(), (name, d.max())


@pytest.mark.parametrize("causal", [True, False])
def test_direct_conv1d_and_the_exact_pipeline_match_jax(causal):
    x, w, _, _ = _inputs(CASES[0])
    ref = np.asarray(jw.direct_conv1d(jnp.asarray(x), jnp.asarray(w),
                                      causal=causal))
    got = tw.direct_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                           causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the exact (quantization-off) F(4,3) pipeline is the convolution
    ts = tw.WinogradSpec(m=4, r=3, base="legendre", quant=QuantConfig.off())
    y = tw.winograd_conv1d(torch.from_numpy(x), torch.from_numpy(w), ts,
                           causal=causal).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)


def test_transform_weights_1d_and_condition_number_match_jax():
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(3, 4, 6)) * 0.3).astype(np.float32)
    for m in (2, 4, 6):
        for base in ("canonical", "legendre", "chebyshev"):
            js = jw.WinogradSpec(m=m, r=3, base=base)
            ts = tw.WinogradSpec(m=m, r=3, base=base)
            jm, tm = jw.make_matrices(js), tw.make_matrices(ts)
            for f in ("AT", "G", "BT", "C", "GP", "BPT", "APT"):
                assert (tw.condition_number(getattr(tm, f))
                        == pytest.approx(jw.condition_number(
                            np.asarray(getattr(jm, f))), rel=1e-12)), \
                    (m, base, f)
            ref = np.asarray(jw.transform_weights_1d(jnp.asarray(w), js, jm))
            got = tw.transform_weights_1d(torch.from_numpy(w), ts, tm)
            # the same casts: apart by at most an ulp of a scale
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"F({m},3) {base}")
