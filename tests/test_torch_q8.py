"""The port's quantization helpers, K5's plain version and ``q8_linear``
against the JAX package, on the CPU, with the same numpy inputs on both
sides.

Tiers:
* ``fake_quant`` forward and its straight-through gradient: bit for bit
  (both sides run the same fp32 IEEE operations), values at exactly
  ±qmax·scale and beyond it included;
* ``quantize_int``/``dequantize_int`` and ``abs_max_scale``: bit for bit;
* K5's plain version against ``kref.q8_matmul_ref``: bit for bit (an
  exact int32 accumulator, then the same two fp32 products in the same
  order), fp32 and bf16 output;
* K5's plain version against the interpret-mode Pallas ``q8_matmul``:
  ``rtol=1e-6``, as ``tests/test_kernels.py`` holds that kernel;
* ``q8_linear``: Xq, Wq and both scales bit for bit; the output to
  ``rtol=1e-6`` against JAX's (interpret-mode Pallas behind it).

The JAX side of every case runs op by op, all cases at once in worker
threads (XLA compiles each op with the GIL released).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro.kernels.q8_matmul import q8_matmul as pallas_q8_matmul
from repro_torch.core import quantization as tq
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.q8_matmul import q8_matmul, q8_matmul_plain

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)


def _fq_inputs(seed, shape=(6, 5, 4, 3)):
    """Normal values and a cotangent of the same shape."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    return x, rng.normal(size=shape).astype(np.float32)


def _edge_inputs(bits):
    """Values at ±qmax·scale, an ulp inside and outside, and beyond."""
    scale = np.float32(0.05)
    edge = np.float32(jq.qmax(bits)) * scale
    x = np.array([edge, -edge, np.nextafter(edge, np.float32(0)),
                  np.nextafter(edge, np.float32(10)), -edge * 1.5,
                  edge * 2, 0.0, 0.3], dtype=np.float32)
    return x, np.arange(1, x.size + 1, dtype=np.float32), scale


def _q8_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K), dtype=np.int8)
    wq = rng.integers(-127, 128, (K, N), dtype=np.int8)
    if (M, K, N) == SATURATED:
        # ±127 with aligned signs: |acc| up to K·127² > 2²⁴, where the
        # int32 → fp32 conversion rounds
        xq = np.where(rng.uniform(size=(M, K)) < 0.02, -127, 127)
        wq = np.where(rng.uniform(size=(K, N)) < 0.02, -127, 127)
        wq = wq * np.where(np.arange(N) % 2, -1, 1)
        xq[:, 0] = 126                   # odd sums, so that fp32 rounds
        xq, wq = xq.astype(np.int8), wq.astype(np.int8)
    sx = np.float32(0.013)
    sw = (rng.uniform(size=N) * 0.02 + 1e-4).astype(np.float32)
    return xq, wq, sx, sw


def _q8_linear_inputs():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(4, 10, 64)).astype(np.float32),
            rng.normal(size=(64, 48)).astype(np.float32))


BITS_AXES = [(bits, axis) for bits in (8, 9) for axis in (None, (0, 2, 3))]
QUANT_CASES = [(bits, axis) for bits in (8, 9) for axis in (None, (1,))]
SATURATED = (8, 2048, 8)
Q8_SHAPES = [(64, 48, 32), (130, 100, 70), (8, 8, 8), SATURATED]
OUT_DTYPES = ["float32", "bfloat16"]


def _jax_fake_quant(bits, axis):
    x, r = _fq_inputs(bits)

    def jloss(x):
        return jnp.sum(jq.fake_quant(x, bits, axis=axis) * r)
    return (np.asarray(jq.fake_quant(jnp.asarray(x), bits, axis=axis)),
            np.asarray(jax.grad(jloss)(jnp.asarray(x))))


def _jax_edges(bits):
    x, r, scale = _edge_inputs(bits)
    js = jnp.float32(scale)
    return (np.asarray(jq.fake_quant(jnp.asarray(x), bits, scale=js)),
            np.asarray(jax.grad(
                lambda v: jnp.sum(jq.fake_quant(v, bits, scale=js) * r))(
                    jnp.asarray(x))))


def _jax_quantize(bits, axis):
    x, _ = _fq_inputs(10 + bits, shape=(7, 9))
    jqv, js = jq.quantize_int(jnp.asarray(x), bits, axis=axis)
    return (jnp.dtype(jqv.dtype).name, np.asarray(jqv), np.asarray(js),
            np.asarray(jq.dequantize_int(jqv, js)),
            np.asarray(jq.abs_max_scale(jnp.asarray(x), bits, axis=axis)))


def _jax_q8_ref(M, K, N, out):
    xq, wq, sx, sw = _q8_inputs(M, K, N, seed=M + K + N)
    return np.asarray(kref.q8_matmul_ref(
        jnp.asarray(xq), jnp.asarray(wq), jnp.float32(sx), jnp.asarray(sw),
        out_dtype=jnp.dtype(out)).astype(jnp.float32))


def _jax_pallas_q8():
    xq, wq, sx, sw = _q8_inputs(130, 100, 70, seed=7)
    return np.asarray(pallas_q8_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.float32(sx), jnp.asarray(sw),
        blocks=(32, 32, 32), interpret=True))


def _jax_q8_linear():
    x, w = _q8_linear_inputs()
    # the quantization of JAX's q8_linear (ops.py), written out
    x2 = jnp.asarray(x).reshape(-1, 64)
    js_x = jnp.maximum(jnp.max(jnp.abs(x2)), 1e-12) / 127.0
    js_w = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(w)), axis=0),
                       1e-12) / 127.0
    jxq = jnp.clip(jnp.round(x2 / js_x), -127, 127).astype(jnp.int8)
    jwq = jnp.clip(jnp.round(jnp.asarray(w) / js_w[None, :]), -127,
                   127).astype(jnp.int8)
    jy = jops.q8_linear(jnp.asarray(x), jnp.asarray(w), interpret=True)
    return [np.asarray(v) for v in (jxq, jwq, js_x, js_w, jy)]


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this module, keyed by case, each a future."""
    jobs = [(("fq",) + c, _jax_fake_quant, c) for c in BITS_AXES]
    jobs += [(("edges", b), _jax_edges, (b,)) for b in (8, 9)]
    jobs += [(("quant",) + c, _jax_quantize, c) for c in QUANT_CASES]
    jobs += [(("q8",) + shape + (out,), _jax_q8_ref, shape + (out,))
             for shape in Q8_SHAPES for out in OUT_DTYPES]
    jobs += [(("pallas",), _jax_pallas_q8, ()), (("linear",),
                                                  _jax_q8_linear, ())]
    with ThreadPoolExecutor(max_workers=8) as pool:
        yield {key: pool.submit(fn, *args) for key, fn, args in jobs}


@pytest.mark.parametrize("bits", [8, 9])
@pytest.mark.parametrize("axis", [None, (0, 2, 3)])
def test_fake_quant_forward_and_ste_gradient_bitwise(bits, axis, jax_refs):
    x, r = _fq_inputs(bits)
    jy, jg = jax_refs[("fq", bits, axis)].result()
    tx = torch.tensor(x, requires_grad=True)
    ty = tq.fake_quant(tx, bits, axis=axis)
    (ty * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    np.testing.assert_array_equal(tx.grad.numpy(), jg)


@pytest.mark.parametrize("bits", [8, 9])
def test_fake_quant_gradient_at_the_clip_edges(bits, jax_refs):
    qm = jq.qmax(bits)
    x, r, scale = _edge_inputs(bits)
    jy, jg = jax_refs[("edges", bits)].result()
    tx = torch.tensor(x, requires_grad=True)
    ty = tq.fake_quant(tx, bits, scale=torch.tensor(scale))
    (ty * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    np.testing.assert_array_equal(tx.grad.numpy(), jg)
    # the saturating STE: a gradient exactly where |x/scale| <= qmax
    inside = np.abs(x / scale) <= qm
    np.testing.assert_array_equal(tx.grad.numpy(), r * inside)
    assert inside[:3].all() and not inside[4:6].any()


def test_fake_quant_gives_the_scale_no_gradient_and_skips_bits_none():
    x, _ = _fq_inputs(1)
    tx = torch.tensor(x, requires_grad=True)
    scale = torch.tensor(0.02, requires_grad=True)
    tq.fake_quant(tx, 8, scale=scale).sum().backward()
    assert scale.grad is None
    assert tq.fake_quant(tx, None) is tx


@pytest.mark.parametrize("bits", [8, 9])
@pytest.mark.parametrize("axis", [None, (1,)])
def test_quantize_dequantize_int_bitwise(bits, axis, jax_refs):
    x, _ = _fq_inputs(10 + bits, shape=(7, 9))
    jdtype, jqv, js, jdq, jscale = jax_refs[("quant", bits, axis)].result()
    tqv, ts = tq.quantize_int(torch.from_numpy(x), bits, axis=axis)
    assert tqv.dtype == (torch.int8 if bits == 8 else torch.int16)
    assert str(tqv.dtype).split(".")[-1] == jdtype
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tq.dequantize_int(tqv, ts).numpy(), jdq)
    np.testing.assert_array_equal(
        tq.abs_max_scale(torch.from_numpy(x), bits, axis=axis).numpy(),
        jscale)


def test_quantize_int_refuses_a_narrow_dtype():
    x = torch.randn(4, 4)
    with pytest.raises(ValueError, match="does not fit"):
        tq.quantize_int(x, 9, dtype=torch.int8)
    with pytest.raises(ValueError):
        jq.quantize_int(jnp.asarray(x.numpy()), 9, dtype=jnp.int8)
    q, _ = tq.quantize_int(x, 9, dtype=torch.int32)
    assert q.dtype == torch.int32


@pytest.mark.parametrize("M,K,N", Q8_SHAPES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_q8_matmul_plain_matches_the_jax_reference(M, K, N, out, jax_refs):
    xq, wq, sx, sw = _q8_inputs(M, K, N, seed=M + K + N)
    if (M, K, N) == SATURATED:
        acc = xq.astype(np.int64) @ wq.astype(np.int64)
        assert np.abs(acc).max() > 2 ** 24
        assert np.any(acc.astype(np.float32).astype(np.int64) != acc)
    jout = jax_refs[("q8", M, K, N, out)].result()
    tdt = getattr(torch, out)
    got = q8_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                    torch.tensor(sx), torch.from_numpy(sw), out_dtype=tdt)
    ref = tref.q8_matmul_ref(torch.from_numpy(xq), torch.from_numpy(wq),
                             torch.tensor(sx), torch.from_numpy(sw), tdt)
    assert got.dtype == ref.dtype == tdt and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), jout)
    np.testing.assert_array_equal(got.float().numpy(), ref.float().numpy())


def test_q8_matmul_plain_matches_the_interpret_mode_pallas_kernel(jax_refs):
    xq, wq, sx, sw = _q8_inputs(130, 100, 70, seed=7)
    jout = jax_refs[("pallas",)].result()
    got = q8_matmul_plain(torch.from_numpy(xq), torch.from_numpy(wq),
                          torch.tensor([sx]), torch.from_numpy(sw))
    np.testing.assert_allclose(got.numpy(), jout, rtol=1e-6)


def test_q8_linear_matches_jax_quantization_and_output(jax_refs):
    x, w = _q8_linear_inputs()
    jxq, jwq, js_x, js_w, jy = jax_refs[("linear",)].result()
    xq, wq, s_x, s_w = tops._q8_operands(torch.from_numpy(x).reshape(-1, 64),
                                         torch.from_numpy(w))
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(wq.numpy(), jwq)
    np.testing.assert_array_equal(s_x.numpy(), js_x)
    np.testing.assert_array_equal(s_w.numpy(), js_w)

    _build.reset_launches()
    y = tops.q8_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(y.shape) == (4, 10, 48)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6)
    assert _build.LAUNCHES["q8_matmul"] == 0      # CPU: the plain version
    ref = torch.from_numpy(x) @ torch.from_numpy(w)
    assert float((y - ref).norm() / ref.norm()) < 0.05


def test_q8_matmul_refuses_what_it_does_not_take():
    xq, wq, sx, sw = _q8_inputs(8, 16, 8, seed=1)
    x, w = torch.from_numpy(xq), torch.from_numpy(wq)
    s, sw_t = torch.tensor(sx), torch.from_numpy(sw)
    with pytest.raises(ValueError, match="do not chain"):
        q8_matmul(x, w[:8], s, sw_t)
    with pytest.raises(ValueError, match="s_w"):
        q8_matmul(x, w, s, sw_t[:4])
    with pytest.raises(ValueError, match="s_x"):
        q8_matmul(x, w, torch.ones(2), sw_t)
    with pytest.raises(ValueError, match="out_dtype"):
        q8_matmul(x, w, s, sw_t, out_dtype=torch.float16)
    assert "q8_matmul" in _build.LAUNCHES
    assert _build.SOURCES["q8_matmul"] == ("q8_matmul",)
