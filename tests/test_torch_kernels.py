"""Each kernel's plain PyTorch version against the JAX package's pure-jnp
references, on the CPU, with the same numpy inputs on both sides.

Tiers (docs/parity.md §Practical rules):
* Xq: the oracle sums in einsum order and the port in the kernels'
  unrolled order, so at most max(1, 1e-4·size) elements may differ, each
  by ±1; the pre-quantization values agree to rtol = atol = 1e-6;
* the int32 GEMM and the Hadamard requant plane: exact;
* fp32 outputs: rtol = atol = 1e-4.
No Pallas kernel runs here; the JAX package's own tests hold its Pallas
kernels against these references.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import winograd as jw
from repro.core.quantization import qmax
from repro.kernels import ref as kref
from repro.kernels.ops import _hadamard_rq
from repro.kernels.wino_gemm import requant_plane
from repro_torch.kernels import fused_serve as fs
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wino_gemm as wg
from repro_torch.kernels import wino_transform as wt
from test_torch_gpu import K3_EDGE_CASES, k3_edge_inputs

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)

SPECS = [(m, base) for m in (2, 4, 6) for base in ("canonical", "legendre")]
CASES = [(m, base, bits) for m, base in SPECS for bits in (None, 8, 9)]
T, CIN, COUT = 13, 11, 7


def _mats(m, base):
    mats = jw.make_matrices(jw.WinogradSpec(m=m, r=3, base=base))
    return {k: np.asarray(getattr(mats, k)) for k in ("CinvT", "BPT", "APT")}


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_xq_tier(got: np.ndarray, want: np.ndarray, label: str = ""):
    """Xq: at most max(1, 1e-4·size) elements off, each by ±1."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    off = int(np.count_nonzero(diff))
    print(f"Xq {label}: {off} of {diff.size} elements differ")
    assert np.abs(diff).max(initial=0) <= 1
    assert off <= max(1, int(1e-4 * diff.size))


def _gemm_inputs(m, seed):
    rng = np.random.default_rng(seed)
    P = (m + 2) ** 2
    xq = rng.integers(-127, 128, (P, T, CIN), dtype=np.int8)
    uq = rng.integers(-127, 128, (P, CIN, COUT), dtype=np.int8)
    # dequantized Hadamard products of O(0.1), outputs of O(1): the
    # magnitudes of a served layer, which the fp32 tier is stated for
    deq = rng.uniform(5e-6, 2e-5, (P, 1)).astype(np.float32)
    return xq, uq, deq


@pytest.mark.parametrize("m,base", SPECS)
def test_input_transform_plain_matches_jax_reference(m, base):
    rng = np.random.default_rng(m)
    n = m + 2
    mats = _mats(m, base)
    cb = base != "canonical"
    tiles = rng.normal(size=(T, CIN, n, n)).astype(np.float32)
    v_ref = np.asarray(kref.input_transform_fp(jnp.asarray(tiles),
                                               mats["CinvT"], mats["BPT"],
                                               cb))
    v = wt.input_domain_plain(_t(tiles), _t(mats["CinvT"]),
                              _t(mats["BPT"]), changes_base=cb)
    # rtol = 1e-6, with atol = 1e-6 of the plane's max: a value that
    # cancels to near zero carries the rounding of its O(max) terms, so
    # an element-wise atol of 1e-6 is out of reach for any two summation
    # orders (measured: 3.3e-6 at values of 0.055 in planes of max 14).
    atol = 1e-6 * float(np.abs(v_ref).max())
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-6, atol=atol)
    # the port's own einsum oracle too
    v_or = tref.input_transform_fp(_t(tiles), _t(mats["CinvT"]),
                                   _t(mats["BPT"]), cb)
    np.testing.assert_allclose(v_or.numpy(), v_ref, rtol=1e-6, atol=atol)

    s = (np.abs(v_ref).max(axis=(1, 2)) / 127.0).reshape(-1, 1)
    s = s.astype(np.float32)
    xq_ref = np.asarray(kref.input_transform_ref(
        jnp.asarray(tiles), mats["CinvT"], mats["BPT"], jnp.asarray(s), cb))
    xq = wt.input_transform(_t(tiles), _t(mats["CinvT"]), _t(mats["BPT"]),
                            _t(s), changes_base=cb)
    assert xq.dtype == torch.int8 and tuple(xq.shape) == xq_ref.shape
    assert_xq_tier(xq.numpy(), xq_ref, f"F({m},3) {base}")


@pytest.mark.parametrize("m,base,bits", CASES)
def test_wino_gemm_plain_matches_jax_reference(m, base, bits):
    xq, uq, deq = _gemm_inputs(m, seed=m + (bits or 0))
    acc_ref = np.asarray(kref.wino_gemm_ref(jnp.asarray(xq),
                                            jnp.asarray(uq)))
    acc = wg.wino_gemm(_t(xq), _t(uq))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    if bits is None:
        return
    hf = acc_ref.astype(np.float32) * deq[:, :, None]
    rq = np.asarray(_hadamard_rq(jnp.asarray(np.abs(hf).max(axis=(1, 2))),
                                 bits))
    plane_ref = np.asarray(requant_plane(
        jnp.asarray(acc_ref), jnp.asarray(deq[:, :, None]),
        jnp.asarray(rq[:, :, None]), qmax(bits))).astype(np.int32)
    plane = wg.wino_gemm(_t(xq), _t(uq), requant_bits=bits, deq=_t(deq),
                         rq=_t(rq))
    np.testing.assert_array_equal(plane.numpy(), plane_ref)
    assert np.abs(plane_ref).max() == qmax(bits)


@pytest.mark.parametrize("m,base", SPECS)
def test_output_transform_plain_matches_jax_reference(m, base):
    rng = np.random.default_rng(10 + m)
    P = (m + 2) ** 2
    mats = _mats(m, base)
    cb = base != "canonical"
    h = rng.integers(-255, 256, (P, T, COUT), dtype=np.int32)
    s = rng.uniform(1e-3, 1e-2, (P, 1)).astype(np.float32)
    y_ref = np.asarray(kref.output_transform_ref(
        jnp.asarray(h), jnp.asarray(s), mats["CinvT"], mats["APT"], m, cb))
    y = wt.output_transform(_t(h), _t(s), _t(mats["CinvT"]),
                            _t(mats["APT"]), m=m, changes_base=cb)
    assert tuple(y.shape) == (T, COUT, m, m)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)
    y_or = tref.output_transform_ref(_t(h), _t(s), _t(mats["CinvT"]),
                                     _t(mats["APT"]), m, cb)
    np.testing.assert_allclose(y_or.numpy(), y_ref, rtol=1e-4, atol=1e-4)


def _output_transform_f64(h, s, mats, m, changes_base):
    """The output transform of the same H and scales in float64."""
    P, T, C = h.shape
    n = m + 2
    x = h.astype(np.float64) * s.astype(np.float64)[:, :, None]
    x = np.moveaxis(x, 0, -1).reshape(T, C, n, n)
    sw = "ij,...jk,lk->...il"
    if changes_base:
        c = mats["CinvT"].astype(np.float64)
        x = np.einsum(sw, c, x, c)
    a = mats["APT"].astype(np.float64)
    return np.einsum(sw, a, x, a)


@pytest.mark.parametrize("m,base,bits,T,C", K3_EDGE_CASES)
def test_output_transform_plain_matches_jax_reference_at_k3_edges(
        m, base, bits, T, C):
    """K3's edge shapes (T·C off 4, 16 and the chunk; n = 4/6/8; H on the
    8/9-bit grids or raw past 2^24), plain version against the JAX
    oracle. At F(6,3) Legendre the transform cancels terms ~10⁴ times its
    outputs (ROADMAP Queue C): there the port may be no farther from the
    float64 value than twice the oracle's own distance."""
    h, s = k3_edge_inputs(m, base, bits, T, C)
    mats = _mats(m, base)
    cb = base != "canonical"
    y_ref = np.asarray(kref.output_transform_ref(
        jnp.asarray(h), jnp.asarray(s), mats["CinvT"], mats["APT"], m, cb))
    y = wt.output_transform(_t(h), _t(s), _t(mats["CinvT"]),
                            _t(mats["APT"]), m=m, changes_base=cb).numpy()
    assert y.shape == (T, C, m, m)
    if m == 6 and cb:
        y64 = _output_transform_f64(h, s, mats, m, cb)
        err, err_ref = np.abs(y - y64).max(), np.abs(y_ref - y64).max()
        print(f"F(6,3) distance to float64: port {err:.3g}, JAX oracle "
              f"{err_ref:.3g}, max |y| {np.abs(y64).max():.3g}")
        assert err <= 2 * err_ref + 1e-6
    else:
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,base,bits", CASES)
def test_fused_gemm_output_plain_matches_staged_jax_composition(m, base,
                                                                bits):
    xq, uq, deq = _gemm_inputs(m, seed=20 + m + (bits or 0))
    mats = _mats(m, base)
    cb = base != "canonical"
    acc = kref.wino_gemm_ref(jnp.asarray(xq), jnp.asarray(uq))
    if bits is None:
        rq = np.ones_like(deq)
        plane_ref = np.asarray(acc.astype(jnp.float32) * deq[:, :, None])
        y_ref = kref.output_transform_ref(acc, jnp.asarray(deq),
                                          mats["CinvT"], mats["APT"], m, cb)
    else:
        hf = np.asarray(acc).astype(np.float32) * deq[:, :, None]
        rq = np.asarray(_hadamard_rq(
            jnp.asarray(np.abs(hf).max(axis=(1, 2))), bits))
        q = requant_plane(acc, jnp.asarray(deq[:, :, None]),
                          jnp.asarray(rq[:, :, None]), qmax(bits))
        plane_ref = np.asarray(q * rq[:, :, None])
        y_ref = kref.output_transform_ref(q.astype(jnp.int32),
                                          jnp.asarray(rq), mats["CinvT"],
                                          mats["APT"], m, cb)
    plane = fs.hadamard_plane_plain(_t(xq), _t(uq), _t(deq), _t(rq), bits)
    np.testing.assert_array_equal(plane.numpy(), plane_ref)
    y = fs.fused_gemm_output(_t(xq), _t(uq), _t(deq), _t(rq),
                             _t(mats["CinvT"]), _t(mats["APT"]), m=m,
                             requant_bits=bits, changes_base=cb)
    assert tuple(y.shape) == (T, COUT, m, m)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("m,base", SPECS)
def test_fused_plain_equals_staged_plain_bit_for_bit(m, base):
    """The port's fused and staged plain versions run the same IEEE
    operations in the same order, as the kernels do."""
    xq, uq, deq = _gemm_inputs(m, seed=40 + m)
    mats = {k: _t(v) for k, v in _mats(m, base).items()}
    cb = base != "canonical"
    acc = wg.wino_gemm(_t(xq), _t(uq))
    rq = (acc.float() * _t(deq)[:, :, None]).abs().amax(dim=(1, 2))
    rq = (rq.clamp_min(1e-12) / qmax(9)).reshape(-1, 1)
    hq = wg.wino_gemm(_t(xq), _t(uq), requant_bits=9, deq=_t(deq), rq=rq)
    staged = wt.output_transform(hq, rq, mats["CinvT"], mats["APT"], m=m,
                                 changes_base=cb)
    fused = fs.fused_gemm_output(_t(xq), _t(uq), _t(deq), rq,
                                 mats["CinvT"], mats["APT"], m=m,
                                 requant_bits=9, changes_base=cb)
    assert torch.equal(fused, staged)


def test_wrappers_reject_malformed_operands():
    xq, uq, _ = _gemm_inputs(4, seed=0)
    with pytest.raises(ValueError, match="chain"):
        wg.wino_gemm(_t(xq), _t(uq[:, :-1]))
    with pytest.raises(ValueError, match="deq and rq"):
        wg.wino_gemm(_t(xq), _t(uq), requant_bits=9)
    with pytest.raises(ValueError, match="n x n"):
        wt.output_transform(torch.zeros((35, 2, 2), dtype=torch.int32),
                            torch.ones((35, 1)), torch.eye(6),
                            torch.ones((4, 6)), m=4)
