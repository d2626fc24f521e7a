"""One int8 Winograd conv layer of the port, staged and fused, against
the same layer composed from the JAX package's pure-jnp pieces
(``ops._extract``, ``ops.prepare_weights_int8``, ``ops._tiles_abs_max``
and the ``kernels/ref.py`` oracles), on the CPU.

The port's layer runs with the JAX-prepared weights and scales, so the
comparison isolates the layer: its own packing and scales are held to
their tiers separately. Tiers as in ``test_torch_kernels``; the JAX
downstream composition consumes the port's Xq, so an allowed ±1 Xq flip
cannot masquerade as an fp32 fault.

At F(6,3) the fp32 output transform cancels terms some 10⁴ times larger
than its outputs, so any two summation orders differ by ~1e-2 on outputs
of O(1) (the JAX einsum oracle and the port's two contractions are both
that far from the float64 value of the same integer plane). There the
port is held to the float64 value instead: no farther from it than
twice the JAX oracle's own distance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import winograd as jw
from repro.core.quantization import qmax
from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro_torch.core import winograd as tw
from repro_torch.kernels import ops as tops
from test_torch_kernels import assert_xq_tier

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)

CASES = [(m, base, bits) for m in (2, 4, 6)
         for base in ("canonical", "legendre") for bits in (None, 8, 9)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_downstream(xq, uq, w_s, in_s, bits, h_amax, spec, geom):
    """JAX staged composition from Xq on: GEMM → requant → output
    transform → reassemble. Returns (y, the same output transform of the
    same integer plane in float64, this plane's Hadamard abs-max)."""
    mats = jw.make_matrices(spec)
    deq = jnp.asarray(in_s) * jnp.asarray(w_s)
    H = kref.wino_gemm_ref(jnp.asarray(xq), jnp.asarray(uq))
    amax = None
    if bits is not None:
        hf = H.astype(jnp.float32) * deq[:, :, None]
        amax = jnp.max(jnp.abs(hf), axis=(1, 2))
        use = amax if h_amax is None else jnp.asarray(h_amax).reshape(-1)
        s_h = jnp.maximum(use.reshape(-1, 1, 1), 1e-12) / qmax(bits)
        H = jnp.clip(jnp.round(hf / s_h), -qmax(bits),
                     qmax(bits)).astype(jnp.int32)
        deq = s_h[:, :, 0]
    y = kref.output_transform_ref(H, deq, mats.CinvT, mats.APT, spec.m,
                                  spec.changes_base)
    P, T, C = H.shape
    n = spec.n
    h64 = np.asarray(H, np.float64) * np.asarray(deq, np.float64)[:, :, None]
    h64 = np.moveaxis(h64, 0, -1).reshape(T, C, n, n)
    sw = "ij,...jk,lk->...il"
    if spec.changes_base:
        c = np.asarray(mats.CinvT, np.float64)
        h64 = np.einsum(sw, c, h64, c)
    a = np.asarray(mats.APT, np.float64)
    y64 = np.einsum(sw, a, h64, a)
    return (np.asarray(jops._reassemble(y, geom, spec.m)),
            np.asarray(jops._reassemble(jnp.asarray(y64), geom, spec.m)),
            amax)


def assert_fp32_tier(y, y_ref, y64, m):
    if m < 6:
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)
        return
    err, err_ref = np.abs(y - y64).max(), np.abs(y_ref - y64).max()
    print(f"F({m},3) distance to float64: port {err:.3g}, JAX oracle "
          f"{err_ref:.3g}, max |y| {np.abs(y64).max():.3g}")
    assert err <= 2 * err_ref + 1e-6


@pytest.mark.parametrize("m,base,bits", CASES)
def test_int8_layer_matches_jax_composition(m, base, bits):
    rng = np.random.default_rng(100 + 10 * m + (bits or 0))
    cin, cout = 5, 7
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
         ).astype(np.float32)
    jspec = jw.WinogradSpec(m=m, r=3, base=base)
    tspec = tw.WinogradSpec(m=m, r=3, base=base)
    n = m + 2

    # JAX pieces
    tiles_j = jops._extract(jnp.asarray(x), m, 3, n, "same")
    geom = jops._geometry(x.shape, m, 3, "same")
    uq_j, ws_j = jops.prepare_weights_int8(jnp.asarray(w), jspec)
    in_j = jops.scales_from_abs_max(jops._tiles_abs_max(tiles_j, jspec))
    uq_j, ws_j, in_j = (np.asarray(a) for a in (uq_j, ws_j, in_j))
    mats = jw.make_matrices(jspec)

    # the port's own pieces, each at its tier
    tiles_t = tops._extract(_t(x), m, 3, n, "same")
    np.testing.assert_array_equal(tiles_t.numpy(), np.asarray(tiles_j))
    assert tops._geometry(x.shape, m, 3, "same") == geom
    # Scales are fp32 maxima of three-matrix einsums that torch and XLA
    # contract in different orders: the fp32 tier, 1e-4, and 1e-3 at
    # F(6,3), whose weight transform cancels as its output transform does
    # (measured: 1.2e-4 relative at F(6,3) Legendre).
    uq_t, ws_t = tops.prepare_weights_int8(_t(w), tspec)
    np.testing.assert_allclose(ws_t.numpy(), ws_j,
                               rtol=1e-3 if m == 6 else 1e-4, atol=0)
    assert_xq_tier(uq_t.numpy(), uq_j, "u_q")
    in_t = tops.scales_from_abs_max(tops._tiles_abs_max(tiles_t, tspec))
    np.testing.assert_allclose(in_t.numpy(), in_j, rtol=1e-4, atol=0)
    xq_t = tops.quantize_input(tiles_t, _t(in_j), spec=tspec)
    xq_j = kref.input_transform_ref(tiles_j, mats.CinvT, mats.BPT,
                                    jnp.asarray(in_j), jspec.changes_base)
    assert_xq_tier(xq_t.numpy(), np.asarray(xq_j), "Xq")

    # staged (dynamic requant when the stage is on)
    y_ref, y64, amax = _jax_downstream(xq_t.numpy(), uq_j, ws_j, in_j,
                                       bits, None, jspec, geom)
    y = tops.winograd_conv2d_int8(_t(x), None, tspec, in_scales=_t(in_j),
                                  u_q=_t(uq_j), w_scales=_t(ws_j),
                                  hadamard_bits=bits, fused=False)
    assert tuple(y.shape) == (2, 9, 11, cout)
    assert_fp32_tier(y.numpy(), y_ref, y64, m)

    # fused with calibrated statistics (this plane's abs-max)
    h_amax = None if amax is None else np.asarray(amax).reshape(-1, 1)
    y_ref_c, y64_c, _ = _jax_downstream(xq_t.numpy(), uq_j, ws_j, in_j,
                                        bits, h_amax, jspec, geom)
    kw = dict(in_scales=_t(in_j), u_q=_t(uq_j), w_scales=_t(ws_j),
              hadamard_bits=bits,
              h_amax=None if h_amax is None else _t(h_amax))
    y_fused = tops.winograd_conv2d_int8(_t(x), None, tspec, fused=True, **kw)
    assert_fp32_tier(y_fused.numpy(), y_ref_c, y64_c, m)
    # the staged path with the same calibrated statistics (K2's requant
    # epilogue) equals the fused one bit for bit
    y_staged_c = tops.winograd_conv2d_int8(_t(x), None, tspec, fused=False,
                                           **kw)
    assert torch.equal(y_fused, y_staged_c)


def test_dynamic_layer_equals_prepared_layer_bit_for_bit():
    """Packing and scale derivation inside the call give the same bytes
    as doing them offline: the calibrate-equals-dynamic contract."""
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    w = _t((rng.normal(size=(3, 3, 4, 6)) / 6).astype(np.float32))
    spec = tw.WinogradSpec(m=4, r=3, base="legendre")
    uq, ws = tops.prepare_weights_int8(w, spec)
    in_s = tops.scales_from_abs_max(tops.input_abs_max(x, spec))
    dyn = tops.winograd_conv2d_int8(x, w, spec, hadamard_bits=9)
    prep = tops.winograd_conv2d_int8(x, None, spec, in_scales=in_s, u_q=uq,
                                     w_scales=ws, hadamard_bits=9)
    assert torch.equal(dyn, prep)
    with pytest.raises(ValueError, match="raw weights"):
        tops.winograd_conv2d_int8(x, None, spec)
    with pytest.raises(ValueError, match="hadamard_bits"):
        tops.execute_int8(tops._extract(x, 4, 3, 6, "same"), uq, ws, in_s,
                          spec=spec, geom=tops._geometry(x.shape, 4, 3,
                                                         "same"),
                          hadamard_bits=None, with_stats=True)
