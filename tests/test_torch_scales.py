"""The int8 serving scales of ``kernels/ops.py`` divide exactly: on
inputs where fp32 ``a · (1/q)`` is not ``a / q`` (the reciprocal form
CUDA takes for a division by a host number), each of the four scale
functions equals numpy's fp32 quotient bit for bit, for q = 127 (int8,
the 8-bit Hadamard grid) and 255 (the 9-bit one). ``tests/test_torch_gpu.py``
holds the same functions on the card against the CPU on these inputs
(``scale_inputs``).
"""
import numpy as np
import torch

from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels import ops

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)


def reciprocal_differs(a: np.ndarray, q: int) -> np.ndarray:
    """Where fp32 a · fl(1/q) differs from fp32 a / q."""
    a = np.asarray(a, np.float32)
    return a * np.float32(1.0 / q) != a / np.float32(q)


def scale_inputs(seed: int = 0) -> dict:
    """numpy inputs of the four scale functions, each with elements where
    the reciprocal form differs from the quotient:

    * ``amax`` (36,) abs-maxima over six decades, the first 36 of many
      draws whose fp32 quotients by 127 and by 255 both differ from the
      reciprocal products;
    * ``w`` (3, 3, 8, 16) integer-valued weights of F(2,3) canonical:
      their Winograd transform (multiples of 1/4) is exact in fp32 on
      any device, so the weight scales see the same abs-maxima on both
      sides, and several positions' abs-maxima differ under the
      reciprocal (``weight_positions`` lists them)."""
    rng = np.random.default_rng(seed)
    a = (10.0 ** rng.uniform(-3, 3, 4096)).astype(np.float32)
    a = a[reciprocal_differs(a, 127) & reciprocal_differs(a, 255)][:36]
    assert a.size == 36
    spec = WinogradSpec(m=2, r=3, base="canonical")
    for _ in range(256):
        w = rng.integers(-200, 201, (3, 3, 8, 16)).astype(np.float32)
        u = ops._transformed_weights(torch.from_numpy(w), spec).numpy()
        pos = np.flatnonzero(reciprocal_differs(
            np.abs(u).max(axis=(1, 2)), 127))
        if pos.size >= 2:
            return {"amax": a, "w": w, "spec": spec,
                    "weight_positions": pos}
    raise AssertionError("no weights with reciprocal-sensitive scales")


def _quotient(a, q):
    return np.maximum(np.asarray(a, np.float32), np.float32(1e-12)) / \
        np.float32(q)


def test_scale_functions_equal_the_fp32_quotient():
    inp = scale_inputs()
    a = inp["amax"]
    assert reciprocal_differs(a, 127).all() and \
        reciprocal_differs(a, 255).all()
    ta = torch.from_numpy(a)
    np.testing.assert_array_equal(ops.scales_from_abs_max(ta).numpy(),
                                  _quotient(a, 127).reshape(-1, 1))
    for bits, q in ((8, 127), (9, 255)):
        np.testing.assert_array_equal(ops._hadamard_rq(ta, bits).numpy(),
                                      _quotient(a, q).reshape(-1, 1))
        hf = torch.zeros((36, 2, 3))
        _, s_h = ops._requant(hf, ta.reshape(-1, 1, 1), bits)
        np.testing.assert_array_equal(s_h.numpy(),
                                      _quotient(a, q).reshape(-1, 1))
    w = torch.from_numpy(inp["w"])
    u = ops._transformed_weights(w, inp["spec"]).numpy()
    u_q, s_w = ops.prepare_weights_int8(w, inp["spec"])
    want = np.maximum(np.abs(u).max(axis=(1, 2)) / np.float32(127),
                      np.float32(1e-12))
    np.testing.assert_array_equal(s_w.numpy()[:, 0], want)
    np.testing.assert_array_equal(
        u_q.numpy(), np.clip(np.round(u / want[:, None, None]), -127, 127))


def test_fixed_order_weight_transform_equals_the_einsum_transform():
    """The weight packing's transform (``transform_weights_2d`` with
    quantization off: elementwise products and sums in one order, the
    same bits on the card and the CPU) against the einsums that the
    quantized transforms take, at the fp32 tier (measured: at most 1.9e-6
    of values up to ~6)."""
    from repro_torch.core.winograd import _sandwich, make_matrices
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(3, 3, 16, 32)).astype(np.float32))
    x = w.permute(2, 3, 0, 1)
    for m in (2, 4, 6):
        for base in ("canonical", "legendre"):
            spec = WinogradSpec(m=m, r=3, base=base)
            got = ops._transformed_weights(w, spec).numpy()
            mats = make_matrices(spec)

            def const(name):
                return torch.from_numpy(getattr(mats, name))
            U = _sandwich(const("Cinv"), _sandwich(const("GP"), x)) \
                if spec.changes_base else _sandwich(const("G"), x)
            want = U.reshape(16, 32, -1).movedim(-1, 0).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
