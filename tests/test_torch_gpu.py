"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (``pytest -m gpu``). Without a card every test here skips.

Every output must match its plain version bit for bit: the integer
ones (Xq, the int32 GEMM, the requant plane) and the fp32 ones too, since
kernel and plain version run the same IEEE operations in the same order
(no FMA contraction). K4 must equal K2 → K3 (fused == staged kernels).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import wino_gemm as wg
from repro_torch.kernels.fused_serve import (fused_gemm_output,
                                             fused_gemm_output_plain)
from repro_torch.kernels.wino_gemm import (_INT_MAX, POSITIONS, TILE,
                                           wino_gemm, wino_gemm_plain)
from repro_torch.kernels.wino_transform import (input_transform,
                                                input_transform_plain,
                                                output_transform,
                                                output_transform_plain)
from repro_torch.kernels.q8_matmul import _WORKSPACES as q8_workspaces
from repro_torch.kernels.q8_matmul import q8_matmul, q8_matmul_plain
from repro_torch.kernels.q8_matmul import q8_splits as q8_matmul_splits
from repro_torch.launch import infer_resnet, train_resnet_qat

pytestmark = pytest.mark.gpu

CASES = [(m, base, bits) for m in (2, 4, 6)
         for base in ("canonical", "legendre") for bits in (None, 8, 9)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(y):
    """An fp32 tensor's bits, so that +0 and -0 differ."""
    return y.cpu().view(torch.int32)


def _inputs(m, base, seed, T=37, cin=19, cout=45):
    """Ragged shapes (no multiple of any block size), made with numpy."""
    rng = np.random.default_rng(seed)
    spec = WinogradSpec(m=m, r=3, base=base)
    n = spec.n
    P = n * n
    tiles = torch.from_numpy(rng.normal(size=(T, cin, n, n))
                             .astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.01, 0.05, (P, 1)).astype(np.float32))
    h = torch.from_numpy(rng.integers(-4000, 4000, (P, T, cout),
                                      dtype=np.int32))
    xq = torch.from_numpy(rng.integers(-127, 128, (P, T, cin),
                                       dtype=np.int8))
    uq = torch.from_numpy(rng.integers(-127, 128, (P, cin, cout),
                                       dtype=np.int8))
    deq = torch.from_numpy(rng.uniform(1e-4, 1e-3, (P, 1))
                           .astype(np.float32))
    return spec, tiles, s, h, xq, uq, deq


def _rq(xq, uq, deq, bits):
    acc = (xq.double() @ uq.double()).float() * deq[:, :, None]
    return (acc.abs().amax(dim=(1, 2)).reshape(-1, 1)
            .clamp_min(1e-12) / (2 ** (bits - 1) - 1))


@pytest.mark.parametrize("m,base,bits", CASES)
def test_kernels_match_plain_versions_on_card(m, base, bits):
    dev = _card()
    spec, tiles, s, h, xq, uq, deq = _inputs(m, base, seed=m * 10 + bits
                                             if bits else m)
    ops_cpu = ops._operands(spec, torch.device("cpu"))
    ops_dev = ops._operands(spec, dev)
    cb = spec.changes_base
    rq = torch.ones_like(deq) if bits is None else _rq(xq, uq, deq, bits)

    got = input_transform(tiles.to(dev), ops_dev["CinvT"], ops_dev["BPT"],
                          s.to(dev), changes_base=cb)
    want = input_transform_plain(tiles, ops_cpu["CinvT"], ops_cpu["BPT"],
                                 s, changes_base=cb)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)

    got = wino_gemm(xq.to(dev), uq.to(dev), requant_bits=bits,
                    deq=deq.to(dev), rq=rq.to(dev))
    want = wino_gemm_plain(xq, uq, bits, deq, rq)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)

    got = output_transform(h.to(dev), s.to(dev), ops_dev["CinvT"],
                           ops_dev["APT"], m=m, changes_base=cb)
    want = output_transform_plain(h, s, ops_cpu["CinvT"], ops_cpu["APT"],
                                  m=m, changes_base=cb)
    assert torch.equal(_bits(got), _bits(want))

    got = fused_gemm_output(xq.to(dev), uq.to(dev), deq.to(dev), rq.to(dev),
                            ops_dev["CinvT"], ops_dev["APT"], m=m,
                            requant_bits=bits, changes_base=cb)
    want = fused_gemm_output_plain(xq, uq, deq, rq, ops_cpu["CinvT"],
                                   ops_cpu["APT"], m=m, requant_bits=bits,
                                   changes_base=cb)
    assert torch.equal(_bits(got), _bits(want))
    # fused == staged kernels (K2 epilogue → K3 with rq) on the card
    if bits is not None:
        H = wino_gemm(xq.to(dev), uq.to(dev), requant_bits=bits,
                      deq=deq.to(dev), rq=rq.to(dev))
        staged = output_transform(H, rq.to(dev), ops_dev["CinvT"],
                                  ops_dev["APT"], m=m, changes_base=cb)
        assert torch.equal(_bits(got), _bits(staged))


# K4 at the kernel's edges: (m, base, requant bits, T, Cin, Cout). Cin = 3
# (the stem: rows not 16-byte aligned), 19 (ragged) and 512 (eight 64-deep
# slabs); T and Cout off every block tile; n = 4, 6, 8; every stash type.
FUSED_EDGE_CASES = [
    (4, "legendre", 9, 70, 3, 64),
    (4, "legendre", 9, 45, 19, 45),
    (4, "legendre", 9, 33, 512, 40),
    (4, "legendre", None, 100, 64, 70),
    (4, "canonical", 8, 50, 128, 96),
    (2, "legendre", 9, 300, 32, 200),
    (2, "canonical", None, 40, 3, 33),
    (6, "legendre", 9, 37, 130, 50),
    (6, "legendre", None, 20, 64, 36),
    (6, "canonical", 8, 17, 19, 65),
]


@pytest.mark.parametrize("m,base,bits,T,cin,cout", FUSED_EDGE_CASES)
def test_fused_kernel_is_bitwise_at_its_edges_on_card(m, base, bits, T, cin,
                                                      cout):
    dev = _card()
    spec, _, _, _, xq, uq, deq = _inputs(m, base, seed=T + cin + cout, T=T,
                                         cin=cin, cout=cout)
    rq = torch.ones_like(deq) if bits is None else _rq(xq, uq, deq, bits)
    o_cpu = ops._operands(spec, torch.device("cpu"))
    o_dev = ops._operands(spec, dev)
    cb = spec.changes_base
    got = fused_gemm_output(xq.to(dev), uq.to(dev), deq.to(dev), rq.to(dev),
                            o_dev["CinvT"], o_dev["APT"], m=m,
                            requant_bits=bits, changes_base=cb)
    want = fused_gemm_output_plain(xq, uq, deq, rq, o_cpu["CinvT"],
                                   o_cpu["APT"], m=m, requant_bits=bits,
                                   changes_base=cb)
    assert torch.equal(got.cpu(), want)


# K1 and K2 at their edges, the cases of chip_smoke.py's phase 3: (m,
# base, requant bits, T, Cin, Cout). T * Cin off a multiple of 16 sends
# K1 to its byte stores; T = 301 leaves a partial 256-window chunk;
# Cin = 3 (the stem) and 19 are unaligned rows for K2; n = 4, 6, 8.
K12_EDGE_CASES = [
    (4, "legendre", 9, 1000, 19, 45),
    (4, "legendre", 8, 301, 64, 45),
    (4, "legendre", None, 1000, 3, 64),
    (2, "legendre", 9, 777, 19, 45),
    (2, "canonical", None, 1000, 3, 45),
    (6, "legendre", 8, 301, 64, 45),
    (6, "canonical", 9, 1000, 19, 130),
]


@pytest.mark.parametrize("m,base,bits,T,cin,cout", K12_EDGE_CASES)
def test_input_transform_is_bitwise_at_its_edges_on_card(m, base, bits, T,
                                                         cin, cout):
    dev = _card()
    spec, tiles, s, _, _, _, _ = _inputs(m, base, seed=T + cin, T=T,
                                         cin=cin, cout=cout)
    # scales from this batch's own abs-max, as calibration makes them
    o_cpu = ops._operands(spec, torch.device("cpu"))
    o_dev = ops._operands(spec, dev)
    s = ops.scales_from_abs_max(ops._tiles_abs_max(tiles, spec))
    cb = spec.changes_base
    got = input_transform(tiles.to(dev), o_dev["CinvT"], o_dev["BPT"],
                          s.to(dev), changes_base=cb)
    want = input_transform_plain(tiles, o_cpu["CinvT"], o_cpu["BPT"], s,
                                 changes_base=cb)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,base,bits,T,cin,cout", K12_EDGE_CASES)
def test_wino_gemm_is_bitwise_at_its_edges_on_card(m, base, bits, T, cin,
                                                   cout):
    dev = _card()
    _, _, _, _, xq, uq, deq = _inputs(m, base, seed=T + cout, T=T, cin=cin,
                                      cout=cout)
    rq = None if bits is None else _rq(xq, uq, deq, bits)
    # every count of positions a block takes, not only the wrapper's choice
    for pb in POSITIONS:
        with mock.patch.object(wg, "gemm_positions", lambda *_: pb):
            got = wino_gemm(xq.to(dev), uq.to(dev), requant_bits=bits,
                            deq=None if bits is None else deq.to(dev),
                            rq=None if bits is None else rq.to(dev))
        want = wino_gemm_plain(xq, uq, bits, deq, rq)
        assert torch.equal(got.cpu(), want), pb


# K3 at its edges, the cases of chip_smoke.py's phase 3: (m, base, H, T,
# C), H on the 8- or 9-bit grid or (None) raw accumulators past 2^24.
# T * C off a multiple of 4 sends K3 to its 4-byte staging; off a
# multiple of 16 and of the chunk (128 windows) leaves a ragged store
# tail; n = 4, 6, 8, the base on and off.
K3_EDGE_CASES = [
    (4, "legendre", 9, 1000, 45),
    (4, "legendre", 8, 301, 45),
    (4, "canonical", None, 777, 19),
    (4, "legendre", None, 1000, 64),
    (2, "legendre", 9, 777, 19),
    (2, "canonical", 8, 1000, 3),
    (6, "legendre", 9, 301, 64),
    (6, "legendre", 8, 100, 45),
    (6, "canonical", None, 1000, 19),
]


def k3_edge_inputs(m, base, bits, T, C):
    """H (n², T, C) int32 and its per-position scales for one K3 edge
    case, made with numpy: grid values with rq-sized scales, or raw
    accumulators past 2^24 with deq-sized ones. Either way H·s is O(0.1)
    to O(1), as in a served layer."""
    rng = np.random.default_rng(T * C + m + (bits or 0))
    P = (m + 2) ** 2
    if bits is None:
        h = rng.integers(-2 ** 30, 2 ** 30, (P, T, C), dtype=np.int32)
        s = rng.uniform(5e-11, 2e-10, (P, 1))
    else:
        qm = 2 ** (bits - 1) - 1
        h = rng.integers(-qm, qm + 1, (P, T, C), dtype=np.int32)
        s = rng.uniform(1e-3, 1e-2, (P, 1))
    return h, s.astype(np.float32)


def test_output_transform_is_bitwise_at_its_edges_on_card():
    """Every K3 edge case, each at an aligned H and at a view one int32
    into its storage (the 4-byte staging at any T * C). The cases run in
    one test: see ROADMAP Queue C on the suite's count of tests."""
    dev = _card()
    for m, base, bits, T, C in K3_EDGE_CASES:
        case = (m, base, bits, T, C)
        spec = WinogradSpec(m=m, r=3, base=base)
        h, s = (torch.from_numpy(a)
                for a in k3_edge_inputs(m, base, bits, T, C))
        if bits is None:
            assert int(h.abs().max()) > 2 ** 24, case
        o_cpu = ops._operands(spec, torch.device("cpu"))
        o_dev = ops._operands(spec, dev)
        cb = spec.changes_base
        got = output_transform(h.to(dev), s.to(dev), o_dev["CinvT"],
                               o_dev["APT"], m=m, changes_base=cb)
        want = output_transform_plain(h, s, o_cpu["CinvT"], o_cpu["APT"],
                                      m=m, changes_base=cb)
        assert torch.equal(_bits(got), _bits(want)), case
        flat = torch.zeros(1 + h.numel(), dtype=torch.int32, device=dev)
        h_off = flat[1:].view(h.shape)
        h_off.copy_(h.to(dev))
        got = output_transform(h_off, s.to(dev), o_dev["CinvT"],
                               o_dev["APT"], m=m, changes_base=cb)
        assert torch.equal(_bits(got), _bits(want)), ("offset view", case)


# A C^-T with the Legendre base's zeros, so that K3 leaves its zero terms
# out, and an A^T under which a window of zeros comes out +0 in the plain
# order but -0 from the nonzero terms alone.
SIGNED_ZERO_CINVT = [[-1.0, 0.0, 0.0, 0.0], [0.0, 0.5, 0.0, 0.0],
                     [-1.0, 0.0, 1.0, 0.0], [0.0, -2.0, 0.0, -1.0]]
SIGNED_ZERO_APT = [[0.0, 1.0, 0.0, 2.0], [-1.0, -0.0, -0.0, -1.0]]


def signed_zero_inputs():
    """(H, scales, C^-T, A^T) with every other window all zero."""
    cinvt = torch.tensor(SIGNED_ZERO_CINVT)
    apt = torch.tensor(SIGNED_ZERO_APT)
    n = cinvt.shape[0]
    rng = np.random.default_rng(n)
    h = torch.from_numpy(rng.integers(-3, 4, (n * n, 40, 7),
                                      dtype=np.int32))
    h[:, ::2] = 0
    return h, torch.full((n * n, 1), 0.5), cinvt, apt


def test_output_transform_keeps_the_sign_of_zero_outputs_on_card():
    """Where leaving out zero terms flips the sign of a zero output, K3
    must redo the window in the plain order, with the base change off and
    on."""
    dev = _card()
    h, s, cinvt, apt = signed_zero_inputs()
    m = apt.shape[0]
    for changes_base in (False, True):
        got = output_transform(h.to(dev), s.to(dev), cinvt.to(dev),
                               apt.to(dev), m=m, changes_base=changes_base)
        want = output_transform_plain(h, s, cinvt, apt, m=m,
                                      changes_base=changes_base)
        assert int((want == 0).sum()) > 0, changes_base
        assert torch.equal(_bits(got), _bits(want)), changes_base


def test_output_transform_takes_the_full_order_without_legendre_zeros_on_card(
):
    """A C^-T without the Legendre base's zeros (flex makes the matrices
    learnable): K3 must leave no term out, at n = 4 and 6."""
    dev = _card()
    for n in (4, 6):
        m = n - 2
        rng = np.random.default_rng(10 + n)
        cinvt = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
        apt = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
        h = torch.from_numpy(rng.integers(-255, 256, (n * n, 300, 9),
                                          dtype=np.int32))
        s = torch.from_numpy(rng.uniform(1e-3, 1e-2, (n * n, 1))
                             .astype(np.float32))
        got = output_transform(h.to(dev), s.to(dev), cinvt.to(dev),
                               apt.to(dev), m=m)
        want = output_transform_plain(h, s, cinvt, apt, m=m)
        assert torch.equal(_bits(got), _bits(want)), n


@pytest.mark.parametrize("P,M,K,N", [(16, 64, 1100, 40), (36, 37, 1200, 45)])
def test_wino_gemm_is_bitwise_past_2_24_on_card(P, M, K, N):
    """Saturated ±127 operands: |acc| passes 2^24, where the requant's
    int32 → fp32 cast rounds."""
    dev = _card()
    rng = np.random.default_rng(P + K)
    xq = np.full((P, M, K), 127, dtype=np.int8)
    xq[rng.uniform(size=(P, M, K)) < 0.01] = -127
    wq = np.repeat(np.where(rng.uniform(size=(P, 1, N)) < 0.5, 127, -127)
                   .astype(np.int8), K, axis=1)
    wq[rng.uniform(size=(P, K, N)) < 0.01] *= -1
    xq, wq = torch.from_numpy(xq), torch.from_numpy(wq)
    deq = torch.from_numpy(rng.uniform(1e-7, 1e-6, (P, 1)).astype(np.float32))
    acc = wino_gemm_plain(xq, wq)
    assert float(acc.abs().max()) > 2 ** 24
    rq = _rq(xq, wq, deq, 9)
    assert torch.equal(wino_gemm(xq.to(dev), wq.to(dev)).cpu(), acc)
    got = wino_gemm(xq.to(dev), wq.to(dev), requant_bits=9, deq=deq.to(dev),
                    rq=rq.to(dev))
    assert torch.equal(got.cpu(), wino_gemm_plain(xq, wq, 9, deq, rq))


def test_kernels_refuse_views_and_shapes_they_do_not_take_on_card():
    dev = _card()
    spec, tiles, s, _, _, _, _ = _inputs(4, "legendre", seed=6)
    o = ops._operands(spec, dev)
    t = tiles.to(dev)
    s = s.to(dev)
    # K1 reads its windows with 16-byte cp.async: a view 4 bytes into its
    # storage, and a non-contiguous view, are refused
    flat = torch.zeros(1 + t.numel(), dtype=torch.float32, device=dev)
    t_off = flat[1:].view(t.shape)
    t_off.copy_(t)
    with pytest.raises(ValueError, match="aligned"):
        input_transform(t_off, o["CinvT"], o["BPT"], s)
    with pytest.raises(ValueError, match="contiguous"):
        input_transform(t.transpose(2, 3), o["CinvT"], o["BPT"], s)
    # K2: M past the grid's 32-bit row index (refused before any launch)
    M = _INT_MAX - TILE[0] + 1
    x = torch.empty((1, M, 1), dtype=torch.int8, device=dev)
    w = torch.zeros((1, 1, 8), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="grid"):
        wino_gemm(x, w)
    del x
    torch.cuda.empty_cache()


def test_launch_counters_count_kernel_launches_only():
    dev = _card()
    spec, tiles, s, h, xq, uq, deq = _inputs(4, "legendre", seed=3)
    ops_dev = ops._operands(spec, dev)
    _build.reset_launches()
    input_transform(tiles.to(dev), ops_dev["CinvT"], ops_dev["BPT"],
                    s.to(dev))
    input_transform(tiles, ops._operands(spec, torch.device("cpu"))["CinvT"],
                    ops._operands(spec, torch.device("cpu"))["BPT"], s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"input_transform": 1, "output_transform": 0,
                               "wino_gemm": 0, "fused_gemm_output": 0,
                               "q8_matmul": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    spec, tiles, s, h, xq, uq, deq = _inputs(4, "legendre", seed=4)
    ops_dev = ops._operands(spec, dev)
    with pytest.raises(ValueError):       # scales left on the CPU
        input_transform(tiles.to(dev), ops_dev["CinvT"], ops_dev["BPT"], s)
    with pytest.raises(ValueError):       # wrong dtype
        wino_gemm(xq.to(dev).to(torch.int32), uq.to(dev))
    # u_q as a contiguous view 4 bytes into its storage: K4 reads it with
    # 4-byte cp.async, so the wrapper refuses it instead of faulting
    P, cin, cout = uq.shape
    flat = torch.zeros(4 + uq.numel(), dtype=torch.int8, device=dev)
    u_off = flat[4:].view(P, cin, cout)
    u_off.copy_(uq.to(dev))
    o = ops._operands(spec, dev)
    with pytest.raises(ValueError, match="aligned"):
        fused_gemm_output(xq.to(dev), u_off, deq.to(dev),
                          torch.ones_like(deq).to(dev), o["CinvT"],
                          o["APT"], m=spec.m, requant_bits=None,
                          changes_base=spec.changes_base)


def test_launcher_serves_through_the_kernels_on_card():
    _card()
    _build.reset_launches()
    out = infer_resnet.main(["--width", "0.125", "--batch", "4",
                             "--calib-steps", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    assert out["packed_layers"] == 14
    # fused serving, then stage 5's 1-device mesh: K4 once a layer a forward
    assert [r["mesh"] for r in out["sharded"]] == [[1, 1]]
    assert _build.LAUNCHES["fused_gemm_output"] == 14 * (
        out["fused_forwards"] + out["sharded_forwards_per_mesh"])
    serving = ("input_transform", "wino_gemm", "output_transform",
               "fused_gemm_output")
    assert all(_build.LAUNCHES[k] > 0 for k in serving)
    assert _build.LAUNCHES["q8_matmul"] == 0     # not on the serving path


@pytest.mark.parametrize("M,K,N,out", [
    (130, 100, 70, torch.float32),      # ragged in every dim: byte loads
    (256, 512, 384, torch.float32),     # K, N multiples of 16: TMA
    (300, 160, 400, torch.float32),     # TMA with ragged tiles
    (8, 2048, 512, torch.float32),      # a decode M: split K
    (8, 8192, 2048, torch.float32),     # a decode M at K = 8192: split K
    (2048, 2048, 512, torch.bfloat16),  # few column tiles: split K
    (33, 1000, 24, torch.float32),      # ragged K and N, split K
    (96, 64, 200, torch.bfloat16)])
def test_q8_matmul_matches_its_plain_version_on_card(M, K, N, out):
    dev = _card()
    rng = np.random.default_rng(M + K + N)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    sx = torch.tensor([0.0137], dtype=torch.float32)
    sw = torch.from_numpy((rng.uniform(size=N) * 0.02 + 1e-4)
                          .astype(np.float32))
    _build.reset_launches()
    got = q8_matmul(xq.to(dev), wq.to(dev), sx.to(dev), sw.to(dev),
                    out_dtype=out)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["q8_matmul"] == 1
    want = q8_matmul_plain(xq, wq, sx, sw, out)
    assert got.dtype == out
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("M,out", [(64, torch.float32),
                                   (8, torch.bfloat16)])
def test_q8_matmul_is_bitwise_past_2_24_on_card(M, out):
    """Saturated ±127 operands at K = 8192: |acc| reaches 1.3e8, where
    int32 → fp32 rounds."""
    dev = _card()
    K, N = 8192, 256
    rng = np.random.default_rng(M)
    xq = np.full((M, K), 127, dtype=np.int8)
    xq[rng.uniform(size=(M, K)) < 0.01] = -127
    wq = np.repeat(np.where(rng.uniform(size=(1, N)) < 0.5, 127, -127)
                   .astype(np.int8), K, axis=0)
    wq[rng.uniform(size=(K, N)) < 0.01] *= -1
    xq, wq = torch.from_numpy(xq), torch.from_numpy(wq)
    sx = torch.tensor([0.0137], dtype=torch.float32)
    sw = torch.from_numpy((rng.uniform(size=N) * 0.02 + 1e-4)
                          .astype(np.float32))
    acc = xq.double() @ wq.double()
    assert float(acc.abs().max()) > 2 ** 24
    got = q8_matmul(xq.to(dev), wq.to(dev), sx.to(dev), sw.to(dev),
                    out_dtype=out)
    want = q8_matmul_plain(xq, wq, sx, sw, out)
    assert got.dtype == out
    assert torch.equal(got.cpu(), want)


def test_q8_matmul_split_workspace_is_left_clean_on_card():
    """Split-K calls share one zeroed workspace per stream: each call must
    leave it zero, so calls in a row (and a shape that grows it) stay bit
    for bit."""
    dev = _card()
    rng = np.random.default_rng(5)
    for M, K, N in [(8, 2048, 512), (33, 1000, 24), (8, 2048, 512),
                    (16, 4096, 1024), (8, 2048, 512)]:
        assert q8_matmul_splits(M, N, K) > 1
        xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
        sx = torch.tensor([0.0137], dtype=torch.float32)
        sw = torch.from_numpy((rng.uniform(size=N) * 0.02 + 1e-4)
                              .astype(np.float32))
        got = q8_matmul(xq.to(dev), wq.to(dev), sx.to(dev), sw.to(dev))
        assert torch.equal(got.cpu(), q8_matmul_plain(xq, wq, sx, sw))
    torch.cuda.synchronize()
    for ws, counters in q8_workspaces.values():
        assert not ws.any() and not counters.any()


def test_trainer_takes_a_step_on_card():
    _card()
    out = train_resnet_qat.main(["--width", "0.125", "--batch", "4",
                                 "--steps", "2", "--device", "cuda"])
    assert np.isfinite(out["losses"]).all()
    assert all(v > 0 for v in out["param_change"].values())
    assert all(v > 0 for v in out["bn_change"].values())
    assert out["peak_mem_bytes"] > 0


def test_serve_launcher_captures_nothing_after_warmup_on_card():
    """``launch/serve`` on the card: one CUDA graph per bucket captured at
    warm-up and none after; every request answered; in every bucket the
    served rows bit for bit with the eager forward of the same padded
    batch (the launcher checks and raises); the graphs hold K1 and K4."""
    _card()
    from repro_torch.launch import serve
    out = serve.main(["--width", "0.25", "--buckets", "1,4,16",
                      "--max-wait-ms", "2", "--rate", "2000", "--requests",
                      "256", "--solo-requests", "2", "--calib-steps", "1",
                      "--calib-batch", "16", "--autotune", "--device",
                      "cuda"])
    assert out["answered"] == 256 and out["compiles_after_warmup"] == 0
    assert out["captures"] == 3
    assert sorted(out["rows_checked"]) == [1, 4, 16]
    for b, per in out["launches_per_capture"].items():
        assert per["input_transform"] == per["fused_gemm_output"] == 14, b
    assert sum(out["replays"].values()) >= sum(
        out["batches_by_bucket"].values())
    assert set(out["tuned_tiles"].values()) <= {(32, 32), (16, 32)}
    # buckets 1 and 4 tuned at warm-up, bucket 16 at calibration
    for layer, per in out["warmup_tiles"].items():
        assert len(per) == 2 and out["tuned_at_T"][layer] not in per
        assert set(per.values()) <= {(32, 32), (16, 32)}


@pytest.mark.parametrize("m", [2, 4, 6])
def test_planner_and_autotune_run_the_kernels_on_card(m):
    """``measure_layer`` and ``autotune_blocks`` at n = 4/6/8 with the
    Hadamard stage off (qm = 0) and at 9 bits: the candidates run K1, K2
    and K3 (calibration) and K4 (the timed hot path) on the card, and K4
    is bit for bit with its plain version at every tile tuned over."""
    from repro_torch.conv import autotune
    from repro_torch.conv.planner import (LayerGeom, PlanEntry,
                                          clear_measure_cache,
                                          measure_layer)
    dev = _card()
    clear_measure_cache()
    autotune.clear_cache()
    geom = LayerGeom("l", (8, 16, 16, 64), 64)
    for bits in (None, 9):
        entry = PlanEntry("winograd_int8", m=m, r=3, base="legendre",
                          hadamard_bits=bits)
        _build.reset_launches()
        costs = measure_layer(geom, [PlanEntry(), entry], device=dev,
                              iters=2, warmup=1)
        torch.cuda.synchronize()
        assert all(np.isfinite(c.us) and c.us > 0 for c in costs)
        # the kernels' error is the plain versions' (the fp32 reference
        # convolutions sum in another order on each device)
        plain = measure_layer(geom, [entry], device="cpu", iters=1,
                              warmup=0)[0]
        assert costs[1].rel_err == pytest.approx(plain.rel_err, abs=1e-5)
        for k in ("input_transform", "wino_gemm", "output_transform",
                  "fused_gemm_output"):
            assert _build.LAUNCHES[k] > 0, (m, bits, k)
        spec = entry.spec()
        T = 8 * (-(-16 // m)) ** 2
        _build.reset_launches()
        res = autotune.autotune_blocks(spec, T, 64, 64, hadamard_bits=bits,
                                       device=dev, iters=2, warmup=1)
        assert res.measured and res.tile in ((32, 32), (16, 32))
        assert _build.LAUNCHES["fused_gemm_output"] == \
            3 * len(res.timings)
        spec_n, P = spec.n, spec.n ** 2
        rng = np.random.default_rng(m)
        xq = torch.from_numpy(rng.integers(-127, 128, (P, T, 64),
                                           dtype=np.int8)).to(dev)
        uq = torch.from_numpy(rng.integers(-127, 128, (P, 64, 64),
                                           dtype=np.int8)).to(dev)
        deq = torch.full((P, 1), 1e-4, device=dev)
        rq = torch.full((P, 1), 0.05 if bits else 1.0, device=dev)
        o = ops._operands(spec, dev)
        want = fused_gemm_output_plain(xq, uq, deq, rq, o["CinvT"], o["APT"],
                                       m=m, requant_bits=bits)
        for tile, _ in res.timings:
            got = fused_gemm_output(xq, uq, deq, rq, o["CinvT"], o["APT"],
                                    m=m, requant_bits=bits, tile=tile)
            assert torch.equal(_bits(got), _bits(want)), (m, bits, tile)
        assert spec_n == m + 2


@pytest.mark.parametrize("x_shape,cout,meshes", [
    # the stem: Cin = 3 takes the mainloop's byte path in every slab
    ((8, 32, 32, 3), 64, ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))),
    # Cout 64: 32 a shard at a model extent of 2
    ((8, 32, 32, 64), 64, ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))),
    # T = 18 tiles at F(4,3) over a (4, 2) mesh: 5-row slabs (K4 tiles
    # taller than the slab, K3's chunk tail)
    ((2, 12, 12, 4), 8, ((4, 2),))])
def test_sharded_serving_is_bitwise_single_device_on_card(x_shape, cout,
                                                          meshes):
    """``execute_int8_sharded`` over meshes of logical devices on the one
    card, through K1 and K4 (calibrated) or K2 → K3 (dynamic requant) per
    slab: bit for bit with the single-device fused and staged calls,
    F(2,3)/F(4,3)/F(6,3) in both bases, Hadamard off/8/9."""
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.launch.mesh import make_serving_mesh
    dev = _card()
    rng = np.random.default_rng(sum(x_shape) + cout)
    x = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.normal(size=(3, 3, x_shape[3], cout)) * 0.1)
                         .astype(np.float32)).to(dev)
    for m, base, bits in CASES:
        spec0 = WinogradSpec(m=m, r=3, base=base)
        u_q, w_s = ops.prepare_weights_int8(w, spec0)
        tiles = ops._extract(x, m, 3, spec0.n, "same")
        geom = ops._geometry(x.shape, m, 3, "same")
        in_s = ops.scales_from_abs_max(ops._tiles_abs_max(tiles, spec0))
        spec = WinogradSpec(m=m, r=3, base=base,
                            quant=QuantConfig(hadamard_bits=bits))
        h = None
        if bits is not None:
            _, a = ops.execute_int8(tiles, u_q, w_s, in_s, spec=spec,
                                    geom=geom, hadamard_bits=bits,
                                    with_stats=True)
            h = a.reshape(-1, 1)
        ref = ops.execute_int8(tiles, u_q, w_s, in_s, h, spec=spec,
                               geom=geom, hadamard_bits=bits, fused=True)
        ref_dyn = (ops.execute_int8(tiles, u_q, w_s, in_s, None, spec=spec,
                                    geom=geom, hadamard_bits=bits)
                   if bits is not None else None)
        for dd, dm in meshes:
            mesh = make_serving_mesh(dd, dm, host_devices=dd * dm,
                                     device=dev)
            ma = "model" if dm > 1 else None
            _build.reset_launches()
            y = ops.execute_int8_sharded(tiles, u_q, w_s, in_s, h,
                                         spec=spec, geom=geom, mesh=mesh,
                                         hadamard_bits=bits, model_axis=ma)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["input_transform"] == 1
            assert _build.LAUNCHES["fused_gemm_output"] == dd * dm
            assert torch.equal(_bits(y), _bits(ref)), (m, base, bits, dd, dm)
            if bits is None:
                continue
            _build.reset_launches()
            yd = ops.execute_int8_sharded(tiles, u_q, w_s, in_s, None,
                                          spec=spec, geom=geom, mesh=mesh,
                                          hadamard_bits=bits, model_axis=ma)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["wino_gemm"] == dd * dm
            assert _build.LAUNCHES["output_transform"] == dd * dm
            assert torch.equal(_bits(yd), _bits(ref_dyn)), \
                ("dynamic", m, base, bits, dd, dm)


def test_int8_serving_scales_on_card_equal_the_cpu():
    """The four scale functions of ``kernels/ops.py`` on the card bit for
    bit with the CPU (the weight packing on any weights: its transform
    sums in a fixed order), on inputs where fp32 ``a · (1/q)`` is not
    ``a / q``
    (``tests/test_torch_scales.py``: abs-maxima for q = 127 and 255,
    integer weights whose exact transform has such abs-maxima), with the
    8- and 9-bit Hadamard grids. A division by a host number on the card
    would take the reciprocal form and differ."""
    from test_torch_scales import reciprocal_differs, scale_inputs
    dev = _card()
    inp = scale_inputs()
    a = torch.from_numpy(inp["amax"])
    ad = a.to(dev)
    assert torch.equal(_bits(ops.scales_from_abs_max(ad)),
                       _bits(ops.scales_from_abs_max(a)))
    for bits in (8, 9):
        assert torch.equal(_bits(ops._hadamard_rq(ad, bits)),
                           _bits(ops._hadamard_rq(a, bits))), bits
        _, s_card = ops._requant(torch.zeros((36, 2, 3), device=dev),
                                 ad.reshape(-1, 1, 1), bits)
        _, s_cpu = ops._requant(torch.zeros((36, 2, 3)),
                                a.reshape(-1, 1, 1), bits)
        assert torch.equal(_bits(s_card), _bits(s_cpu)), bits
    # the reciprocal form on the card differs on these inputs
    assert not torch.equal(_bits(ad / 127.0), _bits(a / 127.0))
    w = torch.from_numpy(inp["w"])
    u_card = ops._transformed_weights(w.to(dev), inp["spec"])
    u_cpu = ops._transformed_weights(w, inp["spec"])
    assert torch.equal(_bits(u_card), _bits(u_cpu))      # exact on both
    assert reciprocal_differs(
        u_cpu.abs().amax(dim=(1, 2)).numpy(), 127).any()
    uq_card, sw_card = ops.prepare_weights_int8(w.to(dev), inp["spec"])
    uq_cpu, sw_cpu = ops.prepare_weights_int8(w, inp["spec"])
    assert torch.equal(_bits(sw_card), _bits(sw_cpu))
    assert torch.equal(uq_card.cpu(), uq_cpu)
    # any weights: the fixed-order transform packs the same bits
    rng = np.random.default_rng(1)
    for m, base, _ in CASES[::3]:
        spec = WinogradSpec(m=m, r=3, base=base)
        w = torch.from_numpy(rng.normal(size=(3, 3, 19, 45))
                             .astype(np.float32))
        u_card = ops._transformed_weights(w.to(dev), spec)
        assert torch.equal(_bits(u_card),
                           _bits(ops._transformed_weights(w, spec)))
        uq_card, sw_card = ops.prepare_weights_int8(w.to(dev), spec)
        uq_cpu, sw_cpu = ops.prepare_weights_int8(w, spec)
        assert torch.equal(_bits(sw_card), _bits(sw_cpu)), (m, base)
        assert torch.equal(uq_card.cpu(), uq_cpu), (m, base)
