"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (``pytest -m gpu``). Without a card every test here skips.

Integer outputs (Xq, the int32 GEMM, the requant plane) must match the
plain versions bit for bit. The fp32 outputs too: kernel and plain
version run the same IEEE operations in the same order (no FMA
contraction), so the stated bound, 1e-6 of the output's max, is slack.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels.fused_serve import (fused_gemm_output,
                                             fused_gemm_output_plain)
from repro_torch.kernels.wino_gemm import wino_gemm, wino_gemm_plain
from repro_torch.kernels.wino_transform import (input_transform,
                                                input_transform_plain,
                                                output_transform,
                                                output_transform_plain)
from repro_torch.kernels.q8_matmul import _WORKSPACES as q8_workspaces
from repro_torch.kernels.q8_matmul import q8_matmul, q8_matmul_plain
from repro_torch.kernels.q8_matmul import q8_splits as q8_matmul_splits
from repro_torch.launch import infer_resnet, train_resnet_qat

pytestmark = pytest.mark.gpu

FP32_REL = 1e-6

CASES = [(m, base, bits) for m in (2, 4, 6)
         for base in ("canonical", "legendre") for bits in (None, 8, 9)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


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
    assert _rel(got.cpu(), want) <= FP32_REL

    got = fused_gemm_output(xq.to(dev), uq.to(dev), deq.to(dev), rq.to(dev),
                            ops_dev["CinvT"], ops_dev["APT"], m=m,
                            requant_bits=bits, changes_base=cb)
    want = fused_gemm_output_plain(xq, uq, deq, rq, ops_cpu["CinvT"],
                                   ops_cpu["APT"], m=m, requant_bits=bits,
                                   changes_base=cb)
    assert _rel(got.cpu(), want) <= FP32_REL
    # fused == staged kernels (K2 epilogue → K3 with rq) on the card
    if bits is not None:
        H = wino_gemm(xq.to(dev), uq.to(dev), requant_bits=bits,
                      deq=deq.to(dev), rq=rq.to(dev))
        staged = output_transform(H, rq.to(dev), ops_dev["CinvT"],
                                  ops_dev["APT"], m=m, changes_base=cb)
        assert _rel(got, staged) <= FP32_REL


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
    assert _build.LAUNCHES["fused_gemm_output"] == 14 * out["fused_forwards"]
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
