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
from repro_torch.launch import infer_resnet

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
                               "wino_gemm": 0, "fused_gemm_output": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    spec, tiles, s, h, xq, uq, deq = _inputs(4, "legendre", seed=4)
    ops_dev = ops._operands(spec, dev)
    with pytest.raises(ValueError):       # scales left on the CPU
        input_transform(tiles.to(dev), ops_dev["CinvT"], ops_dev["BPT"], s)
    with pytest.raises(ValueError):       # wrong dtype
        wino_gemm(xq.to(dev).to(torch.int32), uq.to(dev))


def test_launcher_serves_through_the_kernels_on_card():
    _card()
    _build.reset_launches()
    out = infer_resnet.main(["--width", "0.125", "--batch", "4",
                             "--calib-steps", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    assert out["packed_layers"] == 14
    assert _build.LAUNCHES["fused_gemm_output"] == 14 * out["fused_forwards"]
    assert all(v > 0 for v in _build.LAUNCHES.values())
