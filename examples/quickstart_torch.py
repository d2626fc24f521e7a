"""Quickstart for the PyTorch/CUDA port: the paper's quantized Winograd
convolution through the port's ConvEngine — one dispatch seam, four
backends, offline int8 serving on the hand-written CUDA kernels.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain

The counterpart of ``examples/quickstart.py``. On the card the int8 steps
run the CUDA kernels (K1 → K2 → K3 staged, K1 → K4 fused); with
``--device cpu`` they run the kernels' plain PyTorch versions.
"""
import argparse

import torch

from repro_torch.conv import ConvEngine, ConvPolicy
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import (WinogradSpec, direct_conv2d,
                                       make_matrices)
from repro_torch.device import resolve_device


def rel(y, ref):
    y, ref = y.double(), ref.double()
    return float(torch.sqrt(torch.mean((y - ref) ** 2))
                 / torch.sqrt(torch.mean(ref ** 2)))


@torch.inference_mode()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the CUDA kernels; 'cpu' "
                         "their plain versions")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 32, 32, 16), generator=gen).to(dev)        # NHWC
    w = (torch.randn((3, 3, 16, 32), generator=gen) * 0.2).to(dev)  # HWIO
    ref = direct_conv2d(x, w, "same")

    # 1. Exact Toom-Cook F(4×4, 3×3): 2.25 multiplications per output
    #    point instead of 9 — the speedup the paper preserves.
    spec = WinogradSpec(m=4, r=3, base="legendre",
                        quant=QuantConfig(hadamard_bits=9))
    print("G_C (Legendre-base kernel transform):")
    print(make_matrices(spec).GP.round(3))
    fp = ConvEngine(spec, ConvPolicy(backend="winograd_fp"), device=dev)
    print(f"fp32 Winograd vs direct conv: rel err "
          f"{rel(fp.conv2d(x, w), ref):.2e}")

    # 2. The paper's quantized QAT pipeline (Fig. 2): symmetric int8
    #    casts around every transform, 9-bit Hadamard product stage.
    qat = ConvEngine(spec, ConvPolicy(backend="winograd_fakequant"),
                     device=dev)
    print(f"int8 QAT pipeline, 9-bit Hadamard: rel err "
          f"{rel(qat.conv2d(x, w), ref):.4f}")
    ospec = WinogradSpec(m=4, r=3, base="legendre",
                         quant=QuantConfig(hadamard_bits=9,
                                           position_scales=True))
    qat_pos = ConvEngine(ospec, ConvPolicy(backend="winograd_fakequant"),
                         device=dev)
    print(f"  + per-position scales: rel err "
          f"{rel(qat_pos.conv2d(x, w), ref):.4f}")

    # 3. Policy rules: out-of-regime convs go to direct conv by
    #    themselves — no branching in model code.
    w1 = torch.randn((1, 1, 16, 32), generator=gen).to(dev)
    print("1×1 shortcut backend:",
          qat.backend_for("proj", kernel_size=1, stride=1))
    print("stride-2 conv backend:",
          qat.backend_for("down", kernel_size=3, stride=2))
    assert qat.conv2d(x, w1, layer="proj").shape == (4, 32, 32, 32)

    # 4. True-int8 serving through the CUDA kernels: prepare once
    #    (per-position int8 weights + calibrated scales), then run the
    #    hot path with no weight transform and no scale reduction per
    #    call. The staged pipeline (fused=False, K1 → K2 → K3):
    #    calibrating on a batch reproduces that batch's dynamic scales
    #    exactly.
    srv = ConvEngine(spec, ConvPolicy(backend="winograd_int8"),
                     fused=False, device=dev)
    y_dynamic = srv.conv2d(x, w, layer="conv1")     # dynamic scales
    srv.prepare([("conv1", w)])
    with srv.calibration():
        srv.conv2d(x, w, layer="conv1")             # observe statistics
    y_served = srv.conv2d(x, None, layer="conv1")   # packed hot path
    print(f"int8 kernel path: rel err {rel(y_served, ref):.4f} "
          f"(calibrated == dynamic on the calibration batch: "
          f"{bool(torch.equal(y_served, y_dynamic))})")

    # 5. Fused serving (the default, fused=True): a prepared + calibrated
    #    layer runs GEMM → 8/9-bit Hadamard requant → output transform in
    #    one kernel (K4), bit for bit the staged pipeline.
    fsd = ConvEngine(spec, ConvPolicy(backend="winograd_int8"), device=dev)
    fsd.prepare([("conv1", w)])
    with fsd.calibration():
        fsd.conv2d(x, w, layer="conv1")
    y_fused = fsd.conv2d(x, None, layer="conv1")    # single-pass kernel
    print(f"fused single-pass serving:  rel err {rel(y_fused, ref):.4f} "
          f"(bit for bit with the staged pipeline: "
          f"{bool(torch.equal(y_fused, y_served))})")


if __name__ == "__main__":
    main()
