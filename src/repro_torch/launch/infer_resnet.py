"""Int8 ResNet serving launcher: pack → calibrate → checkpoint → serve,
on the port's CUDA kernels.

    PYTHONPATH=src python -m repro_torch.launch.infer_resnet \\
        --width 1.0 --batch 256 --calib-steps 2

The counterpart of ``repro.launch.infer_resnet`` stages 1–4:

1. **pack** — transform every eligible conv's weights once into
   per-position int8 (``ConvEngine.prepare``).
2. **calibrate** — run calibration batches; the engine turns per-layer,
   per-position input and Hadamard-product maxima into static scales
   (staged pipeline: K1 → K2 → K3).
3. **checkpoint** — serialize the packed + calibrated state in the JAX
   package's format (atomic manifest write).
4. **serve** — restore into a fresh engine and serve one batch fused
   (K1 → K4 per Winograd conv), staged with calibrated requant
   (K1 → K2 with its requant epilogue → K3) and dynamically (no
   calibration: K1 → K2 → K3); report agreement, and gate that fused
   serving adds no error over staged against the fp32 reference, the
   ``direct`` network (``F.conv2d`` with TF32 off).

Runs on the card unless ``--device cpu`` is passed, which runs the
kernels' plain versions. The ``--plan``/``--autotune`` stages and
sharded serving of the JAX launcher are not ported yet.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import restore, save
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.data.pipeline import cifar_batch_at
from repro_torch.device import resolve_device
from repro_torch.models import resnet as RN
from repro_torch.models.param import init_params

__all__ = ["main", "rel"]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS(a − b) / RMS(b), in float64 (random full-width networks reach
    logits whose squares overflow fp32)."""
    a = a.detach().cpu().to(torch.float64)
    b = b.detach().cpu().to(torch.float64)
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b ** 2)))


def _agree(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).to(torch.float64).mean())


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.infer_resnet")
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--base", default="legendre",
                    choices=["canonical", "legendre", "chebyshev"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calib-steps", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary "
                         "directory removed at exit)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the CUDA kernels; 'cpu' "
                         "runs their plain PyTorch versions")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and images")
    args = ap.parse_args(argv)
    if args.calib_steps < 1:
        ap.error("--calib-steps must be >= 1 (int8 serving needs "
                 "calibrated scales)")
    device = resolve_device(args.device)
    if args.ckpt_dir is None:
        with tempfile.TemporaryDirectory() as d:
            return _run(args, device, d)
    return _run(args, device, args.ckpt_dir)


@torch.inference_mode()
def _run(args, device: torch.device, ckpt_dir: str) -> dict:
    cfg = RN.ResNetConfig(
        width_mult=args.width,
        wino=WinogradSpec(m=4, r=3, base=args.base,
                          quant=QuantConfig(hadamard_bits=9)))
    params = init_params(RN.param_specs(cfg),
                         torch.Generator().manual_seed(args.seed))
    state = init_params(RN.state_specs(cfg),
                        torch.Generator().manual_seed(args.seed + 1))

    # 1. pack — offline weight transform + int8 quantization
    engine = RN.make_engine(cfg, backend="winograd_int8", device=device)
    model = RN.ResNet(cfg, params, state, engine)
    packed = engine.prepare(RN.conv_layers(model))
    print(f"[pack] {len(packed)} conv layers → int8 Winograd domain "
          f"(widths {cfg.widths}, {args.base} base, device {device})")

    # 2. calibrate — per-layer per-position input + Hadamard scales
    with engine.calibration():
        for step in range(args.calib_steps):
            batch = cifar_batch_at(step, args.batch, seed=args.seed,
                                   device=device)
            model(batch["images"])
    print(f"[calibrate] {args.calib_steps} batches × {args.batch}")

    # 3. checkpoint the serving state
    path = save(ckpt_dir, 0, engine.export_state())
    print(f"[checkpoint] packed+calibrated state → {path}")

    # 4. serve from the checkpoint with fresh engines
    served = RN.make_engine(cfg, backend="winograd_int8", device=device)
    served.prepare(RN.conv_layers(model))
    tree, _ = restore(ckpt_dir, served.state_template())
    served.import_state(tree)
    staged = RN.make_engine(cfg, backend="winograd_int8", fused=False,
                            device=device)
    staged.import_state(tree)
    dynamic = RN.make_engine(cfg, backend="winograd_int8",  # no prepare
                             device=device)
    fp = RN.make_engine(cfg, backend="direct", device=device)

    images = cifar_batch_at(10_000, args.batch, seed=args.seed,
                            device=device)["images"]
    y_fused = model(images, served)
    y_staged = model(images, staged)
    y_dyn = model(images, dynamic)
    y_fp = model(images, fp)

    rel_fs, agree_fs = rel(y_fused, y_staged), _agree(y_fused, y_staged)
    err_fused, err_staged = rel(y_fused, y_fp), rel(y_staged, y_fp)
    print(f"[serve] fused vs staged pipeline: rel {rel_fs:.4f}, argmax "
          f"agreement {agree_fs:.2f}")
    print(f"[serve] calibrated-int8 vs dynamic-int8: rel "
          f"{rel(y_fused, y_dyn):.4f}, argmax agreement "
          f"{_agree(y_fused, y_dyn):.2f}")
    print(f"[serve] vs fp32 direct reference: fused rel {err_fused:.4f}, "
          f"staged rel {err_staged:.4f}, fused argmax agreement "
          f"{_agree(y_fused, y_fp):.2f}")
    for name, y in (("fused", y_fused), ("staged", y_staged),
                    ("dynamic", y_dyn), ("fp", y_fp)):
        if tuple(y.shape) != (args.batch, cfg.num_classes) or \
                not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} logits: shape {tuple(y.shape)}, "
                                 f"finite {bool(torch.isfinite(y).all())}")
    # Per layer fused equals staged; through 14 re-quantizing layers the
    # meaningful network check is that fused adds no error vs the fp
    # reference beyond what staged has (docs/parity.md).
    assert abs(err_fused - err_staged) < 0.05, \
        (f"fused serving adds error over staged vs the fp reference: "
         f"{err_fused:.4f} vs {err_staged:.4f}")
    np.testing.assert_array_less(err_fused, 1.0)
    return {"packed_layers": len(packed), "fused_forwards": 1,
            "staged_forwards": 1, "dynamic_forwards": 1,
            "calib_forwards": args.calib_steps,
            "rel_fused_staged": rel_fs, "agree_fused_staged": agree_fs,
            "rel_fused_fp": err_fused, "rel_staged_fp": err_staged,
            "rel_fused_dynamic": rel(y_fused, y_dyn),
            "agree_fused_fp": _agree(y_fused, y_fp)}


if __name__ == "__main__":
    main()
