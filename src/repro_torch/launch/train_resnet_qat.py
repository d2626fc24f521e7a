"""The paper's experiment: Winograd-aware quantization-aware training of
ResNet-18 on synthetic CIFAR-10 — F(4,3) in the Legendre base (or
another), flex (learnable) transforms, 8-bit casts with a 9-bit
Hadamard stage, AdamW.

    PYTHONPATH=src python -m repro_torch.launch.train_resnet_qat \\
        [--steps 120] [--batch 16] [--width 0.25] [--device cuda]

The port's counterpart of ``examples/train_resnet_qat.py``, with its
flags and defaults. Every stride-1 3×3 conv runs the fake-quant
Winograd pipeline (``winograd_fakequant``, plain PyTorch with autograd:
the JAX pipeline is plain jnp too, no Pallas kernel); stride-2 convs and
1×1 projections run direct. BatchNorm trains on batch statistics. Runs
on the card unless ``--device cpu`` is passed; TF32 stays off, since
fake-quant rounding is defined on fp32. Swap ``cifar_batch_at`` for a
real CIFAR-10 loader to reproduce the paper at full scale.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.data.pipeline import cifar_batch_at
from repro_torch.device import resolve_device
from repro_torch.models import resnet as RN
from repro_torch.models.param import init_params, param_count
from repro_torch.optim.optimizer import adamw_init, adamw_update

__all__ = ["main"]

LR, WEIGHT_DECAY = 3e-3, 1e-4        # the JAX example's AdamW settings


def _max_change(before: dict, after: dict) -> dict:
    return {k: float((after[k] - before[k]).abs().max()) for k in before}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train_resnet_qat")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--base", default="legendre",
                    choices=["canonical", "legendre", "chebyshev"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    tf32 = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        return _train(args, device)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = tf32


def _train(args, device: torch.device) -> dict:
    cfg = RN.ResNetConfig(
        width_mult=args.width, use_winograd=True, flex=True,
        wino=WinogradSpec(m=4, r=3, base=args.base,
                          quant=QuantConfig(hadamard_bits=9)))
    specs = RN.param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0))
    params["wino_flex"] = RN.init_flex(cfg)
    state = init_params(RN.state_specs(cfg),
                        torch.Generator().manual_seed(1))
    model = RN.ResNet(cfg, params, state, RN.make_engine(cfg, device=device))
    model.train()
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    print(f"ResNet18×{args.width} ({param_count(specs):,} params), "
          f"Winograd F(4×4,3×3) {args.base} base, flex, 8-bit + 9-bit "
          f"Hadamard QAT, batch {args.batch}, device {device}")

    p0 = {k: p.detach().clone() for k, p in params.items()}
    bn0 = {k: b.clone() for k, b in model.named_buffers()}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    names = list(params)
    losses, accs, step_s = [], [], []
    t_start = time.perf_counter()
    for s in range(args.steps):
        batch = cifar_batch_at(s, args.batch, device=device)
        t0 = time.perf_counter()
        loss, _, acc = RN.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        new_p, opt, _ = adamw_update(dict(zip(names, grads)), opt, params,
                                     lr=LR, weight_decay=WEIGHT_DECAY)
        with torch.no_grad():
            for k in names:
                params[k].copy_(new_p[k])
        if cuda:
            torch.cuda.synchronize(device)
        # the step ends in a device sync: the window times the work
        step_s.append(time.perf_counter() - t0)  # lint: waive=unsynced-timing
        losses.append(float(loss.detach()))
        accs.append(float(acc))
        if s % 20 == 0 or s == args.steps - 1:
            print(f"step {s:4d}  loss {losses[-1]:.4f}  acc {accs[-1]:.3f}  "
                  f"({time.perf_counter() - t_start:.0f}s)")

    moved = _max_change(p0, {k: p.detach() for k, p in params.items()})
    bn_moved = _max_change(bn0, dict(model.named_buffers()))
    # the first step pays for cuBLAS/cuDNN set-up; time the rest
    steady = step_s[1:] or step_s
    step_ms = 1e3 * sum(steady) / len(steady)
    out = {"steps": args.steps, "batch": args.batch, "width": args.width,
           "losses": losses, "accs": accs, "step_ms": step_ms,
           "images_per_s": args.batch / (step_ms / 1e3),
           "param_change": moved, "bn_change": bn_moved,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else None)}
    print(f"[train] {step_ms:.1f} ms per step (steps 1..{args.steps - 1}), "
          f"{out['images_per_s']:.0f} images/s"
          + (f", peak memory {out['peak_mem_bytes'] / 2**30:.2f} GiB"
             if cuda else ""))
    return out


if __name__ == "__main__":
    main()
