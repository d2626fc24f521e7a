"""The offline stages the int8 serving launchers share: (plan) → pack →
calibrate (→ tune K4's tiles) → checkpoint, and their flags.

``launch.infer_resnet`` and ``launch.serve`` both call
``add_offline_args`` on their parser and ``build_checkpoint`` on a
model; each then restores the checkpoint into fresh engines and serves
it its own way.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint.checkpoint import save
from repro_torch.conv.planner import PlanEntry, build_plan
from repro_torch.data.pipeline import cifar_batch_at
from repro_torch.models import resnet as RN

__all__ = ["add_offline_args", "parse_bits", "baseline_entry",
           "build_checkpoint"]


def parse_bits(text: str) -> tuple:
    """'none,8,9' → (None, 8, 9)."""
    return tuple(None if b.strip().lower() == "none" else int(b)
                 for b in text.split(","))


def add_offline_args(ap: argparse.ArgumentParser, plan_at: str) -> None:
    """``--autotune`` and ``--plan`` with its ``--plan-*`` options;
    ``plan_at`` names the batch the plan is measured at, for the help."""
    ap.add_argument("--autotune", action="store_true",
                    help="tune K4's block tile per layer shape at the "
                         "calibration batch's geometry; the tiles ride the "
                         "checkpoint, and serve calls at that geometry "
                         "(launch.serve also tunes each bucket at warm-up)")
    ap.add_argument("--plan", action="store_true",
                    help=f"measure a per-layer algorithm plan at {plan_at} "
                         f"before packing; it rides the checkpoint")
    ap.add_argument("--plan-iters", type=int, default=5,
                    help="timed calls per planner candidate")
    ap.add_argument("--plan-tiles", default="2,4,6",
                    help="Winograd output tiles the planner considers")
    ap.add_argument("--plan-bases", default="canonical,legendre",
                    help="polynomial bases the planner considers")
    ap.add_argument("--plan-bits", default="none,8,9",
                    help="Hadamard widths the planner considers ('none': "
                         "the requant stage off)")


def baseline_entry(base: str) -> PlanEntry:
    """What the policy alone serves a Winograd-eligible layer: F(4,3) in
    ``base`` with the 9-bit Hadamard stage."""
    return PlanEntry("winograd_int8", m=4, r=3, base=base, hadamard_bits=9)


def _plan(args, cfg, plan_batch: int, device: torch.device):
    """Measure the plan at ``plan_batch``; returns it and its report: its
    entries and the routes that differ from the policy's own."""
    baseline = baseline_entry(args.base)
    geoms = RN.layer_geoms(cfg, plan_batch)
    plan, _ = build_plan(
        geoms, baseline=baseline,
        tile_sizes=tuple(int(t) for t in args.plan_tiles.split(",")),
        bases=tuple(args.plan_bases.split(",")),
        hadamard_bits=parse_bits(args.plan_bits), device=device,
        iters=args.plan_iters)
    unplanned = RN.make_engine(cfg, backend="winograd_int8", device=device)
    differ = {}
    for g in geoms:
        e = plan.get(g.layer)
        hand = (baseline if unplanned.backend_for(
            g.layer, kernel_size=g.kernel_size, stride=g.stride,
            in_channels=g.cin) == "winograd_int8" else PlanEntry())
        if e != hand:
            differ[g.layer] = f"{hand.describe()} → {e.describe()}"
    print(f"[plan] {plan.describe()}; routes that differ from the "
          f"baseline {baseline.describe()}: "
          + (", ".join(f"{l} {d}" for l, d in differ.items()) or "none"))
    return plan, {"describe": plan.describe(), "dict": plan.to_dict(),
                  "entries": {l: e.describe()
                              for l, e in plan.entries.items()},
                  "differs_from_baseline": differ}


def build_checkpoint(args, cfg, model, *, plan_batch: int,
                     calib_batch: int, device: torch.device,
                     ckpt_dir: str) -> dict:
    """(Plan at ``plan_batch``) → pack ``model``'s convs → calibrate on
    ``args.calib_steps`` batches of ``calib_batch`` (→ tune K4's tiles)
    → checkpoint into ``ckpt_dir``. Reads ``args``' ``base``, ``seed``,
    ``calib_steps`` and the flags of ``add_offline_args``. Returns the
    offline report, with the restore ``template`` of the state written."""
    out: dict = {}
    plan = None
    if args.plan:
        plan, out["plan"] = _plan(args, cfg, plan_batch, device)
    engine = RN.make_engine(cfg, backend="winograd_int8", device=device,
                            autotune=args.autotune, plan=plan)
    packed = engine.prepare(RN.conv_layers(model))
    print(f"[pack] {len(packed)} conv layers → int8 Winograd domain "
          f"(widths {cfg.widths}, {args.base} base, device {device})")
    with engine.calibration():
        for step in range(args.calib_steps):
            model(cifar_batch_at(step, calib_batch, seed=args.seed,
                                 device=device)["images"], engine)
    print(f"[calibrate] {args.calib_steps} batches × {calib_batch}")
    out["packed_layers"] = len(packed)
    if args.autotune:
        tuned = {l: p.tuned for l, p in engine.packed.items()}
        out["tuned_tiles"] = {l: t[0] for l, t in tuned.items()}
        out["tuned_at_T"] = {l: t[1] for l, t in tuned.items()}
        print(f"[autotune] K4 tile per layer (T tiles it was timed at, "
              f"batch {calib_batch}): "
              + ", ".join(f"{l} {t} (T {T})" for l, (t, T) in tuned.items()))
    path = save(ckpt_dir, 0, engine.export_state())
    print(f"[checkpoint] packed + calibrated state → {path}")
    out["template"] = engine.state_template()
    return out
