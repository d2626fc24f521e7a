"""Online int8 serving launcher: (plan) → pack → calibrate → checkpoint →
serve under continuous batching, on the port's CUDA kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --width 1.0 --buckets 1,8,64,256 --rate 4000 --requests 4096

The counterpart of ``repro.launch.serve`` (single device):

1. **offline** — random ResNet-18 weights from ``--seed``; with
   ``--plan`` a per-layer algorithm plan measured at the largest bucket
   (``conv.planner``); pack; calibrate (staged K1 → K2 → K3; with
   ``--autotune`` K4's tiles are tuned there, at the calibration
   batch's geometry); checkpoint the packed, calibrated, planned and
   tuned state (``launch.offline``).
2. **restore + warm up** — the plan is read back from the checkpoint
   without a template (``Plan.from_checkpoint``), a fresh engine built
   with it imports the state, and every bucket runs once eagerly (with
   ``--autotune``, timing K4's tiles at each layer's T of the bucket)
   and is captured into its CUDA graph (``ConvEngine.warmup``).
3. **serve** — serve-alone baselines (largest bucket, then smallest),
   then Poisson load through ``serving.ServingLoop``: p50/p99 latency,
   throughput, batch, padding and in-flight shares, and the captures after
   warm-up, which must be 0. Served rows of a sample of batches in each
   bucket are held bit for bit against the model's eager forward of the
   same padded batch (a bucket the traffic left unused is served a burst
   of its size first). With ``--trace-requests`` a second, traced load
   reads the device's busy share under load. Then drain.

Runs on the card unless ``--device cpu`` is passed (the kernels' plain
versions, no graphs). ``main`` returns the report as a dict.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import restore
from repro_torch.conv.planner import Plan
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.data.pipeline import cifar_batch_at
from repro_torch.device import resolve_device
from repro_torch.launch.offline import add_offline_args, build_checkpoint
from repro_torch.models import resnet as RN
from repro_torch.models.param import init_params
from repro_torch.serving import (ServeConfig, ServingLoop, device_put,
                                 latency_histogram, pad_batch,
                                 run_poisson_load, solo_latencies)
from repro_torch.serving.metrics import device_busy

__all__ = ["main", "IMAGE_SHAPE", "CHECK_BATCHES"]

IMAGE_SHAPE = (32, 32, 3)

#: Served batches per bucket whose rows are held bit for bit against the
#: eager forward of the same padded batch.
CHECK_BATCHES = 2


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--base", default="legendre",
                    choices=["canonical", "legendre", "chebyshev"])
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="comma-separated serving batch geometries; every "
                         "dynamic batch is padded up to one of these "
                         "captured shapes")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="partial-batch flush deadline: a lone request "
                         "never waits longer than this for companions")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--solo-requests", type=int, default=8,
                    help="requests for each serve-alone baseline")
    ap.add_argument("--calib-steps", type=int, default=2)
    ap.add_argument("--calib-batch", type=int, default=8,
                    help="calibration batch size")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary "
                         "directory removed at exit)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, images and arrivals")
    add_offline_args(ap, plan_at="the largest bucket")
    ap.add_argument("--trace-requests", type=int, default=0,
                    help="after the load, a second Poisson run of this "
                         "many requests under torch.profiler: the device's "
                         "busy share under load and its time by kernel")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the CUDA kernels and "
                         "graphs; 'cpu' runs their plain versions")
    args = ap.parse_args(argv)
    if args.calib_steps < 1:
        ap.error("--calib-steps must be >= 1")
    return args


def main(argv: Optional[list] = None) -> dict:
    args = _args(argv)
    device = resolve_device(args.device)
    if args.ckpt_dir is None:
        with tempfile.TemporaryDirectory() as d:
            return _run(args, device, d)
    return _run(args, device, args.ckpt_dir)


def _check_rows(model, engine, rows: dict, requests, batches,
                checked: dict) -> None:
    """Hold the served rows of up to ``CHECK_BATCHES`` of ``batches`` in
    each bucket bit for bit against the model's eager forward (no graph) of
    the same padded batch; count them in ``checked`` ({bucket: n}).
    ``rows``: {rid: (request index, served row)}."""
    for b in batches:
        if checked.get(b.bucket, 0) >= CHECK_BATCHES:
            continue
        idx = [rows[rid][0] for rid in b.rids]
        x = device_put(pad_batch(requests[idx], b.bucket), engine.device)
        want = model(x, engine)[:b.n].cpu().numpy()
        got = np.stack([rows[rid][1] for rid in b.rids])
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise AssertionError(
                f"bucket {b.bucket}: served rows of requests {b.rids} "
                f"differ from the eager forward of the same padded batch "
                f"(max |difference| {np.abs(got - want).max()})")
        checked[b.bucket] = checked.get(b.bucket, 0) + 1


def _traced_load(loop, requests, args) -> dict:
    """A second Poisson run of ``--trace-requests`` requests under
    ``torch.profiler``: the device's busy share under load (the union of
    its intervals over the traced window) and its time by kernel. Its
    latencies carry the profiler's host overhead, so the untraced run's
    stand as the report's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = len(loop.batches)
    acts = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        rep = run_poisson_load(loop, rate_rps=args.rate,
                               n_requests=args.trace_requests,
                               make_request=lambda i: requests[
                                   i % len(requests)], seed=args.seed + 1)
        if loop.device.type == "cuda":
            torch.cuda.synchronize(loop.device)
    busy, window = device_busy(prof)
    by_kernel: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    out = {"requests": args.trace_requests, "wall_s": rep.wall_s,
           "device_busy_ms": busy, "window_ms": window,
           "busy_share": busy / window if window else 0.0,
           "device_ms_summed": sum(by_kernel.values()),
           "batches": len(loop.batches) - start, "top_kernels_ms": top}
    print(f"[trace] {args.trace_requests} more requests under the "
          f"profiler: device busy {busy:.3f} ms (union of its intervals) "
          f"of a {window:.3f} ms traced window "
          f"({100 * out['busy_share']:.1f}%); top device time: "
          + ", ".join(f"{k[:50]} {v:.3f} ms" for k, v in
                      list(top.items())[:6]))
    return out


def _burst(loop, requests, n: int, rows: dict):
    """Submit ``n`` requests back to back (they coalesce into one batch
    of up to the largest bucket) and wait for them: the buckets the
    Poisson traffic left unused get served batches this way."""
    futs = [(i % len(requests), loop.submit(requests[i % len(requests)],
                                            client="burst"))
            for i in range(n)]
    for i, f in futs:
        rows[f.rid] = (i, f.result())


@torch.inference_mode()
def _run(args, device: torch.device, ckpt_dir: str) -> dict:
    buckets = tuple(sorted(int(b) for b in args.buckets.split(",")))
    cfg = RN.ResNetConfig(
        width_mult=args.width,
        wino=WinogradSpec(m=4, r=3, base=args.base,
                          quant=QuantConfig(hadamard_bits=9)))
    params = init_params(RN.param_specs(cfg),
                         torch.Generator().manual_seed(args.seed))
    state = init_params(RN.state_specs(cfg),
                        torch.Generator().manual_seed(args.seed + 1))
    fp = RN.make_engine(cfg, backend="direct", device=device)
    model = RN.ResNet(cfg, params, state, fp)

    # Offline (stage 1).
    out = build_checkpoint(args, cfg, model, plan_batch=buckets[-1],
                           calib_batch=args.calib_batch, device=device,
                           ckpt_dir=ckpt_dir)
    template = out.pop("template")

    # Online: restore → warm up (stage 2). The plan first, without a
    # template: it decides which layers the template holds.
    plan = Plan.from_checkpoint(ckpt_dir)
    if plan is not None:
        print(f"[plan] serving the checkpoint's plan: {plan.describe()}")
    served = RN.make_engine(cfg, backend="winograd_int8", device=device,
                            plan=plan, autotune=args.autotune)
    tree, _ = restore(ckpt_dir, template)
    served.import_state(tree)
    served.serve_fn = RN.serving_forward(model, served)
    loop = ServingLoop(served.serve_fn, IMAGE_SHAPE,
                       ServeConfig(buckets=buckets,
                                   max_wait_ms=args.max_wait_ms),
                       engine=served)
    loop.start()
    out["warmup_s"] = {g[0]: s for g, s in loop.warmup_times.items()}
    for g, secs in loop.warmup_times.items():
        print(f"[warmup] geometry {g}: {secs:.3f}s (eager run + capture "
              f"+ replay)")
    if args.autotune:
        by_layer: dict = {}
        for (layer, T), tile in sorted(served.tuned_tiles.items()):
            by_layer.setdefault(layer, {})[T] = tile
        out["warmup_tiles"] = by_layer
        print("[autotune] K4 tile per layer at each served T, tuned at "
              "warm-up: " + ", ".join(f"{l} {per}"
                                      for l, per in by_layer.items()))

    # Serve-alone baselines through the same graphs.
    solo_imgs = cifar_batch_at(100, max(args.solo_requests, 1),
                               seed=args.seed)["images"].numpy()
    solo = solo_latencies(served.serve_fn, solo_imgs, bucket=buckets[-1],
                          device=device)
    floor = solo_latencies(served.serve_fn, solo_imgs, bucket=buckets[0],
                           device=device)
    out["solo_ms"] = 1e3 * sum(solo) / len(solo)
    out["floor_ms"] = 1e3 * sum(floor) / len(floor)
    print(f"[solo] serve-each-alone through bucket {buckets[-1]}: mean "
          f"{out['solo_ms']:.3f} ms/request "
          f"({1e3 / out['solo_ms']:.2f} req/s); latency floor (bucket "
          f"{buckets[0]}): {out['floor_ms']:.3f} ms")

    # Poisson load through the continuous-batching loop; the payloads
    # are made in bulk first, so making them delays no arrival.
    requests = cifar_batch_at(1000, args.requests,
                              seed=args.seed)["images"].numpy()
    first_batch = len(loop.batches)
    report = run_poisson_load(loop, rate_rps=args.rate,
                              n_requests=args.requests,
                              make_request=lambda i: requests[i],
                              seed=args.seed, keep_outputs=True)
    print("[serve] " + report.describe())
    edges, counts = latency_histogram([s * 1e3 for s in report.latencies_s],
                                      bins=8)
    print("[serve] latency histogram (ms): "
          + " ".join(f"{e:.2f}:{c}" for e, c in zip(edges[:-1], counts)))
    speedup = report.throughput_rps * out["solo_ms"] / 1e3
    print(f"[serve] continuous batching vs serve-alone (bucket "
          f"{buckets[-1]}): {speedup:.2f}× throughput at p50 "
          f"{report.p50_ms():.3f} ms / p99 {report.p99_ms():.3f} ms")
    answered = sum(1 for y in report.outputs
                   if y is not None and y.shape == (cfg.num_classes,)
                   and bool(np.isfinite(y).all()))
    if answered != args.requests:
        raise AssertionError(f"{args.requests - answered} of "
                             f"{args.requests} requests went unanswered "
                             f"or came back malformed")
    if report.compiles != 0:
        raise AssertionError(
            f"{report.compiles} captures or kernel builds on the hot path "
            f"— every serving geometry must be captured at warm-up")
    load_batches = loop.batches[first_batch:]
    rows = {rid: (i, y) for i, (rid, y) in enumerate(zip(report.rids,
                                                         report.outputs))}
    checked: dict = {}
    _check_rows(model, served, rows, requests, load_batches, checked)
    for b in buckets:                  # buckets the traffic left unused
        for _ in range(3):
            if checked.get(b, 0) >= 1:
                break
            start = len(loop.batches)
            _burst(loop, requests, b, rows)
            _check_rows(model, served, rows, requests,
                        loop.batches[start:], checked)
    print(f"[serve] served rows bit for bit with the eager forward of the "
          f"same padded batch: batches checked per bucket {checked}")
    missing = [b for b in buckets if not checked.get(b)]
    if missing:
        raise AssertionError(f"no served batch of bucket(s) {missing} "
                             f"could be checked")
    if args.trace_requests:
        out["trace"] = _traced_load(loop, requests, args)
    if loop.compiles_after_warmup != 0:
        raise AssertionError(f"{loop.compiles_after_warmup} captures or "
                             f"kernel builds on the hot path")
    loop.shutdown(drain=True)
    print("[serve] drained and shut down")
    fwd = served.serve_fn
    out.update({
        "buckets": buckets, "requests": args.requests, "answered": answered,
        "rate_rps": args.rate, "throughput_rps": report.throughput_rps,
        "p50_ms": report.p50_ms(), "p99_ms": report.p99_ms(),
        "mean_batch": report.mean_batch,
        "padding_frac": report.padding_frac,
        "in_flight_frac": report.in_flight_frac, "wall_s": report.wall_s,
        "compiles_after_warmup": report.compiles,
        "captures": fwd.captures,
        "batches_by_bucket": {b: sum(1 for r in load_batches
                                     if r.bucket == b) for b in buckets},
        "rows_checked": checked,
        "launches_per_capture": {k[0]: v for k, v in
                                 fwd.launches_per_capture.items()},
        "replays": {k[0]: v for k, v in fwd.replays.items()},
        "speedup_vs_solo": speedup})
    return out


if __name__ == "__main__":
    main()
