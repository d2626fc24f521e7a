"""LM training launcher: a fault-tolerant loop around the sharded train
step (the port's counterpart of ``repro.launch.train``, with its flags).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tiny --steps 50 --batch 8 --seq 128 [--model-parallel 2] \\
        [--host-devices 4] [--device cpu]

Runs on the card unless ``--device`` names another device. The mesh is
the JAX launcher's, ``make_mesh_for(<devices>, --model-parallel)``, over
every card (or the CPU), or over ``--host-devices N`` logical devices
laid over them; ``"pod"`` in its axes makes the step multi-pod. A 1 × 1
mesh computes the one-device step bit for bit.

Fault tolerance, as the JAX launcher's:
  * a checkpoint every ``--checkpoint-every`` steps (atomic, with a
    manifest, the oldest pruned; ``repro_torch.checkpoint``), in the JAX
    package's format and train-state keys: ``0/<param path>`` for the
    parameters, ``1/m/...``, ``1/v/...`` and ``1/count`` for AdamW's;
  * ``--resume`` restores the train state from the latest complete
    checkpoint; the data is a pure function of the step, so a resumed run
    continues bit for bit;
  * SIGTERM/SIGINT (preemption) takes a final synchronous checkpoint and
    exits 0.

Checkpoints hold whole leaves, so a run saved on one mesh resumes on
another.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch.checkpoint.checkpoint import (Checkpointer, latest_step,
                                               restore)
from repro_torch.configs import ARCHS, tiny_variant
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Sharded, gather_tree
from repro_torch.launch.mesh import logical_devices, make_mesh_for
from repro_torch.launch.steps import init_train_state, make_train_setup
from repro_torch.models.param import tree_leaves

__all__ = ["build_run", "main"]


def build_run(args) -> RunConfig:
    cfg = ARCHS[args.arch]
    if args.tiny:
        cfg = tiny_variant(cfg)
    return RunConfig(
        model=cfg, seq_len=args.seq, global_batch=args.batch,
        microbatch=args.microbatch, lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, seed=args.seed,
    )


def _state(params: dict, opt_state: dict) -> dict:
    """The checkpointed train state: the JAX launcher's (params,
    opt_state) tuple, whose key paths start with its index."""
    return {"0": params, "1": opt_state}


def _load(params: dict, opt_state: dict, directory: str) -> int:
    """The latest checkpoint copied into the live tensors (block by block
    where a leaf is sharded); its step."""
    live = _state(params, opt_state)
    saved, step = restore(directory, live)
    with torch.no_grad():
        for d, s in zip(tree_leaves(live), tree_leaves(saved)):
            if isinstance(d, Sharded):
                d.assign_(s)
            else:
                d.copy_(s)
    return step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--checkpoint-dir", default="checkpoints/run")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="lay N logical devices over the cards (or the "
                         "CPU) for the mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    run = build_run(args)
    mesh = make_mesh_for(len(logical_devices(dev, args.host_devices)),
                         args.model_parallel, device=dev,
                         host_devices=args.host_devices)
    print(f"[train] mesh {mesh.shape} over {len(mesh.distinct())} "
          f"device(s)")
    setup = make_train_setup(run, mesh=mesh)
    params, opt_state = init_train_state(run, run.seed, mesh=mesh)

    start_step = 0
    if args.resume and latest_step(run.checkpoint_dir) is not None:
        start_step = _load(params, opt_state, run.checkpoint_dir)
        print(f"[train] resumed from step {start_step}")

    ckpt = Checkpointer(run.checkpoint_dir, keep=run.keep_checkpoints)
    stop = {"now": False}

    def _on_signal(signum, frame):
        print(f"[train] signal {signum}: checkpointing and exiting")
        stop["now"] = True

    handlers = {s: signal.signal(s, _on_signal)
                for s in (signal.SIGTERM, signal.SIGINT)}
    losses, grad_norms = [], []

    def sync():
        if dev.type == "cuda":
            for d in mesh.distinct():
                torch.cuda.synchronize(d)

    try:
        t_last, last_logged = time.perf_counter(), start_step - 1
        for step in range(start_step, run.total_steps):
            batch = batch_at(run.model, run.seq_len, run.global_batch,
                             step, run.seed, device=mesh.first)
            params, opt_state, metrics = setup.step_fn(params, opt_state,
                                                       batch, step)
            losses.append(metrics["loss"])
            grad_norms.append(metrics["grad_norm"])
            if step % args.log_every == 0 or step == run.total_steps - 1:
                # close the timing window on finished device work
                sync()
                dt = time.perf_counter() - t_last  # lint: waive=unsynced-timing
                t_last = time.perf_counter()
                tok_s = (step - last_logged) * run.seq_len * \
                    run.global_batch / max(dt, 1e-9)
                last_logged = step
                print(f"[train] step={step} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"tok/s={tok_s:,.0f}")
            if stop["now"] or (step > 0 and
                               step % run.checkpoint_every == 0):
                ckpt.save_sync(step + 1, _state(params, opt_state))
                if stop["now"]:
                    print("[train] preemption checkpoint complete")
                    sys.exit(0)
        ckpt.save_sync(run.total_steps, _state(params, opt_state))
        ckpt.wait()
        print("[train] done")
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    return {"params": gather_tree(params),
            "opt_state": gather_tree(opt_state), "mesh": mesh,
            "start_step": start_step,
            "losses": [float(v) for v in losses],
            "grad_norms": [float(v) for v in grad_norms]}


if __name__ == "__main__":
    main()
