"""Dry run: cost every (arch × shape × mesh) cell of the production
meshes without a device (the port's counterpart of
``repro.launch.dryrun``).

For each cell this builds the *real* train/prefill/decode step (the
functions ``launch/train.py`` and the serving loop run, from
``launch.steps``) over ``launch.mesh.make_production_mesh``'s (16, 16)
or (2, 16, 16) mesh, and runs it once under fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): no weight is
allocated, nothing is downloaded and no kernel runs. Each mesh position
is a fake device of its own (``cpu:k``, k its row-major index), so every
op and every copy between positions is seen where it runs, by
``analysis.op_cost.OpCost``. It records:

  * ``memory.argument_size_in_bytes``: the bytes of the step's
    arguments one device holds under their shardings (every parameter,
    moment and cache leaf's block, the batch's row slab; a leaf whole
    over the mesh counts whole, as on every device that holds it);
  * flops, bytes and transcendentals per device, from the ops;
  * collective bytes per device by kind (what a position takes in from
    the others);

and writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

One position, not every one: the single controller walks every row and
model block in Python, and every position of a data × model mesh does
alike work where the shapes divide (``pspec`` cuts only what divides).
So the step runs the work of mesh position 0 alone (the steps'
``first_only``): the other rows and blocks stand in by empty tensors of
their shapes, and the numbers are position 0's. Position 0
is the largest: it computes its row's row-local work (norms, the
softmax, the residual stream) and its model block of every cut product,
where the other blocks of its row compute their blocks only. A batch
that does not cut over every data position leaves the others as
replicas that compute nothing; the record warns of it. The numbers
equal those of a full walk of every position at position 0
(``tests/test_torch_dryrun.py``).

Loop-aware, as the JAX counter multiplies a while body by its trip
count: every layer of the stack (every unit of the hybrid's block
pattern) and every microbatch does alike work, so the step runs at one
and two units and at two and three microbatches, and each count is taken
to the run's depth and microbatches (``_extrapolate``); the train step's
AdamW update is counted at the run's size.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --keep-going
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import warnings

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.op_cost import COLLECTIVES, OpCost, Tally
from repro_torch.configs import SHAPES, all_cells, run_config
from repro_torch.core import quantization
from repro_torch.data.pipeline import input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh, Sharded
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.models.param import tree_paths
from repro_torch.optim.optimizer import adamw_init

__all__ = ["run_cell", "cost_step", "position_mesh", "argument_bytes"]

OUT = "results/dryrun_torch"


def position_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` with every position a device of its own (``cpu:k``, k its
    row-major index): fake tensors keep the index, so each op and copy is
    seen at its position. Only fake tensors live on such devices."""
    devs = np.array([torch.device("cpu", k)
                     for k in range(mesh.devices.size)], dtype=object)
    return Mesh(devs.reshape(mesh.devices.shape), mesh.axis_names)


def _shard_bytes(shape, dtype: torch.dtype, sharding) -> int:
    """Bytes of one device's block of a leaf under ``sharding``."""
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    n = math.prod(shape)
    for e in spec:
        n //= shd.axis_extent(sharding.mesh, e)
    return n * torch.empty((), dtype=dtype).element_size()


def _tree(specs: dict, fn) -> dict:
    out: dict = {}
    for path, s in tree_paths(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(path, s)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _inputs(run, kind: str, mesh: Mesh) -> tuple:
    """(the step's arguments as fake tensors placed over ``mesh``, {name:
    (shape, dtype, sharding)} of every argument leaf)."""
    cfg = run.model
    seq, gb = run.seq_len, run.global_batch
    first = mesh.first
    rule_map = steps._rules(mesh, run.fsdp)
    specs = registry.get_model(cfg).param_specs(cfg)
    shard = steps.param_shardings(cfg, mesh, fsdp=run.fsdp)
    leaves = {}

    def param(path, s):
        sh = _at(shard, path)
        leaves["params/" + "/".join(path)] = (s.shape, s.dtype, sh)
        return Sharded.place(torch.empty(s.shape, dtype=s.dtype,
                                         device=first), sh)
    params = _tree(specs, param)
    one = shd.NamedSharding(mesh, shd.P())
    if kind == "train":
        mdt = getattr(torch, run.moment_dtype)
        for path, s in tree_paths(specs):
            for k in ("m", "v"):
                leaves[f"opt/{k}/" + "/".join(path)] = (
                    s.shape, mdt, _at(shard, path))
        leaves["opt/count"] = ((), torch.int32, one)
        opt = adamw_init(params, mdt)
        batch_specs = input_specs(cfg, seq, gb, "train")
    else:
        batch_specs = input_specs(cfg, seq, gb, kind)
    batch = {k: torch.empty(shape, dtype=dt, device=first)
             for k, (shape, dt) in batch_specs.items()}
    for k, sh in steps._batch_shardings(mesh, batch, rule_map).items():
        leaves[f"batch/{k}"] = (tuple(batch[k].shape), batch[k].dtype, sh)
    if kind == "train":
        return (params, opt, batch, 1), leaves
    if kind == "prefill":
        return (params, batch), leaves
    whole = registry.get_model(cfg).init_cache(cfg, gb, seq, device=first)
    c_sh = steps._cache_pspec(cfg, whole, mesh, rule_map)
    cache = {}
    for name, t in whole.items():
        leaves[f"cache/{name}"] = (tuple(t.shape), t.dtype, c_sh[name])
        cache[name] = Sharded.place(t, c_sh[name])
    return (params, cache, batch["tokens"], batch["pos"]), leaves


def argument_bytes(leaves: dict) -> int:
    """One device's bytes of the step's arguments (``_inputs``' leaves)."""
    return sum(_shard_bytes(shape, dt, sh)
               for shape, dt, sh in leaves.values())


def _unit(cfg) -> tuple:
    """(layers in the stack's repeating unit, layers past its last whole
    unit): one layer, or the hybrid's block pattern."""
    u = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    return u, cfg.n_layers % u


def _microbatches(run) -> int:
    """The train step's microbatches (1: no accumulation loop)."""
    if not run.microbatch or run.microbatch >= run.global_batch:
        return 1
    return run.global_batch // run.microbatch


def _sized(run, units: int, micro: int):
    """``run`` with ``units`` repeating units of layers (its remainder
    kept) and ``micro`` microbatches of its size."""
    u, rem = _unit(run.model)
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, n_layers=units * u + rem))
    if micro > 1:
        run = dataclasses.replace(run, global_batch=run.microbatch * micro)
    return run


def _count(run, kind: str, pmesh: Mesh, first_only: bool, attribute: int,
           part: str = "step") -> OpCost:
    """An ``OpCost`` over one call of ``run``'s ``kind`` step, or (train)
    of its ``part``: "grad" (the microbatched loss and gradients) or
    "update" (AdamW on gradients of the step's layout)."""
    args, _ = _inputs(run, kind, pmesh)
    # each count as a step's first in its process: the scales' cached
    # divisors are made anew (``core.quantization._divisor``)
    quantization._divisor.cache_clear()
    counter = OpCost(attribute=bool(attribute))
    if kind == "train":
        setup = steps.make_train_setup(run, mesh=pmesh, first_only=first_only)
        params, opt, batch, step = args
        if part == "grad":
            fn, call = setup.loss_grad, (params, batch)
        elif part == "update":
            acc = _microbatches(run) > 1        # fp32 accumulators
            grads = shd.map_blocks(lambda p: torch.empty(
                p.shape, dtype=torch.float32 if acc else p.dtype,
                device=p.device), params)
            fn, call = setup.update, (grads, opt, params, step)
        else:
            fn, call = setup.step_fn, args
    else:
        fn, call = steps.make_serve_setup(run, kind, mesh=pmesh,
                                          first_only=first_only), args
    with contextlib.ExitStack() as stack:
        if attribute:       # backward ops attributed to their forward's
            stack.enter_context(warnings.catch_warnings())
            warnings.simplefilter("ignore", UserWarning)
            stack.enter_context(torch.autograd.detect_anomaly(
                check_nan=False))
        stack.enter_context(counter)
        fn(*call)
    return counter


def _extrapolate(tallies: dict, units: int, micro: int) -> Tally:
    """The tally at (``units``, ``micro``) of a bilinear fit a + b·g +
    c·n + d·g·n through the sampled {(g, n): Tally} (g ∈ {1, 2}; n ∈
    {2, 3}, or n = 1 alone): every count is such a function of the
    units and microbatches, each unit and each microbatch alike."""
    ns = sorted({n for _, n in tallies})
    n0, n1 = ns[0], ns[-1]

    def at(get):
        f = {k: get(t) for k, t in tallies.items()}
        b = f[(2, n0)] - f[(1, n0)]
        if n1 == n0:
            return f[(1, n0)] + (units - 1) * b
        c = f[(1, n1)] - f[(1, n0)]
        d = f[(2, n1)] - f[(1, n1)] - b
        return f[(1, n0)] + (units - 1) * b + (micro - n0) * c + \
            (units - 1) * (micro - n0) * d
    out = Tally(**{k: at(lambda t, k=k: getattr(t, k)) for k in
                   ("flops", "matmul_flops", "bytes", "transcendentals",
                    "launches")})
    out.collective_bytes = {c: at(lambda t, c=c: t.collective_bytes[c])
                            for c in COLLECTIVES}
    return out


def cost_step(run, kind: str, mesh: Mesh, *, first_only: bool = True,
              attribute: int = 0, loops: bool = True) -> dict:
    """Run ``run``'s ``kind`` step over ``position_mesh(mesh)`` under fake
    tensors and return position 0's counts: ``tally`` (an
    ``op_cost.Tally``), ``argument_bytes``, ``leaves`` (name → one
    device's bytes), ``rows`` (the batch's rows), ``seconds``.

    ``loops`` (the JAX counter's loop-awareness: XLA's while bodies
    counted once, times their trip counts): the layer stack and the
    microbatch loop run at one and two units of layers and at two and
    three microbatches, and every count is taken to the run's depth and
    microbatches by ``_extrapolate``; the train step's AdamW update,
    whose slicing does not grow linearly with depth, is counted at the
    run's size. Without ``loops`` the whole step runs once, and with
    ``attribute`` its top ops are returned (``top``);
    ``first_only=False`` walks every position (``tallies``: device →
    ``Tally``)."""
    pmesh = position_mesh(mesh)
    # The window times host work under fake tensors: no device work is
    # in flight to synchronize.
    t0 = time.perf_counter()
    out = {}
    with FakeTensorMode(allow_non_fake_inputs=False):
        args, leaves = _inputs(run, kind, pmesh)
        batch = {"tokens": args[2]} if kind == "decode" else \
            args[2 if kind == "train" else 1]
        if kind == "train" and _microbatches(run) > 1:   # rows a microbatch
            batch = {k: v[:run.microbatch] for k, v in batch.items()}
        rows = steps._rows(pmesh, batch, steps._rules(pmesh, run.fsdp))
        del args
        try:
            if loops:
                micro = _microbatches(run) if kind == "train" else 1
                ns = (2, 3) if micro > 1 else (1,)
                part = "grad" if kind == "train" else "step"
                sampled = {(g, n): _count(_sized(run, g, n), kind, pmesh,
                                          first_only, 0, part)
                           .tally(pmesh.first)
                           for g in (1, 2) for n in ns}
                u, rem = _unit(run.model)
                tally = _extrapolate(sampled, run.model.n_layers // u, micro)
                if kind == "train":
                    upd = _count(run, kind, pmesh, first_only, 0, "update") \
                        .tally(pmesh.first)
                    for k in ("flops", "matmul_flops", "bytes",
                              "transcendentals", "launches"):
                        setattr(tally, k, getattr(tally, k) + getattr(upd, k))
                    for c in COLLECTIVES:
                        tally.collective_bytes[c] += upd.collective_bytes[c]
            else:
                counter = _count(run, kind, pmesh, first_only, attribute)
                tally = counter.tally(pmesh.first)
                if attribute:
                    out["top"] = counter.attribute(pmesh.first, attribute)
                if not first_only:
                    out["tallies"] = dict(counter.tallies)
        finally:
            quantization._divisor.cache_clear()
    seconds = time.perf_counter() - t0  # lint: waive=unsynced-timing,cuda-unsynced-timing
    out.update(tally=tally, argument_bytes=argument_bytes(leaves),
               leaves={k: _shard_bytes(*v) for k, v in leaves.items()},
               rows=rows.n, data_positions=shd.axis_extent(
                   pmesh, steps._rules(pmesh, run.fsdp)["batch"]),
               seconds=seconds)
    return out


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_dir: str = OUT, verbose: bool = True) -> dict:
    """Cost one cell on the production mesh and write its JSON."""
    seq, gb, kind = SHAPES[shape]
    run = run_config(arch, shape, multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu",
                                host_devices=512 if multi_pod else 256)
    mesh_name = "x".join(str(s) for s in mesh.devices.shape)
    res = cost_step(run, kind, mesh)
    t = res["tally"]
    warnings = []
    if res["rows"] < res["data_positions"]:
        warnings.append(f"the batch of {gb} cuts into {res['rows']} rows "
                        f"over {res['data_positions']} data positions: "
                        f"the others hold replicas and compute nothing")
    result = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": mesh_name, "n_devices": int(mesh.devices.size),
        "seq_len": seq, "global_batch": gb,
        "dryrun_s": round(res["seconds"], 2),
        "memory": {"argument_size_in_bytes": res["argument_bytes"]},
        "flops_per_device": t.flops,
        "matmul_flops_per_device": t.matmul_flops,
        "bytes_per_device": t.bytes,
        "transcendentals_per_device": t.transcendentals,
        "launches_per_device": t.launches,
        "collective_bytes_per_device": dict(t.collective_bytes),
        "collective_total_bytes_per_device": t.collective_total,
        "warnings": warnings,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape}__{mesh_name}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=2)
    if verbose:
        args_b = res["argument_bytes"]
        print(f"[dryrun] {arch:24s} {shape:12s} mesh={mesh_name:8s} "
              f"{res['seconds']:7.1f}s flops/dev={t.flops:.3e} "
              f"bytes/dev={t.bytes:.3e} args={args_b / 1e9:.2f}GB "
              f"coll/dev={t.collective_total / 1e9:.3f}GB", flush=True)
        for w in warnings:
            print(f"[dryrun]   warning: {w}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod for each cell")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)
    todo = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, args.out)
            except Exception as e:       # noqa: BLE001 — report, go on
                failures.append((arch, shape, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} {shape} multi_pod={mp}: {e}",
                      flush=True)
                if not args.keep_going:
                    traceback.print_exc()
                    raise
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        raise SystemExit(1)
    print("[dryrun] all cells passed")


if __name__ == "__main__":
    main()
