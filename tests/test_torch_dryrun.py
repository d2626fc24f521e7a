"""The port's dry run (``repro_torch.launch.dryrun``, with its cost
counter ``repro_torch.analysis.op_cost``) against the JAX package's
compiled steps, on a (2, 2) data × model mesh, for tiny variants of
llama3.2-1b, recurrentgemma-2b, qwen2-moe-a2.7b and rwkv6-7b at train,
prefill and decode (B = 4, S = 16, train microbatch 2):

* argument bytes per device equal ``compiled.memory_analysis()
  .argument_size_in_bytes`` exactly, but for two leaves the packages
  keep differently, each named with its bytes: the train step's ``step``
  (a host int in the port, an int32 argument in JAX: 4 B) and RWKV-6's
  decode ``pos`` (its step reads no position; jit drops the unused
  argument: 8 B a device);
* matmul FLOPs per device against the loop-scaled ``dot`` and
  ``convolution`` FLOPs of JAX's optimized HLO (``repro.analysis.
  hlo_cost``'s parser), once the products that the port computes whole
  on each device, where JAX cuts them over "model" (``WHOLE``, found by
  the counter's attribution), are counted at a model block's share:
  serving within ``SERVE_TOL``, train within ``TRAIN_TOL`` (PERF.md §6
  gives each gap's cause);
* position 0 computed alone equal to a full walk of every position, in
  the cells of ``WALKED`` (every family, both attention cuts, a train
  step, each running the whole step); the loop-aware count (the default: layers and
  microbatches sampled and taken to the run's size) equal to the whole
  step's where it extrapolates (4 layers and 4 microbatches, a hybrid of
  2 units and a remainder);
* the collective bytes of one column-parallel and one row-parallel
  linear against a count worked out from the shapes.

JAX's side runs in one 4-device subprocess, shared by every case.
"""
import dataclasses
import fcntl
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.op_cost import OpCost
from repro_torch.configs import ARCHS, tiny_variant
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import layers as L

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARCH_LIST = ["llama3.2-1b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
             "rwkv6-7b"]
KINDS = ["train", "prefill", "decode"]
CELLS = [(a, k) for a in ARCH_LIST for k in KINDS]
#: the cells also walked at every position: a train step (its backward
#: through the stand-ins), the decode cache cut by KV head
#: (llama3.2-1b), by head dim with the hybrid's lockstep conv (prefill)
#: and along channels (its decode), the MoE's dispatch over rows and
#: RWKV-6's state cut by head
WALKED = [("llama3.2-1b", "train"), ("llama3.2-1b", "decode"),
          ("recurrentgemma-2b", "prefill"), ("recurrentgemma-2b", "decode"),
          ("qwen2-moe-a2.7b", "prefill"), ("rwkv6-7b", "decode")]
B, S, MICRO = 4, 16, 2

#: the port functions whose products run whole on each row's block-0
#: device where JAX cuts them over "model" (their backward included),
#: by family: the hybrid's w_a and w_i (``_gates``), its w_x (C9: a
#: ``linear`` with a whole weight) and the conv over every channel
#: (``winograd._apply``; ``row``: the decode step's); RWKV-6's time mix
#: and the channel mix's receptance.
WHOLE = {
    "recurrentgemma-2b": ("repro_torch.models.rglru._gates",
                          "repro_torch.models.layers.linear",
                          "repro_torch.core.winograd._apply",
                          "repro_torch.models.rglru.row"),
    "rwkv6-7b": ("repro_torch.models.rwkv6._ddlerp",
                 "repro_torch.models.rwkv6._time_mix",
                 "repro_torch.models.rwkv6._time_mix_chunked",
                 "repro_torch.models.layers.linear"),
}
#: |port / JAX − 1| of the matmul FLOPs a device, so adjusted. Serving:
#: measured 0 in every cell but RWKV-6's decode (+7e-4: 256 flops).
#: Train: measured +7.7 % (llama3.2-1b), +2.6 % (hybrid), +3.0 % (MoE),
#: −0.4 % (RWKV-6): the port's checkpointed layers recompute every
#: product in the backward, where XLA's remat drops those whose outputs
#: the backward never reads (a layer's last products before its residual
#: add), and its chunked CE recomputes the unembedding (PERF.md §6).
SERVE_TOL, TRAIN_TOL = 1e-3, 0.08
#: argument leaves the two packages keep differently: (arch, kind) →
#: (leaf, bytes a device JAX counts beyond the port).
NAMED = {("llama3.2-1b", "train"): ("step", 4),
         ("recurrentgemma-2b", "train"): ("step", 4),
         ("qwen2-moe-a2.7b", "train"): ("step", 4),
         ("rwkv6-7b", "train"): ("step", 4),
         ("rwkv6-7b", "decode"): ("batch/pos", -8)}

_JAX = textwrap.dedent('''
    import os
    # LLVM's optimizations off: they change no HLO (the dots and the
    # argument sizes counted here) and take a fifth of the compile time
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import json, re, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.analysis import hlo_cost as H
    from repro.configs import ARCHS, tiny_variant
    from repro.configs.base import RunConfig
    from repro.launch.steps import make_serve_setup, make_train_setup

    def called(attrs, key):
        m = re.search(key + r"=%([\\w.\\-]+)", attrs)
        return m.group(1) if m else None

    def matmul_flops(text):
        comps = H._split_computations(text)
        parsed = {c: [i for i in map(H._parse_instr, ls) if i]
                  for c, ls in comps.items()}
        memo = {}

        def cost(c, stack=()):
            if c in memo:
                return memo[c]
            if c in stack or c not in parsed:
                return 0.0
            shapes, tot = {}, 0.0
            for ins in parsed[c]:
                shapes[ins.name] = ins.type_str
                tot += one(ins, shapes, stack + (c,))
            memo[c] = tot
            return tot

        def one(ins, shapes, stack):
            op, out = ins.op, H._type_elems_bytes(ins.type_str)[0]
            if op == "while":
                m = re.search(r'known_trip_count[^0-9]*"n":"(\\d+)"',
                              ins.attrs)
                return (int(m.group(1)) if m else 1) * sum(
                    cost(x, stack) for x in (called(ins.attrs, "body"),
                                             called(ins.attrs, "condition"))
                    if x)
            if op in ("fusion", "call"):
                c = called(ins.attrs, "calls") or called(ins.attrs,
                                                         "to_apply")
                return cost(c, stack) if c else 0.0
            if op == "conditional":
                return max((cost(b, stack) for b in
                            re.findall(r"%([\\w.\\-]+)", ins.attrs)),
                           default=0.0)
            if op == "dot":
                m = re.search(r"lhs_contracting_dims=\\{([\\d,]*)\\}",
                              ins.attrs)
                lhs = H._array_dims(shapes.get(ins.operands[0], ""))
                k = 1
                for d in (m.group(1).split(",") if m and lhs else []):
                    k *= lhs[int(d)] if d else 1
                return 2.0 * out * k
            if op == "convolution":
                rhs = H._array_dims(shapes.get(ins.operands[1], ""))
                m = re.search(r"dim_labels=\\S*_(\\S*?)->", ins.attrs)
                k = 1
                for i, ch in enumerate(m.group(1) if m and rhs else ""):
                    k *= rhs[i] if ch != "o" and i < len(rhs) else 1
                return 2.0 * out * k
            return 0.0
        return cost("__entry__")

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    B, S, MICRO = (int(a) for a in sys.argv[2:5])
    for arch, kind in json.loads(sys.argv[1]):
        run = RunConfig(model=tiny_variant(ARCHS[arch]), seq_len=S,
                        global_batch=B,
                        microbatch=MICRO if kind == "train" else None)
        with mesh:
            if kind == "train":
                s = make_train_setup(run, mesh, False)
                args = (s.abstract["params"], s.abstract["opt"],
                        s.abstract["batch"], s.abstract["step"])
            else:
                s = make_serve_setup(run, mesh, False, kind)
                a = s.abstract
                args = ((a["params"], a["batch"]) if kind == "prefill" else
                        (a["params"], a["cache"], a["tokens"], a["pos"]))
            comp = s.step_fn.lower(*args).compile()
        print(json.dumps({
            "cell": [arch, kind],
            "args": int(comp.memory_analysis().argument_size_in_bytes),
            "matmul_flops": matmul_flops(comp.as_text())}), flush=True)
''')


def _run(arch, kind):
    return RunConfig(model=tiny_variant(ARCHS[arch]), seq_len=S,
                     global_batch=B,
                     microbatch=MICRO if kind == "train" else None)


def _mesh():
    return make_mesh_for(4, 2, device="cpu", host_devices=4)


@pytest.fixture(scope="module")
def both(request, tmp_path_factory):
    """{cell: (port's first-position cost, JAX's record, the port's full
    walk)}, computed once a run: under pytest-xdist the first worker to
    need it computes it, and a worker that needs it meanwhile waits for
    its file (the run's shared temporary directory) instead of
    computing it again."""
    if not hasattr(request.config, "workerinput"):
        return _both()
    path = tmp_path_factory.getbasetemp().parent / "torch_dryrun_both.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(_both()))
        return pickle.loads(path.read_bytes())


def _both():
    """``both``'s records: the JAX subprocess runs while the port's dry
    runs do."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps(CELLS), str(B), str(S),
         str(MICRO)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(REPO))
    try:
        port = {c: (dryrun.cost_step(_run(*c), c[1], _mesh(), loops=False,
                                     attribute=10 ** 6 if c[0] in WHOLE
                                     else 0),
                    dryrun.cost_step(_run(*c), c[1], _mesh(),
                                     first_only=False, loops=False)
                    if c in WALKED else None) for c in CELLS}
        out, err = proc.communicate(timeout=400)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    jax_side = {}
    for line in out.splitlines():
        rec = json.loads(line)
        jax_side[tuple(rec["cell"])] = rec
    return {c: (port[c][0], jax_side[c], port[c][1]) for c in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_argument_bytes_per_device_equal_jax(both, cell):
    port, jax_rec, _ = both[cell]
    leaf, extra = NAMED.get(cell, (None, 0))
    if leaf is not None and leaf.startswith("batch/"):
        assert port["leaves"][leaf] == -extra
    assert port["argument_bytes"] + extra == jax_rec["args"], (
        f"{cell}: port {port['argument_bytes']} B, JAX {jax_rec['args']} B"
        f" (named leaf {leaf}: {extra} B)")


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_matmul_flops_per_device_against_jax(both, cell):
    port, jax_rec, _ = both[cell]
    m = _mesh().shape["model"]
    whole = sum(r["matmul_flops"] for r in port.get("top", ())
                if r["caller"].removesuffix(" (backward)")
                in WHOLE.get(cell[0], ()))
    ratio = (port["tally"].matmul_flops - whole * (1 - 1 / m)) / \
        jax_rec["matmul_flops"]
    tol = TRAIN_TOL if cell[1] == "train" else SERVE_TOL
    assert abs(ratio - 1) <= tol, (
        f"{cell}: port/JAX {ratio:.4f} ({whole:.0f} flops whole)")


@pytest.mark.parametrize("cell", WALKED, ids=lambda c: "-".join(c))
def test_one_position_equals_a_full_walk(both, cell):
    """Position 0 alone counts what a walk of every position counts at
    position 0, to the byte and the op (the train step's gradients that
    the other rows and blocks send back to it included), and position 0
    is the largest."""
    port, _, full = both[cell]
    assert port["tally"].as_dict() == full["tally"].as_dict()
    first = dryrun.position_mesh(_mesh()).first
    assert all(t.flops <= full["tallies"][first].flops
               for t in full["tallies"].values())


@pytest.mark.parametrize("inference", [False, True],
                         ids=["autograd", "inference"])
@pytest.mark.parametrize("row_parallel", [False, True],
                         ids=["column", "row"])
def test_collective_bytes_of_a_sharded_linear(row_parallel, inference):
    """A (8, 32) @ (32, 24) fp32 linear, the weight cut over a 2-wide
    model axis: column-parallel, position 0 takes in block 1's (8, 12)
    output (all-gather, 384 B); row-parallel, block 1's (8, 24) partial
    sum (all-reduce, 768 B); nothing else, and block 1 takes in x (or its
    half). Alike under inference mode, where ``Tensor.to`` reaches the
    counter whole (a serving step's copies)."""
    mesh = dryrun.position_mesh(make_mesh_for(2, 2, device="cpu",
                                              host_devices=2))
    spec = shd.P("model", None) if row_parallel else shd.P(None, "model")
    with FakeTensorMode():
        x = torch.empty((8, 32), device=mesh.first)
        w = shd.Sharded.place(torch.empty((32, 24), device=mesh.first),
                              shd.NamedSharding(mesh, spec))
        with torch.inference_mode(inference), \
                shd.running(shd.Rows(mesh, "data")), OpCost() as c:
            L.linear(x, w)
    zero, one = (c.tally(d) for d in mesh.devices.flat)
    kind = "all-reduce" if row_parallel else "all-gather"
    want0 = {k: 0.0 for k in zero.collective_bytes}
    want0[kind] = 8 * 24 * 4 if row_parallel else 8 * 12 * 4
    assert zero.collective_bytes == want0
    assert one.collective_total == (8 * 16 * 4 if row_parallel
                                    else 8 * 32 * 4)
    assert zero.matmul_flops == one.matmul_flops == \
        (2 * 8 * 16 * 24 if row_parallel else 2 * 8 * 32 * 12)


@pytest.mark.parametrize("arch, layers, kind", [
    ("llama3.2-1b", 4, "train"), ("recurrentgemma-2b", 8, "prefill")])
def test_loop_aware_counts_equal_the_whole_step(arch, layers, kind):
    """Sampled at one and two units of layers (and two and three
    microbatches), the counts taken to 4 layers and 4 microbatches, or to
    the hybrid's 2 units and 2 remainder layers, equal one run of the
    whole step's, every field."""
    cfg = dataclasses.replace(tiny_variant(ARCHS[arch]), n_layers=layers)
    run = RunConfig(model=cfg, seq_len=S, global_batch=8 if kind == "train"
                    else B, microbatch=MICRO if kind == "train" else None)
    got = dryrun.cost_step(run, kind, _mesh())
    want = dryrun.cost_step(run, kind, _mesh(), loops=False)
    assert got["tally"].as_dict() == want["tally"].as_dict()


def test_run_cell_writes_the_jax_keys(tmp_path, monkeypatch):
    """``run_cell`` (here on the tiny llama over a 2 × 2 mesh) writes the
    JSON keys of the JAX dry run's records."""
    monkeypatch.setattr(dryrun, "run_config",
                        lambda arch, shape, mp: _run("llama3.2-1b",
                                                     "decode"))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda **kw: _mesh())
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False,
                          str(tmp_path), verbose=False)
    on_disk = json.loads((tmp_path / "llama3.2-1b__decode_32k__2x2.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    for key in ("arch", "shape", "kind", "mesh", "n_devices", "seq_len",
                "global_batch", "memory", "flops_per_device",
                "bytes_per_device", "transcendentals_per_device",
                "collective_bytes_per_device",
                "collective_total_bytes_per_device", "warnings",
                "dryrun_s"):
        assert key in rec
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert set(rec["collective_bytes_per_device"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
