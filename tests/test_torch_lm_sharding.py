"""The port's LM sharding on the CPU: meshes of logical CPU devices
(``launch.mesh``'s ``host_devices``), one process driving them.

* Placement against the JAX package's own functions: ``pspec`` /
  ``tree_shardings`` of every leaf of all ten configs' full-size
  ``param_specs``, ``_batch_shardings`` and ``_cache_pspec``, entry for
  entry, on the (16, 16), (2, 16, 16), (2, 2), (2, 2, 2), (1, 4) and
  (4, 1) meshes with ``fsdp`` off and on. JAX's side is built over a
  ``jax.sharding.AbstractMesh`` of the same shape and axis names (jax 0.9
  builds a ``NamedSharding`` over one without devices); where JAX refuses
  a spec (RWKV-6 with FSDP: its channel mix's (embed, embed) matrix cuts
  both dims over the data axes) the port refuses it too.
* ``make_mesh_for`` against JAX's, run with ``jax.make_mesh`` stubbed to
  return its arguments, for n in {1, 2, 4, 8, 16, 256, 512, 4096}.
* ``compress_leaf`` / ``decompress_leaf`` bit for bit with JAX's (eager),
  and ``compressed_grad_mean`` against JAX's leaf functions summed in the
  ring's order.
* The sharded train step of the six families (tiny variants; the
  hybrid's quantized Toom-Cook conv on, the MoE's aux loss on) against
  the one-device step: a 1 × 1 mesh bit for bit; the (2, 1), (1, 2),
  (2, 2) and (2, 2, 2) meshes (FSDP on the last) within ``TOL`` × (1 +
  each tensor's largest |value|): the loss, the grad norm, and every
  updated parameter where its gradient is above 1e-3 of the leaf's
  largest (Adam's first step moves any parameter by about lr). The MoE
  with ``moe_groups`` = 1 (one sort over every row's tokens) and = the
  data extent; a batch that does not divide the data extent.
* Sharded prefill → decode against one device (the decode cache placed
  by ``_cache_pspec``, heads or head dims over "model"); a 1 × 1 mesh bit
  for bit.
* w8a8 fake-quant linears (``quantize_linears``) over meshes: the
  activation scale over every row's slab, against one device and JAX.
* ``launch/train`` over a 2 × 2 mesh of four logical devices: SIGTERM and
  ``--resume`` bit for bit with a straight run; its checkpoint restored
  onto ``--model-parallel 1`` bit for bit; the serving example over it.
"""
import dataclasses
import os
import signal
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import registry as jreg
from repro.models.param import abstract_params, logical_axes
from repro_torch.checkpoint.checkpoint import latest_step, restore
from repro_torch.configs import ARCHS, tiny_variant
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import batch_at, input_specs
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.sharding import Rows, Sharded, gather_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import (make_host_mesh, make_mesh_for,
                                     make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.param import tree_leaves, tree_paths
from repro_torch.optim.optimizer import adamw_update_

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ["llama3.2-1b", "qwen2-moe-a2.7b", "rwkv6-7b",
            "recurrentgemma-2b", "internvl2-26b", "hubert-xlarge"]
MESHES = [(16, 16), (2, 16, 16), (2, 2), (2, 2, 2), (1, 4), (4, 1)]
TOL = 1e-4
B, S = 4, 16


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else \
        ("data", "model")


def _port_mesh(shape):
    return tshd.Mesh(np.full(shape, torch.device("cpu"), dtype=object),
                     _axes(shape))


def _spec(x):
    return tuple(x.spec)


# ---------------------------------------------------------------------------
# Placement against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_specs_equal_jax_for_every_leaf_of_all_ten_configs(shape, fsdp):
    jm, tm = AbstractMesh(shape, _axes(shape)), _port_mesh(shape)
    multi = len(shape) == 3
    jrules = jshd.rules(fsdp=fsdp, multi_pod=multi)
    trules = tshd.rules(fsdp=fsdp, multi_pod=multi)
    assert tuple(tshd.batch_pspec(trules)) == tuple(jshd.batch_pspec(jrules))
    for name, jcfg in JARCHS.items():
        tcfg = ARCHS[name]
        jspecs = jreg.get_model(jcfg).param_specs(jcfg)
        tspecs = registry.get_model(tcfg).param_specs(tcfg)
        jflat = dict(tree_paths(jax.tree.map(
            lambda s: (s.shape, s.axes), jspecs,
            is_leaf=lambda x: hasattr(x, "axes"))))
        tflat = dict(tree_paths(tspecs))
        assert sorted(jflat) == sorted(tflat), name
        rm = dict(jrules, __mesh_shape__=dict(jm.shape))
        for path, (jshape, jax_axes) in jflat.items():
            t = tflat[path]
            assert (tuple(jshape), tuple(jax_axes)) == (t.shape, t.axes)
            want = tuple(jshd.pspec(jax_axes, rm, jshape))
            got = tuple(tshd.pspec(t.axes, dict(
                trules, __mesh_shape__=dict(tm.shape)), t.shape))
            assert got == want, (name, path)
            assert tuple(tshd.pspec(t.axes, trules)) == \
                tuple(jshd.pspec(jax_axes, jrules)), (name, path)
        try:
            jsh = jshd.tree_shardings(jm, logical_axes(jspecs), jrules,
                                      abstract_params(jspecs))
        except Exception as e:          # noqa: BLE001 — jax refuses it
            assert type(e).__name__ == "DuplicateSpecError", e
            with pytest.raises(ValueError, match="cuts two dimensions"):
                tsteps.param_shardings(tcfg, tm, fsdp=fsdp)
            assert fsdp and name == "rwkv6-7b"
            continue
        tsh = tsteps.param_shardings(tcfg, tm, fsdp=fsdp)
        jflat_sh = dict(tree_paths(jax.tree.map(
            _spec, jsh, is_leaf=lambda x: hasattr(x, "spec"))))
        assert jflat_sh == {p: _spec(s) for p, s in tree_paths(tsh)}, name
        # the batch and the decode cache at batch sizes that divide the
        # data axes, their last or first axis, or none of them
        for batch in (512, 128, 32, 16, 2, 1, 3):
            jb = jsteps._batch_shardings(
                jm, jax.tree.map(lambda s: s,
                                 _jax_input_specs(jcfg, batch)), jrules)
            tb = tsteps._batch_shardings(tm, {
                k: torch.empty(s, device="meta")
                for k, (s, _) in input_specs(tcfg, 1024, batch).items()},
                trules)
            assert {k: _spec(v) for k, v in jb.items()} == \
                {k: _spec(v) for k, v in tb.items()}, (name, batch)
            if tcfg.is_encoder:
                continue
            jc = jax.eval_shape(lambda: jreg.get_model(jcfg).init_cache(
                jcfg, batch, 64))
            tc = registry.get_model(tcfg).init_cache(tcfg, batch, 64,
                                                     device="meta")
            jcs = jsteps._cache_pspec(jcfg, jc, jm, jrules)
            tcs = tsteps._cache_pspec(tcfg, tc, tm, trules)
            assert {k: _spec(v) for k, v in jcs.items()} == \
                {k: _spec(v) for k, v in tcs.items()}, (name, batch)


def _jax_input_specs(jcfg, batch):
    from repro.data.pipeline import input_specs as jinput
    return jinput(jcfg, 1024, batch, "train")


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 256, 512, 4096])
def test_make_mesh_for_equals_jax(n, monkeypatch):
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for mp in (16, 2):
        want = jmesh.make_mesh_for(n, mp)
        got = make_mesh_for(n, mp, device="cpu", host_devices=n)
        assert (tuple(got.shape.values()), got.axis_names) == want
        assert got.devices.size == int(np.prod(want[0]))
    assert make_mesh_for(8, 2, 4, device="cpu", host_devices=8).shape == \
        {"pod": 2, "data": 2, "model": 2}


def test_production_and_host_meshes():
    one = make_production_mesh(device="cpu", host_devices=256)
    two = make_production_mesh(multi_pod=True, device="cpu",
                               host_devices=512)
    assert one.shape == {"data": 16, "model": 16}
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.devices.size == 512
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="pass --host-devices"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="mesh needs 4 devices"):
        make_mesh_for(4, 2, device="cpu", host_devices=2)


def test_sharded_leaf_places_gathers_and_owns_each_block_once():
    mesh = make_mesh_for(8, 2, 4, device="cpu", host_devices=8)
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    s = tshd.constrain(x, mesh, ("pod", "data"), "model")
    assert s.counts() == (4, 2, 1) and len(s.blocks) == 8
    assert s.blocks[(3, 1, 0)].shape == (1, 3, 2)
    assert torch.equal(s.gather(), x)
    assert torch.equal(s.gather(at=(1, 1)), x[:, 3:])
    rep = tshd.constrain(x, mesh, None, "model")
    assert len(rep.blocks) == 2 and rep.model_dim == 1
    w = tshd.constrain(x[0], mesh, "model", None)
    assert torch.equal(w.T.gather(), x[0].T) and w.T.model_dim == 1
    with pytest.raises(ValueError, match="does not cut"):
        tshd.constrain(torch.zeros(4, 6, 3), mesh, None, None, "model")
    assert [t.shape for t in tshd.constrain(x, mesh, None, "model")
            .unbind(0)] == [(6, 2)] * 4


def test_constrain_leading_dp_places_dim_0_over_the_data_axes():
    mesh = make_mesh_for(8, 2, 4, device="cpu", host_devices=8)
    x = torch.randn(8, 6)
    assert L.constrain_leading_dp(x) is x            # no running mesh
    with tshd.running(Rows(mesh, ("pod", "data"))):
        y = L.constrain_leading_dp(x, "model")
        assert isinstance(y, Sharded)
        assert tuple(y.spec) == (("pod", "data"), "model")
        assert tuple(L.constrain_leading_dp(x, "seq").spec) == \
            (("pod", "data"), None)
        assert not isinstance(L.constrain_leading_dp(torch.randn(2, 6)),
                              Sharded)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def _grads(seed, n=3):
    rng = np.random.default_rng(seed)
    return [{"a": (rng.normal(size=(6, 5)) * 10.0 ** rng.integers(-3, 3)
                   ).astype(np.float32),
             "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
            for _ in range(n)]


def test_compress_and_decompress_leaf_bit_for_bit_with_jax():
    for i, g in enumerate(_grads(0, 4)):
        for x in (g["a"], g["b"]["c"], np.zeros(3, np.float32)):
            jq, js, je = jcomp.compress_leaf(jnp.asarray(x))
            tq, ts, te = tcomp.compress_leaf(torch.from_numpy(x))
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
            np.testing.assert_array_equal(
                tcomp.decompress_leaf(tq, ts).numpy(),
                np.asarray(jcomp.decompress_leaf(jq, js)))


@pytest.mark.parametrize("pods", [2, 3])
def test_compressed_grad_mean_sums_in_the_ring_order(pods):
    """Each pod's mean: own, then from i−1, i−2, ... (JAX's leaf functions
    in eager JAX), divided by the pod count; the residual is JAX's."""
    mesh = make_mesh_for(pods * 2, 1, 2, device="cpu",
                         host_devices=pods * 2)
    assert mesh.shape["pod"] == pods
    grads = _grads(1, pods)
    errs = _grads(2, pods)
    tg = [{"a": torch.from_numpy(g["a"]),
           "b": {"c": torch.from_numpy(g["b"]["c"])}} for g in grads]
    te = [{"a": torch.from_numpy(e["a"]) * 1e-3,
           "b": {"c": torch.from_numpy(e["b"]["c"]) * 1e-3}} for e in errs]
    means, new_err = tcomp.compressed_grad_mean(tg, te, mesh)
    for path in (("a",), ("b", "c")):
        def at(tree):
            for k in path:
                tree = tree[k]
            return tree
        packs = []
        for i in range(pods):
            gf = jnp.asarray(at(tg[i]).numpy()) + jnp.asarray(
                at(te[i]).numpy())
            q, s, err = jcomp.compress_leaf(gf)
            packs.append((q, s))
            np.testing.assert_array_equal(at(new_err[i]).numpy(),
                                          np.asarray(err))
        for i in range(pods):
            total = jcomp.decompress_leaf(*packs[i])
            for step in range(1, pods):
                total = total + jcomp.decompress_leaf(
                    *packs[(i - step) % pods])
            np.testing.assert_array_equal(at(means[i]).numpy(),
                                          np.asarray(total / pods))
    zero = tcomp.init_error_state(tg[0])
    assert all(float(t.abs().sum()) == 0 and t.dtype == torch.float32
               for t in tree_leaves(zero))
    with pytest.raises(ValueError, match="for 2 pods|for 3 pods"):
        tcomp.compressed_grad_mean(tg[:1], te[:1], mesh)


# ---------------------------------------------------------------------------
# The sharded train step against the one-device step
# ---------------------------------------------------------------------------

def _cfg(arch, **changes):
    cfg = tiny_variant(ARCHS[arch])
    if cfg.n_experts and "capacity_factor" not in changes:
        changes["capacity_factor"] = cfg.n_experts / cfg.top_k
    return dataclasses.replace(cfg, **changes)


def _step(cfg, mesh=None, fsdp=False, batch=B, micro=None):
    run = RunConfig(model=cfg, seq_len=S, global_batch=batch,
                    microbatch=micro, total_steps=4, warmup_steps=1,
                    fsdp=fsdp, lr=1e-3)
    kw = {} if mesh is None else {"mesh": mesh}
    params, opt = tsteps.init_train_state(run, 0, "cpu", **kw)
    b = batch_at(cfg, S, batch, 0)
    seen = {}

    def update(grads, *args, **kwargs):      # the step's own gradients
        seen["grads"] = gather_tree(grads)
        return adamw_update_(grads, *args, **kwargs)
    with mock.patch.object(tsteps, "adamw_update_", update):
        params, opt, met = tsteps.make_train_setup(run, "cpu", **kw).step_fn(
            params, opt, b, 1)
    return met, seen["grads"], gather_tree(params), gather_tree(opt)


def _close(got, want, what, where=None, floor=0.0):
    d = (got.float() - want.float()).abs()
    bound = TOL * (1 + float(want.float().abs().max())) if want.numel() \
        else 0.0
    ok = d <= bound if where is None else \
        torch.where(where, d <= bound, d <= floor + bound)
    assert bool(ok.all()), f"{what}: {float(d.max()):.3e} past {bound:.3e}"


def _hold(one, sharded, lr=1e-3):
    m0, g0, p0, _ = one
    m1, g1, p1, _ = sharded
    _close(m1["loss"], m0["loss"], "loss")
    _close(m1["grad_norm"], m0["grad_norm"], "grad norm")
    for (path, a), b in zip(tree_paths(g1), tree_leaves(g0)):
        _close(a, b, f"grad {path}")
    for (path, a), b, g in zip(tree_paths(p1), tree_leaves(p0),
                               tree_leaves(g0)):
        above = g.abs() > 1e-3 * float(g.abs().max()) if g.numel() else None
        _close(a, b, f"param {path}", above, 2 * lr)


_ONE: dict = {}


def _one_device(arch, **changes):
    key = (arch, tuple(sorted(changes.items())))
    if key not in _ONE:
        _ONE[key] = _step(_cfg(arch, **changes))
    return _ONE[key]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_on_a_1x1_mesh_is_bit_for_bit(arch):
    one = _one_device(arch)
    got = _step(_cfg(arch), make_mesh_for(1, 1, device="cpu"))
    assert torch.equal(got[0]["loss"], one[0]["loss"])
    assert torch.equal(got[0]["grad_norm"], one[0]["grad_norm"])
    for i in (1, 2):
        for a, b in zip(tree_leaves(got[i]), tree_leaves(one[i])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for k in ("m", "v", "count"):
        for a, b in zip(tree_leaves(got[3][k]), tree_leaves(one[3][k])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_train_step_matches_one_device(arch, shape):
    """The hybrid's quantized conv and the MoE's aux loss on; FSDP on the
    (2, 2, 2) mesh (RWKV-6 there without it: its FSDP specs are refused
    in both packages)."""
    n = int(np.prod(shape))
    mesh = (make_mesh_for(n, shape[-1], 4, device="cpu", host_devices=n)
            if len(shape) == 3 else
            make_mesh_for(n, shape[1], device="cpu", host_devices=n))
    assert tuple(mesh.shape.values()) == shape
    if arch == "recurrentgemma-2b":
        assert _cfg(arch).use_winograd_conv
    fsdp = len(shape) == 3 and arch != "rwkv6-7b"
    _hold(_one_device(arch), _step(_cfg(arch), mesh, fsdp=fsdp))


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_groups_over_rows_match_one_device(groups):
    """moe_groups = 1: one sort over both rows' tokens, at the default
    capacity (tokens drop as they drop on one device); = 2, the data
    extent: each row dispatches its own group."""
    changes = {"moe_groups": groups}
    if groups == 1:
        changes["capacity_factor"] = 1.0
    mesh = make_mesh_for(4, 2, device="cpu", host_devices=4)
    _hold(_one_device("qwen2-moe-a2.7b", **changes),
          _step(_cfg("qwen2-moe-a2.7b", **changes), mesh))


def test_a_batch_off_the_data_extent_and_microbatches():
    """B = 3 on a 2 × 2 mesh stays whole (row 0 computes it); B = 2 on
    (2, 2, 2) goes over "data" alone ("pod" holds replicas); microbatches
    of 2 cut over the rows."""
    cfg = _cfg("llama3.2-1b")
    mesh = make_mesh_for(4, 2, device="cpu", host_devices=4)
    _hold(_step(cfg, batch=3), _step(cfg, mesh, batch=3))
    pod = make_mesh_for(8, 2, 4, device="cpu", host_devices=8)
    _hold(_step(cfg, batch=2), _step(cfg, pod, batch=2))
    _hold(_step(cfg, micro=2), _step(cfg, mesh, micro=2))


def test_a_vocab_off_the_model_extent_moves_its_cut_to_the_embed_dim():
    """A vocab of 126 on a 4-way model axis: ``pspec`` re-places "model"
    on the unembedding's embed dim, and the CE's product runs
    row-parallel."""
    cfg = _cfg("internvl2-26b", vocab=126)
    mesh = make_mesh_for(4, 4, device="cpu", host_devices=4)
    sh = tsteps.param_shardings(cfg, mesh)
    assert tuple(sh["unembed"].spec) == ("model", None)
    _hold(_step(cfg), _step(cfg, mesh))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in FAMILIES if a != "hubert-xlarge"])
def test_sharded_prefill_and_decode_match_one_device(arch):
    cfg = _cfg(arch)
    run = RunConfig(model=cfg, seq_len=S + 4, global_batch=B)
    inputs = batch_at(cfg, S, B, 0, mode="prefill")
    one = tsteps.generate(run, tsteps.init_lm_params(cfg, 0, "cpu"), inputs,
                          4, device="cpu", keep_logits=True)
    for mesh in (make_mesh_for(4, 2, device="cpu", host_devices=4),
                 make_mesh_for(8, 2, 4, device="cpu", host_devices=8)):
        params = tsteps.init_lm_params(cfg, 0, mesh=mesh)
        out = tsteps.generate(run, params, inputs, 4, mesh=mesh,
                              keep_logits=True)
        assert torch.equal(out["tokens"], one["tokens"])
        for a, b in zip(out["logits"], one["logits"]):
            _close(a, b, f"{arch} logits on {mesh.shape}")
        k = next(iter(out["cache"].values()))
        assert isinstance(k, Sharded) and k.counts()[1] == \
            tshd.axis_extent(mesh, ("pod", "data"))
        # every cache leaf placed by _cache_pspec, its "model" entries too
        want = tsteps._cache_pspec(cfg, out["cache"], mesh,
                                   tsteps._rules(mesh, False))
        for name, t in out["cache"].items():
            assert _full(t.spec, len(t.shape)) == \
                _full(want[name].spec, len(t.shape))


def _full(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("arch", [a for a in FAMILIES if a != "hubert-xlarge"])
def test_sharded_serving_on_a_1x1_mesh_is_bit_for_bit(arch):
    """Prefill → 2 decode steps on a 1 × 1 mesh: the cache placed as
    ``_cache_pspec`` says (its model entries of extent 1), every logit and
    cache element bit for bit with one device."""
    cfg = _cfg(arch)
    run = RunConfig(model=cfg, seq_len=S + 2, global_batch=B)
    inputs = batch_at(cfg, S, B, 0, mode="prefill")
    one = tsteps.generate(run, tsteps.init_lm_params(cfg, 0, "cpu"), inputs,
                          2, device="cpu", keep_logits=True)
    mesh = make_mesh_for(1, 1, device="cpu")
    out = tsteps.generate(run, tsteps.init_lm_params(cfg, 0, mesh=mesh),
                          inputs, 2, mesh=mesh, keep_logits=True)
    for a, b in zip(out["logits"], one["logits"]):
        assert torch.equal(a, b)
    want = tsteps._cache_pspec(cfg, out["cache"], mesh,
                               tsteps._rules(mesh, False))
    for name, t in out["cache"].items():
        assert _full(t.spec, len(t.shape)) == \
            _full(want[name].spec, len(t.shape))
        assert torch.equal(t.gather(), one["cache"][name])


def _q8_rows(x, w, mesh, spec):
    """``layers.linear(q8=True)`` of x's rows over ``mesh`` (dim 0 over
    "data", the rows in lockstep), w placed under ``spec``."""
    rows = Rows(mesh, "data", lockstep=True)
    ws = Sharded.place(w, tshd.NamedSharding(mesh, spec))
    with tshd.running(rows):
        parts = rows.each(lambda p, xr: L.linear(xr, p, q8=True), ws,
                          rows.split(x))
    return rows.join(parts)


def test_q8_linears_over_a_mesh_hold_their_tiers():
    """w8a8 fake-quant linears over meshes of logical devices against one
    device: a 1 × 1 mesh and a column-parallel weight on 2 × 2 bit for bit
    (the activation scale over both rows' slabs, each column's scale its
    own), a row-parallel one at the fp32 tier (partial sums); one device
    against JAX's ``linear(q8=True)`` at the fake-quant tier (≤ one
    output quantization step of x's and w's grids apart)."""
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((4, 6, 32)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((32, 24)).astype(np.float32))
    x[3, 2, 5] = 9.0            # the batch's abs-max lies in row 1's slab
    one = L.linear(x, w, q8=True)
    from repro.models import layers as JL
    jx = np.asarray(JL.linear(jnp.asarray(x.numpy()),
                              jnp.asarray(w.numpy()), q8=True))
    step = float(x.abs().max() / 127) * float(w.abs().max() / 127) * 32
    assert np.abs(one.numpy() - jx).max() <= step
    m11 = make_mesh_for(1, 1, device="cpu")
    assert torch.equal(_q8_rows(x, w, m11, tshd.P(None, "model")), one)
    m22 = make_mesh_for(4, 2, device="cpu", host_devices=4)
    assert torch.equal(_q8_rows(x, w, m22, tshd.P(None, "model")), one)
    _close(_q8_rows(x, w, m22, tshd.P("model", None)), one, "row-parallel")
    # each row quantizing by its own slab's abs-max is not what it computes
    alone = torch.cat([L.linear(xr, w, q8=True) for xr in x.split(2)])
    assert not torch.equal(alone, one)


def test_lockstep_rows_under_contention():
    """16 rows in lockstep threads (more than the cores), the interpreter
    switching threads every microsecond: every row quantizes with the
    batch's one scale, each q8 linear bit for bit with one device."""
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.standard_normal((16, 3, 8)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((8, 8)).astype(np.float32))
    x[11, 1, 2] = 7.0
    mesh = make_mesh_for(16, 1, device="cpu", host_devices=16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            assert torch.equal(_q8_rows(x, w, mesh, tshd.P(None, "model")),
                               L.linear(x, w, q8=True))
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_q8_serving_over_a_mesh_matches_one_device(arch):
    """A model with ``quantize_linears`` served over 1 × 1 (bit for bit)
    and 2 × 2 (fp32 tier) against one device."""
    cfg = _cfg(arch, quantize_linears=True)
    run = RunConfig(model=cfg, seq_len=S + 2, global_batch=B)
    inputs = batch_at(cfg, S, B, 0, mode="prefill")
    one = tsteps.generate(run, tsteps.init_lm_params(cfg, 0, "cpu"), inputs,
                          2, device="cpu", keep_logits=True)
    for mesh, exact in ((make_mesh_for(1, 1, device="cpu"), True),
                        (make_mesh_for(4, 2, device="cpu", host_devices=4),
                         False)):
        out = tsteps.generate(run, tsteps.init_lm_params(cfg, 0, mesh=mesh),
                              inputs, 2, mesh=mesh, keep_logits=True)
        for a, b in zip(out["logits"], one["logits"]):
            if exact:
                assert torch.equal(a, b)
            else:
                _close(a, b, f"{arch} q8 logits on {mesh.shape}")


def test_steps_place_batch_and_cache_by_the_jax_helpers():
    """The rows follow ``_batch_shardings`` (with "pod" read off the mesh:
    a (2, 2, 2) mesh cuts a batch of 4 over ("pod", "data"), of 2 over
    "data" alone, of 3 not at all), and a serve step refuses a cache that
    is not placed as ``_cache_pspec`` says."""
    pod = make_mesh_for(8, 2, 4, device="cpu", host_devices=8)
    rm = tsteps._rules(pod, False)
    assert rm["batch"] == ("pod", "data")
    for size, dp in ((4, ("pod", "data")), (2, "data"), (3, None)):
        batch = {"tokens": torch.zeros((size, 5), dtype=torch.int32)}
        assert tsteps._rows(pod, batch, rm).dp == dp
        assert tuple(tsteps._batch_shardings(pod, batch, rm)["tokens"]
                     .spec)[0] == dp
    mesh = make_mesh_for(4, 2, device="cpu", host_devices=4)
    cfg = _cfg("llama3.2-1b")
    k = torch.zeros((2, 4, 3, cfg.n_kv_heads, cfg.d_head))
    rm = tsteps._rules(mesh, False)
    rows = Rows(mesh, "data")
    tsteps._check_cache(cfg, {"k": rows.stitch_cache(
        "k", list(k.split(2, 1)))}, mesh, rm)
    whole = Sharded.place(k, tshd.NamedSharding(mesh, tshd.P()))
    with pytest.raises(ValueError, match="cache leaf 'k' placed"):
        tsteps._check_cache(cfg, {"k": whole}, mesh, rm)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

_TRAIN = ["--arch", "llama3.2-1b", "--tiny", "--steps", "4", "--seq", "16",
          "--batch", "4", "--checkpoint-every", "100", "--log-every", "2",
          "--device", "cpu", "--lr", "1e-2", "--model-parallel", "2",
          "--host-devices", "4"]


def test_train_launcher_resumes_a_2x2_mesh_and_restores_on_another(
        tmp_path):
    """4 steps straight against 2 steps, SIGTERM, ``--resume`` for the
    last 2 on the same 2 × 2 mesh: the same state, bit for bit. The
    last checkpoint restored onto ``--model-parallel 1`` (a 1 × 1 mesh):
    every leaf bit for bit."""
    straight = ttrain.main(_TRAIN + ["--checkpoint-dir",
                                     str(tmp_path / "a")])
    assert straight["mesh"].shape == {"data": 2, "model": 2}
    real = ttrain.batch_at

    def preempted(cfg, seq, batch, step, seed, device=None):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg, seq, batch, step, seed, device=device)
    ttrain.batch_at = preempted
    try:
        with pytest.raises(SystemExit) as e:
            ttrain.main(_TRAIN + ["--checkpoint-dir", str(tmp_path / "b")])
        assert e.value.code == 0
    finally:
        ttrain.batch_at = real
    assert latest_step(str(tmp_path / "b")) == 3
    resumed = ttrain.main(_TRAIN + ["--checkpoint-dir", str(tmp_path / "b"),
                                    "--resume"])
    assert resumed["losses"] == straight["losses"][3:]
    a = ttrain._state(straight["params"], straight["opt_state"])
    b = ttrain._state(resumed["params"], resumed["opt_state"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    # the 2 × 2 run's last save, resumed by a 1 × 1 mesh's launcher
    one = ttrain.main(_TRAIN[:-4] + ["--checkpoint-dir",
                                     str(tmp_path / "a"), "--resume"])
    assert one["mesh"].shape == {"data": 1, "model": 1}
    assert one["start_step"] == 4 and not one["losses"]
    for x, y in zip(tree_leaves(ttrain._state(one["params"],
                                              one["opt_state"])),
                    tree_leaves(a)):
        assert torch.equal(x, y)
    # restore(shardings=) places the leaves as they load
    cfg = tiny_variant(ARCHS["llama3.2-1b"])
    sh = tsteps.param_shardings(cfg, straight["mesh"])
    placed, _ = restore(str(tmp_path / "a"), {"0": one["params"]},
                        shardings={"0": sh})
    leaf = placed["0"]["embed"]
    assert isinstance(leaf, Sharded) and leaf.counts() == (2, 1)
    assert torch.equal(leaf.gather(), a["0"]["embed"])


def test_serving_example_over_a_2x2_mesh(capsys):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import serve_lm_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    args = ["--arch", "recurrentgemma-2b", "--prompt-len", "24",
            "--decode-len", "6", "--batch", "2", "--device", "cpu"]
    one = serve_lm_torch.main(args)
    out = serve_lm_torch.main(args + ["--model-parallel", "2",
                                      "--host-devices", "4"])
    assert torch.equal(out["tokens"], one["tokens"])
    assert "'data': 2, 'model': 2" in capsys.readouterr().out
