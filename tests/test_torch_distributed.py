"""The port's mesh-sharded int8 serving on the CPU, meshes of logical
``cpu`` devices in one process (the counterpart of the JAX package's
``tests/test_distributed.py`` conv-serving tests, which need forced host
devices in subprocesses):

* ``execute_int8_sharded`` bit for bit (``torch.equal`` on fp32) with the
  port's single-device ``execute_int8``: calibrated against fused,
  dynamic requant against staged, over F(2,3)/F(4,3) × canonical/legendre
  × Hadamard off/8/9 on (1,1)/(2,1)/(1,2)/(2,2) meshes, F(6,3) at 9 bits
  on (2,2) and the (4,2) mesh's 5-row slabs (JAX
  ``tests/test_distributed.py:567-672``);
* one case against the JAX package's ``execute_int8_sharded`` on a 1 × 1
  ``jax.sharding.Mesh`` (Pallas interpret mode), at the cross-package
  fp32 tier;
* placement, a checkpoint written under one mesh served under others,
  indivisible Cout, ``plan_cost_us`` and ``rules`` against the JAX
  package's, the serving mesh, and both launchers on a mesh.
"""
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.conv import planner as jplanner
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.winograd import WinogradSpec as JWinogradSpec
from repro.distributed import sharding as jsharding
from repro.kernels import ops as jops
from repro_torch.conv import ConvEngine, ConvPolicy
from repro_torch.conv.packing import place_packed_state
from repro_torch.conv.planner import (TP_COLLECTIVE_US, CandidateCost, Plan,
                                      PlanEntry, plan_cost_us)
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.distributed.sharding import (Mesh, Placed, axis_extent,
                                              data_axis_extent, device_grid,
                                              gather, gather_max, rules,
                                              shard)
from repro_torch.kernels.ops import (_extract, _geometry, _tiles_abs_max,
                                     execute_int8, execute_int8_sharded,
                                     prepare_weights_int8,
                                     scales_from_abs_max)
from repro_torch.launch import infer_resnet, serve
from repro_torch.launch.mesh import logical_devices, make_serving_mesh
from repro_torch.serving import GraphedForward

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))


def _mesh(dd, dm):
    return make_serving_mesh(dd, dm, host_devices=dd * dm, device="cpu")


def _model_axis(dm):
    return "model" if dm > 1 else None


def _layer(seed=0, x_shape=(2, 12, 12, 4), cout=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, x_shape[3], cout)) * 0.2
         ).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _references(x, w, m, base, bits):
    """The single-device operands and outputs: (operands, fused,
    staged dynamic or None)."""
    spec0 = WinogradSpec(m=m, r=3, base=base)
    u_q, w_s = prepare_weights_int8(w, spec0)
    tiles = _extract(x, m, 3, spec0.n, "same")
    geom = _geometry(x.shape, m, 3, "same")
    in_s = scales_from_abs_max(_tiles_abs_max(tiles, spec0))
    spec = WinogradSpec(m=m, r=3, base=base,
                        quant=QuantConfig(hadamard_bits=bits))
    h = None
    if bits is not None:
        _, amax = execute_int8(tiles, u_q, w_s, in_s, spec=spec, geom=geom,
                               hadamard_bits=bits, with_stats=True)
        h = amax.reshape(-1, 1)
    ops = dict(tiles=tiles, u_q=u_q, w_scales=w_s, in_scales=in_s,
               h_amax=h, spec=spec, geom=geom)
    ref = execute_int8(tiles, u_q, w_s, in_s, h, spec=spec, geom=geom,
                       hadamard_bits=bits, fused=True)
    ref_dyn = (execute_int8(tiles, u_q, w_s, in_s, None, spec=spec,
                            geom=geom, hadamard_bits=bits)
               if bits is not None else None)
    return ops, ref, ref_dyn


def _sharded(ops, mesh, bits, dynamic=False, **kw):
    return execute_int8_sharded(
        ops["tiles"], ops["u_q"], ops["w_scales"], ops["in_scales"],
        None if dynamic else ops["h_amax"], spec=ops["spec"],
        geom=ops["geom"], mesh=mesh, hadamard_bits=bits, **kw)


def _check_meshes(ops, ref, ref_dyn, bits, meshes):
    for dd, dm in meshes:
        mesh = _mesh(dd, dm)
        y = _sharded(ops, mesh, bits, model_axis=_model_axis(dm))
        assert torch.equal(y, ref), ("calibrated", dd, dm,
                                     float((y - ref).abs().max()))
        if bits is not None:
            yd = _sharded(ops, mesh, bits, dynamic=True,
                          model_axis=_model_axis(dm))
            assert torch.equal(yd, ref_dyn), (
                "dynamic", dd, dm, float((yd - ref_dyn).abs().max()))


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("base", ("canonical", "legendre"))
@pytest.mark.parametrize("bits", (None, 8, 9))
def test_sharded_serving_is_bitwise_single_device_on_every_mesh(m, base,
                                                                bits):
    """The tentpole sweep: on every mesh, calibrated slabs equal the
    single-device fused call and dynamic slabs (per-slab abs-max merged
    by one maximum) the single-device staged dynamic call, bit for bit."""
    x, w = _layer(seed=m + (bits or 0))
    ops, ref, ref_dyn = _references(x, w, m, base, bits)
    _check_meshes(ops, ref, ref_dyn, bits, MESHES)


@pytest.mark.parametrize("m,base,bits,mesh", [
    (6, "canonical", 9, (2, 2)),
    (6, "legendre", 9, (2, 2)),
    # T = 18 tiles over a (4, 2) mesh: 5-row slabs, 2 rows of padding
    (4, "legendre", 8, (4, 2))])
def test_sharded_f63_and_small_slabs_are_bitwise(m, base, bits, mesh):
    x, w = _layer(seed=7)
    ops, ref, ref_dyn = _references(x, w, m, base, bits)
    if mesh == (4, 2):
        assert ops["tiles"].shape[0] == 18
    _check_meshes(ops, ref, ref_dyn, bits, (mesh,))


def test_sharded_over_a_tuple_data_axis_and_a_replica_axis():
    """T shards over ("pod", "data") jointly, row-major; an axis named by
    neither data nor model holds replicas, and only its index 0
    computes."""
    x, w = _layer(seed=3)
    ops, ref, ref_dyn = _references(x, w, 4, "legendre", 9)
    devs = np.empty((2, 2, 2), dtype=object)
    devs[...] = CPU
    mesh = Mesh(devs, ("pod", "data", "model"))
    grid = device_grid(mesh, ("pod", "data"), "model")
    assert grid.shape == (4, 2)
    for data_axis, model_axis in ((("pod", "data"), "model"),
                                  ("data", None)):
        y = _sharded(ops, mesh, 9, data_axis=data_axis,
                     model_axis=model_axis)
        assert torch.equal(y, ref)
        yd = _sharded(ops, mesh, 9, dynamic=True, data_axis=data_axis,
                      model_axis=model_axis)
        assert torch.equal(yd, ref_dyn)


def test_sharded_matches_jax_sharded_on_a_1x1_mesh():
    """The port's and the JAX package's ``execute_int8_sharded`` on a 1 × 1
    mesh (the JAX one over the process's one CPU device, Pallas in
    interpret mode), the same numpy inputs, calibrated and dynamic
    requant. Inside each package the sharded call is bit for bit its
    single-device one (docs/parity.md's sharded rows; the port's are the
    sweep above, the JAX package's checked here). Across the packages
    the fp32 output is held at the cross-package fp32 tier (rtol = atol
    = 1e-4): XLA contracts the JAX output transform's multiply-adds
    differently from the bitwise order the port's kernels keep, so the
    two differ in last bits (here up to ~1e-6)."""
    x, w = _layer(seed=5, x_shape=(2, 8, 8, 4))
    ops, _, _ = _references(x, w, 2, "legendre", 8)
    jspec = JWinogradSpec(m=2, r=3, base="legendre",
                          quant=JQuantConfig(hadamard_bits=8))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    mesh = _mesh(1, 1)
    args = [ops[k].numpy() for k in ("tiles", "u_q", "w_scales",
                                     "in_scales")]
    hj = ops["h_amax"].numpy()
    # the three JAX programs compile and run in worker threads at once
    # (XLA compiles off the GIL; the same programs as one by one)
    with ThreadPoolExecutor(max_workers=3) as pool:
        sharded = {h is None: pool.submit(
            lambda h=h: np.asarray(jops.execute_int8_sharded(
                *args, h, spec=jspec, geom=ops["geom"], mesh=jmesh,
                hadamard_bits=8, interpret=True, model_axis="model")))
            for h in (hj, None)}
        single = pool.submit(lambda: np.asarray(jops.execute_int8(
            *args, hj, spec=jspec, geom=ops["geom"], hadamard_bits=8,
            fused=True, interpret=True)))
        assert np.array_equal(sharded[False].result(), single.result())
        for dynamic in (False, True):
            got = _sharded(ops, mesh, 8, dynamic=dynamic, model_axis="model")
            np.testing.assert_allclose(got.numpy(), sharded[dynamic].result(),
                                       rtol=1e-4, atol=1e-4)


def test_indivisible_cout_raises_naming_the_axis_and_the_leaf():
    x, w = _layer(cout=8)
    ops, _, _ = _references(x, w, 4, "legendre", 9)
    mesh = _mesh(1, 3)
    with pytest.raises(ValueError, match=r"Cout=8 .*'model' mesh axis "
                                         r"extent 3"):
        _sharded(ops, mesh, 9, model_axis="model")
    tree = {"packed": {"c": {"u_q": ops["u_q"],
                             "w_scales": ops["w_scales"]}}}
    with pytest.raises(ValueError, match="packed/c/u_q: Cout=8"):
        place_packed_state(mesh, tree, model_axis="model")
    # a model axis of extent 1 cuts nothing: each leaf is whole, and on
    # its own device it is the leaf itself
    placed = place_packed_state(_mesh(2, 1), tree,
                                model_axis="model")["packed"]["c"]
    assert placed["u_q"].blocks == 1 and placed["w_scales"].blocks == 1
    assert placed["u_q"].local(CPU) is ops["u_q"]
    assert placed["w_scales"].local(CPU) is ops["w_scales"]


def _engine(mesh=None, dm=1, fused=True):
    spec = WinogradSpec(m=4, r=3, base="legendre",
                        quant=QuantConfig(hadamard_bits=9))
    return ConvEngine(spec, ConvPolicy(backend="winograd_int8"),
                      fused=fused, device=None if mesh else CPU, mesh=mesh,
                      model_axis=_model_axis(dm))


def test_engine_export_under_one_mesh_restores_and_serves_under_others():
    """Export under a (2, 1) mesh writes full arrays; restored under (1, 2)
    and (2, 2) the state is placed (u_q Cout-sharded, the statistics
    whole on every device) and serves the same bits as the single-device
    engine. A layer whose Hadamard statistic was dropped serves the
    sharded dynamic requant: the single-device staged bits."""
    x, w = _layer(seed=11, x_shape=(2, 12, 12, 6), cout=12)
    src = _engine(_mesh(2, 1))
    src.prepare([("c", w)])
    with src.calibration():
        src.conv2d(x, None, layer="c")
    tree = src.export_state()
    assert tuple(tree["packed"]["c"]["u_q"].shape) == (36, 6, 12)
    placed = place_packed_state(_mesh(1, 2), tree, model_axis="model")
    assert placed["packed"]["c"]["blocks"] is tree["packed"]["c"]["blocks"]
    assert placed["packed"]["c"]["u_q"].blocks == 2
    single = _engine()
    single.import_state(tree)
    want = single.conv2d(x, None, layer="c")
    assert torch.equal(src.conv2d(x, None, layer="c"), want)
    for dd, dm in ((1, 2), (2, 2)):
        eng = _engine(_mesh(dd, dm), dm)
        eng.import_state(tree)
        placed = eng._placed["c"]
        assert isinstance(placed["u_q"], Placed)
        assert tuple(placed["u_q"].local(CPU, 1).shape) == (36, 6, 6)
        assert torch.equal(placed["in_scales"].local(CPU),
                           tree["packed"]["c"]["in_scales"])
        # one copy: a whole leaf on the first device is the packed one
        assert placed["in_scales"].local(CPU) is eng.packed["c"].in_scales
        assert torch.equal(eng.conv2d(x, None, layer="c"), want)
        back = eng.export_state()["packed"]["c"]
        for k, v in tree["packed"]["c"].items():
            assert torch.equal(back[k], v), k
    # the statistic dropped: sharded dynamic == single-device staged
    dropped = dataclasses.replace(single.packed["c"], hadamard_amax=None)
    single.packed["c"] = dropped
    staged = single.conv2d(x, None, layer="c")
    eng = _engine(_mesh(2, 2), 2)
    eng.import_state({"packed": {"c": dropped.to_tree()}})
    assert "hadamard_amax" not in eng._placed["c"]
    assert torch.equal(eng.conv2d(x, None, layer="c"), staged)
    # fused=False on a mesh engine runs on its first device
    plain = _engine(_mesh(2, 2), 2, fused=False)
    plain.import_state(tree)
    staged_single = _engine(fused=False)
    staged_single.import_state(tree)
    assert torch.equal(plain.conv2d(x, None, layer="c"),
                       staged_single.conv2d(x, None, layer="c"))


def test_slab_helpers_cut_and_gather():
    mesh = _mesh(2, 2)
    t = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    parts = shard(t, mesh, "data", dim=1)
    assert [tuple(p.shape) for p in parts] == [(2, 4, 3), (2, 4, 3)]
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(gather(parts, mesh, dim=1), t)
    assert shard(t, mesh, None, dim=1)[0] is t
    with pytest.raises(ValueError, match="does not split"):
        shard(t, mesh, "model", dim=2)
    assert torch.equal(gather_max([t, t.flip(1), -t], mesh),
                       torch.maximum(t, t.flip(1)))
    p = Placed(t, mesh, "model", dim=1)
    assert torch.equal(gather([p.local(CPU, k) for k in (0, 1)], mesh,
                              dim=1), t)
    # one copy of each block on the device the four positions repeat
    assert [tuple(p.local(CPU, k).shape) for k in (0, 1)] == [(2, 4, 3)] * 2
    with pytest.raises(KeyError, match="no block 2"):
        p.local(CPU, 2)


def test_axis_extent_and_rules_equal_jax():
    shaped = types.SimpleNamespace(shape={"pod": 2, "data": 3, "model": 4})
    for name in (None, "data", "model", ("pod", "data"), "absent",
                 ("data", "absent")):
        assert axis_extent(shaped, name) == \
            jsharding.axis_extent(shaped, name), name
    for name in ("data", ("pod", "data", "model")):
        assert data_axis_extent(shaped, name) == \
            jsharding.data_axis_extent(shaped, name)
    with pytest.raises(KeyError):
        data_axis_extent(_mesh(2, 1), "model")
    with pytest.raises(KeyError):
        jsharding.data_axis_extent(shaped, "absent")
    for fsdp in (False, True):
        for multi_pod in (False, True):
            for conv_tp in (False, True):
                assert rules(fsdp, multi_pod, conv_tp) == \
                    jsharding.rules(fsdp, multi_pod, conv_tp)


def test_plan_cost_us_equals_jax():
    """The mesh form of the planner's cost: Winograd rows over D_data ·
    D_model plus the modelled gather per layer where D_model > 1, direct
    rows over D_data; the same numbers as the JAX package's on the same
    plan and table (JAX's ``axis_extent`` reads only ``mesh.shape``)."""
    assert TP_COLLECTIVE_US == jplanner.TP_COLLECTIVE_US
    rows = {"a": [("direct", None, None, None, 410.0),
                  ("winograd_int8", 4, "legendre", 9, 233.5)],
            "b": [("direct", None, None, None, 97.25),
                  ("winograd_int8", 2, "canonical", None, 61.0)],
            "c": [("winograd_int8", 6, "legendre", 8, 1210.125)]}
    pick = {"a": 1, "b": 0, "c": 0}

    def build(E, C, P_):
        costs = {l: tuple(C(E(b, m=m, r=3 if m else None, base=base,
                              hadamard_bits=bits), us, 0.01)
                          for b, m, base, bits, us in rs)
                 for l, rs in rows.items()}
        return P_({l: costs[l][i].entry for l, i in pick.items()}), costs
    plan, costs = build(PlanEntry, CandidateCost, Plan)
    jplan, jcosts = build(jplanner.PlanEntry, jplanner.CandidateCost,
                          jplanner.Plan)
    for shape, model_axis in (({"data": 1}, None), ({"data": 4}, None),
                              ({"data": 2, "model": 2}, "model"),
                              ({"data": 2, "model": 4}, "model"),
                              ({"data": 3, "model": 2}, None)):
        stand_in = types.SimpleNamespace(shape=shape)
        for us in (TP_COLLECTIVE_US, 7.5):
            want = jplanner.plan_cost_us(jplan, jcosts, mesh=stand_in,
                                         model_axis=model_axis,
                                         collective_us=us)
            assert plan_cost_us(plan, costs, mesh=stand_in,
                                model_axis=model_axis,
                                collective_us=us) == want
    assert plan_cost_us(plan, costs) == jplanner.plan_cost_us(jplan, jcosts)
    mesh = _mesh(2, 2)
    assert plan_cost_us(plan, costs, mesh=mesh, model_axis="model") == \
        jplanner.plan_cost_us(jplan, jcosts,
                              mesh=types.SimpleNamespace(shape=mesh.shape),
                              model_axis="model")


def test_serving_mesh_lays_logical_devices_and_refuses_missing_ones():
    assert logical_devices("cpu") == [CPU]
    assert logical_devices("cpu", host_devices=3) == [CPU] * 3
    m = make_serving_mesh(2, 2, host_devices=4, device="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {"data": 2,
                                                            "model": 2}
    assert m.distinct() == [CPU] and m.cards() == 0
    d = make_serving_mesh(3, host_devices=4, device="cpu")
    assert d.axis_names == ("data",) and d.shape == {"data": 3}
    with pytest.raises(ValueError, match="pass --host-devices"):
        make_serving_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="--host-devices 2 gives 2"):
        make_serving_mesh(2, 2, host_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_mesh(1, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ConvEngine(None, mesh=Mesh(["cuda:0"], ("data",)))
    # a mesh over two cards is not captured into a graph
    two = Mesh([torch.device("cuda", 0), torch.device("cuda", 1)],
               ("data",))
    assert two.cards() == 2 and str(Mesh(["cuda"], ("d",)).first) == \
        "cuda:0"
    with pytest.raises(NotImplementedError, match="across 2 cards"):
        GraphedForward(lambda x: x, "cuda:0", mesh=two)


def test_infer_resnet_serves_every_stage5_mesh_bitwise_on_cpu():
    out = infer_resnet.main(["--width", "0.125", "--batch", "2",
                             "--calib-steps", "1", "--device", "cpu",
                             "--host-devices", "4"])
    assert [tuple(r["mesh"]) for r in out["sharded"]] == \
        list(infer_resnet.STAGE5_MESHES)
    for r in out["sharded"]:
        assert r["bitwise_vs_fused"] and r["rel_vs_fused"] == 0.0
        assert abs(r["rel_fp"] - out["rel_fused_fp"]) < 0.05
    with pytest.raises(ValueError, match="a 4×1 mesh needs 4 devices: "
                                         "--host-devices 2 gives 2"):
        infer_resnet.main(["--width", "0.125", "--batch", "2",
                           "--calib-steps", "1", "--device", "cpu",
                           "--host-devices", "2"])


def test_infer_resnet_serves_the_one_device_mesh_without_host_devices():
    """On one device and without --host-devices, stage 5 serves the
    1-device mesh, as the JAX launcher does."""
    out = infer_resnet.main(["--width", "0.125", "--batch", "2",
                             "--calib-steps", "1", "--device", "cpu"])
    assert [r["mesh"] for r in out["sharded"]] == [[1, 1]]
    assert out["sharded"][0]["bitwise_vs_fused"]


def test_serve_launcher_on_a_2x2_mesh_on_cpu():
    args = ["--device", "cpu", "--width", "0.125", "--buckets", "1,2",
            "--requests", "6", "--solo-requests", "2", "--rate", "50",
            "--max-wait-ms", "5", "--mesh-devices", "2",
            "--model-devices", "2"]
    out = serve.main(args + ["--host-devices", "4"])
    assert out["mesh"]["shape"] == {"data": 2, "model": 2}
    assert out["answered"] == 6 and out["compiles_after_warmup"] == 0
    assert sorted(out["rows_checked"]) == [1, 2]
    with pytest.raises(ValueError, match="a 2×2 mesh needs 4 devices"):
        serve.main(args)


def test_mesh_keys_k4_tiles_by_the_slab_shape():
    """A tile tuned at the layer's full (T, Cout) is not a slab's: under a
    mesh the engine takes the checkpoint's tile only where the slab has
    both, and warm-up with autotune tunes each slab's own (T, Cout)."""
    x, w = _layer(seed=13)                    # T = 18, Cout = 8
    src = ConvEngine(WinogradSpec(m=4, r=3, base="legendre",
                                  quant=QuantConfig(hadamard_bits=9)),
                     ConvPolicy(backend="winograd_int8"), device=CPU,
                     autotune=True)
    src.prepare([("c", w)])
    with src.calibration():
        src.conv2d(x, None, layer="c")
    assert src.packed["c"].tuned[1] == 18
    tree = src.export_state()
    for (dd, dm), slab in (((1, 1), None), ((2, 1), (9, 8)),
                           ((1, 2), (18, 4)), ((2, 2), (9, 4))):
        eng = ConvEngine(src.spec, ConvPolicy(backend="winograd_int8"),
                         mesh=_mesh(dd, dm), model_axis=_model_axis(dm),
                         autotune=True)
        eng.import_state(tree)
        eng.warmup([tuple(x.shape)],
                   forward=lambda v, e=eng: e.conv2d(v, None, layer="c"))
        assert list(eng.tuned_tiles) == ([] if slab is None
                                         else [("c", *slab)])
