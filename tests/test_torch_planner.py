"""The port's range certifier, engine gate, planner, autotune and planned
checkpoints against the JAX package, on the CPU.

* ``certify_config``: the port's report equals the JAX package's on every
  config of the committed ``ANALYSIS_ranges.json``, the negative control
  and the flip points (Cin = 1040/1041 for the Hadamard cast, 133144/
  133145 for the int32 accumulator), stage by stage, exactly.
* ``solve_plan`` reproduces ``tests/data/golden_plan.json`` on the frozen
  cost surface of ``tests/test_planner.py``.
* A planned, tuned checkpoint written by either package routes the same
  in the other; the ``blocks`` leaf round-trips bit for bit and each
  package reads the other's as "not tuned".
"""
import dataclasses
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import certify as jcertify
from repro.analysis.ranges import certify_config as jcertify_config
from repro.checkpoint import checkpoint as jckpt
from repro.conv import ConvEngine as JConvEngine
from repro.conv import ConvPolicy as JConvPolicy
from repro.conv import planner as jplanner
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.winograd import WinogradSpec as JWinogradSpec
from repro.models import resnet as JRN
from repro_torch.analysis import certify as tcertify
from repro_torch.analysis.ranges import certify_config
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.conv import ConvEngine, ConvPolicy, autotune
from repro_torch.conv.planner import (CandidateCost, LayerGeom, Plan,
                                      PlanEntry, build_plan,
                                      candidate_entries, measure_layer,
                                      plan_cost_us, solve_plan)
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels.fused_serve import (SMEM_LIMIT, TILES,
                                             fused_smem_bytes, fused_tile)
from repro_torch.models import resnet as RN

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _wentry(m=4, base="legendre", bits=9):
    return PlanEntry("winograd_int8", m=m, r=3, base=base,
                     hadamard_bits=bits)


def _spec(m=4, base="legendre", bits=9):
    return WinogradSpec(m=m, r=3, base=base,
                        quant=QuantConfig(hadamard_bits=bits))


def _engine(plan=None, **kw):
    return ConvEngine(_spec(), ConvPolicy(backend="winograd_int8"),
                      plan=plan, device=CPU, **kw)


# ---------------------------------------------------------------------------
# range certifier
# ---------------------------------------------------------------------------

def _committed_configs():
    rep = json.loads((REPO / "ANALYSIS_ranges.json").read_text())
    rows = rep["rows"] + [rep["negative_control"]]
    return [(r["m"], r["r"], r["base"], r["hadamard_bits"], r["cin"])
            for r in rows]


FLIPS = [(m, 3, base, bits, cin) for m in (2, 4, 6)
         for base in ("canonical", "legendre") for bits in (None, 9)
         for cin in (1040, 1041, 133144, 133145)]


def test_certify_config_equals_jax_on_every_committed_config_and_flip():
    configs = _committed_configs()
    assert len(configs) == 73
    flipped = {"hadamard": set(), "int32": set()}
    for cfg in configs + FLIPS:
        ours, ref = certify_config(*cfg), jcertify_config(*cfg)
        assert ours.to_dict() == ref.to_dict(), cfg
        assert ours.summary() == ref.summary()
        assert (ours.int32_safe, ours.hadamard_safe, ours.proved) == \
            (ref.int32_safe, ref.hadamard_safe, ref.proved), cfg
        flipped["hadamard"].add((cfg[4], ours.hadamard_safe))
        flipped["int32"].add((cfg[4], ours.int32_safe))
    # the two flip points
    assert (1040, True) in flipped["hadamard"]
    assert (1041, False) in flipped["hadamard"]
    assert (133144, True) in flipped["int32"]
    assert (133145, False) in flipped["int32"]


def test_certify_cli_reaches_the_jax_verdict_on_the_committed_report():
    assert tcertify.build_report() == jcertify.build_report()
    assert tcertify.main([]) == 0
    # a drifted copy is caught, and the committed file is never written
    committed = REPO / "ANALYSIS_ranges.json"
    before = committed.read_bytes()
    rep = json.loads(before)
    rep["rows"][0]["acc_bound"] += 1
    assert tcertify.diff_reports(rep, tcertify.build_report())
    assert committed.read_bytes() == before


# ---------------------------------------------------------------------------
# the engine's certify= gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "warn", "error"])
def test_engine_certify_modes(mode):
    """F(4,3) Legendre with the 9-bit grid is proved at Cin = 1040 and
    refused at 1041 (the int32 → fp32 cast stops being exact): "error"
    raises and packs nothing, "warn" packs with a RuntimeWarning, "off"
    packs silently; a proved config packs in every mode."""
    eng = _engine(certify=mode)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert eng.prepare_layer("ok", torch.zeros((3, 3, 1040, 1)))
    assert not rec
    w = torch.zeros((3, 3, 1041, 1))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        if mode == "error":
            with pytest.raises(ValueError, match="UNSAFE"):
                eng.prepare_layer("big", w)
            assert "big" not in eng.packed
        else:
            assert eng.prepare_layer("big", w)
    warned = [r for r in rec if issubclass(r.category, RuntimeWarning)]
    assert bool(warned) == (mode == "warn")


def test_engine_rejects_bad_certify_knob_and_gates_plans_always():
    with pytest.raises(ValueError, match="certify"):
        _engine(certify="maybe")
    bad = _wentry(6, "canonical", 8)
    eng = _engine(plan=Plan({"big": bad, "ok": bad}), certify="off")
    with pytest.raises(ValueError, match="contradicts the range certifier"):
        eng.prepare_layer("big", torch.zeros((3, 3, 2 ** 18, 1)))
    assert "big" not in eng.packed
    assert eng.prepare_layer("ok", torch.zeros((3, 3, 64, 1)))


# ---------------------------------------------------------------------------
# plan codec, candidates, solver
# ---------------------------------------------------------------------------

ENTRIES = [PlanEntry(), _wentry(2, "canonical", None),
           _wentry(2, "canonical", 8), _wentry(4, "legendre", 9),
           _wentry(6, "legendre", 9), _wentry(4, "chebyshev", 8)]


def _jentry(e: PlanEntry):
    return jplanner.PlanEntry(**e.to_dict())


def test_plan_entry_codec_equals_jax():
    for e in ENTRIES:
        vec = e.encode()
        assert vec.dtype == np.int32 and vec.shape == (5,)
        np.testing.assert_array_equal(vec, _jentry(e).encode())
        assert PlanEntry.decode(vec) == e
        assert PlanEntry.decode(_jentry(e).encode()) == e
        assert e.describe() == _jentry(e).describe()
    for bad, match in (([7, 4, 3, 0, 9], "algorithm id"),
                       ([1, 4, 3, 9, 9], "base id"), ([0, 0, 0], "fields")):
        with pytest.raises(ValueError, match=match):
            PlanEntry.decode(np.array(bad, np.int32))
    with pytest.raises(ValueError, match="no spec fields"):
        PlanEntry("direct", m=4)
    plan = Plan({"a": ENTRIES[2], "b": PlanEntry()})
    assert Plan.from_tree(plan.to_tree()) == plan
    assert Plan.from_dict(plan.to_dict()) == plan
    assert "1 winograd_int8" in plan.describe()


def test_candidate_grid_equals_jax():
    for args in ((3, 1, 64), (3, 1, 1041), (3, 2, 64), (1, 1, 64),
                 (3, 1, 2 ** 18)):
        ours = candidate_entries(*args)
        ref = jplanner.candidate_entries(*args)
        assert [e.to_dict() for e in ours] == [e.to_dict() for e in ref]
    assert sum(e.is_winograd for e in candidate_entries(3, 1, 64)) == 18
    assert sum(e.is_winograd
               for e in candidate_entries(3, 1, 2 ** 18, certify=False)) \
        == 18


# The frozen synthetic cost surface of tests/test_planner.py.
_SYNTH_ERR = {2: 0.004, 4: 0.011, 6: 0.028}
_SYNTH_BASE = {"canonical": 1.6, "legendre": 1.0}
_SYNTH_BITS = {None: 0.8, 8: 2.4, 9: 1.0}


def _synthetic_cost_table(geoms):
    costs = {}
    for g in geoms:
        b, h, _, cin = g.x_shape
        ho = -(-h // g.stride)
        rows = []
        for e in candidate_entries(g.kernel_size, g.stride, cin):
            if not e.is_winograd:
                us = b * ho * ho * cin * g.cout * g.kernel_size ** 2 / 2e4
                err = 0.0
            else:
                n = e.m + e.r - 1
                tiles = b * (-(-ho // e.m)) ** 2
                us = (tiles * n * n * cin * g.cout / 8e4
                      + tiles * n * n * (cin + g.cout) / 1e3)
                err = (_SYNTH_ERR[e.m] * _SYNTH_BASE[e.base]
                       * _SYNTH_BITS[e.hadamard_bits] * (1.0 + cin / 4096.0))
            rows.append(CandidateCost(e, us, err))
        costs[g.layer] = tuple(rows)
    return costs


def test_solve_plan_reproduces_the_golden_plan():
    cfg = RN.ResNetConfig(width_mult=1.0, wino=_spec())
    geoms = RN.layer_geoms(cfg, batch=8)
    jgeoms = JRN.layer_geoms(JRN.ResNetConfig(
        width_mult=1.0, wino=JWinogradSpec(
            m=4, r=3, base="legendre",
            quant=JQuantConfig(hadamard_bits=9))), batch=8)
    assert [dataclasses.astuple(g) for g in geoms] == \
        [dataclasses.astuple(g) for g in jgeoms]
    costs = _synthetic_cost_table(geoms)
    plan = solve_plan(costs, baseline=_wentry())
    golden = json.loads((REPO / "tests" / "data" /
                         "golden_plan.json").read_text())
    assert plan.to_dict() == golden
    assert {e["algorithm"] for e in golden.values()} == \
        {"direct", "winograd_int8"}
    # and the plan is no slower than the baseline everywhere it fits
    hand = Plan({g.layer: (_wentry() if g.kernel_size == 3 and
                           g.stride == 1 else PlanEntry()) for g in geoms})
    assert plan_cost_us(plan, costs) <= plan_cost_us(hand, costs)


def test_measure_layer_and_build_plan_on_the_cpu():
    geom = LayerGeom("l", (1, 8, 8, 4), 4)
    cands = [PlanEntry(), _wentry(2, "legendre", 8), _wentry(6, "legendre",
                                                              None)]
    costs = measure_layer(geom, cands, device="cpu", iters=1, warmup=0)
    assert [c.entry for c in costs] == cands
    assert costs[0].rel_err == 0.0
    assert all(np.isfinite(c.us) and c.us > 0 for c in costs)
    assert all(0 < c.rel_err < 0.2 for c in costs[1:])
    again = measure_layer(geom, cands, device="cpu", iters=1, warmup=0)
    assert all(a is b for a, b in zip(costs, again))
    plan, table = build_plan([geom], baseline=_wentry(2, "legendre", 8),
                             tile_sizes=(2,), bases=("legendre",),
                             hadamard_bits=(8,), device="cpu", iters=1,
                             warmup=0)
    won = next(c for c in table["l"] if c.entry == plan.get("l"))
    assert won.rel_err <= table["l"][1].rel_err + 0.02


# ---------------------------------------------------------------------------
# plan routing, autotune, checkpoints across the packages
# ---------------------------------------------------------------------------

def _data(seed, cin=8, cout=12, hw=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, hw, hw, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32))


PLAN = {"a": _wentry(2, "canonical", 8), "b": _wentry(6, "legendre", None),
        "c": _wentry(4, "legendre", 9), "d": PlanEntry()}


def _routes(eng, layers):
    """(backend, m, base, hadamard bits) per layer."""
    out = {}
    for l in layers:
        b = eng.backend_for(l, kernel_size=3, stride=1)
        s = eng._layer_spec(l)
        out[l] = (b, s.m, s.base, eng._layer_hbits(l)) \
            if b == "winograd_int8" else (b,)
    return out


def test_plan_routing_wins_over_policy_and_matches_single_spec_engines():
    eng = _engine(plan=Plan(PLAN))
    assert eng.backend_for("d", kernel_size=3, stride=1) == "direct"
    assert eng.backend_for("other", kernel_size=3, stride=2) == "direct"
    with pytest.raises(ValueError, match="outside that Winograd regime"):
        eng.backend_for("a", kernel_size=3, stride=2)
    data = {l: _data(i) for i, l in enumerate(PLAN)}
    assert eng.prepare([(l, torch.from_numpy(w))
                        for l, (_, w) in data.items()]) == ["a", "b", "c"]
    with torch.inference_mode(), eng.calibration():
        for l in "abc":
            eng.conv2d(torch.from_numpy(data[l][0]), None, layer=l)
    for l in "abc":
        e = PLAN[l]
        solo = ConvEngine(e.spec(), ConvPolicy(backend="winograd_int8"),
                          hadamard_bits=e.hadamard_bits, device=CPU)
        x, w = (torch.from_numpy(a) for a in data[l])
        solo.prepare([(l, w)])
        with torch.inference_mode():
            with solo.calibration():
                solo.conv2d(x, None, layer=l)
            assert torch.equal(solo.conv2d(x, None, layer=l),
                               eng.conv2d(x, None, layer=l)), l


def test_autotune_tile_filter_and_leaf():
    for n in (4, 6, 8):
        for requant in (False, True):
            for T, cout in ((16, 32), (4096, 512), (100000, 64)):
                cands = autotune.candidate_tiles(n, T, cout, requant)
                assert cands[0] == fused_tile(n, T, cout, requant)
                assert set(cands) <= set(TILES)
                assert all(fused_smem_bytes(n, *t, requant) <= SMEM_LIMIT
                           for t in cands)
                assert len(set(cands)) == len(cands)
    # unmeasured without a card: the default tile, NaN times
    res = autotune.autotune_blocks(_spec(), 64, 8, 12, hadamard_bits=9,
                                   device="cpu")
    assert res.tile == fused_tile(6, 64, 12, True) and not res.measured
    # the leaf: the port's encoding with the T the tile was timed at, and
    # the JAX package's blocks refused
    from repro_torch.conv.packing import (PackedWinogradWeights,
                                          tile_from_leaf, tile_leaf)
    for t in TILES:
        leaf = tile_leaf(t, 144)
        assert leaf.tolist() == [-t[0], -t[1], -144]
        assert tile_from_leaf(leaf) == (t, 144)
        pk = PackedWinogradWeights(u_q=None, w_scales=None, blocks=leaf)
        assert pk.tuned == (t, 144) and pk.tile_at(144) == t
        assert pk.tile_at(36) is None and pk.tile_at(576) is None
    for jax_blocks in ([32, 32, 32], [16, 32, 64], [128, 128, 256],
                       [-1, -1, -1], [-8, -32, -2], [32, 32, -64]):
        assert tile_from_leaf(torch.tensor(jax_blocks, dtype=torch.int32)) \
            is None, jax_blocks
    assert PackedWinogradWeights(u_q=None, w_scales=None).tile_at(1) is None
    with pytest.raises(ValueError, match="no tile"):
        tile_leaf((8, 8), 144)
    with pytest.raises(ValueError, match="T >= 1"):
        tile_leaf(TILES[0], 0)


def test_autotuned_planned_checkpoint_round_trips_the_blocks_leaf(tmp_path):
    eng = _engine(plan=Plan(PLAN), autotune=True)
    data = {l: _data(i) for i, l in enumerate(PLAN)}
    eng.prepare([(l, torch.from_numpy(w)) for l, (_, w) in data.items()])
    with torch.inference_mode(), eng.calibration():
        for l in "abc":
            eng.conv2d(torch.from_numpy(data[l][0]), None, layer=l)
    tiles = {l: p.tuned for l, p in eng.packed.items()}
    assert all(t[0] in TILES and t[1] > 0 for t in tiles.values()), tiles
    state = eng.export_state()
    tckpt.save(str(tmp_path), 0, state)
    assert Plan.from_checkpoint(str(tmp_path)) == Plan(PLAN)
    served = _engine(plan=Plan.from_checkpoint(str(tmp_path)))
    served.prepare([(l, torch.from_numpy(w)) for l, (_, w) in data.items()])
    tree, _ = tckpt.restore(str(tmp_path), served.state_template())
    served.import_state(tree)
    for l, p in served.packed.items():
        assert torch.equal(p.blocks, state["packed"][l]["blocks"]), l
        assert p.tuned == tiles[l]
    with torch.inference_mode():
        for l in "abc":
            x = torch.from_numpy(data[l][0])
            assert torch.equal(served.conv2d(x, None, layer=l),
                               eng.conv2d(x, None, layer=l)), l


def test_engine_serves_the_tuned_tile_only_at_its_T(monkeypatch):
    """The tuned tile is K4's tile only at the T it was timed at (the
    calibration batch's); a batch of another size gets None, that is
    ``fused_tile``'s choice for its own shape, until ``warmup`` tunes
    that T."""
    import repro_torch.conv.engine as E
    seen = []
    real = E.winograd_conv2d_int8

    def spy(*args, **kw):
        seen.append(kw.get("tile"))
        return real(*args, **kw)
    monkeypatch.setattr(E, "winograd_conv2d_int8", spy)
    eng = _engine(autotune=True)
    x, w = _data(7)                       # N = 2, 10×10 → T = 2·3·3 = 18
    eng.prepare([("c", torch.from_numpy(w))])
    with torch.inference_mode():
        with eng.calibration():
            eng.conv2d(torch.from_numpy(x), None, layer="c")
        tile, T = eng.packed["c"].tuned
        assert T == 18 and tile in TILES
        eng.conv2d(torch.from_numpy(x), None, layer="c")
        eng.conv2d(torch.from_numpy(x[:1]), None, layer="c")
    assert seen == [tile, None]
    # warm-up with autotune tunes the other T (on the CPU: the default,
    # unmeasured) and later calls at it take that tile; it is keyed by
    # the call's (T, Cout), since a mesh's slabs have their own Cout
    eng.warmup([(1, 10, 10, 8)],
               forward=lambda x: eng.conv2d(x, None, layer="c"))
    assert eng.tuned_tiles == {("c", 9, 12): fused_tile(6, 9, 12, True)}
    with torch.inference_mode():
        eng.conv2d(torch.from_numpy(x[:1]), None, layer="c")
    assert seen[2:] == [fused_tile(6, 9, 12, True)] * 2


def _jax_engine(plan):
    spec = JWinogradSpec(m=4, r=3, base="legendre",
                         quant=JQuantConfig(hadamard_bits=9))
    return JConvEngine(spec, JConvPolicy(backend="winograd_int8"),
                       plan=plan)


def test_jax_checkpoint_routes_the_same_in_the_port(tmp_path):
    """JAX save of a planned, tuned state → the port's
    ``Plan.from_checkpoint`` + restore: the same routes, the Pallas
    ``blocks`` leaf kept bit for bit but read as "not tuned"."""
    jplan = jplanner.Plan({l: _jentry(e) for l, e in PLAN.items()})
    jeng = _jax_engine(jplan)
    data = {l: _data(i) for i, l in enumerate(PLAN)}
    jeng.prepare([(l, jnp.asarray(w)) for l, (_, w) in data.items()])
    # calibrated statistics and a tuned Pallas block split, set directly
    # (the JAX engine's own calibration runs interpret-mode kernels)
    for l, pk in list(jeng.packed.items()):
        P = pk.u_q.shape[0]
        jeng.packed[l] = dataclasses.replace(
            pk, in_scales=jnp.full((P, 1), 0.01, jnp.float32),
            hadamard_amax=(jnp.full((P, 1), 3.0, jnp.float32)
                           if PLAN[l].hadamard_bits else None),
            blocks=jnp.asarray([32, 32, 64], jnp.int32))
    jckpt.save(str(tmp_path), 0, jeng.export_state())

    plan = Plan.from_checkpoint(str(tmp_path))
    assert plan == Plan(PLAN)
    eng = _engine(plan=plan)
    eng.prepare([(l, torch.from_numpy(w)) for l, (_, w) in data.items()])
    tree, _ = tckpt.restore(str(tmp_path), eng.state_template())
    eng.import_state(tree)
    assert _routes(eng, PLAN) == _routes(jeng, PLAN)
    for l, pk in eng.packed.items():
        assert pk.blocks.tolist() == [32, 32, 64] and pk.tuned is None, l
        np.testing.assert_array_equal(pk.u_q.numpy(),
                                      np.asarray(jeng.packed[l].u_q))
    with torch.inference_mode():
        y = eng.conv2d(torch.from_numpy(data["c"][0]), None, layer="c")
    assert bool(torch.isfinite(y).all())


def test_port_checkpoint_routes_the_same_in_jax(tmp_path):
    """Port save of a planned, tuned state → JAX ``peek_leaves`` +
    ``Plan.from_checkpoint`` + restore: the same routes, and the port's
    K4 tile read as untuned by the JAX package."""
    eng = _engine(plan=Plan(PLAN), autotune=True)
    data = {l: _data(i) for i, l in enumerate(PLAN)}
    eng.prepare([(l, torch.from_numpy(w)) for l, (_, w) in data.items()])
    with torch.inference_mode(), eng.calibration():
        for l in "abc":
            eng.conv2d(torch.from_numpy(data[l][0]), None, layer=l)
    tckpt.save(str(tmp_path), 0, eng.export_state())

    leaves = jckpt.peek_leaves(str(tmp_path), prefix="plan/")
    assert sorted(leaves) == [f"plan/{l}" for l in sorted(PLAN)]
    jplan = jplanner.Plan.from_checkpoint(str(tmp_path))
    assert jplan == jplanner.Plan({l: _jentry(e) for l, e in PLAN.items()})
    jeng = _jax_engine(jplan)
    jeng.prepare([(l, jnp.asarray(w)) for l, (_, w) in data.items()])
    tree, _ = jckpt.restore(str(tmp_path), jeng.state_template())
    jeng.import_state(tree)
    assert _routes(jeng, PLAN) == _routes(eng, PLAN)
    for l, pk in jeng.packed.items():
        assert pk.blocks is None, l             # the K4 tile: untuned there
        np.testing.assert_array_equal(np.asarray(pk.in_scales),
                                      eng.packed[l].in_scales.numpy())
    # the port's peek sees the same leaves, the bfloat16 view included
    ours = tckpt.peek_leaves(str(tmp_path))
    assert set(ours) == set(jckpt.peek_leaves(str(tmp_path)))


def test_peek_leaves_and_checkpointer_keep_bfloat16(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).to(torch.bfloat16),
            "plan": {"x": torch.tensor([0, -1, -1, -1, -1],
                                       dtype=torch.int32)}}
    ck = tckpt.Checkpointer(str(tmp_path), keep=1)
    ck.save_async(3, tree)
    tree["w"].zero_()                    # after the copy: not in the file
    ck.wait()
    got = tckpt.peek_leaves(str(tmp_path))
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].float().tolist() == [0, 1, 2, 3, 4, 5]
    assert tckpt.peek_leaves(str(tmp_path), prefix="plan/")["plan/x"] \
        .tolist() == [0, -1, -1, -1, -1]
    jgot = jckpt.peek_leaves(str(tmp_path))
    assert np.asarray(jgot["w"], np.float32).tolist() == [0, 1, 2, 3, 4, 5]
    assert tckpt.peek_leaves(str(tmp_path), prefix="nothing/") == {}
    ck.save_sync(4, {"w": tree["w"]})
    assert tckpt.latest_step(str(tmp_path)) == 4
    # a write that fails in the thread raises from the next wait
    (tmp_path / "a_file").write_text("not a directory")
    bad = tckpt.Checkpointer(str(tmp_path / "a_file"))
    bad.save_async(0, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                             # reported once
