"""Checkpoints cross between the packages in both directions: a packed
state written by the JAX package restores into the port's engine leaf for
leaf, and one the port writes restores through the JAX ``restore``."""
import json

import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import winograd as jw
from repro.kernels import ops as jops
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.conv import ConvEngine, ConvPolicy, PackedWinogradWeights
from repro_torch.core import winograd as tw

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)

LAYERS = {"stem": (3, 8), "s0b0.conv1": (8, 8)}


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {l: (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
            .astype(np.float32) for l, (ci, co) in LAYERS.items()}


def _jax_state(ws):
    """A tree shaped like the JAX ``ConvEngine.export_state()``, built from
    its pure-jnp packing pieces: one layer with its Hadamard statistic and
    tuned blocks, one with both sentinels."""
    spec = jw.WinogradSpec(m=4, r=3, base="legendre")
    rng = np.random.default_rng(1)
    packed = {}
    for i, (l, w) in enumerate(sorted(ws.items())):
        uq, s_w = jops.prepare_weights_int8(jnp.asarray(w), spec)
        x = jnp.asarray(rng.normal(size=(1, 8, 8, w.shape[2]))
                        .astype(np.float32))
        in_s = jops.scales_from_abs_max(jops.input_abs_max(x, spec))
        tree = {"u_q": np.asarray(uq), "w_scales": np.asarray(s_w),
                "in_scales": np.asarray(in_s)}
        if i == 0:
            tree["hadamard_amax"] = rng.uniform(1, 2, (36, 1)).astype(
                np.float32)
            tree["blocks"] = np.asarray([128, 128, 256], np.int32)
        else:
            tree["hadamard_amax"] = np.full((36, 1), -1.0, np.float32)
            tree["blocks"] = np.full((3,), -1, np.int32)
        packed[l] = tree
    return {"packed": packed}


def _engine(ws):
    eng = ConvEngine(tw.WinogradSpec(m=4, r=3, base="legendre"),
                     ConvPolicy(backend="winograd_int8"), device="cpu")
    eng.prepare((l, torch.from_numpy(w)) for l, w in ws.items())
    return eng


def test_jax_checkpoint_restores_into_port_engine(tmp_path):
    ws = _weights()
    state = _jax_state(ws)
    jckpt.save(str(tmp_path), 3, state)
    eng = _engine(ws)
    tree, step = tckpt.restore(str(tmp_path), eng.state_template())
    assert step == 3 and tckpt.latest_step(str(tmp_path)) == 3
    eng.import_state(tree)
    assert sorted(eng.packed) == sorted(LAYERS)
    first, second = sorted(LAYERS)
    for l, want in state["packed"].items():
        pk = eng.packed[l]
        for leaf in ("u_q", "w_scales", "in_scales"):
            got = getattr(pk, leaf)
            assert got.dtype == {"u_q": torch.int8}.get(leaf, torch.float32)
            np.testing.assert_array_equal(got.numpy(), want[leaf])
    np.testing.assert_array_equal(eng.packed[first].hadamard_amax.numpy(),
                                  state["packed"][first]["hadamard_amax"])
    assert eng.packed[first].blocks.tolist() == [128, 128, 256]
    assert eng.packed[second].hadamard_amax is None     # sentinel
    assert eng.packed[second].blocks is None            # sentinel
    # the restored engine serves (plain versions on the CPU)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 8, 8, 3)).astype(np.float32))
    y = eng.conv2d(x, None, layer="stem")
    assert tuple(y.shape) == (1, 8, 8, 8) and bool(torch.isfinite(y).all())


def test_port_checkpoint_restores_through_jax(tmp_path):
    ws = _weights(seed=5)
    eng = _engine(ws)
    rng = np.random.default_rng(6)
    with eng.calibration():
        for l, (ci, _) in LAYERS.items():
            x = torch.from_numpy(rng.normal(size=(1, 8, 8, ci))
                                 .astype(np.float32))
            eng.conv2d(x, None, layer=l)
    state = eng.export_state()
    path = tckpt.save(str(tmp_path), 0, state)
    with open(f"{path}/MANIFEST.json") as f:
        man = json.load(f)
    assert man["dtypes"]["packed/stem/u_q"] == "int8"
    with np.load(f"{path}/arrays.npz") as data:
        assert "packed/s0b0.conv1/hadamard_amax" in data.files
    template = {"packed": {
        l: {k: np.zeros(tuple(v.shape), v.numpy().dtype)
            for k, v in sub.items()} for l, sub in state["packed"].items()}}
    tree, step = jckpt.restore(str(tmp_path), template)
    assert step == 0
    for l, sub in state["packed"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(np.asarray(tree["packed"][l][k]),
                                          v.numpy(), err_msg=f"{l}/{k}")
    # and back into a fresh port engine: the same serving state
    eng2 = _engine(ws)
    back, _ = tckpt.restore(str(tmp_path), eng2.state_template())
    eng2.import_state(back)
    for l in LAYERS:
        a, b = eng.packed[l], eng2.packed[l]
        for leaf in ("u_q", "w_scales", "in_scales", "hadamard_amax"):
            assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf


def test_retention_and_incomplete_checkpoints(tmp_path):
    tree = {"a": {"b": torch.arange(3)},
            "bf": torch.ones(2, dtype=torch.bfloat16)}
    for s in range(5):
        tckpt.save(str(tmp_path), s, tree, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004"]
    (tmp_path / "step_00000009").mkdir()        # no manifest: incomplete
    assert tckpt.latest_step(str(tmp_path)) == 4
    back, _ = tckpt.restore(str(tmp_path), tree)
    assert torch.equal(back["a"]["b"], tree["a"]["b"])
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"], tree["bf"])


def test_packed_tree_sentinels_round_trip():
    pk = PackedWinogradWeights(u_q=torch.zeros((36, 2, 3), dtype=torch.int8),
                               w_scales=torch.ones((36, 1)),
                               in_scales=torch.ones((36, 1)))
    tree = pk.to_tree(include_hadamard=True)
    assert float(tree["hadamard_amax"].max()) == -1.0
    assert tree["blocks"].tolist() == [-1, -1, -1]
    back = PackedWinogradWeights.from_tree(tree)
    assert back.hadamard_amax is None and back.blocks is None
    assert "hadamard_amax" not in pk.to_tree()
