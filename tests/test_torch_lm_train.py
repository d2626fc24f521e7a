"""The port's LM training slice against the JAX package, on the CPU:
tiny variants of the six families, the same numpy weights and batches on
both sides (weights carried across by ``params_from_jax``).

* ``chunked_ce`` with S off a multiple of the chunk and masked labels:
  the loss and its gradients equal JAX's at ``1e-5``.
* ``grad_cast``: the identity whose backward returns x's dtype.
* For each family, fp32: the loss and every gradient leaf equal
  ``jax.value_and_grad(loss_fn)`` at ``rtol = atol = 1e-4`` of each
  leaf's largest value (``_close``), with remat on in both packages
  (the hybrid's one group under checkpointing, its remainder layer not).
  The hybrid runs with its Winograd conv off here, as in the serving
  tests (a fake-quant network is chaotic: ROADMAP, "Recorded
  differences"); the conv's own VJP is held against JAX's
  (``test_hybrid_winograd_conv_vjp_matches_jax``): d/dx and d/db at the
  fp32 tier, d/dw in all channels but those an abs-max STE mask flips.
* bfloat16 (llama): JAX compiled with excess precision off; the tier is
  ``BF16_UNITS`` bfloat16 spacings at each gradient leaf's largest
  value, and the port nearer JAX than the fp32 model (``BF16_SHARE``).
* Microbatched (2 × 2) gradients equal the full batch's (fp32, ``1e-5``
  of each leaf's largest value).
* One AdamW step with bf16 and with fp32 moments equals JAX's
  ``adamw_update`` bit for bit (eager JAX; the cosine schedule in fp32).
* ``launch/train.main --device cpu``: N steps straight equal k steps →
  SIGTERM checkpoint → ``--resume`` → N − k steps, bit for bit; the
  port's checkpoint restores through ``repro.checkpoint.restore`` with
  JAX's train-state keys.
* The example trains the tiny variant and its loss falls.
"""
import dataclasses
import os
import signal
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, tiny_variant as jtiny
from repro.models import losses as jlosses
from repro.models import registry as jreg
from repro.models import rglru as jrglru
from repro.models.param import ParamSpec as JParamSpec
from repro.optim import optimizer as jopt
from repro_torch.configs import ARCHS, tiny_variant
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import batch_at
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as L
from repro_torch.models import losses as tlosses
from repro_torch.models import registry, rglru
from repro_torch.models.param import params_from_jax, tree_map
from repro_torch.optim import optimizer as topt

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 24
FAMILIES = ["llama3.2-1b", "qwen2-moe-a2.7b", "rwkv6-7b",
            "recurrentgemma-2b", "internvl2-26b", "hubert-xlarge"]
TOL = 1e-4
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
NO_EXCESS = {"xla_allow_excess_precision": False}
#: The bfloat16 tier, in bfloat16 spacings at a tensor's largest |value|
#: (``_bf16_units``), for the loss and every gradient leaf of the tiny
#: llama. Unlike the forward (bit for bit in tests/test_torch_lm.py), the
#: backward is not: the packages' bfloat16 weight-gradient products sum
#: their rows in their own orders. Measured on three draws of the
#: weights: 0 to 3.5 spacings a leaf (the loss 0 to 1.4e-5 apart), the
#: fp32 model 1.5 to 8.6; summed over the 11 leaves, the port sits at
#: 0.44 to 0.57 of the fp32 model's distance (``BF16_SHARE`` bounds it).
BF16_UNITS = 4.0
BF16_SHARE = 0.75


def _cfgs(arch, **changes):
    if arch == "recurrentgemma-2b":
        changes = {"use_winograd_conv": False, **changes}
    return (dataclasses.replace(jtiny(JARCHS[arch]), **changes),
            dataclasses.replace(tiny_variant(ARCHS[arch]), **changes))


def _numpy_params(jcfg, seed):
    """Values for every leaf of the JAX model's ParamSpec tree: matrices
    scaled by their contraction width (ROADMAP, "Recorded differences"),
    norm scales, biases, mixes and decays off their zero / one inits."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "embed":
            v = rng.normal(size=s.shape) * s.scale
        elif s.init == "normal" and len(s.shape) > 1:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        elif s.init == "ones":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    specs = jreg.get_model(jcfg).param_specs(jcfg)
    return jax.tree.map(leaf, specs,
                        is_leaf=lambda x: isinstance(x, JParamSpec))


def _numpy_batch(jcfg, seed, batch=B, masked=True):
    """A train batch (numpy): inputs and labels, a few labels masked."""
    rng = np.random.default_rng(seed)
    n_text = S - jcfg.n_prefix
    out = {}
    if jcfg.input_mode == "frames":
        out["frames"] = rng.normal(size=(batch, S, jcfg.frontend_dim)
                                   ).astype(np.float32)
        n_text = S
    else:
        out["tokens"] = rng.integers(0, jcfg.vocab, (batch, n_text)
                                     ).astype(np.int32)
    if jcfg.n_prefix:
        out["patches"] = rng.normal(
            size=(batch, jcfg.n_prefix, jcfg.frontend_dim)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (batch, n_text)).astype(np.int32)
    if masked:
        labels[0, :3] = -1
    out["labels"] = labels
    return out


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, tol=TOL, what=""):
    """|got - want| ≤ tol · (1 + max|want|) elementwise: the fp32 tier
    of each leaf."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bound = tol * (1.0 + np.abs(want).max())
    assert np.abs(got - want).max() <= bound, \
        (what, float(np.abs(got - want).max()), bound)


def _jax_value_and_grad(jcfg, params, batch, options=None):
    model = jreg.get_model(jcfg)
    f = jax.jit(jax.value_and_grad(lambda p, b: model.loss_fn(p, b, jcfg)))
    if options:
        f = f.lower(params, batch).compile(compiler_options=options)
    loss, grads = f(params, batch)
    return np.asarray(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX reference of this module, computed once."""
    res = {}
    for i, arch in enumerate(FAMILIES):
        jcfg, _ = _cfgs(arch)
        params = _numpy_params(jcfg, 10 + i)
        batch = _numpy_batch(jcfg, 20 + i)
        loss, grads = _jax_value_and_grad(jcfg, params, batch)
        res[arch] = dict(params=params, batch=batch, loss=loss, grads=grads)
    jcfg, _ = _cfgs("llama3.2-1b", param_dtype="bfloat16")
    model = jreg.get_model(jcfg)
    params = jax.tree.map(lambda s, v: v.astype(s.dtype),
                          model.param_specs(jcfg),
                          res["llama3.2-1b"]["params"],
                          is_leaf=lambda x: isinstance(x, JParamSpec))
    batch = res["llama3.2-1b"]["batch"]
    loss, grads = _jax_value_and_grad(jcfg, params, batch, NO_EXCESS)
    res["bf16"] = dict(params=params, batch=batch, loss=loss, grads=grads)
    return res


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_jax_off_a_chunk_multiple_with_masked_labels():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 21, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 40)) / 4).astype(np.float32)
    labels = rng.integers(0, 40, (2, 21)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -2:] = -1
    want, (jgx, jgw) = jax.value_and_grad(
        lambda x, w: jlosses.chunked_ce(x, w, labels, chunk=8),
        argnums=(0, 1))(x, w)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tlosses.chunked_ce(tx, tw, torch.from_numpy(labels), chunk=8)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close(gx.numpy(), jgx, 1e-5, "dx")
    _close(gw.numpy(), jgw, 1e-5, "dw")
    # a chunk wider than S is one chunk; all labels masked gives 0
    one = tlosses.chunked_ce(tx, tw, torch.from_numpy(labels), chunk=64)
    np.testing.assert_allclose(float(one.detach()), float(want), rtol=1e-5)
    none = tlosses.chunked_ce(tx, tw, torch.full((2, 21), -1))
    assert float(none) == 0.0


def test_grad_cast_backward_returns_the_dtype_of_x():
    x = torch.randn(4, 3).to(torch.bfloat16).requires_grad_()
    w = torch.randn(4, 3)
    y = L.grad_cast(x)
    assert torch.equal(y, x) and y.dtype == torch.bfloat16
    (g,) = torch.autograd.grad((y.float() * w).sum(), x)
    assert g.dtype == torch.bfloat16
    assert torch.equal(g, w.to(torch.bfloat16))
    # the backward itself casts an fp32 cotangent to x's dtype
    ctx = type("Ctx", (), {"dtype": torch.bfloat16})()
    assert L._GradCast.backward(ctx, torch.randn(4, 3)).dtype == \
        torch.bfloat16
    # without autograd (serving) it hands back x itself
    with torch.no_grad():
        assert L.grad_cast(x) is x


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _port_value_and_grad(tcfg, params, batch):
    model = registry.get_model(tcfg)
    return tsteps._value_and_grad(model, tcfg, params_from_jax(params),
                                  _torch_tree(batch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax(arch, jax_side):
    ref = jax_side[arch]
    _, tcfg = _cfgs(arch)
    assert tcfg.remat
    loss, grads = _port_value_and_grad(tcfg, ref["params"], ref["batch"])
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=TOL)
    got, want = _flat(grads), _flat(ref["grads"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        _close(got[k].numpy(), want[k], what=k)
    assert any(np.abs(v).max() > 0 for v in want.values())


def _bf16_units(got, want):
    """max |got - want| in units of the bfloat16 spacing at max |want|."""
    want = np.asarray(want, np.float32)
    unit = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / unit)


def test_bfloat16_loss_and_gradients_match_jax(jax_side):
    """The fp32 weights of ``jax_side`` rounded to bfloat16 (the config's
    fp32 leaves kept), on both sides: the loss (fp32) within 1e-5 and
    every gradient leaf (bfloat16) within ``BF16_UNITS`` of JAX's run
    compiled with excess precision off; summed over the leaves, the port
    within ``BF16_SHARE`` of the fp32 model's distance (the control)."""
    ref = jax_side["bf16"]
    _, tcfg = _cfgs("llama3.2-1b", param_dtype="bfloat16")
    loss, grads = _port_value_and_grad(tcfg, ref["params"], ref["batch"])
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    got, want = _flat(grads), _flat(ref["grads"])
    fp32 = _flat(jax_side["llama3.2-1b"]["grads"])
    port, control = [], []
    for k in want:
        assert got[k].dtype == getattr(torch, want[k].dtype.name), k
        w = np.asarray(want[k], np.float32)
        port.append(_bf16_units(got[k].float().numpy(), w))
        control.append(_bf16_units(fp32[k], w))
        assert port[-1] <= BF16_UNITS, (k, port[-1])
    assert sum(port) < BF16_SHARE * sum(control), (port, control)


#: Of the hybrid conv's 64 channels, how many may have weight gradients
#: off the fp32 tier. A channel's weight gradient passes the STE masks of
#: its weight-transform casts (``_depthwise_wino_weights``), and the mask
#: of a cast's abs-max element, where |x / scale| is qmax to an ulp,
#: flips with a one-ulp difference in the transformed weights (ROADMAP,
#: "Recorded differences"): one such flip zeroes one transform-domain
#: gradient and moves the channel's whole gradient. Measured on 8 draws:
#: 0 to 4 channels flipped, every other channel within 8e-6.
CONV_CHANNELS_OFF = 6


def test_hybrid_winograd_conv_vjp_matches_jax():
    """The gradient through the paper's quantized depthwise Toom-Cook
    conv (F(4,4) Legendre, 9-bit Hadamard) by the saturating STE: the
    port's VJP against JAX's (compiled with algsimp off) on the same
    input, weights and cotangent. d/dx and d/db at the fp32 tier; d/dw
    at the fp32 tier in all but ``CONV_CHANNELS_OFF`` channels."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", use_winograd_conv=True)
    rng = np.random.default_rng(9)
    p = {"conv_w": (rng.normal(size=(4, 64)) * 0.5).astype(np.float32),
         "conv_b": (rng.normal(size=64) * 0.1).astype(np.float32)}
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)
    ct = rng.normal(size=(2, 37, 64)).astype(np.float32)

    def f(p, x):
        _, vjp = jax.vjp(lambda p, x: jrglru._conv1d(p, x, jcfg), p, x)
        return vjp(ct)
    jgp, jgx = jax.jit(f).lower(p, x).compile(
        compiler_options=ALGSIMP_OFF)(p, x)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = rglru._conv1d(tp, tx, tcfg)
    gw, gb, gx = torch.autograd.grad(y, (tp["conv_w"], tp["conv_b"], tx),
                                     torch.from_numpy(ct))
    _close(gx.numpy(), jgx, what="dx")
    _close(gb.numpy(), jgp["conv_b"], what="db")
    jw = np.asarray(jgp["conv_w"])
    off = np.abs(gw.numpy() - jw).max(0) > TOL * (1 + np.abs(jw).max(0))
    assert off.sum() <= CONV_CHANNELS_OFF, np.flatnonzero(off)
    assert np.abs(gw.numpy()).max() > 0 and np.abs(gx.numpy()).max() > 0


def test_microbatched_gradients_equal_the_full_batch():
    """Two microbatches of 2 against the batch of 4 (no label masked, so
    each microbatch counts as many labels): the loss and every gradient
    leaf within ``1e-5`` of its largest value, fp32, every family's
    step through ``_loss_with_microbatch``."""
    for arch in ("llama3.2-1b", "recurrentgemma-2b"):
        jcfg, tcfg = _cfgs(arch)
        params = params_from_jax(_numpy_params(jcfg, 30))
        batch = _torch_tree(_numpy_batch(jcfg, 31, batch=4, masked=False))
        model = registry.get_model(tcfg)
        full = tsteps._loss_with_microbatch(
            model, tcfg, RunConfig(model=tcfg, global_batch=4))
        micro = tsteps._loss_with_microbatch(
            model, tcfg, RunConfig(model=tcfg, global_batch=4,
                                   microbatch=2))
        assert full is not micro
        lf, gf = full(params, batch)
        lm, gm = micro(params, batch)
        np.testing.assert_allclose(float(lm), float(lf), rtol=1e-5)
        for k, want in _flat(gf).items():
            _close(_flat(gm)[k].numpy(), want.numpy(), 1e-5, f"{arch} {k}")
    with pytest.raises(ValueError, match="multiple of the microbatch"):
        tsteps._loss_with_microbatch(model, tcfg, RunConfig(
            model=tcfg, global_batch=4, microbatch=3))


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_adamw_step_matches_jax(moments):
    """Three AdamW steps (the second clipped) from the same parameters
    (bf16 and fp32 leaves), gradients and schedule: parameters, both
    moments and the count bit for bit with eager JAX, written in place
    by ``adamw_update_`` and returned by ``adamw_update``. The
    schedule's values equal eager JAX's (both fp32)."""
    rng = np.random.default_rng(5)
    shapes = {"a": ((3, 4), "bfloat16"), "b": {"c": ((5,), "float32"),
                                               "d": ((2, 3), "bfloat16")}}

    def draw(scale):
        return jax.tree.map(
            lambda sd: (scale * rng.normal(size=sd[0])).astype(sd[1]),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = draw(1.0)
    jstate = jopt.adamw_init(params, jnp.dtype(moments))
    tp = params_from_jax(params)
    tstate = topt.adamw_init(tp, getattr(torch, moments))
    tp2, tstate2 = tree_map(torch.clone, tp), tree_map(torch.clone, tstate)
    jlr = jopt.cosine_schedule(3e-2, 1, 10)
    tlr = topt.cosine_schedule(3e-2, 1, 10)
    jp = params
    for step, scale in enumerate((0.1, 10.0, 0.3)):
        assert tlr(step + 1) == float(jlr(step + 1))
        g = draw(scale)
        jp, jstate, jm = jopt.adamw_update(g, jstate, jp, lr=jlr(step + 1))
        tm = topt.adamw_update_(params_from_jax(g), tstate, tp,
                                lr=tlr(step + 1))
        tp2, tstate2, tm2 = topt.adamw_update(params_from_jax(g), tstate2,
                                              tp2, lr=tlr(step + 1))
        assert float(tm["grad_norm"]) == float(jm["grad_norm"]) == \
            float(tm2["grad_norm"])
        want = _flat({"p": jax.tree.map(np.asarray, jp),
                      "m": jax.tree.map(np.asarray, jstate["m"]),
                      "v": jax.tree.map(np.asarray, jstate["v"])})
        for got in (_flat({"p": tp, "m": tstate["m"], "v": tstate["v"]}),
                    _flat({"p": tp2, "m": tstate2["m"],
                           "v": tstate2["v"]})):
            for k, w in want.items():
                assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
                np.testing.assert_array_equal(
                    got[k].float().numpy(), w.astype(np.float32), err_msg=k)
        assert int(tstate["count"]) == int(tstate2["count"]) == \
            int(jstate["count"]) == step + 1


# ---------------------------------------------------------------------------
# The launcher, checkpoints and the example
# ---------------------------------------------------------------------------

_TRAIN = ["--arch", "llama3.2-1b", "--tiny", "--steps", "5", "--seq", "16",
          "--batch", "4", "--microbatch", "2", "--checkpoint-every", "100",
          "--log-every", "2", "--device", "cpu", "--lr", "1e-2"]


def test_train_resumes_bit_for_bit_after_a_preemption(tmp_path):
    """5 steps straight against 3 steps, a SIGTERM (the launcher takes a
    checkpoint and exits 0), then ``--resume`` for the last 2: the same
    parameters, moments and count, bit for bit."""
    straight = ttrain.main(_TRAIN + ["--checkpoint-dir",
                                     str(tmp_path / "a")])
    assert len(straight["losses"]) == 5
    assert all(np.isfinite(straight["losses"]))
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
    assert signal.getsignal(signal.SIGTERM) is not None
    from repro_torch.checkpoint.checkpoint import latest_step
    assert latest_step(str(tmp_path / "b")) == 3
    resumed = ttrain.main(_TRAIN + ["--checkpoint-dir", str(tmp_path / "b"),
                                    "--resume"])
    assert resumed["start_step"] == 3 and len(resumed["losses"]) == 2
    assert resumed["losses"] == straight["losses"][3:]
    a = _flat(ttrain._state(straight["params"], straight["opt_state"]))
    b = _flat(ttrain._state(resumed["params"], resumed["opt_state"]))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_port_checkpoint_restores_through_jax_with_its_train_state_keys(
        tmp_path):
    """The launcher's last checkpoint read by the JAX package's
    ``restore`` into JAX's (params, adamw_init(params)) template: every
    leaf present, of JAX's shape and dtype, equal to the port's."""
    from repro.checkpoint import checkpoint as jckpt
    from repro.models.param import init_params as jinit
    out = ttrain.main(_TRAIN[:4] + ["2"] + _TRAIN[5:] +
                      ["--checkpoint-dir", str(tmp_path)])
    jcfg = jtiny(JARCHS["llama3.2-1b"])
    jparams = jinit(jreg.get_model(jcfg).param_specs(jcfg),
                    jax.random.PRNGKey(0))
    (rp, ropt), step = jckpt.restore(
        str(tmp_path), (jparams, jopt.adamw_init(jparams)))
    assert step == 2
    got = _flat({"p": jax.tree.map(np.asarray, rp),
                 "m": jax.tree.map(np.asarray, ropt["m"]),
                 "v": jax.tree.map(np.asarray, ropt["v"])})
    want = _flat({"p": out["params"], "m": out["opt_state"]["m"],
                  "v": out["opt_state"]["v"]})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)
    assert int(ropt["count"]) == 2


def test_train_entry_points_refuse_what_they_cannot_do():
    """No card: the launcher's default device raises, as does a train
    step built for the card; ``--model-parallel`` above 1 raises (LM
    sharding is not ported); a step refuses a batch off its device."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--arch", "llama3.2-1b", "--tiny", "--steps", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsteps.make_train_setup(RunConfig(
                model=tiny_variant(ARCHS["llama3.2-1b"])))
    with pytest.raises(NotImplementedError, match="LM sharding"):
        ttrain.main(_TRAIN + ["--model-parallel", "2"])
    cfg = tiny_variant(ARCHS["llama3.2-1b"])
    run = RunConfig(model=cfg, seq_len=8, global_batch=2, total_steps=2,
                    warmup_steps=1)
    params, opt = tsteps.init_train_state(run, 0, "cpu")
    assert opt["m"]["embed"].dtype == torch.float32
    batch = batch_at(cfg, 8, 2, 0)
    step = tsteps.make_train_setup(run, "cpu").step_fn
    with pytest.raises(ValueError, match="batch on meta"):
        step(params, opt, {k: v.to("meta") for k, v in batch.items()}, 0)
    with pytest.raises(ValueError, match="train state on cpu"):
        tsteps.make_train_setup(run, "meta").step_fn(params, opt, batch, 0)
    bf16 = dataclasses.replace(run, moment_dtype="bfloat16")
    assert tsteps.init_train_state(bf16, 0, "cpu")[1]["v"]["embed"].dtype \
        == torch.bfloat16


def test_the_example_trains_the_tiny_variant_and_its_loss_falls(tmp_path):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import train_lm_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    out = train_lm_torch.main(["--device", "cpu", "--steps", "60",
                               "--lr", "1e-2",
                               "--checkpoint-dir", str(tmp_path)])
    losses = out["losses"]
    assert len(losses) == 60 and all(np.isfinite(losses))
    # fresh Markov batches every step: the mean of the last 10 steps
    # below the first 10's (measured 4.824 against 4.867)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.02, losses
