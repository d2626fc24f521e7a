"""The port's LM serving slice against the JAX package, on the CPU: tiny
variants of every family, the JAX model's weights carried across by
``params_from_jax`` and the same numpy inputs on both sides.

* Whole models, fp32, ``rtol = atol = 1e-4``: prefill's last logits and
  every cache leaf, then 4 decode steps fed JAX's greedy tokens (teacher
  forcing, so that a near-tie cannot fork the two paths): each step's
  logits and the final cache. The hybrid's window (16) equals the
  prompt, so its decode wraps the ring buffer. ``forward`` for the
  encoder (hubert).
* bfloat16, one model of each family, the same weights rounded: prefill
  logits and cache, one decode step (``forward`` for the encoder) within
  half a bfloat16 spacing at each tensor's largest value of JAX's run
  compiled with excess precision off, and the fp32 model past it
  (``BF16_UNITS``).
* The hybrid's quantized 1-D Toom-Cook conv (F(4,4) Legendre, 9-bit
  Hadamard) at the fake-quant tier of ``tests/test_torch_conv1d.py``,
  JAX compiled with XLA's algebraic simplifier off, in float32 and in
  bfloat16; its transformed weights to ``1e-6`` of their largest value.
* The whole hybrid with that conv on, as ``test_resnet_fake_quant_*``
  holds the fake-quant ResNet (ROADMAP, "Recorded differences": a
  fake-quant network is chaotic, one flipped rounding step moves what
  follows): JAX's prefill runs with each conv's output replaced by the
  port's, and every conv's input, the cache, the logits and 4 decode
  steps then agree to ``1e-4``.
* Configs field by field, parameter shapes and axes of all ten full
  configs (declared, nothing allocated), input shapes and dtypes.
* The serving steps refuse tensors off their device.
* The example end to end on the CPU, and its refusals.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, tiny_variant as jtiny
from repro.configs import RESNET as JRESNET
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro.models import rglru as jrglru
from repro.models.param import ParamSpec as JParamSpec
from repro_torch import configs as tconfigs
from repro_torch.configs import ARCHS, RESNET, tiny_variant
from repro_torch.configs.base import RunConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.steps import (generate, init_lm_params,
                                      make_serve_setup)
from repro_torch.models import registry, rglru
from repro_torch.models.param import ParamSpec, params_from_jax

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, N_DEC = 2, 16, 4
DECODERS = ["llama3.2-1b", "qwen1.5-32b", "minitron-4b", "qwen2-moe-a2.7b",
            "kimi-k2-1t-a32b", "rwkv6-7b", "recurrentgemma-2b",
            "internvl2-26b"]
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
_JCONV = jrglru._conv1d


def _cfgs(arch, **changes):
    return (dataclasses.replace(jtiny(JARCHS[arch]), **changes),
            dataclasses.replace(tiny_variant(ARCHS[arch]), **changes))


def _conv_off(arch):
    return {"use_winograd_conv": False} if arch == "recurrentgemma-2b" \
        else {}


def _numpy_params(jcfg, seed):
    """Values for every leaf of the JAX model's ParamSpec tree: matrices
    scaled by their contraction width, so activations stay O(1); norm
    scales, biases, mixes and decays off their zero / one inits, so that
    every term is exercised."""
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


def _prompt(jcfg, seed):
    """A prefill batch: tokens, frames or patches + tokens (numpy)."""
    rng = np.random.default_rng(seed)
    if jcfg.input_mode == "frames":
        return {"frames": rng.normal(size=(B, PROMPT, jcfg.frontend_dim))
                .astype(np.float32)}
    n_text = PROMPT - jcfg.n_prefix if jcfg.n_prefix else PROMPT
    out = {"tokens": rng.integers(0, jcfg.vocab, (B, n_text))
           .astype(np.int32)}
    if jcfg.n_prefix:
        out["patches"] = rng.normal(
            size=(B, jcfg.n_prefix, jcfg.frontend_dim)).astype(np.float32)
    return out


def _grow(jmodel, jcfg, cache, total):
    full = jax.eval_shape(lambda: jmodel.init_cache(jcfg, B, total))
    return jax.tree.map(lambda s, f: jnp.pad(s, [(0, a - b) for b, a in
                                                 zip(s.shape, f.shape)]),
                        cache, full)


def _jax_serve(jcfg, params, prompt, prefill=None, teacher=None):
    """JAX: prefill, grow the cache, N_DEC greedy decode steps (fed
    ``teacher[i]`` at step i where given)."""
    jmodel = jreg.get_model(jcfg)
    prefill = prefill or jax.jit(lambda p, b: jmodel.prefill(p, b, jcfg))
    cache0, logits = prefill(params, prompt)
    out = {"prefill_cache": jax.tree.map(np.asarray, cache0),
           "logits": [np.asarray(logits)], "tokens": []}
    cache = _grow(jmodel, jcfg, cache0, PROMPT + N_DEC)
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos,
                                                            jcfg))
    for i in range(N_DEC):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out["tokens"].append(np.asarray(tok))
        if teacher is not None:
            tok = jnp.asarray(teacher[i])
        logits, cache = step(params, cache, tok,
                             jnp.full((B,), PROMPT + i, jnp.int32))
        out["logits"].append(np.asarray(logits))
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX reference of this module, computed once, each model's in
    a worker thread at once (XLA compiles off the GIL; the same programs
    on the same inputs as one after another)."""
    res, jobs = {}, {}
    with ThreadPoolExecutor(max_workers=len(DECODERS) + 1) as pool:
        for i, arch in enumerate(DECODERS):
            jcfg, _ = _cfgs(arch, **_conv_off(arch))
            params = _numpy_params(jcfg, i)
            prompt = _prompt(jcfg, 100 + i)
            res[arch] = dict(params=params, prompt=prompt)
            jobs[arch] = pool.submit(_jax_serve, jcfg, params, prompt)
        jcfg, _ = _cfgs("hubert-xlarge")
        params = _numpy_params(jcfg, 50)
        prompt = _prompt(jcfg, 150)
        res["hubert-xlarge"] = dict(params=params, prompt=prompt)
        hubert = pool.submit(lambda: np.asarray(jax.jit(
            lambda p, b: jreg.get_model(jcfg).forward(p, b, jcfg))(
                params, prompt)[0]))
        for arch, job in jobs.items():
            res[arch].update(job.result())
        res["hubert-xlarge"]["logits"] = hubert.result()
    return res


def _close_tree(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL,
                                   err_msg=f"{what} {k}")


def _port_serve(arch, ref, **changes):
    _, tcfg = _cfgs(arch, **changes)
    run = RunConfig(model=tcfg, seq_len=PROMPT + N_DEC, global_batch=B)
    params = params_from_jax(ref["params"])
    prompt = {k: torch.from_numpy(v) for k, v in ref["prompt"].items()}
    cache, logits = make_serve_setup(run, "prefill", "cpu")(params, prompt)
    teacher = torch.from_numpy(np.concatenate(ref["tokens"], 1))
    out = generate(run, params, prompt, N_DEC, device="cpu",
                   teacher=teacher, keep_logits=True)
    return cache, logits, out


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_teacher_forced_decode_match_jax(arch, jax_side):
    ref = jax_side[arch]
    cache, logits, out = _port_serve(arch, ref, **_conv_off(arch))
    np.testing.assert_allclose(logits.numpy(), ref["logits"][0], **TOL)
    _close_tree(cache, ref["prefill_cache"], "prefill cache")
    assert len(out["logits"]) == N_DEC + 1
    for i, (got, want) in enumerate(zip(out["logits"], ref["logits"])):
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"step {i}")
    _close_tree(out["cache"], ref["cache"], "decode cache")
    # the greedy picks follow the logits (JAX's, fed back as the teacher)
    assert out["tokens"].shape == (B, N_DEC + 1)
    np.testing.assert_array_equal(out["tokens"][:, :N_DEC].numpy(),
                                  np.concatenate(ref["tokens"], 1))
    assert out["timer"] == "host_clock" and len(out["decode_ms"]) == N_DEC


def test_encoder_forward_matches_jax(jax_side):
    ref = jax_side["hubert-xlarge"]
    _, tcfg = _cfgs("hubert-xlarge")
    params = params_from_jax(ref["params"])
    logits, _ = registry.get_model(tcfg).forward(
        params, {"frames": torch.from_numpy(ref["prompt"]["frames"])}, tcfg)
    assert logits.shape == (B, PROMPT, tcfg.vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)


def test_params_from_jax_carries_bfloat16_bit_for_bit():
    jcfg = dataclasses.replace(jtiny(JARCHS["llama3.2-1b"]),
                               param_dtype="bfloat16")
    from repro.models.param import init_params
    params = jax.tree.map(np.asarray, init_params(
        jreg.get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(0)))
    got = params_from_jax(params)
    w = params["blocks"]["attn"]["wq"]
    assert w.dtype.name == "bfloat16"
    t = got["blocks"]["attn"]["wq"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16))


# ---------------------------------------------------------------------------
# bfloat16, the dtype the full configs serve in
# ---------------------------------------------------------------------------

#: One model of each family (the hybrid with its conv off, as above).
BF16_ARCHS = ["llama3.2-1b", "qwen2-moe-a2.7b", "rwkv6-7b",
              "recurrentgemma-2b", "internvl2-26b", "hubert-xlarge"]
#: XLA may keep a bfloat16 result in float32 inside a fusion ("excess
#: precision"), which an eager op cannot; with that off, every op of the
#: JAX reference rounds to the dtype it is written in, as the port's do.
NO_EXCESS = {"xla_allow_excess_precision": False}
#: The tier, in units of the bfloat16 spacing at a tensor's largest
#: |value|. Measured on these inputs, port against JAX: 0 in every
#: bfloat16 tensor of the six (bit for bit), 3.2e-5 in RWKV-6's float32
#: state; on another draw of RWKV-6's weights 0.5, where its float32 exp
#: and tanh, a float32 ulp apart, flip a bfloat16 rounding. The float32
#: model against JAX's bfloat16 one (the control, which the test also
#: asserts): 0.93 to 12.5. One misplaced cast (attention probabilities
#: kept in fp32, rope's cos/sin or the MoE's combine weights rounded to
#: bfloat16, the RG-LRU decay rounded) moved the logits 0.75 to 4.
BF16_UNITS = 0.5


def _bf16_units(got, want):
    """max |got - want| in units of the bfloat16 spacing at max |want|."""
    want = np.asarray(want, np.float32)
    unit = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / unit)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bfloat16_prefill_and_decode_match_jax(arch, jax_side):
    """The fp32 weights of ``jax_side`` rounded to the config's dtypes
    (bfloat16 but for the float32 leaves), on both sides: prefill's last
    logits and every cache leaf, then one decode step fed JAX's greedy
    token (the encoder: ``forward``), each within ``BF16_UNITS`` of JAX's
    bfloat16 run and the fp32 model's (``jax_side``) past it."""
    ref = jax_side[arch]
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16", **_conv_off(arch))
    jmodel = jreg.get_model(jcfg)
    params = jax.tree.map(lambda s, v: v.astype(s.dtype),
                          jmodel.param_specs(jcfg), ref["params"],
                          is_leaf=lambda x: isinstance(x, JParamSpec))
    tparams = params_from_jax(params)
    prompt = {k: torch.from_numpy(v) for k, v in ref["prompt"].items()}

    def compiled(f, *args):
        return jax.jit(f).lower(*args).compile(
            compiler_options=NO_EXCESS)(*args)
    if jcfg.is_encoder:
        want = compiled(lambda p, b: jmodel.forward(p, b, jcfg)[0], params,
                        ref["prompt"])
        got, _ = registry.get_model(tcfg).forward(tparams, prompt, tcfg)
        triples = [("logits", got, want, ref["logits"])]
    else:
        jcache, jlogits = compiled(lambda p, b: jmodel.prefill(p, b, jcfg),
                                   params, ref["prompt"])
        tok = ref["tokens"][0]
        jstep, _ = compiled(
            lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, jcfg),
            params, _grow(jmodel, jcfg, jcache, PROMPT + 1), tok,
            jnp.full((B,), PROMPT, jnp.int32))
        run = RunConfig(model=tcfg, seq_len=PROMPT + 1, global_batch=B)
        cache, logits = make_serve_setup(run, "prefill", "cpu")(tparams,
                                                                prompt)
        out = generate(run, tparams, prompt, 1, device="cpu",
                       teacher=torch.tensor(tok), keep_logits=True)
        triples = [("prefill logits", logits, jlogits, ref["logits"][0]),
                   ("decode logits", out["logits"][1], jstep,
                    ref["logits"][1])]
        triples += [(f"prefill cache {k}", cache[k], jcache[k],
                     ref["prefill_cache"][k]) for k in sorted(jcache)]
    for what, got, want, fp32 in triples:
        assert got.dtype == getattr(torch, jnp.dtype(want.dtype).name), what
        want = np.asarray(want.astype(jnp.float32))
        port = _bf16_units(got.float().numpy(), want)
        control = _bf16_units(fp32, want)
        assert port <= BF16_UNITS < control, (what, port, control)


# ---------------------------------------------------------------------------
# The hybrid's quantized 1-D Toom-Cook conv
# ---------------------------------------------------------------------------

def _fake_quant_close(got, want):
    """The fake-quant tier of tests/test_torch_conv1d.py."""
    d = np.abs(got - want)
    flipped = d > 1e-4 * (1 + np.abs(want))
    assert flipped.sum() <= 0.005 * d.size, int(flipped.sum())
    assert d.max() <= np.abs(want).max() / 127 * (1 + 1e-4) + 1e-4


def test_hybrid_winograd_conv_matches_jax():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    assert tcfg.use_winograd_conv and tcfg.winograd.r == 4 \
        and tcfg.winograd.m == 4 and tcfg.winograd.quant.hadamard_bits == 9
    rng = np.random.default_rng(7)
    p = {"conv_w": (rng.normal(size=(4, 64)) * 0.5).astype(np.float32),
         "conv_b": (rng.normal(size=64) * 0.1).astype(np.float32)}
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)     # ragged T
    want = jax.jit(lambda p, x: jrglru._conv1d(p, x, jcfg)).lower(
        p, x).compile(compiler_options=ALGSIMP_OFF)(p, x)
    got = rglru._conv1d({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg)
    assert got.shape == (2, 37, 64)
    _fake_quant_close(got.numpy(), np.asarray(want))
    # the transformed weights: a scale per channel, as JAX's vmap
    from repro.core import winograd as jw
    from repro_torch.core import winograd as tw
    ju = np.asarray(jrglru._depthwise_wino_weights(
        jnp.asarray(p["conv_w"]), jcfg.winograd,
        jw.make_matrices(jcfg.winograd)))
    tu = rglru._depthwise_wino_weights(torch.from_numpy(p["conv_w"]),
                                       tcfg.winograd,
                                       tw.make_matrices(tcfg.winograd))
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-6,
                               atol=1e-6 * np.abs(ju).max())
    # one channel's kernel scaled by 1000 leaves the others' casts alone
    w2 = p["conv_w"].copy()
    w2[:, 0] *= 1000.0
    tu2 = rglru._depthwise_wino_weights(torch.from_numpy(w2), tcfg.winograd,
                                        tw.make_matrices(tcfg.winograd))
    np.testing.assert_array_equal(tu2[1:].numpy(), tu[1:].numpy())


def test_hybrid_winograd_conv_in_bfloat16_matches_jax():
    """The conv as the full config runs it: bfloat16 activations and
    weights, the transforms in float32 between the casts. JAX compiled
    with excess precision off as well (``NO_EXCESS``): with it on, XLA
    keeps the bfloat16 fake-quant steps in float32 and most outputs move
    by many steps."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", param_dtype="bfloat16")
    rng = np.random.default_rng(8)
    p = {"conv_w": (rng.normal(size=(4, 64)) * 0.5).astype(jnp.bfloat16),
         "conv_b": (rng.normal(size=64) * 0.1).astype(jnp.bfloat16)}
    x = rng.normal(size=(2, 37, 64)).astype(jnp.bfloat16)
    want = jax.jit(lambda p, x: jrglru._conv1d(p, x, jcfg)).lower(
        p, x).compile(compiler_options={**ALGSIMP_OFF, **NO_EXCESS})(p, x)
    tp = params_from_jax(p)
    got = rglru._conv1d(tp, params_from_jax({"x": x})["x"], tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 37, 64)
    _fake_quant_close(got.float().numpy(),
                      np.asarray(want.astype(jnp.float32)))


def _jax_rec_params(params, jcfg):
    """The JAX hybrid's recurrent blocks' ``rec`` parameters, in depth
    order."""
    pat, n_full, rem = jrglru.split_pattern(jcfg)
    out = [jax.tree.map(lambda t: t[g], params["groups"][f"{i}_{k}"]["rec"])
           for g in range(n_full) for i, k in enumerate(pat) if k == "rec"]
    return out + [params["rem"][f"{i}_{k}"]["rec"]
                  for i, k in enumerate(rem) if k == "rec"]


def test_hybrid_with_the_winograd_conv_replays_through_jax(jax_side):
    """The port's prefill and decode with the conv on; JAX's (eager)
    prefill with each conv's output replaced by the port's, then its 4
    decode steps (the decode conv is direct)."""
    arch = "recurrentgemma-2b"
    jcfg, tcfg = _cfgs(arch)
    ref = jax_side[arch]
    seen = []
    conv = rglru._conv1d

    def record(p, x, cfg):
        y = conv(p, x, cfg)
        seen.append((x.numpy().copy(), y.numpy().copy()))
        return y
    rglru._conv1d = record
    try:
        cache, logits, out = _port_serve(arch, ref)
    finally:
        rglru._conv1d = conv
    rec = _jax_rec_params(ref["params"], jcfg)
    assert len(rec) == 3 and len(seen) == 2 * len(rec)   # two prefills
    for (x1, y1), (x2, y2) in zip(seen, seen[len(rec):]):
        np.testing.assert_array_equal(y1, y2)
    replay, jax_inputs = iter(seen), []

    def replayed(p, x, cfg):
        jax_inputs.append(np.asarray(x))
        return jnp.asarray(next(replay)[1])
    jrglru._conv1d = replayed
    try:
        jref = _jax_serve(jcfg, ref["params"], ref["prompt"],
                          prefill=lambda p, b: jrglru.prefill(p, b, jcfg),
                          teacher=ref["tokens"])
    finally:
        jrglru._conv1d = _JCONV
    assert len(jax_inputs) == len(rec)
    # each conv against JAX's own pipeline on the port's input (one
    # program: every layer's conv has the same shapes)
    jconv = jax.jit(lambda p, v: _JCONV(p, v, jcfg)).lower(
        rec[0], seen[0][0]).compile(compiler_options=ALGSIMP_OFF)
    for p, (x, y), jx in zip(rec, seen, jax_inputs):
        np.testing.assert_allclose(x, jx, **TOL)
        _fake_quant_close(y, np.asarray(jconv(p, x)))
    np.testing.assert_allclose(logits.numpy(), jref["logits"][0], **TOL)
    _close_tree(cache, jref["prefill_cache"], "prefill cache")
    np.testing.assert_array_equal(out["tokens"][:, :N_DEC].numpy(),
                                  np.concatenate(jref["tokens"], 1))
    for i, (got, want) in enumerate(zip(out["logits"], jref["logits"])):
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"step {i}")
    _close_tree(out["cache"], jref["cache"], "decode cache")


# ---------------------------------------------------------------------------
# Configs, parameter declarations, inputs
# ---------------------------------------------------------------------------

def _same_value(a, b):
    """A port config value against the JAX package's: dataclasses field
    by field, dtypes by name."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(b):
            _same_value(getattr(a, f.name), getattr(b, f.name))
        return
    if isinstance(a, (type, np.dtype)):
        assert np.dtype(a).name == np.dtype(b).name, (a, b)
        return
    assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_configs_and_tiny_variants_equal_jax(arch):
    ours, ref = ARCHS[arch], JARCHS[arch]
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    for cfg, jcfg in ((ours, ref), (tiny_variant(ours), jtiny(ref))):
        for f in dataclasses.fields(jcfg):
            _same_value(getattr(cfg, f.name), getattr(jcfg, f.name))
        assert cfg.is_encoder == jcfg.is_encoder
        assert cfg.moe_every == jcfg.moe_every
        assert cfg.param_count_dense_proxy() == \
            jcfg.param_count_dense_proxy()
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    from repro import configs as jconfigs
    assert tconfigs.cells(arch) == jconfigs.cells(arch)
    for shape in tconfigs.SHAPES:
        for multi_pod in (False, True):
            got = tconfigs.run_config(arch, shape, multi_pod)
            want = jconfigs.run_config(arch, shape, multi_pod)
            for f in dataclasses.fields(want):
                _same_value(getattr(got, f.name), getattr(want, f.name))


def test_registry_shapes_and_resnet_equal_jax():
    from repro import configs as jconfigs
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert list(ARCHS) == list(JARCHS)
    assert RESNET.name == JRESNET.name and RESNET.family == JRESNET.family
    assert RESNET.width_mult == JRESNET.width_mult
    _same_value(RESNET.wino, JRESNET.wino)
    assert RESNET.use_winograd == JRESNET.use_winograd
    with pytest.raises(ValueError, match="unknown family"):
        registry.get_model(RESNET)


def _spec_leaves(tree, is_spec, prefix=()):
    if is_spec(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_spec_leaves(v, is_spec, prefix + (k,)))
    return out


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_specs_equal_jax_at_full_size(arch):
    """Shapes, logical axes, inits, scales and dtypes of every declared
    leaf of the full config (declarations only: nothing is allocated)."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    got = _spec_leaves(registry.get_model(cfg).param_specs(cfg),
                       lambda x: isinstance(x, ParamSpec))
    want = _spec_leaves(jreg.get_model(jcfg).param_specs(jcfg),
                        lambda x: isinstance(x, JParamSpec))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert (g.shape, g.axes, g.init, g.scale) == \
            (w.shape, w.axes, w.init, w.scale), path
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, path


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge",
                                  "internvl2-26b"])
def test_batches_match_jax_input_specs(arch):
    """``batch_at`` and ``input_specs`` against JAX's ``input_specs``, in
    every mode; JAX's Markov structure (a token takes the previous
    position's draw with p = 0.5, so it equals the previous token about
    a quarter of the time) in both packages' token streams."""
    cfg, jcfg = tiny_variant(ARCHS[arch]), jtiny(JARCHS[arch])
    S = 64
    for mode in ("train", "prefill", "decode"):
        want = {k: (v.shape, np.dtype(v.dtype).name) for k, v in
                jpipe.input_specs(jcfg, S, 4, mode).items()}
        got = {k: (tuple(shape), str(dt).split(".")[-1]) for k, (shape, dt)
               in tpipe.input_specs(cfg, S, 4, mode).items()}
        assert got == want, mode
        if mode == "decode":
            continue
        batch = tpipe.batch_at(cfg, S, 4, 3, mode=mode)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in batch.items()} == want, mode
    batch = tpipe.batch_at(cfg, S, 4, 3)
    again = tpipe.batch_at(cfg, S, 4, 3)
    for k in batch:
        assert torch.equal(batch[k], again[k])            # pure in step
    if "tokens" in batch:
        t = batch["tokens"]
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab
        assert torch.equal(t[:, 1:], batch["labels"][:, :-1])
        jt = np.asarray(jpipe.batch_at(jcfg, S, 4, 3)["tokens"])
        rep = (t[:, 1:] == t[:, :-1]).float().mean().item()
        jrep = float((jt[:, 1:] == jt[:, :-1]).mean())
        assert 0.15 < rep < 0.35 and 0.15 < jrep < 0.35, (rep, jrep)
        other = tpipe.batch_at(cfg, S, 4, 4)["tokens"]
        assert not torch.equal(t, other)


def test_serve_steps_refuse_tensors_off_their_device():
    """A step runs only on the device it was built for: steps built for
    another device (``meta`` here) refuse CPU weights, batches and
    caches, and so does ``generate``; a CPU step refuses a batch that
    lies elsewhere."""
    cfg = tiny_variant(ARCHS["llama3.2-1b"])
    run = RunConfig(model=cfg, seq_len=PROMPT + 1, global_batch=B)
    params = init_lm_params(cfg, 0, "cpu")
    batch = tpipe.batch_at(cfg, PROMPT, B, 0, mode="prefill")
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    with pytest.raises(ValueError, match="parameters on cpu"):
        make_serve_setup(run, "prefill", "meta")(params, meta_batch)
    with pytest.raises(ValueError, match="batch on cpu"):
        make_serve_setup(run, "prefill", "meta")(params, batch)
    cache, _ = make_serve_setup(run, "prefill", "cpu")(params, batch)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    pos = torch.full((B,), PROMPT, dtype=torch.int32)
    with pytest.raises(ValueError, match="decode inputs on cpu"):
        make_serve_setup(run, "decode", "meta")(params, cache, tok, pos)
    with pytest.raises(ValueError, match="batch on meta"):
        make_serve_setup(run, "prefill", "cpu")(params, meta_batch)
    with pytest.raises(ValueError, match="on cpu; this step runs on meta"):
        generate(run, params, batch, 1, device="meta")


# ---------------------------------------------------------------------------
# The example
# ---------------------------------------------------------------------------

def _example():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_example_serves_on_cpu(arch, capsys):
    """Prefill 24 + 20 decode steps: the hybrid (window 16) wraps its
    ring buffer; the RWKV prompt is a multiple of its chunk."""
    out = _example().main(["--arch", arch, "--prompt-len", "24",
                           "--decode-len", "20", "--batch", "2",
                           "--device", "cpu"])
    assert out["tokens"].shape == (2, 21)
    assert out["timer"] == "host_clock" and len(out["decode_ms"]) == 20
    assert "sample continuation" in capsys.readouterr().out


def test_example_refuses_what_it_cannot_serve():
    mod = _example()
    with pytest.raises(SystemExit, match="encoder-only"):
        mod.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mod.main(["--arch", "rwkv6-7b", "--prompt-len", "20",
                  "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--decode-len", "1"])
