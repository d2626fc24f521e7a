"""The port's training path against the JAX package, on the CPU, with the
same numpy inputs on both sides: the fp and fake-quant Winograd
pipeline (plain and flex) with its gradients, AdamW, and one
ResNet-18 training step.

Tiers:
* fp pipeline (quantization off), forward and gradients with respect to
  x, w and the flex matrices: ``rtol = atol = 1e-4`` (fp32 sums in
  another order than XLA's);
* fake-quant pipeline: the tier ``docs/parity.md`` gives requantizing
  paths, element-wise ``1e-4`` except flipped elements. Forward: a value
  on a rounding boundary may land one step apart, so at most 0.5 % of
  the outputs may differ, each by at most one step of the output cast
  (max|y|/127). Gradients: the saturating straight-through mask of a
  stage's abs-max element sits at |x/scale| = qmax to within an ulp, so
  it may pass in one package and stop in the other; the gradient then
  differs over that element's footprint (one tile's inputs, one output
  channel's weights). At most 25 % of a gradient's elements may differ,
  each by at most 0.25 of its largest value (measured over four seeds
  of every case: 18 % and 0.18 at worst). The JAX reference is compiled
  with XLA's algebraic simplifier off: under ``jit`` it rewrites the
  scale's ``amax / 127`` into ``amax · (1/127)``, one ulp away, which
  moves the JAX package's own jitted fake-quant off its op-by-op result
  (the F(4,3) matrix G then quantizes 14 of its 18 entries to another
  step). The port computes the op-by-op definition;
* ``adamw_update`` and ``cosine_schedule``: ``1e-6``;
* one ResNet step (width 0.125, batch 4, flex, the ``winograd_fp``
  backend): loss and BN state at ``1e-4``; gradients within ``1e-4`` of
  each tensor's largest; updated parameters at ``1e-4`` wherever JAX's
  gradient stands above 1e-4 of its tensor's largest. Below that floor
  the gradient is rounding noise, which AdamW's first step divides by
  its own magnitude, so there the update may differ by up to two steps
  of the learning rate;
* the same step with the ``winograd_fakequant`` backend (the trainer's
  path), conv outputs forced: no element-wise tier holds between two
  free-running fake-quant networks. One flipped rounding step re-scales
  a per-tensor-quantized stage, and the F(4,3) Legendre output
  transform amplifies the re-quantized values: in this network's first
  block, two input-transform values one step apart moved the layer's
  outputs by up to 105 output steps, and JAX's own op-by-op and jitted
  (simplifier off) runs of the network differ by 0.08 in the loss. So
  every conv of the port's network is recorded, and JAX's ``loss_fn``
  runs with an engine that returns those outputs. Each conv's backend,
  each conv's input (what the network feeds it), the loss, the
  accuracy, the new BN state, and, with each conv's input held fixed,
  the gradients with respect to every conv output and to the BN and
  head parameters are held at ``1e-4`` (gradients: ``1e-4`` of each
  tensor's largest). The convs themselves are held per layer above.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import winograd as jw
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.models import resnet as JRN
from repro.models.param import ParamSpec as JParamSpec
from repro.optim import optimizer as jopt
from repro_torch.conv import ConvEngine, ConvPolicy
from repro_torch.core import winograd as tw
from repro_torch.core.quantization import QuantConfig
from repro_torch.launch import train_resnet_qat
from repro_torch.models import resnet as RN
from repro_torch.optim import optimizer as topt

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)

LR, WD = 3e-3, 1e-4
CONV_CASES = [(quant, flex, m, base) for quant in ("fp", "fakequant")
              for flex in (False, True) for m in (2, 4)
              for base in ("canonical", "legendre")]


def _specs(quant, m, base):
    jq = JQuantConfig.off() if quant == "fp" else JQuantConfig(
        hadamard_bits=9)
    tq = QuantConfig.off() if quant == "fp" else QuantConfig(hadamard_bits=9)
    return (jw.WinogradSpec(m=m, r=3, base=base, quant=jq),
            tw.WinogradSpec(m=m, r=3, base=base, quant=tq))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _conv_inputs(case):
    quant, flex, m, base = case
    rng = np.random.default_rng(CONV_CASES.index(case))
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 5)) * 0.3).astype(np.float32)
    r = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    fx = {k: (np.asarray(v) + 0.01 * rng.normal(size=v.shape))
          .astype(np.float32)
          for k, v in jw.flex_init(_specs(quant, m, base)[0]).items()}
    return x, w, r, fx


WIDTH, BATCH, HW = 0.125, 4, 16


def _numpy_tree(specs, rng):
    """He-scaled convs and head, non-trivial BN (a JAX ParamSpec tree)."""
    def leaf(s):
        if len(s.shape) == 4:
            fan = s.shape[0] * s.shape[1] * s.shape[2]
            return rng.normal(size=s.shape) * np.sqrt(2.0 / fan)
        if len(s.shape) == 2:
            return rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        if s.init == "ones":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)
    return jax.tree.map(lambda s: leaf(s).astype(np.float32), specs,
                        is_leaf=lambda x: isinstance(x, JParamSpec))


def _resnet_cfgs(backend):
    jspec = jw.WinogradSpec(m=4, r=3, base="legendre",
                            quant=JQuantConfig(hadamard_bits=9))
    tspec = tw.WinogradSpec(m=4, r=3, base="legendre",
                            quant=QuantConfig(hadamard_bits=9))
    return (JRN.ResNetConfig(width_mult=WIDTH, wino=jspec, flex=True,
                             conv_backend=backend),
            RN.ResNetConfig(width_mult=WIDTH, wino=tspec, flex=True,
                            conv_backend=backend))


def _port_model(cfg, params, state):
    tp, ts = RN.params_from_jax(params, state)
    model = RN.ResNet(cfg, tp, ts, RN.make_engine(cfg, device="cpu"))
    model.train()
    return model


class _Replay:
    """Stands in for the JAX ``ConvEngine`` inside ``JRN.forward``: each
    conv returns the next of the given outputs and keeps its input."""

    def __init__(self, outs):
        self._outs = iter(outs)
        self.inputs = []

    def conv2d(self, x, w, **kw):
        self.inputs.append(x)
        return next(self._outs)


def _fakequant_step(jcfg, cfg, params, state, batch, pool):
    """The port's fake-quant training step with every conv recorded, and
    JAX's ``loss_fn`` lowered on those conv outputs (compile submitted to
    ``pool``). Both sides differentiate with each conv's input held
    fixed."""
    model = _port_model(cfg, params, state)
    eng, rec = model.engine, []
    conv2d = eng.conv2d

    def recording(x, w, *, layer, stride=1, **kw):
        # the input detached: gradients stop at each conv's input, as
        # they do at the replayed convs on the JAX side
        y = conv2d(x.detach(), w, layer=layer, stride=stride, **kw)
        geom = {"kernel_size": w.shape[0], "stride": stride,
                "in_channels": w.shape[2]}
        rec.append((layer, eng.backend_for(layer, **geom), geom, x, y))
        return y
    eng.conv2d = recording
    P = dict(model.named_parameters())
    loss, new_state, acc = RN.loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    wrt = list(P.values()) + [y for *_, y in rec]
    # what feeds only stage 0 no longer reaches the loss: zero gradient
    g = [torch.zeros_like(t) if v is None else v for t, v in zip(
        wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
    outs = [y.detach().numpy() for *_, y in rec]

    def step(params, outs):
        def f(params, outs):
            replay = _Replay(outs)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(JRN, "make_engine", lambda cfg: replay)
                loss, (new_state, acc) = JRN.loss_fn(params, state, batch,
                                                     jcfg)
            return loss, (new_state, acc, replay.inputs)
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            params, outs)
    job = pool.submit(jax.jit(step).lower(params, outs).compile)
    return job, outs, {
        "layers": [r[:3] for r in rec],
        "inputs": [r[3].detach().numpy() for r in rec],
        "loss": loss.detach().numpy(), "acc": acc.numpy(),
        "state": {k: v.numpy() for k, v in new_state.items()},
        "grads": {k: v.numpy() for k, v in zip(P, g)},
        "out_grads": [v.numpy() for v in g[len(P):]]}


def _resnet_inputs():
    """Weights, BN state and a batch for the step, made from seed 0."""
    rng = np.random.default_rng(0)
    jcfg = _resnet_cfgs("winograd_fp")[0]
    specs = JRN.param_specs(jcfg)
    params = _numpy_tree({k: v for k, v in specs.items()
                          if k != "wino_flex"}, rng)
    params["wino_flex"] = {k: np.asarray(v)
                           for k, v in JRN.init_flex(jcfg).items()}
    state = _numpy_tree(JRN.state_specs(jcfg), rng)
    batch = {"images": rng.normal(size=(BATCH, HW, HW, 3))
             .astype(np.float32),
             "labels": rng.integers(0, 10, BATCH)}
    return params, state, batch


@pytest.fixture(scope="module")
def compile_pool():
    """Worker threads for XLA compiles (they release the GIL), so the JAX
    references compile side by side and beside the port's own work."""
    with ThreadPoolExecutor(max_workers=8) as pool:
        yield pool


ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
SPECS = [(m, base) for m in (2, 4) for base in ("canonical", "legendre")]


def _conv_args(quant, flex, m, base):
    x, w, r, fx = _conv_inputs((quant, flex, m, base))
    if not flex:
        fx = {k: np.asarray(v)
              for k, v in jw.flex_init(_specs(quant, m, base)[0]).items()}
    return x, w, r, fx


def _conv_group_fn(quant, group):
    """Forward and gradients of every spec in ``group`` as one function;
    each spec takes the transform matrices as an argument, so one
    compile serves the analytic matrices (the plain pipeline's
    arithmetic) and the perturbed flex ones."""
    def run(args):
        res = []
        for (m, base), (x, w, r, fx) in zip(group, args):
            js = _specs(quant, m, base)[0]

            def f(x, w, fx):
                y = jw.winograd_conv2d(x, w, js, flex=fx)
                return jnp.sum(y * r), y
            res.append(jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(x, w, fx))
        return res
    return run


@pytest.fixture(scope="module")
def jax_jobs(compile_pool):
    """Lowers every JAX reference of this module and submits each compile
    as soon as it is lowered: the fp network's gradient (the longest
    compile) first, then the fake-quant network on the port's conv
    outputs, the conv groups (the fp specs in one compile, each
    fake-quant spec in its own with the algebraic simplifier off), and
    AdamW on the network's parameters. The port's side runs on its one
    thread meanwhile, leaving the other cores to the compiles."""
    params, state, batch = net = _resnet_inputs()
    jcfg = _resnet_cfgs("winograd_fp")[0]

    def grad_step(params, state, batch):
        return jax.value_and_grad(JRN.loss_fn, has_aux=True)(
            params, state, batch, jcfg)
    jobs = {"net": (net, compile_pool.submit(
        jax.jit(grad_step).lower(*net).compile))}
    jobs["fq"] = _fakequant_step(*_resnet_cfgs("winograd_fakequant"),
                                 *net, compile_pool)
    groups = [("fp", SPECS, {})] + [("fakequant", [s], ALGSIMP_OFF)
                                    for s in SPECS]
    jobs["convs"] = [
        (quant, group, compile_pool.submit(
            jax.jit(_conv_group_fn(quant, group)).lower(
                [_conv_args(quant, False, m, base) for m, base in group]
            ).compile, compiler_options=opts))
        for quant, group, opts in groups]

    def update(grads, params):
        return jopt.adamw_update(grads, jopt.adamw_init(params), params,
                                 lr=LR, weight_decay=WD)[0]
    jobs["adamw"] = compile_pool.submit(
        jax.jit(update).lower(params, params).compile)
    return jobs


@pytest.fixture(scope="module")
def jax_convs(jax_jobs):
    """JAX forward and gradients of every conv case."""
    out = {}
    for quant, group, job in jax_jobs["convs"]:
        compiled = job.result()
        for flex in (False, True):
            res = compiled([_conv_args(quant, flex, m, base)
                            for m, base in group])
            for (m, base), ((_, jy), jg) in zip(group, res):
                out[(quant, flex, m, base)] = (
                    np.asarray(jy), [np.asarray(jg[0]), np.asarray(jg[1]),
                                     {k: np.asarray(v)
                                      for k, v in jg[2].items()}])
    return out


@pytest.mark.parametrize("quant,flex,m,base", CONV_CASES)
def test_winograd_conv2d_and_its_gradients_match_jax(quant, flex, m, base,
                                                     jax_convs):
    ts = _specs(quant, m, base)[1]
    x, w, r, fx = _conv_inputs((quant, flex, m, base))
    jy, jg = jax_convs[(quant, flex, m, base)]

    tx = torch.tensor(x, requires_grad=True)
    twt = torch.tensor(w, requires_grad=True)
    tfx = {k: torch.tensor(v, requires_grad=True) for k, v in fx.items()}
    ty = tw.winograd_conv2d(tx, twt, ts, flex=tfx if flex else None)
    (ty * torch.from_numpy(r)).sum().backward()

    ty = ty.detach().numpy()
    if quant == "fp":
        np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
    else:
        d = np.abs(ty - jy)
        flipped = d > 1e-4 * (1 + np.abs(jy))
        step = np.abs(jy).max() / 127
        print(f"{quant} F({m},3) {base} flex={flex}: {int(flipped.sum())} "
              f"of {d.size} outputs flipped, max |diff| {d.max():.4g} "
              f"(output step {step:.4g})")
        assert flipped.sum() <= 0.005 * d.size
        assert d.max() <= step * (1 + 1e-4) + 1e-4
    pairs = [("x", tx.grad, jg[0]), ("w", twt.grad, jg[1])]
    if flex:
        pairs += [(k, tfx[k].grad, jg[2][k]) for k in sorted(tfx)]
    else:
        assert all(v.grad is None for v in tfx.values())
    for name, got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        if quant == "fp":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            continue
        d = np.abs(got - want)
        flipped = d > 1e-4 * (1 + np.abs(want))
        assert flipped.sum() <= 0.25 * d.size, (name, int(flipped.sum()))
        assert d.max() <= 0.25 * np.abs(want).max(), (name, d.max())


def test_flex_init_and_direct_conv2d_match_jax():
    for base in ("canonical", "legendre"):
        js, ts = _specs("fp", 4, base)
        ref = jw.flex_init(js)
        ours = tw.flex_init(ts)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    for pad in ("same", "valid"):
        np.testing.assert_allclose(
            tw.direct_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                             pad).numpy(),
            np.asarray(jw.direct_conv2d(x, w, pad)), rtol=1e-4, atol=1e-4)


def test_engine_backends_route_like_jax_and_int8_refuses_flex():
    spec = tw.WinogradSpec(m=4, r=3, base="legendre",
                           quant=QuantConfig(hadamard_bits=9))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 4)).astype(np.float32))
    flex = tw.flex_init(spec)
    for backend, want in (
            ("winograd_fp", tw.winograd_conv2d(x, w, dataclass_off(spec),
                                               flex=flex)),
            ("winograd_fakequant", tw.winograd_conv2d(x, w, spec,
                                                      flex=flex)),
            ("direct", tw.direct_conv2d(x, w))):
        eng = ConvEngine(spec, ConvPolicy(backend=backend), device="cpu")
        np.testing.assert_array_equal(eng.conv2d(x, w, flex=flex).numpy(),
                                      want.numpy())
    eng = ConvEngine(spec, ConvPolicy(backend="winograd_int8"), device="cpu")
    with pytest.raises(ValueError, match="flex"):
        eng.conv2d(x, w, flex=flex)


def dataclass_off(spec):
    return tw.WinogradSpec(m=spec.m, r=spec.r, base=spec.base,
                           quant=QuantConfig.off())


def test_adamw_update_and_cosine_schedule_match_jax():
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp, jstate = params, jopt.adamw_init(params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = topt.adamw_init(tp)
    jupdate = jax.jit(functools.partial(jopt.adamw_update, lr=LR,
                                        weight_decay=WD))
    for step, gscale in enumerate((0.1, 10.0, 0.3)):   # clip on step 2
        g = {k: (gscale * rng.normal(size=s)).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate, jm = jupdate(g, jstate, jp)
        tp, tstate, tm = topt.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp,
            lr=LR, weight_decay=WD)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (tstate["m"][k],
                                               jstate["m"][k]),
                              (tstate["v"][k], jstate["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
    steps = np.array([0, 3, 10, 40, 99, 100, 150])
    jlr = np.asarray(jax.jit(jopt.cosine_schedule(LR, 10, 100))(steps))
    tlr = topt.cosine_schedule(LR, 10, 100)
    np.testing.assert_allclose([tlr(int(s)) for s in steps], jlr, rtol=1e-6,
                               atol=1e-9)


@pytest.fixture(scope="module")
def resnet_step(jax_jobs):
    """One training step from the same weights in both packages: JAX
    ``loss_fn`` + ``adamw_update`` with the ``winograd_fp`` backend (one
    jit compile of the network, one of the update) against the port's; and the port's
    ``winograd_fakequant`` step against JAX's ``loss_fn`` on the port's
    recorded conv outputs."""
    (params, state, batch), net_job = jax_jobs["net"]
    model = _port_model(_resnet_cfgs("winograd_fp")[1], params, state)
    P = dict(model.named_parameters())
    loss, new_state, acc = RN.loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    new_p, _, _ = topt.adamw_update(grads, topt.adamw_init(P), P, lr=LR,
                                    weight_decay=WD)

    fq_job, fq_outs, fq_port = jax_jobs["fq"]
    (fl, (fst, facc, fins)), (fgp, fgy) = fq_job.result()(params, fq_outs)
    jfq = JRN.make_engine(_resnet_cfgs("winograd_fakequant")[0])
    (jl, (jst, jacc)), jg = net_job.result()(params, state, batch)
    jp = jax_jobs["adamw"].result()(jg, params)
    return {"jax": [np.asarray(jl), np.asarray(jacc), _flat(jst),
                    _flat(jg), _flat(jp)],
            "port": [loss.detach().numpy(), acc.numpy(),
                     {k: v.numpy() for k, v in new_state.items()},
                     {k: v.numpy() for k, v in grads.items()},
                     {k: v.numpy() for k, v in new_p.items()}],
            "fq_port": fq_port,
            "fq_jax": {"loss": np.asarray(fl), "acc": np.asarray(facc),
                       "state": _flat(fst),
                       "inputs": [np.asarray(v) for v in fins],
                       "grads": _flat(fgp),
                       "out_grads": [np.asarray(v) for v in fgy],
                       "backends": [jfq.backend_for(layer, **geom)
                                    for layer, _, geom in fq_port["layers"]]}}


def test_resnet_step_loss_acc_and_bn_state_match_jax(resnet_step):
    jl, jacc, jst, _, _ = resnet_step["jax"]
    tl, tacc, tst, _, _ = resnet_step["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert float(tacc) == float(jacc)
    assert sorted(tst) == sorted(jst) and len(tst) == 40
    for k in jst:
        np.testing.assert_allclose(tst[k], jst[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_resnet_step_gradients_and_update_match_jax(resnet_step):
    _, _, _, jg, jp = resnet_step["jax"]
    _, _, _, tg, tp = resnet_step["port"]
    assert sorted(tg) == sorted(jg) and "wino_flex.GP" in tg
    below = 0
    for k in jg:
        scale = np.abs(jg[k]).max()
        np.testing.assert_allclose(tg[k], jg[k], rtol=0,
                                   atol=1e-4 * max(scale, 1e-30),
                                   err_msg=k)
        floor = np.abs(jg[k]) < 1e-4 * scale
        d = np.abs(tp[k] - jp[k])
        assert (d[~floor] <= 1e-4 * (1 + np.abs(jp[k][~floor]))).all(), k
        assert (d[floor] <= 2 * LR * (1 + WD * np.abs(jp[k][floor]))
                + 1e-4).all(), k
        below += int(floor.sum())
    print(f"{below} parameters with a gradient below its tensor's floor")


def test_resnet_fake_quant_step_chains_its_layers_like_jax(resnet_step):
    """The trainer's path: routing, what each conv is fed, loss, accuracy
    and BN state, with the conv outputs forced to the port's."""
    port, ref = resnet_step["fq_port"], resnet_step["fq_jax"]
    layers = [layer for layer, _, _ in port["layers"]]
    assert len(layers) == 20 and layers[:3] == ["stem", "s0b0.conv1",
                                                "s0b0.conv2"]
    backends = [b for _, b, _ in port["layers"]]
    assert backends == ref["backends"]
    assert backends.count("winograd_fakequant") == 14
    assert len(ref["inputs"]) == len(port["inputs"])
    for layer, got, want in zip(layers, port["inputs"], ref["inputs"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=layer)
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-4,
                               atol=1e-4)
    assert float(port["acc"]) == float(ref["acc"])
    assert sorted(port["state"]) == sorted(ref["state"])
    for k, want in ref["state"].items():
        np.testing.assert_allclose(port["state"][k], want, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_resnet_fake_quant_step_backward_chains_like_jax(resnet_step):
    """Gradients with respect to every conv output, and to the BN and
    head parameters, with each conv's input held fixed on both sides."""
    port, ref = resnet_step["fq_port"], resnet_step["fq_jax"]
    assert len(port["out_grads"]) == len(ref["out_grads"]) == 20
    for (layer, _, _), got, want in zip(port["layers"], port["out_grads"],
                                        ref["out_grads"]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=layer)
    names = [k for k in ref["grads"]
             if ".bn" in k or k.startswith(("bn_stem", "head"))]
    assert len(names) == 2 * 20 + 2
    for k in names:
        want = ref["grads"][k]
        np.testing.assert_allclose(port["grads"][k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_trainer_takes_fake_quant_steps_on_cpu():
    """On several threads, where torch's CPU conv backward needs the NCHW
    copy that ``direct_conv2d`` makes for the 1×1 stride-2 projections."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = train_resnet_qat.main(["--width", "0.125", "--batch", "2",
                                     "--steps", "2", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    moved = out["param_change"]
    assert all(v > 0 for v in moved.values()), moved
    assert {"wino_flex.GP", "wino_flex.BPT", "wino_flex.APT"} <= set(moved)
    assert all(v > 0 for v in out["bn_change"].values())
    assert out["peak_mem_bytes"] is None


def test_trainer_refuses_the_card_default_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_resnet_qat.main(["--width", "0.125", "--steps", "1"])
