"""The slice as a whole: ResNet-18/CIFAR-10 at width 0.125, batch 2,
16×16 images, with the JAX model's weights carried across by
``params_from_jax`` and the same numpy images on both sides.

* the port's ``direct`` network equals JAX ``forward`` under a ``direct``
  engine to rtol = atol = 1e-4 (BN, ReLU, head, layouts, weights);
* the port's int8 network, calibrated on one batch and served fused and
  staged, passes the launcher's gate (``infer_resnet.py:309-312``)
  against JAX's ``winograd_fp`` network: fused adds no error over staged
  (|Δ rel| < 0.05) and its error stays below 1;
* the port's launcher runs end to end on the CPU, and refuses the card's
  default without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import winograd as jw
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.models import resnet as JRN
from repro.models.param import ParamSpec as JParamSpec
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels import _build
from repro_torch.launch import infer_resnet
from repro_torch.models import resnet as RN
from repro_torch.core.winograd import flex_init

# One intra-op thread: under pytest-xdist the workers share the cores,
# and torch's OpenMP pool in each would oversubscribe them (ROADMAP,
# Queue C).
torch.set_num_threads(1)

WIDTH, BATCH, HW = 0.125, 2, 16


def _numpy_tree(specs, rng):
    """Values for a JAX ParamSpec tree: He-scaled convs and head,
    non-trivial BN so that every term of BN is exercised."""
    def leaf(s):
        if len(s.shape) == 4:                      # HWIO conv
            fan = s.shape[0] * s.shape[1] * s.shape[2]
            return rng.normal(size=s.shape) * np.sqrt(2.0 / fan)
        if len(s.shape) == 2:                      # head
            return rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        if s.init == "ones":                       # BN scale / var
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)      # BN bias / mean, head_b
    return jax.tree.map(lambda s: leaf(s).astype(np.float32), specs,
                        is_leaf=lambda x: isinstance(x, JParamSpec))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    jspec = jw.WinogradSpec(m=4, r=3, base="legendre",
                            quant=JQuantConfig(hadamard_bits=9))
    jcfg = JRN.ResNetConfig(width_mult=WIDTH, wino=jspec)
    params = _numpy_tree(JRN.param_specs(jcfg), rng)
    state = _numpy_tree(JRN.state_specs(jcfg), rng)
    images = rng.normal(size=(BATCH, HW, HW, 3)).astype(np.float32)
    calib = rng.normal(size=(BATCH, HW, HW, 3)).astype(np.float32)

    def jax_logits(backend):
        eng = JRN.make_engine(jcfg, backend=backend)
        fn = jax.jit(lambda im: JRN.forward(params, state, im, jcfg,
                                            training=False, engine=eng)[0])
        return np.array(fn(jnp.asarray(images)))

    cfg = RN.ResNetConfig(width_mult=WIDTH, wino=WinogradSpec(
        m=4, r=3, base="legendre", quant=QuantConfig(hadamard_bits=9)))
    tp, ts = RN.params_from_jax(params, state)
    return dict(cfg=cfg, tp=tp, ts=ts, images=torch.from_numpy(images),
                calib=torch.from_numpy(calib), jax_logits=jax_logits)


def test_direct_network_matches_jax_forward(nets):
    cfg = nets["cfg"]
    model = RN.ResNet(cfg, nets["tp"], nets["ts"],
                      RN.make_engine(cfg, backend="direct", device="cpu"))
    with torch.inference_mode():
        y = model(nets["images"])
    y_ref = nets["jax_logits"]("direct")
    assert tuple(y.shape) == (BATCH, 10)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)


def test_int8_network_passes_the_launcher_gate_against_jax_fp(nets):
    cfg = nets["cfg"]
    eng = RN.make_engine(cfg, backend="winograd_int8", device="cpu")
    model = RN.ResNet(cfg, nets["tp"], nets["ts"], eng)
    staged = RN.make_engine(cfg, backend="winograd_int8", fused=False,
                            device="cpu")
    with torch.inference_mode():
        assert len(eng.prepare(RN.conv_layers(model))) == 14
        with eng.calibration():
            model(nets["calib"])
        staged.import_state(eng.export_state())
        y_fused = model(nets["images"])
        y_staged = model(nets["images"], staged)
    y_fp = torch.from_numpy(nets["jax_logits"]("winograd_fp"))
    err_fused = infer_resnet.rel(y_fused, y_fp)
    err_staged = infer_resnet.rel(y_staged, y_fp)
    agree = float((y_fused.argmax(-1) == y_fp.argmax(-1)).float().mean())
    print(f"int8 vs JAX winograd_fp: fused rel {err_fused:.4f}, staged rel "
          f"{err_staged:.4f}, argmax agreement {agree:.2f}")
    assert abs(err_fused - err_staged) < 0.05
    assert err_fused < 1.0
    # per layer fused equals staged; on the CPU both run the plain
    # versions, whose arithmetic is shared, so the logits agree exactly
    assert torch.equal(y_fused, y_staged)


def test_launcher_runs_end_to_end_on_cpu(tmp_path):
    _build.reset_launches()
    out = infer_resnet.main(["--width", str(WIDTH), "--batch", "2",
                             "--calib-steps", "1", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    assert out["packed_layers"] == 14
    assert abs(out["rel_fused_fp"] - out["rel_staged_fp"]) < 0.05
    assert (tmp_path / "step_00000000" / "MANIFEST.json").exists()
    # the CPU run launched no kernel
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_launcher_refuses_the_card_default_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_resnet.main(["--width", str(WIDTH), "--batch", "2",
                           "--calib-steps", "1"])


def test_unported_backends_and_training_mode_raise(nets):
    """What the port did not serve before now runs: the fake-quant
    backend (the engine's default) in eval and in training mode. What it
    still refuses raises: flex transforms on the int8 backend."""
    cfg = nets["cfg"]
    model = RN.ResNet(cfg, nets["tp"], nets["ts"],
                      RN.make_engine(cfg, device="cpu"))  # fakequant default
    with torch.no_grad():
        y_eval = model(nets["images"])
        model.train()
        y_train = model(nets["images"])
    for y in (y_eval, y_train):
        assert tuple(y.shape) == (BATCH, 10) and bool(torch.isfinite(y).all())
    moved = [float((b - nets["ts"]["bn_stem"][k]).abs().max())
             for k, b in (("mean", model.bn_stem.mean),
                          ("var", model.bn_stem.var))]
    assert min(moved) > 0          # training mode updated the running stats
    eng = RN.make_engine(cfg, backend="winograd_int8", device="cpu")
    with pytest.raises(ValueError, match="flex"):
        eng.conv2d(nets["images"], model.stem.detach(), layer="stem",
                   flex=flex_init(cfg.wino))
