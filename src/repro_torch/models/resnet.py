"""ResNet18-CIFAR10, the paper's own experimental model, with every
conv routed through the port's ``ConvEngine`` (the counterpart of
``repro.models.resnet``).

The policy sends stride-1 3×3 convs to the configured Winograd backend
(fake-quant QAT for training, the int8 CUDA kernels for serving) and
stride-2 convs / 1×1 projections to direct convolution, the split of
the JAX model. ``ResNet`` is an ``nn.Module``: in eval mode its forward
is the JAX ``forward(training=False)`` (BatchNorm with running
statistics); in training mode it is ``forward(training=True)``, BatchNorm
normalizing with the batch statistics and updating the running ones in
place (the JAX model returns them as a new state tree). Weights keep
the JAX layouts (HWIO convs, (in, out) head) and its tree paths as
parameter names (``blocks.s0b0.conv1``, ``wino_flex.GP``), so
``params_from_jax`` carries a JAX model across as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.conv import ConvEngine, ConvPolicy
from repro_torch.conv.planner import LayerGeom
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec, flex_init
from repro_torch.models.param import ParamSpec

__all__ = ["ResNetConfig", "ResNet", "param_specs", "state_specs",
           "init_flex", "make_engine", "conv_layers", "params_from_jax",
           "loss_fn", "serving_forward", "layer_geoms", "NUM_CLASSES"]

NUM_CLASSES = 10
_STAGES = (2, 2, 2, 2)          # ResNet18 basic blocks per stage
_BN_MOMENTUM = 0.9              # weight of the old running statistics
_WIDTHS = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    width_mult: float = 0.5      # the paper's channel multiplier
    wino: Optional[WinogradSpec] = WinogradSpec(
        m=4, r=3, base="legendre", quant=QuantConfig())
    use_winograd: bool = True    # False → direct conv everywhere (baseline)
    conv_backend: Optional[str] = None   # engine backend for eligible convs
    flex: bool = False           # learnable transform matrices
    num_classes: int = NUM_CLASSES
    name: str = "resnet18-cifar10"   # the architecture registry's key
    family: str = "cnn"

    @property
    def widths(self):
        return tuple(max(8, int(w * self.width_mult)) for w in _WIDTHS)


def _conv_spec(cin, cout, k):
    return ParamSpec((k, k, cin, cout), (None, None, "embed", "mlp"),
                     scale=1.0)


def _bn_spec(c):
    return {"scale": ParamSpec((c,), (None,), init="ones"),
            "bias": ParamSpec((c,), (None,), init="zeros")}


def _bn_state_spec(c):
    return {"mean": ParamSpec((c,), (None,), init="zeros"),
            "var": ParamSpec((c,), (None,), init="ones")}


def _has_proj(cin, cout, stride) -> bool:
    return stride != 1 or cin != cout


def _block_specs(cin, cout, stride):
    s = {"conv1": _conv_spec(cin, cout, 3), "bn1": _bn_spec(cout),
         "conv2": _conv_spec(cout, cout, 3), "bn2": _bn_spec(cout)}
    if _has_proj(cin, cout, stride):
        s["proj"] = _conv_spec(cin, cout, 1)
        s["bn_proj"] = _bn_spec(cout)
    return s


def _block_state(cin, cout, stride):
    s = {"bn1": _bn_state_spec(cout), "bn2": _bn_state_spec(cout)}
    if _has_proj(cin, cout, stride):
        s["bn_proj"] = _bn_state_spec(cout)
    return s


def _iter_blocks(cfg):
    cin = cfg.widths[0]
    for si, (n, cout) in enumerate(zip(_STAGES, cfg.widths)):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            yield f"s{si}b{bi}", cin, cout, stride
            cin = cout


def param_specs(cfg: ResNetConfig) -> dict:
    w0 = cfg.widths[0]
    specs = {
        "stem": _conv_spec(3, w0, 3),
        "bn_stem": _bn_spec(w0),
        "head": ParamSpec((cfg.widths[-1], cfg.num_classes),
                          ("embed", None)),
        "head_b": ParamSpec((cfg.num_classes,), (None,), init="zeros"),
        "blocks": {nm: _block_specs(ci, co, st)
                   for nm, ci, co, st in _iter_blocks(cfg)},
    }
    if cfg.use_winograd and cfg.flex and cfg.wino is not None:
        specs["wino_flex"] = {
            k: ParamSpec(tuple(v.shape), (None,) * v.ndim, init="zeros")
            for k, v in flex_init(cfg.wino).items()}
    return specs


def state_specs(cfg: ResNetConfig) -> dict:
    w0 = cfg.widths[0]
    return {"bn_stem": _bn_state_spec(w0),
            "blocks": {nm: _block_state(ci, co, st)
                       for nm, ci, co, st in _iter_blocks(cfg)}}


def init_flex(cfg: ResNetConfig) -> Optional[dict]:
    """The flex matrices' starting values (the analytic matrices, not the
    zeros of ``param_specs``), or None without flex."""
    return (flex_init(cfg.wino)
            if cfg.use_winograd and cfg.flex and cfg.wino is not None
            else None)


def params_from_jax(params_np: dict, state_np: dict) -> tuple[dict, dict]:
    """The JAX model's parameter and state trees (nested dicts of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``, ``wino_flex``
    included) → the port's trees (nested dicts of fp32 CPU tensors).
    Layouts are shared, so the two packages then compute the same
    network."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32))
    return conv(params_np), conv(state_np)


def make_engine(cfg: ResNetConfig, backend: Optional[str] = None,
                fused: bool = True, device=None,
                autotune: bool = False,
                autotune_opts: Optional[dict] = None,
                plan=None,
                warmup: Optional[tuple] = None,
                mesh=None, data_axis="data",
                model_axis=None) -> ConvEngine:
    """The config's ConvEngine. ``backend`` overrides the eligible-conv
    backend (``"winograd_int8"`` to serve through the CUDA kernels,
    ``"direct"`` for the fp32 reference); ``fused=False`` forces the
    staged int8 pipeline. ``autotune``/``autotune_opts``: tune K4's tile
    per layer shape at calibration (``conv.autotune``). ``plan``: a
    measured ``conv.planner.Plan`` (planned layers route by their entry,
    the policy covers the rest). ``mesh``: serve prepared, calibrated
    int8 layers across a ``distributed.sharding.Mesh``, tiles over
    ``data_axis`` and, with ``model_axis``, each conv's Cout over that
    axis (see ``ConvEngine``).

    ``warmup=(params, state, geometries)`` also builds the serving
    forward (``serving_forward``) as ``engine.serve_fn`` and runs
    ``engine.warmup`` over the ``(batch, 32, 32, 3)`` geometries. Only for
    an engine that holds its final serving state when built; a restore
    flow calls ``engine.warmup`` after ``import_state``."""
    if not cfg.use_winograd or cfg.wino is None:
        eng = ConvEngine(cfg.wino,
                         ConvPolicy(backend="direct", fallback="direct"),
                         device=device, plan=plan)
    else:
        backend = backend or cfg.conv_backend or "winograd_fakequant"
        eng = ConvEngine(cfg.wino, ConvPolicy(backend=backend), fused=fused,
                         device=device, autotune=autotune,
                         autotune_opts=autotune_opts, plan=plan, mesh=mesh,
                         data_axis=data_axis, model_axis=model_axis)
    if warmup is not None:
        params, state, geometries = warmup
        eng.serve_fn = serving_forward(ResNet(cfg, params, state, eng))
        eng.warmup(geometries)
    return eng


def serving_forward(model: "ResNet", engine: Optional[ConvEngine] = None):
    """The online serving callable: images → logits in inference mode
    through ``engine`` (the model's own by default), one CUDA graph per
    input shape on the card (``serving.graphs.GraphedForward``; eager on
    the CPU). Build it once per engine and reuse it: a new one captures
    every shape again. The logits it returns are the graph's static
    output, overwritten by the next call of the same shape. An engine
    whose mesh spans several cards is refused (``GraphedForward``)."""
    from repro_torch.serving.graphs import GraphedForward
    eng = engine or model.engine
    return GraphedForward(lambda images: model(images, eng), eng.device,
                          mesh=eng.mesh)


def layer_geoms(cfg: ResNetConfig, batch: int,
                image_hw: int = 32) -> list[LayerGeom]:
    """The planner's layer menu: one ``conv.planner.LayerGeom`` per
    engine-routed conv, in ``conv_layers`` order, at the input shapes the
    forward gives each (SAME padding halves the extent at every stride-2
    block)."""
    hw = image_hw
    geoms = [LayerGeom("stem", (batch, hw, hw, 3), cfg.widths[0])]
    for nm, cin, cout, stride in _iter_blocks(cfg):
        hw_out = -(-hw // stride)
        geoms.append(LayerGeom(f"{nm}.conv1", (batch, hw, hw, cin), cout,
                               stride=stride))
        geoms.append(LayerGeom(f"{nm}.conv2", (batch, hw_out, hw_out, cout),
                               cout))
        if _has_proj(cin, cout, stride):
            geoms.append(LayerGeom(f"{nm}.proj", (batch, hw, hw, cin), cout,
                                   kernel_size=1, stride=stride))
        hw = hw_out
    return geoms


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.detach().to(torch.float32).clone())


class _BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis of NHWC, as the JAX
    model's ``_bn``: training mode normalizes with the batch mean and
    biased variance over (N, H, W) and sets the running statistics to
    ``0.9·old + 0.1·batch``; eval mode uses them."""

    def __init__(self, p: dict, st: dict):
        super().__init__()
        self.scale = _param(p["scale"])
        self.bias = _param(p["bias"])
        self.register_buffer("mean", st["mean"].to(torch.float32).clone())
        self.register_buffer("var", st["var"].to(torch.float32).clone())

    def forward(self, x):
        if self.training:
            var, mu = torch.var_mean(x, dim=(0, 1, 2), correction=0)
            with torch.no_grad():
                mom = _BN_MOMENTUM
                self.mean.copy_(mom * self.mean + (1 - mom) * mu)
                self.var.copy_(mom * self.var + (1 - mom) * var)
        else:
            mu, var = self.mean, self.var
        y = (x - mu) * torch.rsqrt(var + 1e-5)
        return y * self.scale + self.bias


class _Block(nn.Module):
    def __init__(self, p: dict, st: dict):
        super().__init__()
        self.conv1 = _param(p["conv1"])
        self.conv2 = _param(p["conv2"])
        self.bn1 = _BatchNorm(p["bn1"], st["bn1"])
        self.bn2 = _BatchNorm(p["bn2"], st["bn2"])
        self.proj = _param(p["proj"]) if "proj" in p else None
        self.bn_proj = (_BatchNorm(p["bn_proj"], st["bn_proj"])
                        if "proj" in p else None)


class ResNet(nn.Module):
    """ResNet18-CIFAR10. ``forward(images)``: (B, 32, 32, 3) NHWC →
    logits (B, classes), every conv through ``engine`` (the module's own
    unless one is passed, so one set of weights can serve through
    several engines). Built in eval mode; ``.train()`` switches
    BatchNorm to batch statistics. The parameters are trainable and the
    flex matrices, where ``params`` holds ``wino_flex``, are parameters
    too."""

    def __init__(self, cfg: ResNetConfig, params: dict, state: dict,
                 engine: ConvEngine):
        super().__init__()
        self.cfg = cfg
        self.engine = engine
        self.stem = _param(params["stem"])
        self.bn_stem = _BatchNorm(params["bn_stem"], state["bn_stem"])
        self.blocks = nn.ModuleDict({
            nm: _Block(params["blocks"][nm], state["blocks"][nm])
            for nm, _, _, _ in _iter_blocks(cfg)})
        self.head = _param(params["head"])
        self.head_b = _param(params["head_b"])
        self.wino_flex = (nn.ParameterDict(
            {k: _param(v) for k, v in params["wino_flex"].items()})
            if "wino_flex" in params else None)
        self.to(engine.device)
        self.eval()

    def forward(self, images: torch.Tensor,
                engine: Optional[ConvEngine] = None) -> torch.Tensor:
        eng = engine or self.engine
        flex = dict(self.wino_flex) if self.wino_flex is not None else None
        x = eng.conv2d(images, self.stem, layer="stem", flex=flex)
        x = F.relu(self.bn_stem(x))
        for nm, _, _, stride in _iter_blocks(self.cfg):
            blk = self.blocks[nm]
            h = eng.conv2d(x, blk.conv1, layer=f"{nm}.conv1", stride=stride,
                           flex=flex)
            h = F.relu(blk.bn1(h))
            h = blk.bn2(eng.conv2d(h, blk.conv2, layer=f"{nm}.conv2",
                                   flex=flex))
            if blk.proj is not None:
                sc = blk.bn_proj(eng.conv2d(x, blk.proj, layer=f"{nm}.proj",
                                            stride=stride, flex=flex))
            else:
                sc = x
            x = F.relu(h + sc)
        x = x.mean(dim=(1, 2))
        return x @ self.head + self.head_b


def loss_fn(model: ResNet, batch: dict
            ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Mean cross-entropy of ``model`` on ``batch`` (``images``,
    ``labels``) → (loss, state, acc): the JAX ``loss_fn``. ``state`` is
    the BatchNorm running statistics by name, after this forward (in
    training mode it has just updated them)."""
    logits = model(batch["images"])
    labels = batch["labels"]
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, dict(model.named_buffers()), acc


def conv_layers(model: ResNet):
    """Yield (layer_name, weights, stride) for every engine-routed conv of
    ``model`` in forward order — the input of ``ConvEngine.prepare``."""
    yield "stem", model.stem, 1
    for nm, _, _, stride in _iter_blocks(model.cfg):
        blk = model.blocks[nm]
        yield f"{nm}.conv1", blk.conv1, stride
        yield f"{nm}.conv2", blk.conv2, 1
        if blk.proj is not None:
            yield f"{nm}.proj", blk.proj, stride
