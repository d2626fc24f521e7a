"""ResNet18-CIFAR10, the paper's own experimental model, served through
the port's ``ConvEngine`` (the counterpart of ``repro.models.resnet``).

The policy sends stride-1 3×3 convs to the configured Winograd backend
and stride-2 convs / 1×1 projections to direct convolution, the split of
the JAX model. ``ResNet`` is an ``nn.Module`` whose forward is the JAX
``forward(training=False)``: inference-mode BatchNorm with running
statistics. Weights keep the JAX layouts (HWIO convs, (in, out) head),
so ``params_from_jax`` carries a JAX model across as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.conv import ConvEngine, ConvPolicy
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.models.param import ParamSpec

__all__ = ["ResNetConfig", "ResNet", "param_specs", "state_specs",
           "make_engine", "conv_layers", "params_from_jax", "NUM_CLASSES"]

NUM_CLASSES = 10
_STAGES = (2, 2, 2, 2)          # ResNet18 basic blocks per stage
_WIDTHS = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    width_mult: float = 0.5      # the paper's channel multiplier
    wino: Optional[WinogradSpec] = WinogradSpec(
        m=4, r=3, base="legendre", quant=QuantConfig())
    use_winograd: bool = True    # False → direct conv everywhere (baseline)
    conv_backend: Optional[str] = None   # engine backend for eligible convs
    num_classes: int = NUM_CLASSES

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
    return {
        "stem": _conv_spec(3, w0, 3),
        "bn_stem": _bn_spec(w0),
        "head": ParamSpec((cfg.widths[-1], cfg.num_classes),
                          ("embed", None)),
        "head_b": ParamSpec((cfg.num_classes,), (None,), init="zeros"),
        "blocks": {nm: _block_specs(ci, co, st)
                   for nm, ci, co, st in _iter_blocks(cfg)},
    }


def state_specs(cfg: ResNetConfig) -> dict:
    w0 = cfg.widths[0]
    return {"bn_stem": _bn_state_spec(w0),
            "blocks": {nm: _block_state(ci, co, st)
                       for nm, ci, co, st in _iter_blocks(cfg)}}


def params_from_jax(params_np: dict, state_np: dict) -> tuple[dict, dict]:
    """The JAX model's parameter and state trees (nested dicts of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) → the port's trees
    (nested dicts of fp32 CPU tensors). Layouts are shared, so the two
    packages then compute the same network."""
    if "wino_flex" in params_np:
        raise NotImplementedError("flex transforms are not ported yet")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32))
    return conv(params_np), conv(state_np)


def make_engine(cfg: ResNetConfig, backend: Optional[str] = None,
                fused: bool = True, device=None) -> ConvEngine:
    """The config's ConvEngine. ``backend`` overrides the eligible-conv
    backend (``"winograd_int8"`` to serve through the CUDA kernels,
    ``"direct"`` for the fp32 reference); ``fused=False`` forces the
    staged int8 pipeline."""
    if not cfg.use_winograd or cfg.wino is None:
        return ConvEngine(cfg.wino,
                          ConvPolicy(backend="direct", fallback="direct"),
                          device=device)
    backend = backend or cfg.conv_backend or "winograd_fakequant"
    return ConvEngine(cfg.wino, ConvPolicy(backend=backend), fused=fused,
                      device=device)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.to(torch.float32), requires_grad=False)


class _BatchNorm(nn.Module):
    """Inference-mode BatchNorm over the channel (last) axis."""

    def __init__(self, p: dict, st: dict):
        super().__init__()
        self.scale = _frozen(p["scale"])
        self.bias = _frozen(p["bias"])
        self.register_buffer("mean", st["mean"].to(torch.float32))
        self.register_buffer("var", st["var"].to(torch.float32))

    def forward(self, x):
        y = (x - self.mean) * torch.rsqrt(self.var + 1e-5)
        return y * self.scale + self.bias


class _Block(nn.Module):
    def __init__(self, p: dict, st: dict):
        super().__init__()
        self.conv1 = _frozen(p["conv1"])
        self.conv2 = _frozen(p["conv2"])
        self.bn1 = _BatchNorm(p["bn1"], st["bn1"])
        self.bn2 = _BatchNorm(p["bn2"], st["bn2"])
        self.proj = _frozen(p["proj"]) if "proj" in p else None
        self.bn_proj = (_BatchNorm(p["bn_proj"], st["bn_proj"])
                        if "proj" in p else None)


class ResNet(nn.Module):
    """ResNet18-CIFAR10 for inference. ``forward(images)``: (B, 32, 32, 3)
    NHWC → logits (B, classes), every conv through ``engine`` (the
    module's own unless one is passed, so one set of weights can serve
    through several engines)."""

    def __init__(self, cfg: ResNetConfig, params: dict, state: dict,
                 engine: ConvEngine):
        super().__init__()
        self.cfg = cfg
        self.engine = engine
        self.stem = _frozen(params["stem"])
        self.bn_stem = _BatchNorm(params["bn_stem"], state["bn_stem"])
        self.blocks = nn.ModuleDict({
            nm: _Block(params["blocks"][nm], state["blocks"][nm])
            for nm, _, _, _ in _iter_blocks(cfg)})
        self.head = _frozen(params["head"])
        self.head_b = _frozen(params["head_b"])
        self.to(engine.device)
        self.eval()

    def forward(self, images: torch.Tensor,
                engine: Optional[ConvEngine] = None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("BatchNorm training mode is not "
                                      "ported yet; call .eval()")
        eng = engine or self.engine
        x = eng.conv2d(images, self.stem, layer="stem")
        x = F.relu(self.bn_stem(x))
        for nm, _, _, stride in _iter_blocks(self.cfg):
            blk = self.blocks[nm]
            h = eng.conv2d(x, blk.conv1, layer=f"{nm}.conv1", stride=stride)
            h = F.relu(blk.bn1(h))
            h = blk.bn2(eng.conv2d(h, blk.conv2, layer=f"{nm}.conv2"))
            if blk.proj is not None:
                sc = blk.bn_proj(eng.conv2d(x, blk.proj, layer=f"{nm}.proj",
                                            stride=stride))
            else:
                sc = x
            x = F.relu(h + sc)
        x = x.mean(dim=(1, 2))
        return x @ self.head + self.head_b


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
