"""ConvEngine: dispatch over the convolution backends, and the owner of
the prepared/calibrated int8 serving state (the port's counterpart of
``repro.conv.engine``).

Backends served by the port:

* ``direct`` — ``F.conv2d`` with TF32 off (full fp32, the counterpart of
  ``lax.conv``): stride-2 convs, 1×1 projections, and the fp reference.
* ``winograd_int8`` — the CUDA kernels through ``kernels.ops``: K1 input
  transform, then the single-pass K4 (``fused=True``, the default, for
  prepared + calibrated layers) or the staged K2 → K3 pipeline.

``winograd_fp`` and ``winograd_fakequant`` are routed by the policy but
not ported yet; routing a layer to them raises.

Lifecycle (int8 serving):

1. **prepare** — ``engine.prepare(named_weights)`` packs each eligible
   layer once into ``PackedWinogradWeights``.
2. **calibrate** — under ``with engine.calibration():`` run batches
   through the model; per-layer, per-position input maxima (and the
   Hadamard-product maxima when the 8/9-bit stage is on) become static
   scales on exit.
3. **serialize** — ``export_state()`` / ``state_template()`` /
   ``import_state()`` round-trip the state through ``repro_torch.checkpoint``
   in the JAX package's on-disk format.
4. **execute** — ``conv2d`` on a prepared + calibrated layer runs with no
   weight transform and no scale reduction.

A layer re-packed after a weight update keeps its ``in_scales`` but
drops ``hadamard_amax`` (weight-dependent) and serves with dynamic
requant until recalibrated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Optional

import torch
import torch.nn.functional as F

from repro_torch.conv.packing import (PackedWinogradWeights, merge_abs_max,
                                      pack_weights, scales_from_abs_max)
from repro_torch.conv.policy import ConvPolicy
from repro_torch.core.winograd import WinogradSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (_extract, _geometry, _tiles_abs_max,
                                     execute_int8, prepare_weights_int8,
                                     winograd_conv2d_int8)

__all__ = ["ConvEngine"]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding along one dim: (lo, hi), hi taking the odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _direct(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding: str = "same") -> torch.Tensor:
    """Direct convolution, NHWC × HWIO → NHWC, in full fp32: cuDNN's TF32
    is off for the call, so this is the counterpart of ``lax.conv`` with
    "SAME"/"VALID" padding."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if padding == "same":
        (hl, hh), (wl, wh) = (_same_pads(x.shape[1], w.shape[0], stride),
                              _same_pads(x.shape[2], w.shape[1], stride))
        xn = F.pad(xn, (wl, wh, hl, hh))
    elif padding != "valid":
        raise ValueError(padding)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xn, wn, stride=stride)
    return y.permute(0, 2, 3, 1)


def _same_packed_weights(a: PackedWinogradWeights,
                         b: PackedWinogradWeights) -> bool:
    """Whether two packs encode identical weights (both leaves: a pure
    rescale of w leaves u_q unchanged)."""
    return (a.u_q.shape == b.u_q.shape
            and bool(torch.equal(a.u_q, b.u_q))
            and bool(torch.equal(a.w_scales, b.w_scales)))


class ConvEngine:
    """Dispatches convolutions through a policy-selected backend and owns
    the prepared/calibrated serving state (see module docstring)."""

    def __init__(self, spec: Optional[WinogradSpec],
                 policy: Optional[ConvPolicy] = None,
                 padding: str = "same",
                 hadamard_bits: "Optional[int] | str" = "from_spec",
                 fused: bool = True,
                 device=None):
        """``hadamard_bits``: the 8/9-bit Hadamard requant stage; the
        default mirrors ``spec.quant.hadamard_bits``, an int overrides,
        None disables.

        ``fused``: serve prepared + calibrated int8 layers through the
        single-pass K4 kernel (default); calibration and dynamic requant
        stay staged either way.

        ``device``: where the packed state lives and the kernels run —
        ``cuda`` unless the caller asks for another; without a card, a
        CUDA engine raises here."""
        if spec is None:
            policy = policy or ConvPolicy(backend="direct",
                                          fallback="direct")
            routed = ({policy.backend, policy.fallback}
                      | {b for _, b in policy.overrides})
            if any(b != "direct" for b in routed):
                raise ValueError("Winograd backends need a WinogradSpec")
        if hadamard_bits == "from_spec":
            hadamard_bits = (spec.quant.hadamard_bits
                             if spec is not None else None)
        self.spec = spec
        self.policy = policy or ConvPolicy()
        self.padding = padding
        self.hadamard_bits = hadamard_bits
        self.fused = fused
        self.device = resolve_device(device)
        self.packed: dict[str, PackedWinogradWeights] = {}
        self._calibrating = False
        self._amax: dict[str, torch.Tensor] = {}     # input-domain running max
        self._amax_h: dict[str, torch.Tensor] = {}   # Hadamard-product max
        self._scales: dict[str, torch.Tensor] = {}   # finalized calibrations
        self._h_amax_final: dict[str, torch.Tensor] = {}
        # The packed weights each calibration observed: the Hadamard
        # abs-max may only reattach to a later prepare() of the same
        # weights.
        self._calib_uq: dict[str, tuple] = {}

    # -- dispatch -----------------------------------------------------------

    def backend_for(self, layer: str, *, kernel_size: int, stride: int,
                    in_channels: Optional[int] = None) -> str:
        r = self.spec.r if self.spec is not None else None
        m = self.spec.m if self.spec is not None else None
        return self.policy.backend_for(layer, kernel_size=kernel_size,
                                       stride=stride, spec_r=r,
                                       in_channels=in_channels, spec_m=m)

    def conv2d(self, x: torch.Tensor, w: Optional[torch.Tensor], *,
               layer: str = "conv", stride: int = 1,
               padding: Optional[str] = None) -> torch.Tensor:
        """One convolution. x: (N,H,W,Cin) NHWC; w: (k,k,Cin,Cout) HWIO.

        ``w`` may be None for a prepared + calibrated ``winograd_int8``
        layer. For an int8 layer with packed state the packed weights are
        authoritative and a passed ``w`` is ignored.
        """
        pad = padding or self.padding
        pk = self.packed.get(layer)
        spec = self.spec
        if w is None:
            if pk is None or spec is None:
                raise ValueError(f"layer {layer!r}: no weights and no "
                                 "prepared state")
            k, cin = spec.r, pk.u_q.shape[1]
        else:
            k, cin = w.shape[0], w.shape[2]
        backend = self.backend_for(layer, kernel_size=k, stride=stride,
                                   in_channels=cin)
        if w is None and backend != "winograd_int8":
            raise ValueError(
                f"layer {layer!r}: no weights passed but policy routes to "
                f"{backend!r} — packed state only serves winograd_int8")

        if backend == "direct":
            return _direct(x, w, stride, pad)
        if backend != "winograd_int8":
            raise NotImplementedError(
                f"layer {layer!r}: the {backend!r} backend is not ported "
                f"yet; the port serves 'direct' and 'winograd_int8'")
        hbits = self.hadamard_bits
        if self._calibrating:
            return self._calibrate_conv(x, w, pk, layer, pad, spec, hbits)
        if pk is not None:
            return winograd_conv2d_int8(
                x, None, spec, pad,
                in_scales=pk.in_scales if pk.calibrated else None,
                u_q=pk.u_q, w_scales=pk.w_scales,
                hadamard_bits=hbits,
                h_amax=pk.hadamard_amax if pk.calibrated else None,
                fused=self.fused)
        return winograd_conv2d_int8(x, w, spec, pad, hadamard_bits=hbits,
                                    fused=self.fused)

    def _calibrate_conv(self, x, w, pk, layer, pad, spec, hbits):
        """One int8 conv under calibration: extract tiles once, record
        input-domain and Hadamard-product maxima, execute with this
        batch's statistics (bit-identical to the dynamic derivation)."""
        if pk is not None:
            u_q, w_scales = pk.u_q, pk.w_scales
        else:
            u_q, w_scales = prepare_weights_int8(w, spec)
        tiles = _extract(x, spec.m, spec.r, spec.n, pad)
        geom = _geometry(x.shape, spec.m, spec.r, pad)
        amax = _tiles_abs_max(tiles, spec)
        self._amax[layer] = merge_abs_max(self._amax.get(layer), amax)
        self._calib_uq[layer] = (u_q, w_scales)
        scales = scales_from_abs_max(amax)
        if hbits is None:
            return execute_int8(tiles, u_q, w_scales, scales, spec=spec,
                                geom=geom, hadamard_bits=None)
        y, amax_h = execute_int8(tiles, u_q, w_scales, scales, spec=spec,
                                 geom=geom, hadamard_bits=hbits,
                                 with_stats=True)
        self._amax_h[layer] = merge_abs_max(self._amax_h.get(layer), amax_h)
        return y

    # -- prepare / calibrate ------------------------------------------------

    def prepare_layer(self, layer: str, w: torch.Tensor, *,
                      stride: int = 1) -> bool:
        """Pack one layer's weights if the policy routes it to int8.
        Returns True when the layer was packed (already-calibrated scales
        for the layer are preserved across a re-pack)."""
        backend = self.backend_for(layer, kernel_size=w.shape[0],
                                   stride=stride, in_channels=w.shape[2])
        if backend != "winograd_int8":
            return False
        old = self.packed.get(layer)
        new = pack_weights(w.detach().to(self.device), self.spec)
        if (old is not None and old.blocks is not None
                and old.u_q.shape == new.u_q.shape):
            new = dataclasses.replace(new, blocks=old.blocks)
        if old is not None and old.calibrated:
            # in_scales depend only on the inputs and survive a re-pack;
            # the Hadamard abs-max survives only an idempotent one.
            new = dataclasses.replace(
                new, in_scales=old.in_scales,
                hadamard_amax=(old.hadamard_amax
                               if _same_packed_weights(old, new) else None))
        elif layer in self._scales:      # calibrated before packing
            seen = self._calib_uq.get(layer)
            same_w = (seen is not None
                      and _same_packed_weights(
                          PackedWinogradWeights(u_q=seen[0],
                                                w_scales=seen[1]), new))
            new = dataclasses.replace(
                new, in_scales=self._scales[layer],
                hadamard_amax=(self._h_amax_final.get(layer)
                               if same_w else None))
        self.packed[layer] = new
        return True

    def prepare(self, named_weights: Iterable[tuple]) -> list[str]:
        """Pack every int8-routed layer. Items: (layer, w[, stride])."""
        packed = []
        for item in named_weights:
            layer, w, stride = item if len(item) == 3 else (*item, 1)
            if self.prepare_layer(layer, w, stride=stride):
                packed.append(layer)
        return packed

    @contextlib.contextmanager
    def calibration(self):
        """Record per-layer input statistics; finalize scales on exit."""
        self.begin_calibration()
        try:
            yield self
        finally:
            self.end_calibration()

    def begin_calibration(self):
        self._calibrating = True
        self._amax = {}
        self._amax_h = {}

    def end_calibration(self) -> dict[str, torch.Tensor]:
        """Finalize: running abs-maxima → per-layer in_scales (and the
        Hadamard abs-max when that stage is on). Scales are kept for
        layers not packed yet, so calibrate-then-prepare works too."""
        self._calibrating = False
        scales = {}
        for layer, amax in self._amax.items():
            s = scales_from_abs_max(amax)
            scales[layer] = s
            self._scales[layer] = s
            hs = None
            if layer in self._amax_h:
                # Stored as the raw abs-max: execute_int8 applies the same
                # scale formula as the dynamic requant.
                hs = self._amax_h[layer].reshape(-1, 1)
                self._h_amax_final[layer] = hs
            if layer in self.packed:
                self.packed[layer] = dataclasses.replace(
                    self.packed[layer], in_scales=s, hadamard_amax=hs)
        self._amax = {}
        self._amax_h = {}
        return scales

    # -- serialization ------------------------------------------------------

    def export_state(self) -> dict:
        """Packed + calibrated state as a checkpointable tree (the JAX
        engine's layout). Uncalibrated ``in_scales`` are an error; a
        dropped ``hadamard_amax`` rides as a sentinel leaf."""
        missing = [l for l, p in self.packed.items() if not p.calibrated]
        if missing:
            raise ValueError(f"layers not calibrated: {sorted(missing)}")
        include = self.hadamard_bits is not None
        return {"packed": {l: p.to_tree(include_hadamard=include)
                           for l, p in self.packed.items()}}

    def state_template(self) -> dict:
        """Zero-filled tree matching ``export_state`` — the restore
        skeleton for ``repro_torch.checkpoint.restore`` after
        ``prepare()``."""
        def tmpl(p: PackedWinogradWeights) -> dict:
            P = p.u_q.shape[0]
            zeros = torch.zeros((P, 1), dtype=torch.float32,
                                device=self.device)
            t = {"u_q": p.u_q, "w_scales": p.w_scales,
                 "in_scales": p.in_scales if p.calibrated else zeros}
            if self.hadamard_bits is not None:
                t["hadamard_amax"] = (p.hadamard_amax
                                      if p.hadamard_amax is not None
                                      else zeros)
            t["blocks"] = (p.blocks if p.blocks is not None
                           else torch.full((3,), PackedWinogradWeights
                                           .BLOCKS_MISSING,
                                           dtype=torch.int32))
            return t
        return {"packed": {l: tmpl(p) for l, p in self.packed.items()}}

    def import_state(self, tree: dict):
        """Adopt a restored packed + calibrated tree, placed on this
        engine's device."""
        self.packed = {l: PackedWinogradWeights.from_tree(sub, self.device)
                       for l, sub in tree["packed"].items()}
