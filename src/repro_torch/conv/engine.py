"""ConvEngine: dispatch over the convolution backends, and the owner of
the prepared/calibrated int8 serving state (the port's counterpart of
``repro.conv.engine``).

Backends:

* ``direct`` — ``F.conv2d`` with TF32 off (full fp32, the counterpart of
  ``lax.conv``): stride-2 convs, 1×1 projections, the baseline.
* ``winograd_fp`` — ``core.winograd.winograd_conv2d`` with quantization
  off: the exact F(m, r) reference.
* ``winograd_fakequant`` — the same pipeline with the paper's Fig. 2
  fake-quant casts (8-bit, 8/9-bit Hadamard): quantization-aware
  training, differentiable through the straight-through estimator.
* ``winograd_int8`` — the CUDA kernels through ``kernels.ops``: K1 input
  transform, then the single-pass K4 (``fused=True``, the default, for
  prepared + calibrated layers) or the staged K2 → K3 pipeline.

The two plain-PyTorch Winograd backends take ``flex=`` transforms; the
int8 backend packs the analytic matrices and refuses them.

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

Around the lifecycle:

* ``certify=`` gates each int8 layer's ``(spec, base, hadamard_bits,
  Cin)`` at pack time with the exact range certifier
  (``analysis.ranges``);
* ``autotune=True`` times K4's block tiles per layer shape at the end of
  calibration (``conv.autotune``), at the calibration batch's geometry,
  and keeps each winner with the T it was timed at in the packed state,
  so it rides the checkpoint; ``warmup`` then times them at each serving
  geometry's own T (``tuned_tiles``); a call at a T tuned neither way
  takes ``fused_tile``;
* ``plan=`` (a ``conv.planner.Plan``) routes each planned layer by its
  own measured entry, possibly another F(m, 3), base and Hadamard width
  per layer; the plan rides the checkpoint as ``plan/<layer>`` leaves;
* ``warmup`` runs the serving forward once per serving geometry
  (capturing one CUDA graph each, ``serving.graphs``), so the first
  request of a registered shape builds and captures nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Iterable, Optional

import torch

from repro_torch.conv.packing import (PackedWinogradWeights, merge_abs_max,
                                      pack_weights, scales_from_abs_max,
                                      tile_leaf)
from repro_torch.conv.policy import ConvPolicy
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import (WinogradSpec, direct_conv2d,
                                       make_matrices, winograd_conv2d)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (_extract, _geometry, _tiles_abs_max,
                                     execute_int8, prepare_weights_int8,
                                     winograd_conv2d_int8)

__all__ = ["ConvEngine"]


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
                 device=None,
                 autotune: bool = False,
                 autotune_opts: Optional[dict] = None,
                 certify: str = "warn",
                 plan: "Optional[object]" = None):
        """``hadamard_bits``: the 8/9-bit Hadamard requant stage; the
        default mirrors ``spec.quant.hadamard_bits``, an int overrides,
        None disables.

        ``fused``: serve prepared + calibrated int8 layers through the
        single-pass K4 kernel (default); calibration and dynamic requant
        stay staged either way.

        ``device``: where the packed state lives and the kernels run —
        ``cuda`` unless the caller asks for another; without a card, a
        CUDA engine raises here.

        ``autotune``: at the end of calibration, time K4's block tiles
        once per distinct (spec, tile geometry) at the calibration
        batch's T and keep each layer's winner, with that T, in its
        packed state (``conv.autotune``); ``warmup`` tunes each serving
        geometry's T the same way before its capture, so serving never
        tunes. A call takes the tile tuned at its own T, else
        ``fused_tile``'s choice. ``autotune_opts`` goes to
        ``autotune_blocks`` (``iters``, ``warmup``). The output is the
        same bits at every tile.

        ``certify``: the pack-time range gate. Each int8 layer's
        ``(spec, base, hadamard_bits, Cin)`` is proved int32-safe and
        Hadamard-faithful before its weights are packed: ``"warn"``
        (default) warns on a config it cannot prove, ``"error"`` raises,
        ``"off"`` skips the check. It gates the unplanned layers only: a
        planned layer is always gated and raises (the planner emits
        proved configs only, so a refused entry is corrupted state).

        ``plan``: a ``conv.planner.Plan``. A planned layer ignores the
        policy: ``direct`` serves direct, ``winograd_int8`` packs and
        serves with the entry's own ``(m, r, base, hadamard_bits)``; the
        engine-wide spec covers the unplanned layers. An entry outside
        its Winograd regime raises. The plan rides ``export_state`` /
        ``state_template`` / ``import_state`` as ``plan/<layer>``
        leaves."""
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
        self.fp_spec = (dataclasses.replace(spec, quant=QuantConfig.off())
                        if spec is not None else None)
        self.mats = make_matrices(spec) if spec is not None else None
        self.policy = policy or ConvPolicy()
        self.padding = padding
        self.hadamard_bits = hadamard_bits
        self.fused = fused
        self.device = resolve_device(device)
        if certify not in ("off", "warn", "error"):
            raise ValueError(f"certify must be 'off', 'warn' or 'error', "
                             f"got {certify!r}")
        self.certify = certify
        self.plan = plan
        self.autotune = autotune
        self.autotune_opts = dict(autotune_opts or {})
        self.packed: dict[str, PackedWinogradWeights] = {}
        self._calibrating = False
        self._amax: dict[str, torch.Tensor] = {}     # input-domain running max
        self._amax_h: dict[str, torch.Tensor] = {}   # Hadamard-product max
        self._scales: dict[str, torch.Tensor] = {}   # finalized calibrations
        self._h_amax_final: dict[str, torch.Tensor] = {}
        # (T, Cin, Cout) tile geometry each layer calibrated at: the
        # shape the tile autotuner searches.
        self._tile_geom: dict[str, tuple] = {}
        # K4 tiles tuned at warm-up: {(layer, T): (bt, bc)}.
        self.tuned_tiles: dict[tuple, tuple] = {}
        self._tuning = False
        # The packed weights each calibration observed: the Hadamard
        # abs-max may only reattach to a later prepare() of the same
        # weights.
        self._calib_uq: dict[str, tuple] = {}
        # The serving callable warmup() defaults to (set by
        # models.resnet.make_engine(warmup=...)).
        self.serve_fn = None

    # -- warmup -------------------------------------------------------------

    def warmup(self, geometries: Iterable[tuple],
               forward=None) -> dict[tuple, float]:
        """Run the serving forward once per serving geometry.

        ``geometries``: the input shapes (e.g. ``(batch, 32, 32, 3)``)
        the online loop will dispatch. ``forward``: the serving callable,
        by default ``self.serve_fn`` (``models.resnet.serving_forward``:
        the first call of each shape runs eagerly, building any kernel
        and operand table, then captures the shape's CUDA graph), so the
        build and capture storm happens here and serving captures
        nothing. With ``autotune`` the eager run also tunes K4's tile at
        each layer's T of the geometry (``tuned_tiles``), before the
        capture. Warm up once the engine holds its final serving state.
        Returns {shape: seconds} per geometry."""
        forward = forward if forward is not None else self.serve_fn
        if forward is None:
            raise ValueError("warmup needs a serving callable: pass "
                             "forward= or set engine.serve_fn")
        times = {}
        self._tuning = self.autotune
        try:
            for g in geometries:
                g = tuple(int(d) for d in g)
                t0 = time.perf_counter()
                forward(torch.zeros(g, device=self.device))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                times[g] = time.perf_counter() - t0  # lint: waive=unsynced-timing
        finally:
            self._tuning = False
        return times

    # -- dispatch -----------------------------------------------------------

    def _plan_entry(self, layer: str):
        """The layer's PlanEntry, or None (unplanned: the policy)."""
        return self.plan.get(layer) if self.plan is not None else None

    def _layer_spec(self, layer: str) -> Optional[WinogradSpec]:
        """The spec serving this layer: its plan entry's own where it is
        planned Winograd, else the engine-wide spec."""
        e = self._plan_entry(layer)
        return e.spec() if e is not None and e.is_winograd else self.spec

    def _layer_hbits(self, layer: str) -> Optional[int]:
        """The Hadamard requant width serving this layer."""
        e = self._plan_entry(layer)
        return (e.hadamard_bits if e is not None and e.is_winograd
                else self.hadamard_bits)

    def backend_for(self, layer: str, *, kernel_size: int, stride: int,
                    in_channels: Optional[int] = None) -> str:
        e = self._plan_entry(layer)
        if e is not None:
            # A plan wins over the policy. Its entries are made inside
            # the Winograd regime only, so one outside it is a plan of
            # another model: refuse rather than serve an unmeasured
            # config.
            if not e.is_winograd:
                return "direct"
            if stride != 1 or kernel_size != e.r:
                raise ValueError(
                    f"plan routes layer {layer!r} to {e.describe()} but "
                    f"the layer is outside that Winograd regime (kernel "
                    f"{kernel_size}, stride {stride}) — the plan does "
                    f"not match this model; re-plan")
            return "winograd_int8"
        r = self.spec.r if self.spec is not None else None
        m = self.spec.m if self.spec is not None else None
        return self.policy.backend_for(layer, kernel_size=kernel_size,
                                       stride=stride, spec_r=r,
                                       in_channels=in_channels, spec_m=m)

    def conv2d(self, x: torch.Tensor, w: Optional[torch.Tensor], *,
               layer: str = "conv", stride: int = 1,
               flex: Optional[dict] = None,
               padding: Optional[str] = None) -> torch.Tensor:
        """One convolution. x: (N,H,W,Cin) NHWC; w: (k,k,Cin,Cout) HWIO.

        ``flex``: trainable transform matrices (``core.winograd.flex_init``
        keys) for the ``winograd_fp``/``winograd_fakequant`` backends;
        ignored by ``direct``, refused by ``winograd_int8``.

        ``w`` may be None for a prepared + calibrated ``winograd_int8``
        layer. For an int8 layer with packed state the packed weights are
        authoritative and a passed ``w`` is ignored.
        """
        pad = padding or self.padding
        pk = self.packed.get(layer)
        spec = self._layer_spec(layer)
        hbits = self._layer_hbits(layer)
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
            return direct_conv2d(x, w, pad, stride)
        if backend == "winograd_fp":
            return winograd_conv2d(x, w, self.fp_spec, mats=self.mats,
                                   flex=flex, padding=pad)
        if backend == "winograd_fakequant":
            return winograd_conv2d(x, w, self.spec, mats=self.mats,
                                   flex=flex, padding=pad)
        if flex is not None:
            raise ValueError(
                "the winograd_int8 backend packs analytic transform "
                "matrices; flex-trained transforms are not supported — "
                "serve flex models via winograd_fakequant/winograd_fp")
        if self._calibrating:
            return self._calibrate_conv(x, w, pk, layer, pad, spec, hbits)
        if pk is not None:
            N, nt_h, nt_w, _, _ = _geometry(x.shape, spec.m, spec.r, pad)
            tile = self._tile_for(layer, pk, spec, hbits, N * nt_h * nt_w)
            return winograd_conv2d_int8(
                x, None, spec, pad,
                in_scales=pk.in_scales if pk.calibrated else None,
                u_q=pk.u_q, w_scales=pk.w_scales,
                hadamard_bits=hbits,
                h_amax=pk.hadamard_amax if pk.calibrated else None,
                fused=self.fused, tile=tile)
        return winograd_conv2d_int8(x, w, spec, pad, hadamard_bits=hbits,
                                    fused=self.fused)

    def _tile_for(self, layer, pk, spec, hbits, T: int):
        """K4's tile for a call over ``T`` tiles: the packed state's
        where it was tuned at this T, else one tuned at this T during
        ``warmup`` (timed now, if warming up with ``autotune``), else
        None (``fused_tile``)."""
        tile = pk.tile_at(T) or self.tuned_tiles.get((layer, T))
        if tile is None and self._tuning and self.fused and pk.calibrated:
            from repro_torch.conv.autotune import autotune_blocks
            tile = autotune_blocks(
                spec, T, int(pk.u_q.shape[1]), int(pk.u_q.shape[2]),
                hadamard_bits=hbits, device=self.device,
                **self.autotune_opts).tile
            self.tuned_tiles[(layer, T)] = tile
        return tile

    def _calibrate_conv(self, x, w, pk, layer, pad, spec, hbits):
        """One int8 conv under calibration: extract tiles once, record
        input-domain and Hadamard-product maxima, execute with this
        batch's statistics (bit-identical to the dynamic derivation).
        ``spec``/``hbits`` are the layer's own (plan-resolved)."""
        if pk is not None:
            u_q, w_scales = pk.u_q, pk.w_scales
        else:
            u_q, w_scales = prepare_weights_int8(w, spec)
        tiles = _extract(x, spec.m, spec.r, spec.n, pad)
        geom = _geometry(x.shape, spec.m, spec.r, pad)
        amax = _tiles_abs_max(tiles, spec)
        self._amax[layer] = merge_abs_max(self._amax.get(layer), amax)
        self._calib_uq[layer] = (u_q, w_scales)
        self._tile_geom[layer] = (int(tiles.shape[0]), int(u_q.shape[1]),
                                  int(u_q.shape[2]))
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

    def _certify_layer(self, layer: str, *, cin: int):
        """The pack-time range gate (see ``certify`` in ``__init__``): a
        planned layer is gated always and raises; an unplanned one
        follows the knob."""
        from repro_torch.analysis.ranges import certify_config
        e = self._plan_entry(layer)
        if e is not None and e.is_winograd:
            rep = certify_config(e.m, e.r, e.base, e.hadamard_bits, cin)
            if rep.proved:
                return
            raise ValueError(
                f"plan contradicts the range certifier for layer "
                f"{layer!r}: {e.describe()} at Cin={cin} is "
                f"{rep.summary()} — the planner only emits proved "
                f"configs (conv.planner.candidate_entries), so this plan "
                f"is corrupted or belongs to another model; re-plan "
                f"instead of overriding")
        if self.certify == "off":
            return
        rep = certify_config(self.spec.m, self.spec.r, self.spec.base,
                             self.hadamard_bits, cin)
        if rep.proved:
            return
        acc = rep.stage("gemm_accumulator")
        why = ("overflows int32" if not rep.int32_safe else
               "exceeds the fp32-exact limit; the Hadamard requant cast "
               "can round")
        msg = (f"layer {layer!r}: {rep.summary()} — worst-case int32 "
               f"accumulator {int(acc.bound)} ({acc.bits:.0f} bits) "
               f"{why}. Reduce Cin, split the reduction, or pass "
               f"certify='off' to override.")
        if self.certify == "error":
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def prepare_layer(self, layer: str, w: torch.Tensor, *,
                      stride: int = 1) -> bool:
        """Pack one layer's weights if its routing sends it to int8.
        Returns True when the layer was packed (already-calibrated scales
        for the layer are preserved across a re-pack)."""
        backend = self.backend_for(layer, kernel_size=w.shape[0],
                                   stride=stride, in_channels=w.shape[2])
        if backend != "winograd_int8":
            return False
        self._certify_layer(layer, cin=w.shape[2])
        old = self.packed.get(layer)
        new = pack_weights(w.detach().to(self.device),
                           self._layer_spec(layer))
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
        layers not packed yet, so calibrate-then-prepare works too. With
        ``autotune=True`` this is also where K4's tiles are tuned."""
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
        if self.autotune:
            self.autotune_packed()
        return scales

    def autotune_packed(self) -> dict[str, tuple]:
        """Tune K4's block tile for every packed layer whose tile
        geometry calibration recorded, and keep each winner in its packed
        state (``PackedWinogradWeights.blocks``) with the T it was timed
        at. Same-shaped layers share one timed search. Returns
        {layer: (bt, bc)}."""
        from repro_torch.conv.autotune import autotune_blocks
        tuned = {}
        for layer, geom in self._tile_geom.items():
            pk = self.packed.get(layer)
            if pk is None:
                continue
            res = autotune_blocks(self._layer_spec(layer), *geom,
                                  hadamard_bits=self._layer_hbits(layer),
                                  device=self.device, **self.autotune_opts)
            tuned[layer] = res.tile
            self.packed[layer] = dataclasses.replace(
                pk, blocks=tile_leaf(res.tile, geom[0]))
        return tuned

    # -- serialization ------------------------------------------------------

    def export_state(self) -> dict:
        """Packed + calibrated state as a checkpointable tree (the JAX
        engine's layout). Uncalibrated ``in_scales`` are an error; a
        dropped ``hadamard_amax`` rides as a sentinel leaf."""
        missing = [l for l, p in self.packed.items() if not p.calibrated]
        if missing:
            raise ValueError(f"layers not calibrated: {sorted(missing)}")
        state = {"packed": {
            l: p.to_tree(include_hadamard=self._layer_hbits(l) is not None)
            for l, p in self.packed.items()}}
        if self.plan is not None:
            # every routed layer, direct ones too: a planned checkpoint
            # determines routing with no policy
            state["plan"] = self.plan.to_tree()
        return state

    def state_template(self) -> dict:
        """Zero-filled tree matching ``export_state`` — the restore
        skeleton for ``repro_torch.checkpoint.restore`` after
        ``prepare()``. It has a ``plan`` group only when the engine holds
        a plan, so a checkpoint without one restores into a plan-less
        engine; recover a checkpoint's plan first with
        ``conv.planner.Plan.from_checkpoint``."""
        def tmpl(l: str, p: PackedWinogradWeights) -> dict:
            P = p.u_q.shape[0]
            zeros = torch.zeros((P, 1), dtype=torch.float32,
                                device=self.device)
            t = {"u_q": p.u_q, "w_scales": p.w_scales,
                 "in_scales": p.in_scales if p.calibrated else zeros}
            if self._layer_hbits(l) is not None:
                t["hadamard_amax"] = (p.hadamard_amax
                                      if p.hadamard_amax is not None
                                      else zeros)
            t["blocks"] = (p.blocks if p.blocks is not None
                           else torch.full((3,), PackedWinogradWeights
                                           .BLOCKS_MISSING,
                                           dtype=torch.int32))
            return t
        state = {"packed": {l: tmpl(l, p) for l, p in self.packed.items()}}
        if self.plan is not None:
            state["plan"] = self.plan.to_tree()
        return state

    def import_state(self, tree: dict):
        """Adopt a restored packed + calibrated tree, placed on this
        engine's device. A tree with a ``plan`` group makes the
        checkpoint's plan the engine's."""
        if "plan" in tree:
            from repro_torch.conv.planner import Plan
            self.plan = Plan.from_tree(tree["plan"])
        self.packed = {l: PackedWinogradWeights.from_tree(sub, self.device)
                       for l, sub in tree["packed"].items()}
