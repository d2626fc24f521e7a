"""Offline weight packing and input-scale calibration for int8 serving
(the port's counterpart of ``repro.conv.packing``).

Everything that does not depend on the live batch — the Winograd weight
transform, its per-position int8 quantization and the per-position input
scales — is computed once here, so the hot path (``kernels.ops``) runs
no weight transform and no scale reduction per call.

Under a device mesh (``place_packed_state``) a packed state is placed
once: every ``u_q`` cut along Cout per model index, each shard made
contiguous there and held by every device of its model column; the
per-position statistics whole on every device. A checkpoint holds the
full arrays, so a state written under one mesh restores under any
other.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels.fused_serve import TILES
from repro_torch.kernels.ops import (input_abs_max, prepare_weights_int8,
                                     scales_from_abs_max)

__all__ = ["PackedWinogradWeights", "pack_weights", "observed_abs_max",
           "merge_abs_max", "scales_from_abs_max", "tile_leaf",
           "tile_from_leaf", "place_packed_state"]


def tile_leaf(tile: tuple, T: int) -> torch.Tensor:
    """K4 tile ``(bt, bc)``, tuned at ``T`` Winograd tiles → its
    ``blocks`` leaf ``(-bt, -bc, -T)``."""
    bt, bc = (int(t) for t in tile)
    if (bt, bc) not in TILES:
        raise ValueError(f"K4 has no tile {tile}; it was compiled for "
                         f"{TILES}")
    if int(T) < 1:
        raise ValueError(f"a tile is tuned at T >= 1 tiles, not {T}")
    return torch.tensor([-bt, -bc, -int(T)], dtype=torch.int32)


def tile_from_leaf(leaf: Optional[torch.Tensor]) -> Optional[tuple]:
    """``((bt, bc), T)``: the K4 tile a ``blocks`` leaf holds and the T
    it was tuned at, or None where it holds none (untuned, or the JAX
    package's block split)."""
    if leaf is None or tuple(leaf.shape) != (3,):
        return None
    a, b, t = (int(v) for v in leaf.tolist())
    return ((-a, -b), -t) if (-a, -b) in TILES and t < 0 else None


@dataclasses.dataclass
class PackedWinogradWeights:
    """Prepared per-layer serving state for the int8 Winograd backend.

    ``u_q``: (P, Cin, Cout) int8. ``w_scales``: (P, 1) fp32.
    ``in_scales``: (P, 1) fp32 calibrated input scales, None until
    calibration finishes. ``hadamard_amax``: (P, 1) fp32 calibrated
    abs-maxima of the Hadamard products (only with the 8/9-bit stage).

    A missing ``hadamard_amax`` is a legitimate state (a re-pack after a
    weight update drops it) and serializes as a negative sentinel leaf.

    ``blocks``: the (3,) int32 CPU leaf both packages keep under this
    name, or None (untuned; serialized as ``BLOCKS_MISSING`` thrice). It
    means something else in each package:

    * in the JAX package, the autotuned Pallas block split
      ``(bm, bn, bk)``, all positive;
    * in this port, K4's autotuned block tile ``(bt, bc)``
      (``conv.autotune``) and the number of Winograd tiles T it was
      timed at, stored negated, ``(-bt, -bc, -T)``: all negative, which
      the JAX package reads as untuned.

    So neither package takes the other's value for its own: ``tile_at``
    gives the K4 tile only where the leaf is the port's encoding of a
    tile K4 was compiled for (``kernels.fused_serve.TILES``) and the
    call has the T it was tuned at, and None ("not tuned", K4 then
    picks ``fused_tile`` for the call's own shape) otherwise: at any
    other T, and for a JAX block split. The leaf itself is kept as it
    came, so a checkpoint round-trips it bit for bit.
    """

    u_q: torch.Tensor
    w_scales: torch.Tensor
    in_scales: Optional[torch.Tensor] = None
    hadamard_amax: Optional[torch.Tensor] = None
    blocks: Optional[torch.Tensor] = None

    #: Serialized stand-in for a dropped ``hadamard_amax``.
    HADAMARD_MISSING: ClassVar[float] = -1.0
    #: Serialized stand-in for untuned ``blocks``.
    BLOCKS_MISSING: ClassVar[int] = -1

    @property
    def tuned(self) -> Optional[tuple]:
        """``((bt, bc), T)``: K4's tuned tile and the T it was timed at,
        or None (see ``blocks``)."""
        return tile_from_leaf(self.blocks)

    def tile_at(self, T: int) -> Optional[tuple]:
        """K4's tuned tile for a call over ``T`` Winograd tiles: the
        tuned one at the T it was timed at, else None (``fused_tile``)."""
        tuned = self.tuned
        return tuned[0] if tuned is not None and tuned[1] == T else None

    @property
    def calibrated(self) -> bool:
        return self.in_scales is not None

    def to_tree(self, include_hadamard: Optional[bool] = None) -> dict:
        """Plain-dict form for checkpointing (requires calibration).

        ``include_hadamard`` pins the presence of the ``hadamard_amax``
        leaf: True writes the sentinel when the statistic was dropped,
        False omits the leaf, None includes it iff present.
        """
        if not self.calibrated:
            raise ValueError("uncalibrated PackedWinogradWeights cannot be "
                             "serialized; run calibration first")
        tree = {"u_q": self.u_q, "w_scales": self.w_scales,
                "in_scales": self.in_scales}
        if include_hadamard is None:
            include_hadamard = self.hadamard_amax is not None
        if include_hadamard:
            tree["hadamard_amax"] = (
                self.hadamard_amax if self.hadamard_amax is not None
                else torch.full_like(self.in_scales, self.HADAMARD_MISSING))
        tree["blocks"] = (self.blocks.to(torch.int32)
                          if self.blocks is not None
                          else torch.full((3,), self.BLOCKS_MISSING,
                                          dtype=torch.int32))
        return tree

    @classmethod
    def from_tree(cls, tree: dict,
                  device: Optional[torch.device] = None
                  ) -> "PackedWinogradWeights":
        """From a checkpoint tree (tensors or numpy arrays), placed on
        ``device`` (default: where the leaves are)."""
        def leaf(name):
            return torch.as_tensor(tree[name]).to(device)
        hs = tree.get("hadamard_amax")
        if hs is not None:
            hs = leaf("hadamard_amax")
            if float(hs.max()) < 0:              # the dropped-stat sentinel
                hs = None
        blocks = tree.get("blocks")
        if blocks is not None:
            blocks = torch.as_tensor(blocks).to("cpu", torch.int32)
            if bool((blocks == cls.BLOCKS_MISSING).all()):   # untuned
                blocks = None
        return cls(u_q=leaf("u_q"), w_scales=leaf("w_scales"),
                   in_scales=leaf("in_scales"), hadamard_amax=hs,
                   blocks=blocks)


def pack_weights(w: torch.Tensor, spec: WinogradSpec
                 ) -> PackedWinogradWeights:
    """Transform + quantize (r,r,Cin,Cout) weights once, offline."""
    u_q, w_scales = prepare_weights_int8(w, spec)
    return PackedWinogradWeights(u_q=u_q, w_scales=w_scales)


def observed_abs_max(x: torch.Tensor, spec: WinogradSpec,
                     padding: str = "same") -> torch.Tensor:
    """Per-position abs-max of one batch in the Winograd input domain:
    x (N, H, W, Cin) → (n²,) fp32, the same reduction the dynamic path
    uses."""
    return input_abs_max(x, spec, padding)


def merge_abs_max(running: Optional[torch.Tensor],
                  new: torch.Tensor) -> torch.Tensor:
    """Fold one batch's abs-max into the running calibration maxima."""
    return new if running is None else torch.maximum(running, new)


def place_packed_state(mesh, state_tree: dict, model_axis=None) -> dict:
    """Place a packed state tree (``export_state``'s) across ``mesh`` once,
    each leaf a ``distributed.sharding.Placed``: ``u_q`` cut along Cout
    into one contiguous block per index of ``model_axis`` (None: whole),
    every other leaf whole on every device; ``blocks``, the port's
    host-side tile record, and the plan stay as they are. A Cout that
    the model extent does not divide raises, naming the leaf: the
    executor cuts exactly Cout / D_model columns a device."""
    from repro_torch.distributed.sharding import Placed, axis_extent
    dm = axis_extent(mesh, model_axis)
    out = {"packed": {}}
    for layer, sub in state_tree["packed"].items():
        cout = sub["u_q"].shape[-1]
        if cout % dm != 0:
            raise ValueError(
                f"packed/{layer}/u_q: Cout={cout} is not divisible by the "
                f"mesh's {model_axis!r} axis extent {dm} — conv tensor "
                "parallelism shards the per-position GEMM's N axis into "
                "equal per-device slabs. Serve this checkpoint on a model "
                "axis that divides every layer's Cout.")
        out["packed"][layer] = {
            name: (leaf if name == "blocks" else
                   Placed(torch.as_tensor(leaf), mesh, model_axis, dim=2)
                   if name == "u_q" else Placed(torch.as_tensor(leaf), mesh))
            for name, leaf in sub.items()}
    if "plan" in state_tree:
        out["plan"] = state_tree["plan"]
    return out
