"""Offline weight packing and input-scale calibration for int8 serving
(the port's counterpart of ``repro.conv.packing``).

Everything that does not depend on the live batch — the Winograd weight
transform, its per-position int8 quantization and the per-position input
scales — is computed once here, so the hot path (``kernels.ops``) runs
no weight transform and no scale reduction per call.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch.core.winograd import WinogradSpec
from repro_torch.kernels.ops import (input_abs_max, prepare_weights_int8,
                                     scales_from_abs_max)

__all__ = ["PackedWinogradWeights", "pack_weights", "observed_abs_max",
           "merge_abs_max", "scales_from_abs_max"]


@dataclasses.dataclass
class PackedWinogradWeights:
    """Prepared per-layer serving state for the int8 Winograd backend.

    ``u_q``: (P, Cin, Cout) int8. ``w_scales``: (P, 1) fp32.
    ``in_scales``: (P, 1) fp32 calibrated input scales, None until
    calibration finishes. ``hadamard_amax``: (P, 1) fp32 calibrated
    abs-maxima of the Hadamard products (only with the 8/9-bit stage).

    A missing ``hadamard_amax`` is a legitimate state (a re-pack after a
    weight update drops it) and serializes as a negative sentinel leaf.
    ``blocks``: (3,) int32 — the JAX package's autotuned TPU block split,
    kept so checkpoints stay interchangeable; the port's kernels do not
    read it. Untuned serializes as a negative sentinel.
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
            blocks = torch.as_tensor(blocks)
            if int(blocks.max()) < 0:            # untuned
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
