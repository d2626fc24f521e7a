"""Convolution dispatch, offline weight packing and scale calibration
(see ``repro_torch.conv.engine`` for the backends and the lifecycle)."""
from repro_torch.conv.engine import ConvEngine
from repro_torch.conv.packing import (PackedWinogradWeights, merge_abs_max,
                                      observed_abs_max, pack_weights,
                                      scales_from_abs_max)
from repro_torch.conv.policy import BACKENDS, ConvPolicy

__all__ = [
    "BACKENDS",
    "ConvEngine",
    "ConvPolicy",
    "PackedWinogradWeights",
    "pack_weights",
    "observed_abs_max",
    "merge_abs_max",
    "scales_from_abs_max",
]
