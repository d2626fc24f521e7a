"""Symmetric quantization settings of the Winograd pipeline.

The port's counterpart of ``repro.core.quantization``: the grid helpers
and the per-stage ``QuantConfig``. The fake-quant (QAT) casts are not
ported yet; the int8 serving path needs only these.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["QuantConfig", "qmax", "storage_dtype"]


def qmax(bits: int) -> int:
    """Largest representable magnitude of a signed symmetric b-bit grid."""
    return 2 ** (bits - 1) - 1


def storage_dtype(bits: int) -> torch.dtype:
    """Narrowest signed integer dtype that holds a symmetric b-bit grid:
    int8 through 8 bits, int16 for the paper's 9-bit Hadamard grid,
    int32 up to 32 bits."""
    if bits < 2:
        raise ValueError(f"a signed symmetric grid needs >= 2 bits, "
                         f"got {bits}")
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    if bits <= 32:
        return torch.int32
    raise ValueError(f"no integer storage dtype for {bits}-bit grids")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Per-stage quantization settings for the Winograd pipeline.

    ``None`` bit-widths disable quantization for that stage (fp path).
    ``hadamard_bits=9`` is the paper's accuracy-recovering option.
    """

    act_bits: Optional[int] = 8
    weight_bits: Optional[int] = 8
    trans_bits: Optional[int] = 8      # after each pre/post transform stage
    hadamard_bits: Optional[int] = 9   # the Hadamard-product stage
    matrix_bits: Optional[int] = 8     # the transform matrices themselves
    per_channel_weights: bool = True
    # True quantizes between the base-change matmul and the main
    # transform matmul; False casts only at stage boundaries.
    cast_between_stages: bool = True
    # Per-Winograd-position scales for transform-domain tensors instead
    # of per-tensor (beyond the paper; off by default).
    position_scales: bool = False

    @classmethod
    def off(cls) -> "QuantConfig":
        return cls(act_bits=None, weight_bits=None, trans_bits=None,
                   hadamard_bits=None, matrix_bits=None)

    @property
    def is_off(self) -> bool:
        return all(b is None for b in (self.act_bits, self.weight_bits,
                                       self.trans_bits, self.hadamard_bits,
                                       self.matrix_bits))
