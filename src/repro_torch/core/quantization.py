"""Symmetric quantization of the Winograd pipeline.

The port's counterpart of ``repro.core.quantization``: the grid helpers,
the per-stage ``QuantConfig``, the fake-quant cast of quantization-aware
training with its saturating straight-through estimator, and the
true-integer helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["QuantConfig", "qmax", "storage_dtype", "abs_max_scale",
           "fake_quant", "quantize_int", "dequantize_int"]


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


def abs_max_scale(x: torch.Tensor, bits: int,
                  axis: Optional[Sequence[int]] = None,
                  eps: float = 1e-12) -> torch.Tensor:
    """Dynamic symmetric scale amax/qmax, per tensor or per channel.

    ``axis`` lists the axes to reduce over; the remaining axes keep their
    own scale (kept dims, broadcastable against ``x``)."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=tuple(axis), keepdim=True)
    # A tensor divisor: CUDA divides by a host number through its
    # reciprocal, amax · (1/qmax), at times an ulp off the quotient (the
    # rewrite XLA's algsimp makes); the CPU divides.
    return torch.clamp_min(amax, eps) / amax.new_full((), qmax(bits))


class _FakeQuant(torch.autograd.Function):
    """clip(round(x / scale), ±qmax) · scale. Backward is the saturating
    straight-through estimator: the gradient passes where
    |x / scale| ≤ qmax and is zero where the clip saturates; the scale
    gets none."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        qm = qmax(bits)
        xs = x / scale
        # only the mask is kept for backward (1 byte an element, not 4)
        ctx.save_for_backward(xs.abs() <= qm)
        return torch.clamp(torch.round(xs), -qm, qm) * scale

    @staticmethod
    def backward(ctx, g):
        inside, = ctx.saved_tensors
        return g * inside.to(g.dtype), None, None


def fake_quant(x: torch.Tensor, bits: Optional[int],
               axis: Optional[Sequence[int]] = None,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric fake-quantize ``x`` to ``bits``; a no-op when bits is
    None. Without ``scale``, the dynamic abs-max scale, computed with no
    gradient (JAX's ``stop_gradient``)."""
    if bits is None:
        return x
    if scale is None:
        scale = abs_max_scale(x.detach(), bits, axis=axis)
    return _FakeQuant.apply(x, scale, bits)


def quantize_int(x: torch.Tensor, bits: int = 8,
                 axis: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to a true integer tensor and its fp scale.

    ``dtype=None`` selects the narrowest dtype that holds the grid
    (``storage_dtype``); an explicitly passed dtype too narrow for
    ``bits`` raises instead of silently widening."""
    if dtype is None:
        dtype = storage_dtype(bits)
    elif qmax(bits) > torch.iinfo(dtype).max:
        raise ValueError(
            f"a {bits}-bit symmetric grid spans ±{qmax(bits)}, which does "
            f"not fit the requested {dtype} — pass dtype=None to widen "
            f"(storage_dtype({bits}) = {storage_dtype(bits)})")
    scale = abs_max_scale(x, bits, axis=axis)
    q = torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits))
    return q.to(dtype), scale


def dequantize_int(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale
