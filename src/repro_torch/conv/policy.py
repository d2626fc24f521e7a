"""Per-layer convolution backend selection (the port's copy of
``repro.conv.policy``).

The rules that used to live as ad-hoc branches at the call sites
(``stride == 1 and cfg.use_winograd and ...``) are centralized here: a
``ConvPolicy`` names the backend for Winograd-eligible layers, the
fallback for everything outside the Winograd regime (strided convs, 1×1
shortcuts, kernel sizes the spec's F(m, r) does not cover), and optional
per-layer overrides for mixed-precision deployments.

The policy's hand thresholds (``min_channels``,
``large_tile_min_channels``) model profitability only.
"""
from __future__ import annotations

import dataclasses

__all__ = ["BACKENDS", "ConvPolicy"]

#: The engine's backend matrix (see repro_torch.conv.engine).
BACKENDS = ("direct", "winograd_fp", "winograd_fakequant", "winograd_int8")


@dataclasses.dataclass(frozen=True)
class ConvPolicy:
    """Chooses a backend per layer from static layer facts.

    ``backend`` applies to Winograd-eligible convolutions (stride 1,
    kernel size == spec.r, at least ``min_channels`` input channels);
    ``fallback`` to everything else. ``overrides`` (a tuple of
    ``(layer_name, backend)`` pairs — tuple, so the policy stays hashable
    for jit static args) wins over both.

    ``large_tile_min_channels`` gates *large-tile* specs (output tile
    ``m >= large_tile_m``, i.e. F(6,3) and up) by input channel count:
    at F(6,3) the per-tile transform cost and the spatial padding waste
    (inputs pad up to multiples of 6 + 2) are big enough that
    thin-channel layers lose to the fallback — the GEMM the tile
    amortizes is too small. Channel-rich layers keep the 2.25×
    multiplication saving of the larger tile. Zero (default) disables
    the gate.
    """

    backend: str = "winograd_fakequant"
    fallback: str = "direct"
    min_channels: int = 0
    large_tile_min_channels: int = 0
    large_tile_m: int = 6
    overrides: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        for b in (self.backend, self.fallback):
            if b not in BACKENDS:
                raise ValueError(f"unknown backend {b!r}; one of {BACKENDS}")
        for name, b in self.overrides:
            if b not in BACKENDS:
                raise ValueError(f"override {name!r}: unknown backend {b!r}")

    def backend_for(self, layer: str, *, kernel_size: int, stride: int,
                    spec_r: int | None, in_channels: int | None = None,
                    spec_m: int | None = None) -> str:
        """Resolve the backend for one convolution layer.

        Overrides win, but cannot force a Winograd backend onto a layer
        outside the Winograd regime (the pipeline has no stride/kernel
        generality — silently dispatching would compute the wrong conv).
        They *can* force a thin-channel layer past the channel-count
        thresholds, which only model profitability.
        """
        regime_ok = (stride == 1 and spec_r is not None
                     and kernel_size == spec_r)
        for name, b in self.overrides:
            if name == layer:
                if b != "direct" and not regime_ok:
                    raise ValueError(
                        f"override {layer!r} → {b!r}: layer is outside the "
                        f"Winograd regime (kernel {kernel_size}, stride "
                        f"{stride}, spec r={spec_r})")
                return b
        eligible = regime_ok and (in_channels is None
                                  or in_channels >= self.min_channels)
        if (eligible and in_channels is not None and spec_m is not None
                and spec_m >= self.large_tile_m
                and in_channels < self.large_tile_min_channels):
            eligible = False
        return self.backend if eligible else self.fallback
