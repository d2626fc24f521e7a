"""Winograd/Toom-Cook specs, transform matrices and tile geometry.

The port's counterpart of ``repro.core.winograd`` (see its module
docstring for the paper's eq. (3)/(4) and the orientation of the base
change ``C``). Matrices are exact-rational constructions returned as
numpy constants; the torch code moves them to a device where it needs
them. Only what the int8 serving path uses is ported here: the spec,
the matrices, the tile geometry and the quantization-free weight
transform that ``kernels.ops.prepare_weights_int8`` runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import legendre as _legendre
from repro_torch.core import toom_cook as _tc
from repro_torch.core.quantization import QuantConfig

__all__ = ["WinogradSpec", "WinogradMatrices", "make_matrices",
           "transform_weights_2d"]


@dataclasses.dataclass(frozen=True)
class WinogradSpec:
    """Static configuration of a Winograd/Toom-Cook convolution."""

    m: int = 4                   # output tile size (per dim)
    r: int = 3                   # kernel size (per dim)
    base: str = "legendre"       # canonical | legendre | chebyshev
    quant: QuantConfig = QuantConfig()
    flex: bool = False           # learnable transform matrices
    dtype: Any = np.float32

    @property
    def n(self) -> int:
        return self.m + self.r - 1

    @property
    def changes_base(self) -> bool:
        return self.base != "canonical"


@dataclasses.dataclass(frozen=True)
class WinogradMatrices:
    """Float transform matrices for a spec (numpy, read-only constants).

    ``C`` is the canonical→basis coefficient conversion (the paper's
    "P"); ``Cinv`` converts back. For base="canonical" both are I.
    """

    AT: np.ndarray      # (m, n)
    G: np.ndarray       # (n, r)
    BT: np.ndarray      # (n, n)
    C: np.ndarray       # (n, n)
    Cinv: np.ndarray    # (n, n)
    GP: np.ndarray      # (n, r)  = C @ G
    BPT: np.ndarray     # (n, n)  = Bᵀ Cᵀ
    APT: np.ndarray     # (m, n)  = Aᵀ Cᵀ
    CinvT: np.ndarray   # (n, n)  = C⁻ᵀ


@functools.lru_cache(maxsize=None)
def make_matrices(spec: WinogradSpec) -> WinogradMatrices:
    """Exact-rational construction of the spec's transform matrices at
    the default interpolation points, cached per spec (the Fraction
    arithmetic costs milliseconds and the serving path asks per call).
    Built exactly as ``repro.core.winograd._build_matrices``."""
    AT_f, G_f, BT_f = _tc.toom_cook_matrices(spec.m, spec.r)
    P_f, Pinv_f = _legendre.base_change(spec.n, spec.base)
    AT = _tc.to_float(AT_f)
    G = _tc.to_float(G_f)
    BT = _tc.to_float(BT_f)
    C = _tc.to_float(Pinv_f)
    Cinv = _tc.to_float(P_f)
    d = spec.dtype
    return WinogradMatrices(
        AT=np.asarray(AT, d), G=np.asarray(G, d), BT=np.asarray(BT, d),
        C=np.asarray(C, d), Cinv=np.asarray(Cinv, d),
        GP=np.asarray(C @ G, d), BPT=np.asarray(BT @ C.T, d),
        APT=np.asarray(AT @ C.T, d), CinvT=np.asarray(Cinv.T, d),
    )


def _sandwich(M: torch.Tensor, X: torch.Tensor,
              N: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M @ X @ Nᵀ over the trailing two dims of X (N defaults to M)."""
    if N is None:
        N = M
    return torch.einsum("ij,...jk,lk->...il", M, X, N)


def transform_weights_2d(w: torch.Tensor, spec: WinogradSpec,
                         mats: WinogradMatrices) -> torch.Tensor:
    """(r, r, Cin, Cout) HWIO weights → Winograd domain (Cin, Cout, n, n)
    for a quantization-free spec: U = G W Gᵀ, or with a base change
    U = C⁻¹ (G_C W G_Cᵀ) C⁻ᵀ."""
    if not spec.quant.is_off:
        raise NotImplementedError(
            "the fake-quant weight transform is not ported yet; pass a "
            "spec with QuantConfig.off()")
    def const(a):
        return torch.as_tensor(a, dtype=w.dtype, device=w.device)
    wt = w.permute(2, 3, 0, 1)                      # (Cin, Cout, r, r)
    if spec.changes_base:
        U = _sandwich(const(mats.GP), wt)           # G_C W G_Cᵀ
        return _sandwich(const(mats.Cinv), U)       # C⁻¹ (·) C⁻ᵀ
    return _sandwich(const(mats.G), wt)             # G W Gᵀ


def _pad_amounts(size: int, m: int, r: int, padding: str,
                 causal: bool = False) -> tuple[int, int, int, int]:
    """→ (pad_lo, pad_hi, n_tiles, out_size) along one spatial dim."""
    if padding == "same":
        out = size
        lo = r - 1 if causal else (r - 1) // 2
    elif padding == "valid":
        out = size - r + 1
        lo = 0
    else:
        raise ValueError(padding)
    nt = -(-out // m)  # ceil
    needed = nt * m + r - 1
    hi = needed - size - lo
    return lo, hi, nt, out


def _extract_tiles_1d_axis(x: torch.Tensor, m: int, n: int,
                           axis: int) -> torch.Tensor:
    """Overlapping length-n windows at stride m along ``axis`` (a view):
    ``axis`` becomes the window starts and a trailing dim of size n holds
    each window. Padded by ``_pad_amounts``, the axis holds exactly
    (n_tiles - 1)·m + n values, so every window is whole."""
    return x.unfold(axis, n, m)
