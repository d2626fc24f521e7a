"""Winograd/Toom-Cook specs, transform matrices and the 2-D pipeline.

The port's counterpart of ``repro.core.winograd`` (see its module
docstring for the paper's eq. (3)/(4) and the orientation of the base
change ``C``). Matrices are exact-rational constructions returned as
numpy constants; the torch code moves them to a device where it needs
them.

``winograd_conv2d`` is the quantization-aware pipeline of the paper's
Fig. 2 in plain PyTorch: with a quantization-free spec it is the exact
fp Winograd convolution, otherwise every stage boundary (and, with
``cast_between_stages``, the value between the base change and the main
transform) passes through ``fake_quant``, so autograd trains through it
with the saturating straight-through estimator. *Flex* passes the
transform matrices G_C, B_Cᵀ, A_Cᵀ (or G, Bᵀ, Aᵀ) as trainable tensors;
C and C⁻¹ stay fixed. ``winograd_conv1d`` is the same pipeline in 1-D
(temporal convolutions: causal or centred padding), and
``condition_number`` the 2-norm conditioning of a transform matrix.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import legendre as _legendre
from repro_torch.core import toom_cook as _tc
from repro_torch.core.quantization import QuantConfig, fake_quant

__all__ = ["WinogradSpec", "WinogradMatrices", "make_matrices",
           "flex_init", "transform_weights_2d", "winograd_conv2d",
           "direct_conv2d", "transform_weights_1d", "winograd_conv1d",
           "direct_conv1d", "condition_number"]


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


def make_matrices(spec: WinogradSpec, points=None) -> WinogradMatrices:
    """Exact-rational construction of the spec's transform matrices,
    built exactly as ``repro.core.winograd._build_matrices``. Cached per
    spec at the default interpolation points (the Fraction arithmetic
    costs milliseconds and the serving path asks per call)."""
    if points is None:
        return _make_matrices_default(spec)
    return _build_matrices(spec, points)


@functools.lru_cache(maxsize=None)
def _make_matrices_default(spec: WinogradSpec) -> WinogradMatrices:
    return _build_matrices(spec, None)


def _build_matrices(spec: WinogradSpec, points) -> WinogradMatrices:
    AT_f, G_f, BT_f = _tc.toom_cook_matrices(spec.m, spec.r, points=points)
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


def flex_init(spec: WinogradSpec, points=None) -> dict[str, torch.Tensor]:
    """Initial values of the trainable transform matrices (flex mode),
    as fp32 CPU tensors."""
    mats = make_matrices(spec, points=points)
    keys = ("GP", "BPT", "APT") if spec.changes_base else ("G", "BT", "AT")
    return {k: torch.tensor(getattr(mats, k), dtype=torch.float32)
            for k in keys}


def _sandwich(M: torch.Tensor, X: torch.Tensor,
              N: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M @ X @ Nᵀ over the trailing two dims of X (N defaults to M)."""
    if N is None:
        N = M
    return torch.einsum("ij,...jk,lk->...il", M, X, N)


def _q(x: torch.Tensor, bits: Optional[int], axis=None) -> torch.Tensor:
    return fake_quant(x, bits, axis=axis)


def _q_dom(x: torch.Tensor, bits: Optional[int], quant: QuantConfig,
           ndims: int = 2) -> torch.Tensor:
    """Quantize a transform-domain tensor (trailing ``ndims`` = the tile
    grid): per-tensor scale, or per Winograd position with
    ``quant.position_scales``."""
    axis = tuple(range(x.ndim - ndims)) if quant.position_scales else None
    return _q(x, bits, axis=axis)


def _q_mid(x: torch.Tensor, quant: QuantConfig,
           ndims: int = 2) -> torch.Tensor:
    """The cast between the base-change matmul and the main transform
    matmul (only under ``cast_between_stages``)."""
    if not quant.cast_between_stages:
        return x
    return _q_dom(x, quant.trans_bits, quant, ndims=ndims)


def _resolve(mats: WinogradMatrices, flex: Optional[dict],
             spec: WinogradSpec, like: torch.Tensor):
    """Pick and fake-quantize the per-stage transform matrices: flex
    tensors where given, else the analytic constants (as tensors of
    ``like``'s dtype and device). Returns (kernel_mat, input_mat,
    output_mat, back, backT), ``back`` = quantized C⁻¹ (None for the
    canonical base)."""
    mb = spec.quant.matrix_bits

    def const(name):
        return torch.as_tensor(getattr(mats, name), dtype=like.dtype,
                               device=like.device)

    def pick(name):
        return flex[name] if flex else const(name)
    if spec.changes_base:
        return (_q(pick("GP"), mb), _q(pick("BPT"), mb), _q(pick("APT"), mb),
                _q(const("Cinv"), mb), _q(const("CinvT"), mb))
    return (_q(pick("G"), mb), _q(pick("BT"), mb), _q(pick("AT"), mb),
            None, None)


def transform_weights_2d(w: torch.Tensor, spec: WinogradSpec,
                         mats: WinogradMatrices,
                         flex: Optional[dict] = None) -> torch.Tensor:
    """(r, r, Cin, Cout) HWIO weights → Winograd domain (Cin, Cout, n, n).

    Canonical: U = G W Gᵀ. Changed base: U₁ = G_C W G_Cᵀ (quantize),
    U = C⁻¹ U₁ C⁻ᵀ (quantize), the casts of Fig. 2; weights quantized
    per output channel when configured."""
    q = spec.quant
    wt = w.permute(2, 3, 0, 1)                      # (Cin, Cout, r, r)
    w_axis = (0, 2, 3) if q.per_channel_weights else None
    wt = _q(wt, q.weight_bits, axis=w_axis)
    Gm, _, _, back, _ = _resolve(mats, flex, spec, w)
    U = _sandwich(Gm, wt)                           # G_C W G_Cᵀ (or G W Gᵀ)
    if spec.changes_base:
        U = _q_mid(U, q)
        U = _sandwich(back, U)                      # C⁻¹ (·) C⁻ᵀ
    return _q_dom(U, q.trans_bits, q)


def _transform_input_tiles(tiles: torch.Tensor, spec: WinogradSpec,
                           mats: WinogradMatrices,
                           flex: Optional[dict]) -> torch.Tensor:
    """(..., n, n) input tiles → Winograd domain, quantized per Fig. 2."""
    q = spec.quant
    tiles = _q(tiles, q.act_bits)
    _, BTm, _, _, backT = _resolve(mats, flex, spec, tiles)
    if spec.changes_base:
        V = _sandwich(backT, tiles)                 # C⁻ᵀ X C⁻¹
        V = _q_mid(V, q)
        V = _sandwich(BTm, V)                       # B_Cᵀ (·) B_C
    else:
        V = _sandwich(BTm, tiles)                   # Bᵀ X B
    return _q_dom(V, q.trans_bits, q)


def _transform_output_tiles(H: torch.Tensor, spec: WinogradSpec,
                            mats: WinogradMatrices,
                            flex: Optional[dict]) -> torch.Tensor:
    """(..., n, n) Hadamard results → (..., m, m) spatial outputs."""
    q = spec.quant
    _, _, ATm, _, backT = _resolve(mats, flex, spec, H)
    if spec.changes_base:
        Y = _sandwich(backT, H)                     # C⁻ᵀ (·) C⁻¹
        Y = _q_mid(Y, q)
        return _sandwich(ATm, Y)                    # A_Cᵀ (·) A_C
    return _sandwich(ATm, H)                        # Aᵀ (·) A


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


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor, spec: WinogradSpec,
                    mats: Optional[WinogradMatrices] = None,
                    flex: Optional[dict] = None,
                    padding: str = "same") -> torch.Tensor:
    """Quantization-aware Winograd convolution, stride 1. x: (N,H,W,C)
    NHWC, w: (r,r,Cin,Cout) HWIO → (N, Ho, Wo, Cout)."""
    if mats is None:
        mats = make_matrices(spec)
    q = spec.quant
    N, H, W, _ = x.shape
    r, m, n = spec.r, spec.m, spec.n
    if tuple(w.shape[:2]) != (r, r):
        raise ValueError(f"weights {tuple(w.shape)} do not fit {spec}")
    lo_h, hi_h, nt_h, Ho = _pad_amounts(H, m, r, padding)
    lo_w, hi_w, nt_w, Wo = _pad_amounts(W, m, r, padding)
    xp = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h))
    tiles = _extract_tiles_1d_axis(xp, m, n, axis=1)   # (N,th,Wp,C,n)
    tiles = _extract_tiles_1d_axis(tiles, m, n, axis=2)  # (N,th,tw,C,n,n)

    V = _transform_input_tiles(tiles, spec, mats, flex)  # (N,th,tw,Cin,n,n)
    U = transform_weights_2d(w, spec, mats, flex)        # (Cin,Cout,n,n)
    # Hadamard product and channel reduction: n² independent GEMMs
    H_ = torch.einsum("bhwcij,cdij->bhwdij", V, U)
    H_ = _q_dom(H_, q.hadamard_bits, q)
    Y = _transform_output_tiles(H_, spec, mats, flex)    # (N,th,tw,Cout,m,m)
    Y = _q(Y, q.act_bits)
    Y = Y.permute(0, 1, 4, 2, 5, 3).reshape(N, nt_h * m, nt_w * m, -1)
    return Y[:, :Ho, :Wo, :]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding along one dim: (lo, hi), hi taking the odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def direct_conv2d(x: torch.Tensor, w: torch.Tensor, padding: str = "same",
                  stride: int = 1) -> torch.Tensor:
    """Direct convolution, NHWC × HWIO → NHWC, in full fp32: cuDNN's TF32
    is off for the forward call, so this is the counterpart of
    ``lax.conv_general_dilated`` with "SAME"/"VALID" padding (the
    paper's baseline; the JAX function takes stride 1 only)."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if padding == "same":
        (hl, hh), (wl, wh) = (_same_pads(x.shape[1], w.shape[0], stride),
                              _same_pads(x.shape[2], w.shape[1], stride))
        xn = F.pad(xn, (wl, wh, hl, hh))
    elif padding != "valid":
        raise ValueError(padding)
    if (xn.device.type == "cpu" and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        # torch 2.13's CPU conv backward corrupts memory on this
        # channels-last view with a 1×1 stride-2 kernel (the ResNet's
        # projections) when it runs on several threads; an NCHW copy
        # takes the safe kernel. Inference keeps the view.
        xn = xn.contiguous()
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xn, wn, stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# 1-D pipeline (temporal convolutions, e.g. RG-LRU's width-4 conv)
# ---------------------------------------------------------------------------

def _apply(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """M @ x over the trailing dim of X."""
    return torch.einsum("ij,...j->...i", M, X)


def transform_weights_1d(w: torch.Tensor, spec: WinogradSpec,
                         mats: WinogradMatrices,
                         flex: Optional[dict] = None) -> torch.Tensor:
    """(r, Cin, Cout) weights → (Cin, Cout, n), with the casts of
    ``transform_weights_2d`` along one axis."""
    q = spec.quant
    wt = w.permute(1, 2, 0)                         # (Cin, Cout, r)
    w_axis = (0, 2) if q.per_channel_weights else None
    wt = _q(wt, q.weight_bits, axis=w_axis)
    Gm, _, _, back, _ = _resolve(mats, flex, spec, w)
    U = _apply(Gm, wt)
    if spec.changes_base:
        U = _q_mid(U, q, ndims=1)
        U = _apply(back, U)
    return _q_dom(U, q.trans_bits, q, ndims=1)


def winograd_conv1d(x: torch.Tensor, w: torch.Tensor, spec: WinogradSpec,
                    mats: Optional[WinogradMatrices] = None,
                    flex: Optional[dict] = None,
                    causal: bool = True,
                    U: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantization-aware 1-D Toom-Cook convolution, stride 1.
    x: (N, T, C), w: (r, Cin, Cout) → (N, T, Cout).

    ``causal=True`` left-pads r - 1 (the RG-LRU temporal conv); False
    centres the window. ``U``: pre-transformed weights
    (``transform_weights_1d``)."""
    if mats is None:
        mats = make_matrices(spec)
    q = spec.quant
    N, T, _ = x.shape
    r, m, n = spec.r, spec.m, spec.n
    if w.shape[0] != r:
        raise ValueError(f"weights {tuple(w.shape)} do not fit {spec}")
    lo, hi, nt, To = _pad_amounts(T, m, r, "same", causal=causal)
    xp = F.pad(x, (0, 0, lo, hi))
    tiles = _extract_tiles_1d_axis(xp, m, n, axis=1)     # (N, nt, C, n)
    tiles = _q(tiles, q.act_bits)
    _, BTm, ATm, _, backT = _resolve(mats, flex, spec, tiles)
    if spec.changes_base:
        V = _q_mid(_apply(backT, tiles), q, ndims=1)
        V = _apply(BTm, V)
    else:
        V = _apply(BTm, tiles)
    V = _q_dom(V, q.trans_bits, q, ndims=1)
    if U is None:
        U = transform_weights_1d(w, spec, mats, flex)    # (Cin, Cout, n)
    H_ = torch.einsum("btci,cdi->btdi", V, U)
    H_ = _q_dom(H_, q.hadamard_bits, q, ndims=1)
    if spec.changes_base:
        Y = _q_mid(_apply(backT, H_), q, ndims=1)
        Y = _apply(ATm, Y)
    else:
        Y = _apply(ATm, H_)
    Y = _q(Y, q.act_bits)
    Y = Y.permute(0, 1, 3, 2).reshape(N, nt * m, -1)
    return Y[:, :To, :]


def direct_conv1d(x: torch.Tensor, w: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Direct 1-D convolution in full fp32, NTC × (r, Cin, Cout) → NTC,
    left-padded r - 1 when causal, else centred (the low side takes the
    smaller half)."""
    r = w.shape[0]
    lo = r - 1 if causal else (r - 1) // 2
    xn = F.pad(x.permute(0, 2, 1), (lo, r - 1 - lo))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv1d(xn, w.permute(2, 1, 0))
    return y.permute(0, 2, 1)


def condition_number(M) -> float:
    """2-norm condition number of a matrix (largest over smallest
    singular value, in float64): the conditioning of a transform."""
    s = np.linalg.svd(np.asarray(M, np.float64), compute_uv=False)
    return float(s.max() / s.min())
