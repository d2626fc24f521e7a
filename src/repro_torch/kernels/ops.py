"""The int8 Winograd convolution composed from the kernels (the
inference path), the port's counterpart of ``repro.kernels.ops``.

Staged pipeline (NHWC):
    extract tiles (pad + unfold)                  → (T, Cin, n, n) fp32
    wino_transform.input_transform   (K1)         → (n², T, Cin) int8
    wino_gemm.wino_gemm              (K2)         → (n², T, Cout) int32
    [optional 8/9-bit Hadamard requant: K2's epilogue with calibrated
     statistics, plain torch when derived dynamically]
    wino_transform.output_transform  (K3)         → (T, Cout, m, m) fp32
    reassemble                                    → (N, Ho, Wo, Cout)

Fused serving pipeline (``fused=True``; needs calibrated Hadamard
statistics when the 8/9-bit stage is on):
    extract → K1 → fused_serve.fused_gemm_output (K4) → reassemble.
Calibration (``with_stats``) and dynamic requant run staged: their
plane-wide reductions cannot run inside a tiled kernel.

One Xq everywhere: every mode obtains its int8 input through
``quantize_input``, the one input-transform unit.

Tile extraction and the calibration reduction (``_tiles_abs_max``) are
plain torch, as they were XLA glue outside Pallas in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QuantConfig, qmax, quantize_int
from repro_torch.core.winograd import (WinogradSpec, _extract_tiles_1d_axis,
                                       _pad_amounts, make_matrices,
                                       transform_weights_2d)
from repro_torch.kernels import ref as kref
from repro_torch.kernels.fused_serve import fused_gemm_output
from repro_torch.kernels.q8_matmul import q8_matmul
from repro_torch.kernels.wino_gemm import wino_gemm
from repro_torch.kernels.wino_transform import (input_transform,
                                                output_transform)

__all__ = ["prepare_weights_int8", "input_abs_max", "scales_from_abs_max",
           "quantize_input", "winograd_conv2d_int8", "execute_int8",
           "q8_linear"]


@functools.lru_cache(maxsize=None)
def _operands(spec: WinogradSpec, device: torch.device) -> dict:
    """The transform matrices the kernels take, as fp32 tensors on
    ``device`` (made once per spec and device)."""
    mats = make_matrices(spec)
    return {k: torch.as_tensor(getattr(mats, k), dtype=torch.float32,
                               device=device).contiguous()
            for k in ("CinvT", "BPT", "APT")}


def _geometry(x_shape, m: int, r: int, padding: str):
    N, H, W, _ = x_shape
    _, _, nt_h, Ho = _pad_amounts(H, m, r, padding)
    _, _, nt_w, Wo = _pad_amounts(W, m, r, padding)
    return (N, nt_h, nt_w, Ho, Wo)


def _extract(x: torch.Tensor, m: int, r: int, n: int,
             padding: str) -> torch.Tensor:
    """(N,H,W,C) → (T, C, n, n) overlapping tiles, contiguous."""
    N, H, W, C = x.shape
    lo_h, hi_h, nt_h, _ = _pad_amounts(H, m, r, padding)
    lo_w, hi_w, nt_w, _ = _pad_amounts(W, m, r, padding)
    xp = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h))
    t = _extract_tiles_1d_axis(xp, m, n, axis=1)          # (N,th,Wp,C,n)
    t = _extract_tiles_1d_axis(t, m, n, axis=2)           # (N,th,tw,C,n,n)
    return t.reshape(N * nt_h * nt_w, C, n, n).contiguous()


def _reassemble(y: torch.Tensor, geom, m: int) -> torch.Tensor:
    N, nt_h, nt_w, Ho, Wo = geom
    y = y.reshape(N, nt_h, nt_w, -1, m, m)
    y = y.permute(0, 1, 4, 2, 5, 3)
    y = y.reshape(N, nt_h * m, nt_w * m, -1)
    return y[:, :Ho, :Wo, :]


def _hadamard_rq(h_amax: torch.Tensor, hadamard_bits: int) -> torch.Tensor:
    """Calibrated Hadamard requant scales: (n²,)|(n²,1) abs-max → (n²,1).
    The one scale formula of the 8/9-bit requant stage."""
    return torch.clamp_min(h_amax.reshape(-1, 1), 1e-12) / qmax(hadamard_bits)


def prepare_weights_int8(w: torch.Tensor, spec: WinogradSpec
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline weight packing: (r,r,Cin,Cout) fp → per-position int8.

    Exact fp Winograd transform, then symmetric per-position int8
    quantization. Returns ``(u_q, w_scales)``: ``u_q`` (P, Cin, Cout)
    int8 and ``w_scales`` (P, 1) fp32.
    """
    mats = make_matrices(spec)
    P = spec.n * spec.n
    fp_spec = WinogradSpec(m=spec.m, r=spec.r, base=spec.base,
                           quant=QuantConfig.off())
    U = transform_weights_2d(w.to(torch.float32), fp_spec, mats)
    u_src = U.reshape(*U.shape[:2], P).movedim(-1, 0)          # (P,Cin,Cout)
    s_w = u_src.abs().amax(dim=(1, 2), keepdim=True) / 127.0
    s_w = torch.clamp_min(s_w, 1e-12)
    u_q = torch.clamp(torch.round(u_src / s_w), -127, 127).to(torch.int8)
    return u_q.contiguous(), s_w.reshape(P, 1)


def _tiles_abs_max(tiles: torch.Tensor, spec: WinogradSpec) -> torch.Tensor:
    """Per-position abs-max of extracted (T,Cin,n,n) tiles in the
    Winograd input domain → (n²,) fp32. The dynamic-scale fallback and
    offline calibration both call exactly this, so calibrating on a
    batch reproduces that batch's dynamic scales bit for bit."""
    ops = _operands(spec, tiles.device)
    v_fp = kref.input_transform_fp(tiles, ops["CinvT"], ops["BPT"],
                                   spec.changes_base)
    return v_fp.abs().amax(dim=(1, 2))


def input_abs_max(x: torch.Tensor, spec: WinogradSpec,
                  padding: str = "same") -> torch.Tensor:
    """Per-position abs-max of (N,H,W,Cin) in the Winograd input domain
    → (n²,) fp32: the calibration entry point."""
    tiles = _extract(x, spec.m, spec.r, spec.n, padding)
    return _tiles_abs_max(tiles, spec)


def scales_from_abs_max(amax: torch.Tensor) -> torch.Tensor:
    """(n²,) abs-max → (n², 1) symmetric int8 scales."""
    return torch.clamp_min(amax, 1e-12).reshape(-1, 1) / 127.0


def quantize_input(tiles: torch.Tensor, in_scales: torch.Tensor, *,
                   spec: WinogradSpec) -> torch.Tensor:
    """THE int8 input transform + quantization unit: every serving mode
    obtains its Xq (n², T, Cin) through this one call of K1."""
    ops = _operands(spec, tiles.device)
    return input_transform(tiles, ops["CinvT"], ops["BPT"], in_scales,
                           changes_base=spec.changes_base)


def winograd_conv2d_int8(x: torch.Tensor, w: Optional[torch.Tensor],
                         spec: WinogradSpec,
                         padding: str = "same",
                         in_scales: Optional[torch.Tensor] = None,
                         u_q: Optional[torch.Tensor] = None,
                         w_scales: Optional[torch.Tensor] = None,
                         hadamard_bits: Optional[int] = None,
                         h_amax: Optional[torch.Tensor] = None,
                         fused: bool = False,
                         tile: Optional[tuple] = None) -> torch.Tensor:
    """True-int8 Winograd conv. x: (N,H,W,Cin) NHWC fp32.

    * **dynamic**: pass raw HWIO weights ``w``; weight packing and the
      input-scale reduction run per call.
    * **prepared**: pass ``u_q``/``w_scales`` from
      ``prepare_weights_int8`` and calibrated ``in_scales``; no weight
      transform and no scale reduction runs.

    ``fused=True`` serves through K4 whenever no dynamic reduction is
    needed (requant off, or ``h_amax`` calibrated); otherwise staged.
    ``tile``: K4's block tile (None: its default).
    """
    if u_q is None:
        if w is None:
            raise ValueError("pass either raw weights w or prepared "
                             "(u_q, w_scales)")
        u_q, w_scales = prepare_weights_int8(w, spec)
    elif w_scales is None:
        raise ValueError("prepared u_q requires w_scales")
    tiles = _extract(x, spec.m, spec.r, spec.n, padding)
    geom = _geometry(x.shape, spec.m, spec.r, padding)
    if in_scales is None:
        in_scales = scales_from_abs_max(_tiles_abs_max(tiles, spec))
    return execute_int8(tiles, u_q, w_scales, in_scales, h_amax,
                        spec=spec, geom=geom, hadamard_bits=hadamard_bits,
                        fused=fused, tile=tile)


def execute_int8(tiles: torch.Tensor, u_q: torch.Tensor,
                 w_scales: torch.Tensor, in_scales: torch.Tensor,
                 h_amax: Optional[torch.Tensor] = None, *,
                 spec: WinogradSpec, geom: tuple,
                 hadamard_bits: Optional[int], with_stats: bool = False,
                 fused: bool = False, tile: Optional[tuple] = None):
    """The serving hot path on extracted tiles, prepared weights and
    static scales.

    With calibrated ``h_amax`` (the (n²,) per-position abs-max of the
    Hadamard products) the requant stage does no reduction either.
    ``with_stats=True`` (calibration) runs staged and also returns this
    batch's Hadamard abs-max. ``tile``: K4's block tile (None: its
    default).
    """
    if with_stats and hadamard_bits is None:
        raise ValueError("with_stats records the Hadamard abs-max; it "
                         "needs hadamard_bits")
    ops = _operands(spec, tiles.device)
    m = spec.m

    Xq = quantize_input(tiles, in_scales, spec=spec)
    deq = in_scales * w_scales                        # (P, 1)

    use_fused = (fused and not with_stats
                 and (hadamard_bits is None or h_amax is not None))
    if use_fused:
        if hadamard_bits is None:
            rq = torch.ones_like(deq)
        else:
            rq = _hadamard_rq(h_amax, hadamard_bits)
        y = fused_gemm_output(Xq, u_q, deq, rq, ops["CinvT"], ops["APT"],
                              m=m, requant_bits=hadamard_bits,
                              changes_base=spec.changes_base, tile=tile)
        return _reassemble(y, geom, m)

    amax_h = None
    if (hadamard_bits is not None and h_amax is not None
            and not with_stats):
        # Calibrated requant runs as K2's epilogue: the grid the formula
        # below produces, without the fp32 plane in device memory.
        rq = _hadamard_rq(h_amax, hadamard_bits)
        H = wino_gemm(Xq, u_q, requant_bits=hadamard_bits, deq=deq, rq=rq)
        deq = rq
    else:
        H = wino_gemm(Xq, u_q)                        # (P, T, Cout) int32
        if hadamard_bits is not None:
            # Dynamic 8/9-bit Hadamard stage: derive the per-position
            # scale from this plane (no calibration, or recording one).
            qm = qmax(hadamard_bits)
            hf = H.to(torch.float32) * deq[:, :, None]
            if h_amax is None or with_stats:
                amax_h = hf.abs().amax(dim=(1, 2), keepdim=True)
            amax = amax_h if h_amax is None else h_amax.reshape(-1, 1, 1)
            s_h = torch.clamp_min(amax, 1e-12) / qm
            H = torch.clamp(torch.round(hf / s_h), -qm, qm).to(torch.int32)
            deq = s_h[:, :, 0]

    y = output_transform(H, deq.contiguous(), ops["CinvT"], ops["APT"],
                         m=m, changes_base=spec.changes_base)
    out = _reassemble(y, geom, m)
    if with_stats:
        return out, amax_h[:, 0, 0]
    return out


def _q8_operands(x2: torch.Tensor, w: torch.Tensor):
    """q8_linear's dynamic quantization: x (M, K) per tensor, w (K, N)
    per output column, scale = max(amax, 1e-12)/127 → (xq, wq, s_x, s_w)."""
    xq, s_x = quantize_int(x2, 8)
    wq, s_w = quantize_int(w, 8, axis=(0,))
    return xq, wq, s_x, s_w.reshape(-1)


def q8_linear(x: torch.Tensor, w: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dynamic w8a8 linear: x quantized per tensor, w per output column,
    then the int8 GEMM with its dequant epilogue (K5).

    x: (..., K) fp, w: (K, N) fp → (..., N). The quantization is plain
    torch, as it is plain jnp in the JAX package."""
    lead = x.shape[:-1]
    xq, wq, s_x, s_w = _q8_operands(x.reshape(-1, x.shape[-1]), w)
    y = q8_matmul(xq, wq, s_x, s_w, out_dtype=out_dtype)
    return y.reshape(*lead, -1)
