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

Sharded serving (``execute_int8_sharded``): K1 once on the full tiles,
then per (T-slab × Cout-slab) of a data × model device mesh either K4
(calibrated) or K2 → plain requant with the merged abs-max → K3
(dynamic); the slabs' outputs are gathered along Cout, then along T.

Tile extraction and the calibration reduction (``_tiles_abs_max``) are
plain torch, as they were XLA glue outside Pallas in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantization import (QuantConfig, divide, qmax,
                                          quantize_int)
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
           "execute_int8_sharded", "q8_linear"]


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
    return divide(torch.clamp_min(h_amax.reshape(-1, 1), 1e-12),
                  qmax(hadamard_bits))


def prepare_weights_int8(w: torch.Tensor, spec: WinogradSpec
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline weight packing: (r,r,Cin,Cout) fp → per-position int8.

    Exact fp Winograd transform, then symmetric per-position int8
    quantization. Returns ``(u_q, w_scales)``: ``u_q`` (P, Cin, Cout)
    int8 and ``w_scales`` (P, 1) fp32.
    """
    u_src = _transformed_weights(w, spec)                     # (P,Cin,Cout)
    s_w = divide(u_src.abs().amax(dim=(1, 2), keepdim=True), 127.0)
    s_w = torch.clamp_min(s_w, 1e-12)
    u_q = torch.clamp(torch.round(u_src / s_w), -127, 127).to(torch.int8)
    return u_q.contiguous(), s_w.reshape(-1, 1)


def _transformed_weights(w: torch.Tensor, spec: WinogradSpec
                         ) -> torch.Tensor:
    """(r,r,Cin,Cout) → the exact fp Winograd-domain weights
    (P, Cin, Cout): ``transform_weights_2d`` with quantization off."""
    U = transform_weights_2d(
        w.to(torch.float32),
        dataclasses.replace(spec, quant=QuantConfig.off()),
        make_matrices(spec))                              # (Cin,Cout,n,n)
    return U.reshape(*U.shape[:2], spec.n * spec.n).movedim(-1, 0)


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
    return divide(torch.clamp_min(amax, 1e-12).reshape(-1, 1), 127.0)


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
            hf = _dequant(H, deq)
            if h_amax is None or with_stats:
                amax_h = _plane_abs_max(hf)
            amax = amax_h if h_amax is None else h_amax.reshape(-1, 1, 1)
            H, deq = _requant(hf, amax, hadamard_bits)

    y = output_transform(H, deq.contiguous(), ops["CinvT"], ops["APT"],
                         m=m, changes_base=spec.changes_base)
    out = _reassemble(y, geom, m)
    if with_stats:
        return out, amax_h[:, 0, 0]
    return out


def _dequant(H: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """The dynamic requant's fp32 plane: int32 (P, T, C) · (P, 1)."""
    return H.to(torch.float32) * deq[:, :, None]


def _plane_abs_max(hf: torch.Tensor) -> torch.Tensor:
    """Per-position abs-max of a dequantized plane: (P, 1, 1)."""
    return hf.abs().amax(dim=(1, 2), keepdim=True)


def _requant(hf: torch.Tensor, amax: torch.Tensor, bits: int):
    """The dynamic 8/9-bit Hadamard requant of the plane ``hf`` with the
    per-position maximum ``amax`` (P, 1, 1): (int32 plane, (P, 1) scale).
    The single-device and the sharded executors both requant here, so
    their formulas and order are one."""
    qm = qmax(bits)
    s_h = divide(torch.clamp_min(amax, 1e-12), qm)
    Hq = torch.clamp(torch.round(hf / s_h), -qm, qm).to(torch.int32)
    return Hq, s_h[:, :, 0]


def _on(device: torch.device):
    """Make ``device`` current for a kernel launch (the kernels launch on
    the current device's current stream)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def execute_int8_sharded(tiles: torch.Tensor, u_q, w_scales, in_scales,
                         h_amax=None, *, spec: WinogradSpec, geom: tuple,
                         mesh, hadamard_bits: Optional[int],
                         tile: Optional[tuple] = None, data_axis="data",
                         model_axis=None) -> torch.Tensor:
    """Serving over a data × model device mesh: the Winograd tile axis T
    sharded over ``data_axis`` and the per-position GEMM's N axis (Cout)
    over ``model_axis`` (None: a data-only mesh).

    ``tiles`` lie on the mesh's first device. ``u_q`` and the per-position
    statistics are tensors or ``distributed.sharding.Placed`` over this
    mesh (``conv.packing.place_packed_state``: ``u_q`` cut along Cout per
    model index, the statistics whole on every device); tensors are
    placed here.

    One Xq: K1 runs once on the full tile tensor and only its int8 output
    is cut (T zero-padded to a multiple of the data extent; zero rows
    give zero products, which raise no abs-max, and are cropped). Each
    mesh position (a, b) then runs on its own device's current stream,
    against its own Cout shard:

    * calibrated (``h_amax`` given, or the Hadamard stage off): K4 on its
      (T/D_data, Cout/D_model) slab, with ``tile`` (one tile for every
      slab, as they share a shape);
    * dynamic (``hadamard_bits`` set, no ``h_amax``): K2 on its slab, the
      slab's per-position abs-max of the dequantized plane, one merge of
      those maxima (a max of maxima: the single-device plane's maximum
      exactly), then per slab the plain requant with that maximum and K3
      — the formulas and order of ``execute_int8``'s dynamic branch.

    The outputs are gathered along Cout, then along T, cropped and
    reassembled: the output equals ``execute_int8``'s bit for bit
    (calibrated: fused; dynamic: staged) on any mesh. ``Cout`` must
    divide into the model extent.
    """
    from repro_torch.distributed.sharding import (axis_extent, device_grid,
                                                  gather, gather_max,
                                                  placed_or, shard)
    dm = axis_extent(mesh, model_axis)
    cout = u_q.shape[-1]
    if cout % dm != 0:
        raise ValueError(
            f"sharded serving: Cout={cout} is not divisible by the "
            f"{model_axis!r} mesh axis extent {dm} — conv tensor "
            "parallelism slices the per-position GEMM's N axis into "
            "equal per-device slabs (see conv.packing)")
    first = mesh.first
    if tiles.device != first:
        raise ValueError(f"tiles are on {tiles.device}; a sharded call "
                         f"takes them on the mesh's first device {first}")
    u = placed_or(u_q, mesh, model_axis, dim=2)
    w_s, in_s, h = (placed_or(t, mesh) for t in (w_scales, in_scales,
                                                  h_amax))
    dynamic = hadamard_bits is not None and h is None
    m = spec.m
    grid = device_grid(mesh, data_axis, model_axis)
    dd = grid.shape[0]

    Xq = quantize_input(tiles, in_s.local(first), spec=spec)
    T = Xq.shape[1]
    pad = (-T) % dd
    if pad:
        Xq = F.pad(Xq, (0, 0, 0, pad))
    xs = shard(Xq, mesh, data_axis, dim=1)

    # per device: transform operands, dequant (and requant) scales
    local: dict = {}
    for dev in dict.fromkeys(grid.flat):
        deq = in_s.local(dev) * w_s.local(dev)
        rq = (torch.ones_like(deq) if hadamard_bits is None else
              None if dynamic else
              _hadamard_rq(h.local(dev), hadamard_bits))
        local[dev] = (_operands(spec, dev), deq, rq)
    slabs: dict = {}

    def xq_at(a, dev):
        if (a, dev) not in slabs:
            slabs[(a, dev)] = xs[a].to(dev, non_blocking=True)
        return slabs[(a, dev)]

    ys = np.empty(grid.shape, dtype=object)
    if not dynamic:
        for (a, b), dev in np.ndenumerate(grid):
            ops, deq, rq = local[dev]
            with _on(dev):
                ys[a, b] = fused_gemm_output(
                    xq_at(a, dev), u.local(dev, b), deq, rq, ops["CinvT"],
                    ops["APT"], m=m, requant_bits=hadamard_bits,
                    changes_base=spec.changes_base, tile=tile)
    else:
        hfs = np.empty(grid.shape, dtype=object)
        maxima = []
        for (a, b), dev in np.ndenumerate(grid):
            _, deq, _ = local[dev]
            with _on(dev):
                hfs[a, b] = _dequant(wino_gemm(xq_at(a, dev),
                                               u.local(dev, b)), deq)
                maxima.append(_plane_abs_max(hfs[a, b]))
        amax = gather_max(maxima, mesh)                 # the one merge
        for (a, b), dev in np.ndenumerate(grid):
            ops = local[dev][0]
            with _on(dev):
                Hq, s_h = _requant(hfs[a, b],
                                   amax.to(dev, non_blocking=True),
                                   hadamard_bits)
                ys[a, b] = output_transform(
                    Hq, s_h.contiguous(), ops["CinvT"], ops["APT"], m=m,
                    changes_base=spec.changes_base)
    y = gather([gather(list(ys[a]), mesh, dim=1) for a in range(dd)],
               mesh, dim=0)
    return _reassemble(y[:T], geom, m)


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
