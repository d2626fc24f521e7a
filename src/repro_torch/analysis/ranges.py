"""Static numeric-range certifier for the int8 Winograd serving pipeline.

The port's own copy of the JAX package's numpy + ``Fraction`` module of
the same name (``repro_torch`` imports nothing of ``repro``); its
verdicts must equal that module's on every config.

The paper's central argument is that changing the polynomial base shrinks
the magnitudes of the A/B/G transform matrices, which bounds bit growth
through the quantized pipeline — that is why 8/9-bit Hadamard products
recover direct-convolution accuracy. Until now those bounds existed only
implicitly in committed test tolerances. This module makes them a
*proof*: symbolic interval / bit-growth propagation over the quantized
Winograd dataflow, in exact rational arithmetic end to end.

Framework (Barabasz, Anderson, Soodhalter & Gregg 2018): a linear stage
``y = M x`` with ``|x_j| <= a`` has the tight worst-case bound
``|y_i| <= a * l1(M_i)`` (per-row L1 norm), attained by the sign-aligned
input ``x_j = a*sign(M_ij)``. A 2-D transform sandwich ``M X Mᵀ``
therefore amplifies by at most ``max_i l1(M_i)²``. Starting from the
exact-Fraction matrices of ``core.toom_cook`` / ``core.legendre``
(``toom_cook.row_l1_norms``), the certifier derives worst-case
magnitudes at every pipeline stage for a config
``(spec m/r, base, hadamard_bits, Cin, x_amax, w_amax)``:

* the transformed input (tight: the composed operator is exactly
  ``BᵀXB`` in every base — the base change is an algebraic identity;
  what the base *changes* is the per-matmul intermediate, reported as
  its own stage because the fake-quant pipeline quantizes there),
* the int8 quantized operands (clip-bounded at ±127 by construction),
* the int8×int8→int32 GEMM accumulation over K = Cin
  (K2 ``kernels.wino_gemm`` and K4's accumulators),
* the fp32 requant intermediate ``acc · deq`` of ``requant_plane``,
* the 8/9-bit Hadamard requant grid, and
* the ``AᵀYA`` output sandwich.

Two machine-checkable verdicts come out:

* **int32-safe** — the worst-case accumulator ``Cin·127²`` stays within
  ``wino_gemm.INT32_ACC_LIMIT``: the kernels cannot overflow.
* **hadamard_bits-safe** — the requant stage is provably *faithful*:
  ``requant_plane`` casts the int32 accumulator to fp32, exact only up
  to ``wino_gemm.FP32_EXACT_INT_LIMIT`` (2²⁴); past it the cast itself
  rounds and the fused/staged bit-identity contract degrades. The
  verdict also pins the grid's storage
  (``core.quantization.storage_dtype`` — the quantize_int stage
  boundary: 8-bit grids in int8, the paper's 9-bit grid in int16).

Bounds are *conservative but not vacuous*: integer-stage bounds are
exact and attained (adversarial sign-aligned constructions in
the JAX package's tests hit them exactly); fp-stage bounds are attained
up to float rounding.

Consumers: ``ConvEngine(certify=...)`` gates configs at pack time, the
planner (``conv.planner.candidate_entries``) prefilters its grid with it,
and ``python -m repro_torch.analysis.certify`` checks the committed
``ANALYSIS_ranges.json``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction
from typing import Optional, Union

import numpy as np

from repro_torch.core import legendre as _legendre
from repro_torch.core import toom_cook as _tc
from repro_torch.core.quantization import qmax, storage_dtype
from repro_torch.kernels.wino_gemm import (FP32_EXACT_INT_LIMIT,
                                           INT32_ACC_LIMIT,
                                           max_abs_accumulator)

__all__ = ["StageRange", "RangeReport", "exact_matrices", "amplifications",
           "certify_config", "INT8_QMAX"]

INT8_QMAX = qmax(8)    # 127 — the GEMM operand grid

Number = Union[int, float, Fraction]


def _frac(x: Number) -> Fraction:
    """Exact conversion; floats go through str() so 0.1 means 0.1."""
    if isinstance(x, Fraction):
        return x
    if isinstance(x, int):
        return Fraction(x)
    return Fraction(str(x))


def _dot(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Exact object-dtype (Fraction) matrix product."""
    return A.dot(B)


@functools.lru_cache(maxsize=None)
def exact_matrices(m: int, r: int, base: str) -> dict:
    """The pipeline's transform matrices as exact Fraction arrays.

    Mirrors ``core.winograd.make_matrices`` (same construction, same
    orientation of the base change: C is the canonical→basis coefficient
    conversion) but never leaves rational arithmetic — these are the
    ground truth the certified bounds are derived from.
    """
    AT, G, BT = _tc.toom_cook_matrices(m, r)
    n = m + r - 1
    P_f, Pinv_f = _legendre.base_change(n, base)
    C, Cinv = Pinv_f, P_f
    return {
        "AT": AT, "G": G, "BT": BT, "C": C, "Cinv": Cinv,
        "GP": _dot(C, G), "BPT": _dot(BT, C.T), "APT": _dot(AT, C.T),
        "CinvT": Cinv.T.copy(),
    }


@functools.lru_cache(maxsize=None)
def amplifications(m: int, r: int, base: str) -> dict:
    """Exact worst-case amplification factors (max per-row L1 norms).

    ``<name>``: the factor of one 1-D application of that matrix; the
    2-D sandwich squares it. ``input/weight/output_composed``: the tight
    end-to-end 2-D factor (the composed operator is base-independent —
    ``Bᵀ··B``, ``G··Gᵀ``, ``Aᵀ··A``). ``input/weight/output_staged``:
    the conservative product over the two matmul stages the changed-base
    pipeline actually executes — the bound that governs the fake-quant
    pipeline's intermediate casts, and the paper's per-base bit-growth
    comparison (canonical executes one stage, so staged == composed
    there).
    """
    M = exact_matrices(m, r, base)
    a = {k: _tc.max_row_l1(v) for k, v in M.items()}
    out = {k: v for k, v in a.items()}
    out["input_composed"] = a["BT"] ** 2
    out["weight_composed"] = a["G"] ** 2
    out["output_composed"] = a["AT"] ** 2
    if base == "canonical":
        out["input_staged"] = out["input_composed"]
        out["weight_staged"] = out["weight_composed"]
        out["output_staged"] = out["output_composed"]
    else:
        # Execution order (core.winograd): input C⁻ᵀXC⁻¹ then B_Cᵀ·B_C;
        # weights G_C W G_Cᵀ then C⁻¹·C⁻ᵀ; output C⁻ᵀHC⁻¹ then A_Cᵀ·A_C.
        out["input_staged"] = (a["CinvT"] ** 2) * (a["BPT"] ** 2)
        out["weight_staged"] = (a["GP"] ** 2) * (a["Cinv"] ** 2)
        out["output_staged"] = (a["CinvT"] ** 2) * (a["APT"] ** 2)
    return out


@dataclasses.dataclass(frozen=True)
class StageRange:
    """Worst-case magnitude at one pipeline stage.

    ``bound`` is exact (Fraction); ``bits`` is the effective bit demand:
    for integer stages the signed bits needed to hold every reachable
    value, for fp stages the bit *growth* over the pipeline input
    (log₂ of the amplification) — the paper's Table-style number.
    """

    name: str
    dtype: str                  # "fp32" | "int8" | "int16" | "int32"
    bound: Fraction
    bits: float
    note: str = ""
    safe: Optional[bool] = None     # None: no hard limit at this stage

    def to_dict(self) -> dict:
        d = {"name": self.name, "dtype": self.dtype,
             "bound": float(self.bound), "bound_exact": str(self.bound),
             "bits": round(self.bits, 4), "note": self.note}
        if self.safe is not None:
            d["safe"] = self.safe
        return d


def _int_bits(bound: Fraction) -> float:
    """Signed bits needed for integer magnitudes up to ``bound``."""
    return math.floor(math.log2(int(bound))) + 2 if bound >= 1 else 1.0


def _growth_bits(bound: Fraction, ref: Fraction) -> float:
    """log₂ amplification of a fp stage over the pipeline input."""
    return math.log2(float(bound / ref)) if bound > 0 and ref > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class RangeReport:
    """The certifier's machine-checkable output for one config."""

    config: dict
    stages: tuple               # of StageRange, pipeline order
    int32_safe: bool
    hadamard_safe: bool
    amplification: dict         # name -> Fraction

    @property
    def proved(self) -> bool:
        """Both verdicts hold: the config provably cannot overflow the
        int32 accumulator nor desaturate the declared Hadamard grid."""
        return self.int32_safe and self.hadamard_safe

    def stage(self, name: str) -> StageRange:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)

    def to_dict(self) -> dict:
        return {
            "config": dict(self.config),
            "int32_safe": self.int32_safe,
            "hadamard_safe": self.hadamard_safe,
            "proved": self.proved,
            "stages": [s.to_dict() for s in self.stages],
            "amplification": {k: {"value": float(v), "exact": str(v)}
                              for k, v in self.amplification.items()},
        }

    def summary(self) -> str:
        c = self.config
        verdict = "PROVED" if self.proved else "UNSAFE"
        parts = [] if self.proved else \
            [v for v, ok in (("int32-overflow", self.int32_safe),
                             ("hadamard-unfaithful", self.hadamard_safe))
             if not ok]
        tail = f" ({', '.join(parts)})" if parts else ""
        return (f"F({c['m']},{c['r']}) {c['base']} "
                f"bits={c['hadamard_bits']} Cin={c['cin']}: "
                f"{verdict}{tail}")


@functools.lru_cache(maxsize=None)
def certify_config(m: int, r: int, base: str,
                   hadamard_bits: Optional[int], cin: int,
                   x_amax: Number = 1, w_amax: Number = 1) -> RangeReport:
    """Prove worst-case ranges for one serving config, exactly.

    Models the int8 kernel pipeline of ``kernels.ops``: fp input
    transform → per-position abs-max int8 quantization → int8×int8→int32
    GEMM over K = Cin → (optional) 8/9-bit Hadamard requant
    (``requant_plane``: int32→fp32 cast, fp32 multiply, round, clip) →
    fp output transform sandwich. Changed-base intermediates are
    reported as their own stages: they bound the fake-quant (QAT)
    pipeline's extra casts, and they are where canonical and Legendre
    provably differ — the composed end-to-end operators are
    base-independent.
    """
    if base not in ("canonical", "legendre", "chebyshev"):
        raise ValueError(f"unknown base {base!r}")
    if hadamard_bits is not None and not 2 <= hadamard_bits <= 16:
        raise ValueError(f"hadamard_bits must be in [2, 16] or None, "
                         f"got {hadamard_bits}")
    if cin < 1:
        raise ValueError(f"cin must be >= 1, got {cin}")
    xa, wa = _frac(x_amax), _frac(w_amax)
    amp = amplifications(m, r, base)
    changes_base = base != "canonical"
    stages: list[StageRange] = []

    def fp(name, bound, note=""):
        stages.append(StageRange(name, "fp32", bound,
                                 _growth_bits(bound, xa * wa), note))

    # -- input side ---------------------------------------------------------
    stages.append(StageRange("input", "fp32", xa, 0.0,
                             "activations, |x| <= x_amax"))
    if changes_base:
        fp("input_base_change", (amp["CinvT"] ** 2) * xa,
           "C⁻ᵀXC⁻¹ intermediate — quantized in the fake-quant pipeline "
           "(cast_between_stages), transient in the int8 kernels")
    fp("input_transformed", amp["input_composed"] * xa,
       "V = BᵀXB (composed operator; base-exact identity)")
    bound_v = stages[-1].bound
    stages.append(StageRange(
        "input_quantized", "int8", Fraction(INT8_QMAX),
        _int_bits(Fraction(INT8_QMAX)),
        "per-position abs-max symmetric quantization clips at ±127 — "
        f"worst-case quantum {float(bound_v / INT8_QMAX):.3e}·x_amax"))

    # -- weight side --------------------------------------------------------
    if changes_base:
        fp("weight_base_change", (amp["GP"] ** 2) * wa,
           "G_C W G_Cᵀ intermediate before the C⁻¹ sandwich")
    fp("weight_transformed", amp["weight_composed"] * wa,
       "U = GWGᵀ (composed operator; base-exact identity)")
    bound_u = stages[-1].bound
    stages.append(StageRange(
        "weight_quantized", "int8", Fraction(INT8_QMAX),
        _int_bits(Fraction(INT8_QMAX)),
        "prepare_weights_int8 per-position symmetric grid"))

    # -- GEMM accumulator ---------------------------------------------------
    acc_bound = Fraction(max_abs_accumulator(cin))
    int32_safe = acc_bound <= INT32_ACC_LIMIT
    stages.append(StageRange(
        "gemm_accumulator", "int32", acc_bound, _int_bits(acc_bound),
        f"int8×int8→int32 over K=Cin={cin}: Cin·127² (exact, attained); "
        f"int32 limit {INT32_ACC_LIMIT}", safe=int32_safe))

    # -- Hadamard requant ---------------------------------------------------
    hadamard_fp_bound = cin * bound_v * bound_u
    cast_exact = acc_bound <= FP32_EXACT_INT_LIMIT
    fp("hadamard_fp", hadamard_fp_bound,
       "requant_plane input acc·deq — worst Cin·|V|·|U|; int32→fp32 "
       f"cast exact up to 2^24 ({'holds' if cast_exact else 'VIOLATED'})")
    if hadamard_bits is not None:
        qm = qmax(hadamard_bits)
        store = str(storage_dtype(hadamard_bits)).split(".")[-1]
        hadamard_safe = cast_exact
        stages.append(StageRange(
            "hadamard_requant", store,
            Fraction(qm), _int_bits(Fraction(qm)),
            f"{hadamard_bits}-bit grid (qmax={qm}); kernels keep it in "
            "int32, the quantize_int stage boundary stores "
            f"{store}; faithful "
            "iff the accumulator cast is exact", safe=hadamard_safe))
        bound_h = hadamard_fp_bound     # requant-dequant clips at amax
    else:
        # No declared grid to saturate — but record the cast verdict so
        # a None-bits config still can't silently lose accumulator bits.
        hadamard_safe = cast_exact
        bound_h = hadamard_fp_bound

    # -- output side --------------------------------------------------------
    if changes_base:
        fp("output_base_change", (amp["CinvT"] ** 2) * bound_h,
           "C⁻ᵀHC⁻¹ intermediate of the output sandwich")
    fp("output", amp["output_composed"] * bound_h,
       "Y = AᵀHA (composed operator; base-exact identity)")

    config = {"m": m, "r": r, "base": base, "hadamard_bits": hadamard_bits,
              "cin": cin, "x_amax": float(xa), "w_amax": float(wa)}
    return RangeReport(config=config, stages=tuple(stages),
                       int32_safe=int32_safe, hadamard_safe=hadamard_safe,
                       amplification=amp)
