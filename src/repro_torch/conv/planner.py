"""Per-layer algorithm planner: measure → error budget → solve → serve
(the port's counterpart of ``repro.conv.planner``).

1. **candidates** — for each layer geometry, {direct} ∪ {F(2,3), F(4,3),
   F(6,3)} × {canonical, legendre} × Hadamard bits {None, 8, 9},
   prefiltered by the range certifier (``analysis.ranges``): a config it
   cannot prove int32-safe and Hadamard-faithful is never timed, so a
   plan only carries proved configs.
2. **measure** — time each candidate on synthetic operands of exactly
   the layer's serving geometry: Winograd candidates through the port's
   serving path (prepare → calibrate → K1 → K4 on the card), the direct
   candidate through ``F.conv2d`` (cuDNN, TF32 off), each the median of
   ``iters`` calls timed with CUDA events after warm-up; with the error
   relative to the fp32 direct convolution. Memoised per (geometry,
   candidate, options).
3. **solve** — per layer the fastest candidate within the layer's error
   budget (latency adds over layers and the budget is per layer, so the
   per-layer argmin is the network optimum). With a ``baseline`` entry
   the budget is the baseline's own error at that layer plus
   ``err_slack``: the plan may not add error over the unplanned engine.
4. **serialize** — one ``(5,)`` int32 leaf per layer under ``plan/``,
   the JAX package's codec, so a planned checkpoint written by either
   package routes identically in the other; ``Plan.from_checkpoint``
   reads it without a template.

``ConvEngine(plan=...)`` consumes the result (see ``conv.engine``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec

__all__ = [
    "PlanEntry", "Plan", "LayerGeom", "CandidateCost",
    "candidate_entries", "measure_layer", "solve_plan", "build_plan",
    "plan_cost_us", "clear_measure_cache", "time_call_us", "PLAN_VEC_LEN",
    "DEFAULT_TILE_SIZES", "DEFAULT_BASES", "DEFAULT_HADAMARD_BITS",
]

#: The candidate grid (the paper's menu); ``chebyshev`` is valid in a
#: hand-written plan but not enumerated.
DEFAULT_TILE_SIZES = (2, 4, 6)
DEFAULT_BASES = ("canonical", "legendre")
DEFAULT_HADAMARD_BITS = (None, 8, 9)

_ALGORITHMS = ("direct", "winograd_int8")
#: Index space of the serialized base field (append-only: checkpoints
#: hold it).
_BASE_IDS = ("canonical", "legendre", "chebyshev")
#: Absent integer fields of the serialized vector.
_MISSING = -1
#: Serialized layout: (algo_id, m, r, base_id, hadamard_bits) int32.
PLAN_VEC_LEN = 5


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One layer's planned serving configuration: ``direct`` carries no
    spec fields; ``winograd_int8`` needs ``m``/``r``/``base``
    (``hadamard_bits=None`` turns the 8/9-bit requant stage off)."""

    algorithm: str = "direct"
    m: Optional[int] = None
    r: Optional[int] = None
    base: Optional[str] = None
    hadamard_bits: Optional[int] = None

    def __post_init__(self):
        if self.algorithm not in _ALGORITHMS:
            raise ValueError(f"unknown plan algorithm {self.algorithm!r}; "
                             f"one of {_ALGORITHMS}")
        if self.algorithm == "winograd_int8":
            if not (self.m and self.r and self.base):
                raise ValueError("winograd_int8 plan entries need m, r "
                                 f"and base, got {self}")
            if self.base not in _BASE_IDS:
                raise ValueError(f"unknown base {self.base!r}; one of "
                                 f"{_BASE_IDS}")
        elif (self.m or self.r or self.base
              or self.hadamard_bits is not None):
            raise ValueError("direct plan entries carry no spec fields, "
                             f"got {self}")

    @property
    def is_winograd(self) -> bool:
        return self.algorithm == "winograd_int8"

    def spec(self) -> Optional[WinogradSpec]:
        """The entry's WinogradSpec (None for direct), cached per entry:
        the engine resolves it on every call and the kernels' operand
        tables are cached per spec."""
        return _entry_spec(self) if self.is_winograd else None

    def encode(self) -> np.ndarray:
        """(5,) int32 checkpoint vector; ``_MISSING`` for absent fields."""
        if not self.is_winograd:
            return np.array([0, _MISSING, _MISSING, _MISSING, _MISSING],
                            np.int32)
        bits = (self.hadamard_bits if self.hadamard_bits is not None
                else _MISSING)
        return np.array([1, self.m, self.r, _BASE_IDS.index(self.base),
                         bits], np.int32)

    @classmethod
    def decode(cls, vec) -> "PlanEntry":
        v = [int(x) for x in np.asarray(vec).reshape(-1)]
        if len(v) != PLAN_VEC_LEN:
            raise ValueError(f"plan vector must have {PLAN_VEC_LEN} "
                             f"fields, got {len(v)}")
        if v[0] == 0:
            return cls()
        if v[0] != 1:
            raise ValueError(f"unknown plan algorithm id {v[0]}")
        if not 0 <= v[3] < len(_BASE_IDS):
            raise ValueError(f"unknown plan base id {v[3]}")
        return cls("winograd_int8", m=v[1], r=v[2], base=_BASE_IDS[v[3]],
                   hadamard_bits=None if v[4] == _MISSING else v[4])

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PlanEntry":
        return cls(**d)

    def describe(self) -> str:
        if not self.is_winograd:
            return "direct"
        bits = ("fp" if self.hadamard_bits is None
                else f"{self.hadamard_bits}b")
        return f"F({self.m},{self.r})/{self.base}/{bits}"


@functools.lru_cache(maxsize=None)
def _entry_spec(entry: PlanEntry) -> WinogradSpec:
    return WinogradSpec(m=entry.m, r=entry.r, base=entry.base,
                        quant=QuantConfig(hadamard_bits=entry.hadamard_bits))


class Plan:
    """A {layer: PlanEntry} mapping with checkpoint codecs: one ``(5,)``
    int32 vector per layer under a top-level ``plan`` group, every routed
    layer included (direct ones too), so a restored checkpoint fully
    determines routing."""

    def __init__(self, entries: Mapping[str, PlanEntry]):
        for layer, e in entries.items():
            if not isinstance(e, PlanEntry):
                raise TypeError(f"layer {layer!r}: expected PlanEntry, "
                                f"got {type(e).__name__}")
        self.entries: dict[str, PlanEntry] = dict(entries)

    def get(self, layer: str) -> Optional[PlanEntry]:
        return self.entries.get(layer)

    def __len__(self):
        return len(self.entries)

    def __eq__(self, other):
        return isinstance(other, Plan) and self.entries == other.entries

    def __repr__(self):
        inner = ", ".join(f"{l}: {e.describe()}"
                          for l, e in sorted(self.entries.items()))
        return f"Plan({{{inner}}})"

    def describe(self) -> str:
        n_w = sum(e.is_winograd for e in self.entries.values())
        return (f"{len(self.entries)} layers: {n_w} winograd_int8, "
                f"{len(self.entries) - n_w} direct")

    def to_tree(self) -> dict:
        return {layer: torch.from_numpy(e.encode())
                for layer, e in self.entries.items()}

    @classmethod
    def from_tree(cls, tree: Mapping) -> "Plan":
        return cls({layer: PlanEntry.decode(np.asarray(vec))
                    for layer, vec in tree.items()})

    def to_dict(self) -> dict:
        return {layer: e.to_dict() for layer, e in self.entries.items()}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Plan":
        return cls({layer: PlanEntry.from_dict(e) for layer, e in d.items()})

    @classmethod
    def from_checkpoint(cls, directory: str,
                        step: Optional[int] = None) -> "Optional[Plan]":
        """The plan a checkpoint carries, or None for a checkpoint
        without one (serve by the policy). Reads the ``plan/`` leaves
        without a template (``checkpoint.peek_leaves``): the plan decides
        which layers the restore template holds."""
        from repro_torch.checkpoint.checkpoint import peek_leaves
        flat = peek_leaves(directory, step=step, prefix="plan/")
        if not flat:
            return None
        return cls({key[len("plan/"):]: PlanEntry.decode(arr)
                    for key, arr in flat.items()})


def candidate_entries(kernel_size: int, stride: int, cin: int, *,
                      tile_sizes: Sequence[int] = DEFAULT_TILE_SIZES,
                      bases: Sequence[str] = DEFAULT_BASES,
                      hadamard_bits: Sequence[Optional[int]]
                      = DEFAULT_HADAMARD_BITS,
                      certify: bool = True) -> list[PlanEntry]:
    """The candidates for one layer geometry: ``direct`` first (exact,
    always feasible), then, inside the Winograd regime (stride 1,
    kernel 3), each grid config the certifier proves at this ``cin``
    (every one with ``certify=False``)."""
    cands = [PlanEntry()]
    if stride != 1 or kernel_size != 3:      # the kernels take F(m, 3)
        return cands
    for m in tile_sizes:
        for base in bases:
            for bits in hadamard_bits:
                if certify:
                    from repro_torch.analysis.ranges import certify_config
                    if not certify_config(m, kernel_size, base, bits,
                                          cin).proved:
                        continue
                cands.append(PlanEntry("winograd_int8", m=m, r=kernel_size,
                                       base=base, hadamard_bits=bits))
    return cands


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """What the planner needs about one layer: its serving input shape
    ``x_shape`` = (batch, H, W, Cin), output channels, kernel and stride
    (``models.resnet.layer_geoms`` lists them for the paper's model)."""

    layer: str
    x_shape: tuple
    cout: int
    kernel_size: int = 3
    stride: int = 1

    @property
    def cin(self) -> int:
        return int(self.x_shape[3])

    def key(self) -> tuple:
        """The memo key (no layer name: same-shaped layers share it)."""
        return (tuple(int(d) for d in self.x_shape), int(self.cout),
                int(self.kernel_size), int(self.stride))


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """One measured (or given) candidate: median µs a call and RMS error
    relative to the fp32 direct convolution."""

    entry: PlanEntry
    us: float
    rel_err: float


#: (geom.key(), entry, device, iters, warmup, padding) → CandidateCost.
_MEASURE_CACHE: dict = {}


def clear_measure_cache():
    _MEASURE_CACHE.clear()


def time_call_us(fn, device: torch.device, iters: int, warmup: int) -> float:
    """Median µs of ``fn()``: on the card a pair of CUDA events around
    each call, read after one synchronize; on the CPU the host clock."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for a, b in evs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(device)
        times = sorted(a.elapsed_time(b) * 1e3 for a, b in evs)
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()    # CPU tensors: the work is done when the call returns
            times.append((time.perf_counter() - t0) * 1e6)  # lint: waive=unsynced-timing
        times.sort()
    return times[len(times) // 2]


def _layer_operands(geom: LayerGeom, device: torch.device):
    """Synthetic fp32 operands of the serving geometry from fixed seeds:
    plans depend on shapes only and need no model data."""
    gx = torch.Generator().manual_seed(0)
    gw = torch.Generator().manual_seed(1)
    x = torch.randn(geom.x_shape, generator=gx)
    w = torch.randn((geom.kernel_size, geom.kernel_size, geom.cin,
                     geom.cout), generator=gw) * 0.1
    return x.to(device), w.to(device)


def _rel_rms(y: torch.Tensor, ref: torch.Tensor) -> float:
    y, ref = y.double(), ref.double()
    denom = float(torch.sqrt(torch.mean(ref ** 2))) or 1.0
    return float(torch.sqrt(torch.mean((y - ref) ** 2))) / denom


@torch.inference_mode()
def measure_layer(geom: LayerGeom,
                  candidates: Optional[Sequence[PlanEntry]] = None, *,
                  device=None, iters: int = 5, warmup: int = 2,
                  padding: str = "same") -> tuple[CandidateCost, ...]:
    """Time every candidate of one layer geometry on its serving path.

    Winograd candidates run the int8 lifecycle (pack, calibrate on the
    synthetic batch, then the prepared hot path: K1 → K4 on the card),
    so the time is what the plan will serve; ``direct`` is ``F.conv2d``.
    Errors are RMS relative to the fp32 direct convolution (``direct``
    scores 0). Memoised per (geometry, candidate, options).
    """
    from repro_torch.conv.engine import ConvEngine
    from repro_torch.conv.policy import ConvPolicy
    from repro_torch.core.winograd import direct_conv2d
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if candidates is None:
        candidates = candidate_entries(geom.kernel_size, geom.stride,
                                       geom.cin)
    x, w = _layer_operands(geom, dev)
    y_ref = None
    out = []
    for entry in candidates:
        key = (geom.key(), entry, dev, iters, warmup, padding)
        hit = _MEASURE_CACHE.get(key)
        if hit is not None:
            out.append(hit)
            continue
        if not entry.is_winograd:
            us = time_call_us(lambda: direct_conv2d(x, w, padding,
                                                  geom.stride),
                            dev, iters, warmup)
            cost = CandidateCost(entry, us, 0.0)
        else:
            if y_ref is None:
                y_ref = direct_conv2d(x, w, padding, geom.stride)
            # certify="off": candidate_entries has already filtered
            eng = ConvEngine(entry.spec(),
                             ConvPolicy(backend="winograd_int8"),
                             padding=padding,
                             hadamard_bits=entry.hadamard_bits,
                             certify="off", device=dev)
            eng.prepare([(geom.layer, w, geom.stride)])
            with eng.calibration():
                eng.conv2d(x, w, layer=geom.layer, stride=geom.stride)

            def fn(e=eng):
                return e.conv2d(x, None, layer=geom.layer,
                                stride=geom.stride)
            us = time_call_us(fn, dev, iters, warmup)
            cost = CandidateCost(entry, us, _rel_rms(fn(), y_ref))
        _MEASURE_CACHE[key] = cost
        out.append(cost)
    return tuple(out)


def solve_plan(costs: Mapping[str, Sequence[CandidateCost]], *,
               baseline: Optional[PlanEntry] = None,
               err_slack: float = 0.02,
               err_budget: Optional[float] = None) -> Plan:
    """Each layer's fastest candidate within its error budget:
    ``err_budget`` where given; else, with a ``baseline``, the
    baseline's own error at that layer plus ``err_slack`` (the slack
    alone where the baseline was not measured); else the slack alone.
    The exact ``direct`` candidate is always feasible. Ties break by
    lower error, then direct before Winograd, then the smaller tile,
    base name and bit width, so a frozen cost table gives one plan."""
    entries = {}
    for layer, cands in costs.items():
        if not cands:
            raise ValueError(f"layer {layer!r}: empty candidate set")
        budget = err_budget
        if budget is None:
            budget = err_slack
            if baseline is not None:
                base_cost = next((c for c in cands if c.entry == baseline),
                                 None)
                if base_cost is not None:
                    budget = base_cost.rel_err + err_slack
        feasible = [c for c in cands if c.rel_err <= budget]
        if not feasible:
            raise ValueError(
                f"layer {layer!r}: no candidate within error budget "
                f"{budget:.4f} — include the exact 'direct' candidate")
        entries[layer] = min(
            feasible,
            key=lambda c: (c.us, c.rel_err, c.entry.is_winograd,
                           c.entry.m or 0, c.entry.base or "",
                           c.entry.hadamard_bits or 0)).entry
    return Plan(entries)


def plan_cost_us(plan: Plan,
                 costs: Mapping[str, Sequence[CandidateCost]]) -> float:
    """Total time of ``plan`` under a cost table (µs): the sum of its
    entries' single-device times."""
    total = 0.0
    for layer, entry in plan.entries.items():
        cost = next((c for c in costs[layer] if c.entry == entry), None)
        if cost is None:
            raise ValueError(f"layer {layer!r}: plan entry "
                             f"{entry.describe()} not in the cost table")
        total += cost.us
    return total


def build_plan(geoms: Iterable[LayerGeom], *,
               baseline: Optional[PlanEntry] = None,
               tile_sizes: Sequence[int] = DEFAULT_TILE_SIZES,
               bases: Sequence[str] = DEFAULT_BASES,
               hadamard_bits: Sequence[Optional[int]]
               = DEFAULT_HADAMARD_BITS,
               certify: bool = True, device=None,
               iters: int = 5, warmup: int = 2,
               err_slack: float = 0.02,
               err_budget: Optional[float] = None,
               ) -> tuple[Plan, dict[str, tuple[CandidateCost, ...]]]:
    """Measure and solve a layer menu → (plan, cost table): the
    certifier-proved candidates of each layer (``candidate_entries``)
    timed on the serving geometries (``measure_layer``, memoised per
    shape), solved under the no-added-error budget (``solve_plan``)."""
    costs: dict[str, tuple[CandidateCost, ...]] = {}
    for geom in geoms:
        cands = candidate_entries(geom.kernel_size, geom.stride, geom.cin,
                                  tile_sizes=tile_sizes, bases=bases,
                                  hadamard_bits=hadamard_bits,
                                  certify=certify)
        costs[geom.layer] = measure_layer(geom, cands, device=device,
                                          iters=iters, warmup=warmup)
    return solve_plan(costs, baseline=baseline, err_slack=err_slack,
                      err_budget=err_budget), costs
