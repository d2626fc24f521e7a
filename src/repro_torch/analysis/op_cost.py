"""Per-device cost of a step from its ATen ops: the dry run's counter
(``launch.dryrun``), the port's counterpart of ``repro.analysis.hlo_cost``.

The JAX package walks the compiled per-device HLO. The port has no
compiler: it runs the real step eagerly, here under fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``) on a mesh whose every
position is a device of its own, and ``OpCost`` (a ``TorchDispatchMode``)
tallies each op on the device it runs on:

* flops: matmuls, convolutions and attention as
  ``torch.utils.flop_counter`` counts them (``matmul_flops``), plus one
  per output element of every other op that launches a kernel, as
  ``analyze_hlo`` counts elementwise ops;
* transcendentals: the output elements of exp, log, tanh, sigmoid, the
  square roots, powers, trigonometric functions and divisions (JAX counts
  ``divide`` among them);
* bytes: each op reads its tensor inputs and writes its outputs once.
  Views (and the ops that only make or alias tensors: ``empty``,
  ``detach``) are free, as the eager port launches no kernel for them;
* collective bytes: a copy from another mesh position's device counts
  the bytes its receiver takes in, under the kind of collective its code
  names (``distributed.sharding.moving``: all-gather, all-reduce,
  reduce-scatter, all-to-all; a copy outside any is a
  collective-permute);
* ``launches``: the ops that launch a kernel.

Remat recomputation is counted where it runs, as the step runs it.
``attribute`` lists the top ops with the port's function that called
them (the counterpart of ``attribute_hlo``); a backward op is listed
under the forward function it differentiates where the step ran under
``torch.autograd.detect_anomaly``, which keeps each node's forward
traceback (``launch.dryrun`` does, when it attributes).
"""
from __future__ import annotations

import dataclasses
import re
import sys
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding

__all__ = ["OpCost", "Tally", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# ops that launch no kernel: they make, alias or describe tensors
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.detach, _aten.alias, _aten._unsafe_view, _aten.lift_fresh,
         _aten.lift_fresh_copy, _aten.new_empty, _aten.new_empty_strided,
         _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
         _aten.sym_storage_offset, _aten.is_same_size, _aten.set_,
         _aten._local_scalar_dense}

_TRANSCENDENTAL = {_aten.exp, _aten.exp2, _aten.expm1, _aten.log,
                   _aten.log1p, _aten.log2, _aten.tanh, _aten.sigmoid,
                   _aten.rsqrt, _aten.sqrt, _aten.pow, _aten.sin, _aten.cos,
                   _aten.erf, _aten.div, _aten.reciprocal, _aten.atan2,
                   _aten._softmax, _aten._log_softmax, _aten.silu,
                   _aten.gelu, _aten.logaddexp, _aten.logsumexp}

_COPIES = {_aten._to_copy, _aten.copy_}


@dataclasses.dataclass
class Tally:
    """One device's counts (the fields of ``HloCost`` and the launches)."""
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    launches: int = 0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "launches": self.launches,
                "collective_bytes": dict(self.collective_bytes),
                "collective_total": self.collective_total}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_SKIP = (__name__, "repro_torch.distributed.sharding")
_FRAME = re.compile(r'File "([^"]*)", line \d+, in (\S+)')


def _caller() -> str:
    """The port function an op runs for, "module.function": the innermost
    frame of the port (outside this counter and the sharding helpers) on
    the stack; in autograd's backward, outside a checkpointed layer's
    recomputation, the function whose forward op the running node
    differentiates (from the node's forward traceback, which autograd
    keeps under anomaly detection), marked " (backward)"."""
    f, recompute, name = sys._getframe(2), False, "?"
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        recompute |= mod == "torch.utils.checkpoint"
        if name == "?" and mod.startswith("repro_torch") and \
                mod not in _SKIP:
            name = f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is None or recompute:
        return name
    for line in reversed(node.metadata.get("traceback_", [])):
        m = _FRAME.search(line)
        path = m.group(1).replace("\\", "/") if m else ""
        if "/repro_torch/" in path:
            mod = "repro_torch." + path.split("/repro_torch/")[-1][:-3] \
                .replace("/", ".")
            if mod not in _SKIP:
                return f"{mod}.{m.group(2)} (backward)"
    return name


_KIND: dict = {}


def _kind(func) -> str:
    """"free" (no kernel), "composite" (may decompose into counted ops)
    or "op", once per overload."""
    packet = func._overloadpacket
    if packet in _FREE:
        return "free"
    # before the view test: ``to`` may alias its input, but decomposes
    # into ``_to_copy`` when it copies
    if packet not in flop_registry and func.namespace == "aten" and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
        return "composite"
    return "free" if func.is_view else "op"


class OpCost(TorchDispatchMode):
    """Tally every op by the device it runs on (``tallies``: device →
    ``Tally``). ``attribute=True`` also keeps, per (op, calling port
    function) and device, the bytes, flops and collective bytes
    (``attribute``)."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        self.tallies: dict = defaultdict(Tally)
        self._attr = defaultdict(lambda: [0.0, 0.0, 0.0, 0, 0.0]) \
            if attribute else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _KIND.get(func)
        if kind is None:
            kind = _KIND[func] = _kind(func)
        if kind == "composite":
            # an op with a composite form (inference mode passes
            # ``matmul`` and ``einsum`` here whole): count its parts, as
            # ``FlopCounterMode`` does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if kind == "free":
            return out
        packet = func._overloadpacket
        outs = _tensors(out)
        if not outs:            # a query (a size, a device): no kernel
            return out
        ins = _tensors((args, kwargs))
        dev = outs[0].device
        tally = self.tallies[dev]
        out_bytes = sum(_nbytes(t) for t in outs)
        coll = 0.0
        if packet in _COPIES:
            src = (args[1] if packet is _aten.copy_ else args[0]).device
            if src != dev:           # taken in from another position
                coll = float(out_bytes)
                tally.collective_bytes[
                    sharding.moving_kind() or "collective-permute"] += coll
                tally.bytes += out_bytes
                tally.launches += 1
                self._note(func, dev, out_bytes, 0.0, coll, False)
                return out
        tally.launches += 1
        in_bytes = sum(_nbytes(t) for t in ins)
        tally.bytes += in_bytes + out_bytes
        n_out = sum(t.numel() for t in outs)
        matmul = packet in flop_registry
        if matmul:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            tally.matmul_flops += f
        else:
            f = float(n_out)
        tally.flops += f
        if packet in _TRANSCENDENTAL:
            tally.transcendentals += n_out
        self._note(func, dev, in_bytes + out_bytes, f, 0.0, matmul)
        return out

    def _note(self, func, dev, nbytes, flops, coll, matmul) -> None:
        if self._attr is None:
            return
        a = self._attr[(str(func._overloadpacket), _caller(), dev)]
        a[0] += nbytes
        a[1] += flops
        a[2] += coll
        a[3] += 1
        a[4] += flops if matmul else 0.0

    def tally(self, device) -> Tally:
        """The counts of one device (zeros if nothing ran there)."""
        return self.tallies.get(torch.device(device), Tally())

    def attribute(self, device, top: int = 25, key: str = "bytes") -> list:
        """The ``top`` (op, caller) pairs on ``device`` by ``key`` ∈
        {"bytes", "flops", "coll"}: dicts of op, caller, bytes, flops
        (of which matmul flops), collective bytes and the number of
        calls."""
        if self._attr is None:
            raise ValueError("OpCost(attribute=True) keeps the attribution")
        col = {"bytes": 0, "flops": 1, "coll": 2}[key]
        dev = torch.device(device)
        rows = [(op, caller, v) for (op, caller, d), v in self._attr.items()
                if d == dev]
        rows.sort(key=lambda r: -r[2][col])
        return [{"op": op, "caller": caller, "bytes": v[0], "flops": v[1],
                 "matmul_flops": v[4], "collective_bytes": v[2],
                 "calls": v[3]}
                for op, caller, v in rows[:top]]


def most(tallies: dict) -> Optional[torch.device]:
    """The device with the most flops, then bytes (None if empty)."""
    if not tallies:
        return None
    return max(tallies, key=lambda d: (tallies[d].flops, tallies[d].bytes))
