"""A device mesh, the logical-axis rules, and the helpers that cut a
tensor into per-device slabs and gather them back (the port's
counterpart of ``repro.distributed.sharding``).

One process drives every device of the mesh (a single controller, as
the JAX package's ``shard_map`` over a ``Mesh`` does): the serving
executor (``kernels.ops.execute_int8_sharded``) launches each slab's
kernels on its own device's current stream and gathers the outputs onto
the mesh's first device. A mesh's entries may repeat a device: logical
devices laid over fewer physical ones (``launch.mesh``), so one card
runs every slab shape through the real kernels, one slab after another.

Gathering is the counterpart of ``all_gather(tiled=True)`` and
``pmax``: a copy to the mesh's first device, then ``torch.cat`` or a
maximum. A copy between two cards is enqueued on the current streams of
both, which PyTorch joins with events: no host synchronisation.

The LM half: ``pspec`` maps a tensor's logical axes to a
``PartitionSpec`` by the rules (divisibility-aware, with the JAX
package's ``_RESHARD_RETRY`` re-placement); ``NamedSharding`` pairs it
with a mesh; ``Sharded`` holds a tensor as its blocks under one, each
distinct block once, on the device of the first mesh position that
holds it (GSPMD's placement of a ``jax.Array``). ``Rows`` is how an LM
step runs a batch over a mesh: the batch cut over the data axes into
rows, each row's work on its own device, and a weight cut over "model"
multiplied block by block (``models.layers.linear``). The step installs
its ``Rows`` (``running``), as the JAX launcher installs its mesh with
``with mesh:``; the model code reads it (``rows``). A decode cache is
placed as the JAX package's ``_cache_pspec`` places it
(``cache_model_dim``, ``Rows.stitch_cache``), a row's blocks read and
written through ``CacheRow``. Rows run in lockstep threads where a
batch-global abs-max spans them (``Rows.lockstep_max``). For the dry
run (``launch.dryrun``) a ``Rows`` computes mesh position 0 alone
(``first_only``) and the copies between positions name the collective
they stand for (``moving``).

Not ported: ``shard_map_compat`` (JAX only).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

__all__ = ["Mesh", "Placed", "placed_or", "rules", "axis_extent",
           "data_axis_extent", "device_grid", "shard", "gather",
           "gather_max", "PartitionSpec", "P", "NamedSharding", "pspec",
           "named_sharding", "tree_shardings", "batch_pspec", "constrain",
           "Sharded", "place_tree", "gather_tree", "tree_blocks",
           "map_blocks", "from_blocks", "Rows", "running", "rows",
           "cache_model_dim", "CacheRow", "moving"]


class Mesh:
    """A named n-D array of ``torch.device``s: the counterpart of
    ``jax.sharding.Mesh``. ``devices`` is a (nested) sequence or object
    array of devices or device strings, ``axis_names`` one name per
    dimension. ``shape`` maps each axis name to its extent, in order, as
    the JAX mesh's does. Entries may repeat a device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            d = torch.device(d)
            # a bare "cuda" names card 0, as a tensor placed there reports
            self.devices[idx] = (torch.device("cuda", 0)
                                 if d.type == "cuda" and d.index is None
                                 else d)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """Where the full tensors live and the gathers land."""
        return self.devices.flat[0]

    def distinct(self) -> list:
        """The mesh's devices without repeats, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def cards(self) -> int:
        """Distinct CUDA devices the mesh spans."""
        return sum(1 for d in self.distinct() if d.type == "cuda")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices "
                f"{[str(d) for d in self.devices.flat]})")


def rules(fsdp: bool = False, multi_pod: bool = True,
          conv_tp: bool = False) -> dict:
    """Logical axis → mesh axis (None: replicated), as the JAX package's
    rules. The conv-serving axes: ``T``, the flattened batch·tile axis of
    the Winograd domain, shards over the data axes; ``cout``, the
    per-position GEMM's N axis, over ``model`` with ``conv_tp``; ``cin``
    and ``wino_pos`` (the n² positions) never shard. ``fsdp`` also
    shards ``embed`` over the data axes."""
    data_axes = ("pod", "data") if multi_pod else ("data",)
    r = {
        "batch": data_axes,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert_mlp": None,
        "experts": "model",
        "embed": None,
        "layers": None,
        "seq": None,
        "T": data_axes,
        "cout": "model" if conv_tp else None,
        "cin": None,
        "wino_pos": None,
        None: None,
    }
    if fsdp:
        r["embed"] = data_axes
    return r


def _names(axis) -> tuple:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_extent(mesh, name=None) -> int:
    """Devices along one mesh axis: ``name`` is an axis name, a tuple of
    names (the product of their extents) or None (1, replicated); an
    axis the mesh lacks has extent 1. Reads only ``mesh.shape``."""
    shape = dict(mesh.shape)
    n = 1
    for a in _names(name):
        n *= shape.get(a, 1)
    return n


def data_axis_extent(mesh, axis="data") -> int:
    """Devices along ``axis`` (a name or tuple of names); unlike
    ``axis_extent`` it raises ``KeyError`` on an axis the mesh lacks."""
    n = 1
    for a in _names(axis):
        n *= mesh.shape[a]
    return n


def _flat_index(mesh: Mesh, pos: tuple, names: tuple) -> int:
    """Row-major index of mesh position ``pos`` over the axes ``names``
    (those the mesh has)."""
    k = 0
    for a in names:
        if a in mesh.shape:
            i = mesh.axis_names.index(a)
            k = k * mesh.shape[a] + pos[i]
    return k


def device_grid(mesh: Mesh, data_axis="data", model_axis=None
                ) -> np.ndarray:
    """The (D_data, D_model) object array of devices a sharded call runs
    on: row a takes the a-th T slab, column b the b-th Cout shard (data
    axes flattened row-major, as ``shard_map`` splits a dimension over a
    tuple of axes). An axis named by neither holds replicas of the same
    work: only its index 0 computes."""
    d_names, m_names = _names(data_axis), _names(model_axis)
    dd, dm = axis_extent(mesh, d_names), axis_extent(mesh, m_names)
    grid = np.empty((dd, dm), dtype=object)
    for pos, dev in np.ndenumerate(mesh.devices):
        if any(pos[i] for i, a in enumerate(mesh.axis_names)
               if a not in d_names + m_names):
            continue
        grid[_flat_index(mesh, pos, d_names),
             _flat_index(mesh, pos, m_names)] = dev
    return grid


def shard(x: torch.Tensor, mesh, axis, dim: int) -> list:
    """``x`` cut along ``dim`` into ``axis_extent(mesh, axis)`` equal
    slabs, in mesh-index order, each contiguous (a kernel takes no
    strided view; one extent returns ``x`` itself). The extent must
    divide the dimension."""
    n = axis_extent(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of extent {x.shape[dim]} does "
                         f"not split into {n} equal slabs over the mesh "
                         f"axis {axis!r}")
    if n == 1:
        return [x]
    return [s.contiguous() for s in torch.split(x, x.shape[dim] // n, dim)]


def gather(parts: Sequence[torch.Tensor], mesh, dim: int) -> torch.Tensor:
    """``all_gather(tiled=True)``: the parts copied to the mesh's first
    device and concatenated along ``dim``, in order."""
    first = mesh.first
    if len(parts) == 1:
        return parts[0].to(first, non_blocking=True)
    return torch.cat([p.to(first, non_blocking=True) for p in parts], dim)


def gather_max(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """``pmax``: the elementwise maximum of the parts, on the mesh's first
    device. A max of maxima is the maximum over the whole, exactly."""
    first = mesh.first
    out = parts[0].to(first, non_blocking=True)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(first, non_blocking=True))
    return out


class Placed:
    """A logical tensor placed across a mesh (the counterpart of a
    ``jax.Array`` under a ``NamedSharding``): cut into equal contiguous
    blocks along ``dim`` over the mesh axis ``axis`` (None: whole, every
    device holding all of it), each block on every device whose mesh
    position takes it. A device that several positions repeat holds one
    copy of each block it takes; a block that is all of ``x`` on ``x``'s
    own device is ``x`` itself."""

    def __init__(self, x: torch.Tensor, mesh: Mesh, axis=None,
                 dim: int = 0):
        self.mesh, self.axis, self.dim = mesh, axis, dim
        self.shape, self.dtype = tuple(x.shape), x.dtype
        blocks = shard(x, mesh, axis, dim)
        names = _names(axis)
        self._local: dict = {}
        for pos, dev in np.ndenumerate(mesh.devices):
            k = _flat_index(mesh, pos, names)
            if (dev, k) not in self._local:
                self._local[(dev, k)] = blocks[k].to(dev)

    @property
    def blocks(self) -> int:
        return axis_extent(self.mesh, self.axis)

    def local(self, device: torch.device, k: int = 0) -> torch.Tensor:
        """Block ``k`` on ``device`` (raises where the mesh put none)."""
        try:
            return self._local[(torch.device(device), k)]
        except KeyError:
            raise KeyError(f"no block {k} of this tensor on {device}: "
                           f"placed over {self.mesh}") from None


def placed_or(x: Optional[torch.Tensor], mesh: Mesh, axis=None,
              dim: int = 0) -> Optional["Placed"]:
    """``x`` as placed across ``mesh``: itself when already placed there,
    else placed now (None stays None)."""
    if x is None or isinstance(x, Placed):
        if x is not None and x.mesh is not mesh:
            raise ValueError("a tensor placed over another mesh")
        return x
    return Placed(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# LM placement: partition specs, named shardings, sharded tensors
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names
    (the dimension cut over their product, row-major) or None (whole).
    As ``jax.sharding.PartitionSpec``, a list becomes a tuple and a tuple
    of one name that name."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a ``PartitionSpec`` over its axis names. As JAX's, it
    raises on an axis the mesh lacks or one that cuts two dimensions."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)
        seen = []
        for e in self.spec:
            for a in _names(e):
                if a not in mesh.shape:
                    raise ValueError(f"mesh axis {a!r} of {self.spec} is not "
                                     f"in the mesh {mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"mesh axis {a!r} cuts two dimensions "
                                     f"in {self.spec}")
                seen.append(a)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


# When a logical axis cannot take its mesh axis (the dim does not divide:
# qwen2-moe's 60 experts on a 16-way model axis), the freed mesh axis is
# retried on another dim of the same tensor, in this order.
_RESHARD_RETRY = ("expert_mlp", "mlp", "heads", "kv_heads", "vocab",
                  "embed")


def pspec(axes: tuple, rule_map: dict, shape: Optional[tuple] = None
          ) -> PartitionSpec:
    """The spec of one tensor from its logical ``axes`` and the rules;
    with ``shape``, a mesh axis (read from ``rule_map["__mesh_shape__"]``)
    that does not divide its dim is dropped and retried on another dim
    (``_RESHARD_RETRY``), as the JAX package's ``pspec``."""
    entries = [rule_map.get(a, None) for a in axes]
    if shape is None:
        return P(*entries)
    mesh_shape = rule_map.get("__mesh_shape__", {})

    def extent(e):
        n = 1
        for a in _names(e):
            n *= mesh_shape.get(a, 1)
        return n
    dropped = []
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is not None and d % extent(e) != 0:
            dropped.append(e)
            entries[i] = None
    for e in dropped:
        if isinstance(e, (tuple, list)):
            continue
        placed = False
        for name in _RESHARD_RETRY:
            for i, a in enumerate(axes):
                if a == name and entries[i] is None and \
                        shape[i] % extent(e) == 0 and e not in entries:
                    entries[i] = e
                    placed = True
                    break
            if placed:
                break
    return P(*entries)


def named_sharding(mesh: Mesh, axes: tuple, rule_map: dict,
                   shape: Optional[tuple] = None) -> NamedSharding:
    rm = dict(rule_map)
    rm["__mesh_shape__"] = dict(mesh.shape)
    return NamedSharding(mesh, pspec(axes, rm, shape))


def _tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of nested dicts alike."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def tree_shardings(mesh: Mesh, axes_tree, rule_map: dict,
                   abstract_tree=None):
    """A tree of ``NamedSharding``s congruent to a tree of logical-axes
    tuples; with ``abstract_tree`` (leaves with a ``.shape``, such as the
    ``ParamSpec``s) divisibility-aware, as JAX's."""
    if abstract_tree is None:
        return _tree_map2(lambda ax, _: named_sharding(mesh, ax, rule_map),
                          axes_tree, axes_tree)
    return _tree_map2(lambda ax, ab: named_sharding(mesh, ax, rule_map,
                                                    tuple(ab.shape)),
                      axes_tree, abstract_tree)


def batch_pspec(rule_map: dict) -> PartitionSpec:
    return P(rule_map["batch"])


def constrain(x: torch.Tensor, mesh: Mesh, *axes) -> "Sharded":
    """``x`` placed under ``P(*axes)`` over ``mesh`` (None: whole)."""
    return Sharded.place(x, NamedSharding(mesh, P(*axes)))


def _owners(sharding: NamedSharding, ndim: int) -> dict:
    """{block index: device}: per dim, the row-major index of a position
    over the dim's axes; each block owned by the first position (in mesh
    order) that holds it."""
    mesh = sharding.mesh
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    out: dict = {}
    for pos, dev in np.ndenumerate(mesh.devices):
        key = tuple(_flat_index(mesh, pos, _names(e)) for e in spec)
        out.setdefault(key, dev)
    return out


class Sharded:
    """A tensor held as blocks under a ``NamedSharding`` (the counterpart
    of a ``jax.Array`` placed by one): dim d cut into
    ``axis_extent(mesh, spec[d])`` equal blocks, each distinct block
    stored once, on its owner's device (``_owners``). Parameters, their
    moments and gradients, and decode caches of a sharded LM step are
    held so (a batch is whole tensors, cut into rows by ``Rows``).
    Copies and concatenations are differentiable: a gradient reaches
    each block through them."""

    def __init__(self, sharding: NamedSharding, shape: tuple,
                 blocks: dict):
        self.sharding, self.shape, self.blocks = sharding, tuple(shape), \
            blocks
        self.dtype = next(iter(blocks.values())).dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def counts(self) -> tuple:
        """Blocks along each dim."""
        spec = tuple(self.spec) + (None,) * (len(self.shape) -
                                              len(self.spec))
        return tuple(axis_extent(self.mesh, e) for e in spec)

    @property
    def model_dim(self) -> Optional[int]:
        """The dim cut over "model" into more than one block, if any."""
        for d, (e, n) in enumerate(zip(self.spec, self.counts())):
            if e == "model" and n > 1:
                return d
        return None

    def _slices(self, key) -> tuple:
        return tuple(slice(k * (s // n), (k + 1) * (s // n))
                     for k, s, n in zip(key, self.shape, self.counts()))

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding) -> "Sharded":
        """``x`` cut into its blocks, each copied to its owner (a leaf of
        one block on its owner's device is ``x`` itself)."""
        owners = _owners(sharding, x.dim())
        probe = cls(sharding, x.shape, {(): x})
        for d, (s, n) in enumerate(zip(x.shape, probe.counts())):
            if s % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not cut "
                                 f"into {n} blocks under {sharding.spec}")
        if len(owners) == 1:
            (key, dev), = owners.items()
            return cls(sharding, x.shape, {key: x.to(dev)})
        return cls(sharding, x.shape,
                   {k: x[probe._slices(k)].to(dev, copy=True)
                    for k, dev in owners.items()})

    def gather(self, device=None, at: Optional[tuple] = None
               ) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first);
        with ``at = (dim, k)`` only the k-th block along ``dim``, whole
        along the others."""
        dev = self.mesh.first if device is None else device
        n = self.counts()

        def build(prefix, d):
            if d == len(n):
                return self.blocks[prefix].to(dev)
            ks = [at[1]] if at is not None and at[0] == d else range(n[d])
            parts = [build(prefix + (k,), d + 1) for k in ks]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)
        return build((), 0)

    def tensors(self) -> list:
        """The stored blocks, in block-index order."""
        return [self.blocks[k] for k in sorted(self.blocks)]

    def with_tensors(self, ts) -> "Sharded":
        """This layout over other blocks (``tensors``' order)."""
        return Sharded(self.sharding, self.shape,
                       dict(zip(sorted(self.blocks), ts, strict=True)))

    def map(self, fn) -> "Sharded":
        """``fn`` on every block (elementwise maps: a new dtype at most)."""
        return self.with_tensors([fn(t) for t in self.tensors()])

    def unbind(self, dim: int = 0) -> list:
        """Slices along a whole leading dim (a stacked leaf's layers)."""
        if dim != 0 or self.counts()[0] != 1:
            raise ValueError("only a whole dim 0 unbinds")
        sub = NamedSharding(self.mesh, tuple(self.spec)[1:])
        parts = {k: b.unbind(0) for k, b in self.blocks.items()}
        return [Sharded(sub, self.shape[1:],
                        {k[1:]: p[i] for k, p in parts.items()})
                for i in range(self.shape[0])]

    @property
    def T(self) -> "Sharded":
        """The transpose of a 2-D tensor (blocks transposed in place)."""
        spec = tuple(self.spec) + (None,) * (2 - len(self.spec))
        return Sharded(NamedSharding(self.mesh, spec[::-1]), self.shape[::-1],
                       {k[::-1]: b.T for k, b in self.blocks.items()})

    @torch.no_grad()
    def assign_(self, whole: torch.Tensor) -> None:
        """Copy ``whole`` (any device) into the blocks, in place."""
        for k, b in self.blocks.items():
            b.copy_(whole[self._slices(k)])

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, {self.spec}, "
                f"{len(self.blocks)} blocks)")


def place_tree(tree, shardings):
    """Every leaf placed under its sharding (a None sharding, at a leaf
    or over a subtree, leaves it as it is)."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return Sharded.place(tree, shardings)


def gather_tree(tree, device=None):
    """Every ``Sharded`` leaf gathered whole on ``device`` (default: its
    mesh's first); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return tree.gather(device) if isinstance(tree, Sharded) else tree


# ---------------------------------------------------------------------------
# The rows of a batch over a mesh
# ---------------------------------------------------------------------------

class Rows:
    """How an LM step runs a batch over a mesh: the batch cut along dim 0
    over the data axes ``dp`` into R rows (``device_grid``: an axis that
    ``dp`` leaves out holds replicas, which do not compute); row r runs
    on ``grid[r, 0]`` and multiplies model block b of a weight at
    ``grid[r, b]``. ``r`` is the row now running (set by ``each``).
    Without a mesh: one row on the batch's own device, and every method
    is the identity."""

    def __init__(self, mesh: Optional[Mesh] = None, dp=None,
                 first_only: bool = False, lockstep: bool = False):
        self._thread = threading.local()
        self.mesh, self.dp, self.r = mesh, dp, 0
        self.grid = None if mesh is None else \
            device_grid(mesh, dp, "model")
        self.n = 1 if mesh is None else self.grid.shape[0]
        self.m = 1 if mesh is None else self.grid.shape[1]
        self.first_only = first_only
        self.lockstep = lockstep and self.n > 1 and not first_only

    @property
    def r(self) -> int:
        """The running row (of this thread, where rows run in lockstep)."""
        return getattr(self._thread, "r", 0)

    @r.setter
    def r(self, value: int) -> None:
        self._thread.r = value

    def lockstep_max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over every row, each row's ``t`` taken
        before any row goes on (``t`` itself outside a lockstep ``each``):
        a batch-global abs-max such as a per-tensor quantization scale.

        Two forms carry this contract, and neither can take the other's
        place. A fake-quantized linear (``layers.linear(q8=True)``) sits
        inside each row's attention and MLP: a form over every row's
        slab at once would split every layer at each of its linears, so
        its rows run in lockstep threads, and only where a config
        fake-quantizes its linears over several rows. The hybrid's
        quantized conv is one call between its layer's ``each`` calls,
        so it takes the rows' slabs as a list (``rglru._conv1d_rows``)
        and needs no threads: threads would run every hybrid step over
        a mesh, and the dry run, which walks one position in one thread
        under a dispatch mode, could not count its scales."""
        if not getattr(self._thread, "stepping", False):
            return t
        self._vals[self.r] = t
        self._barrier.wait()
        with moving("all-reduce"):
            out = self._vals[0]
            for v in self._vals[1:]:
                out = torch.maximum(out, v.to(out.device))
        self._barrier.wait()
        return out.to(t.device)

    def _each_lockstep(self, fn, params, lists) -> list:
        """``each`` with every row in a thread of its own, in lockstep at
        each ``lockstep_max``."""
        args = list(zip(*lists, strict=True))
        self._barrier = threading.Barrier(len(args))
        self._vals = [None] * len(args)
        grad, inference = torch.is_grad_enabled(), \
            torch.is_inference_mode_enabled()
        out, errors = [None] * len(args), []

        def run(r):
            self.r, self._thread.stepping = r, True
            dev = self.grid[r, 0]
            if dev.type == "cuda":      # the row's device, current here
                torch.cuda.set_device(dev)
            try:
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad):
                    out[r] = fn(self.local(params), *args[r])
            except BaseException as e:          # noqa: BLE001
                errors.append(e)
                self._barrier.abort()
        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(len(args))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors if not isinstance(
                e, threading.BrokenBarrierError)), errors[0])
        return out

    def device(self, b: int = 0) -> Optional[torch.device]:
        """Where the running row computes model block b (None: anywhere,
        the one-device case)."""
        return None if self.grid is None else self.grid[self.r, b]

    def _stand_in(self, out, dev, inputs=()):
        """With ``first_only`` (the dry run: only mesh position 0 computes,
        every position doing alike work), what another row or block would
        return: empty tensors shaped like position 0's ``out``, on ``dev``
        (a device, or a map from position 0's devices to this one's).
        Where a gradient is taken they hang on ``inputs``, the tensors the
        skipped work would have read, as they were before it moved them
        to its device: the backward then hands each a gradient from that
        device (``_StandIn``), which is what position 0 takes in from the
        skipped work."""
        flat = _flat_tensors(out)

        def where(t):
            return dev.get(t.device, dev.get(None)) if isinstance(
                dev, dict) else dev
        inputs = [t for t in inputs if isinstance(t, torch.Tensor)
                  and t.requires_grad]
        if torch.is_grad_enabled() and inputs:
            home = where(flat[0]) if flat else None
            made = list(_StandIn.apply(
                home, [(t.shape, t.dtype, where(t), t.requires_grad)
                       for t in flat], *inputs))
        else:
            made = [torch.empty_like(t, device=where(t)) for t in flat]
        it = iter(made)

        def build(o):
            if isinstance(o, torch.Tensor):
                return next(it)
            if isinstance(o, (list, tuple)):
                return type(o)(build(v) for v in o)
            if isinstance(o, dict):
                return {k: build(v) for k, v in o.items()}
            return o
        return build(out)

    def per_block(self, fn, m: int, inputs=None) -> list:
        """``fn(b, device)`` for model blocks b < m of the running row, each
        on the row's device of block b (with ``first_only``, block 0 only:
        the others stand in, hanging on ``inputs(b)``, the tensors block b
        reads before it moves them to its device)."""
        outs = [fn(0, self.device(0))]
        for b in range(1, m):
            dev = self.device(b)
            outs.append(self._stand_in(
                outs[0], dev, inputs(b) if inputs is not None else ())
                if self.first_only else fn(b, dev))
        return outs

    def split(self, t: torch.Tensor) -> list:
        """``t`` cut along dim 0 into the rows, each on its row's device."""
        if self.grid is None:
            return [t]
        if t.shape[0] % self.n:
            raise ValueError(f"{t.shape[0]} rows do not cut into {self.n}")
        parts = torch.split(t, t.shape[0] // self.n) if self.n > 1 else [t]
        return [p.to(self.grid[r, 0]) for r, p in enumerate(parts)]

    def join(self, parts: list, dim: int = 0) -> torch.Tensor:
        """The rows' parts concatenated on row 0's device."""
        if len(parts) == 1:
            return parts[0]
        home = parts[0].device
        with moving("all-gather"):
            return torch.cat([p.to(home) for p in parts], dim)

    def stitch_cache(self, name: str, parts: list,
                     dim: Optional[int] = None):
        """The rows' parts of decode-cache leaf ``name`` (batch dim 1) as
        the cache is placed (``_cache_pspec`` of ``launch.steps``): a
        ``Sharded`` whose (row r, block b) block lies on ``grid[r, b]``,
        cut along ``cache_model_dim``. A part is a whole tensor (cut here)
        or a list of its model blocks along ``dim`` (each where it lies).
        Without a mesh: part 0 itself."""
        if self.grid is None:
            return parts[0][0] if isinstance(parts[0], list) else parts[0]
        if isinstance(parts[0], list):      # blocks along ``dim``
            shape, d = list(parts[0][0].shape), dim
            shape[d] *= len(parts[0])
        else:
            shape = list(parts[0].shape)
            d = cache_model_dim(name, shape, self.m)
        shape[1] *= len(parts)
        spec = [None] * len(shape)
        spec[1] = self.dp
        if d is not None:
            spec[d] = "model"
        blocks = {}
        for r, part in enumerate(parts):
            if not isinstance(part, list):
                if d is None or self.m == 1:
                    part = [part]
                else:
                    s = part.shape[d] // self.m
                    part = [part.narrow(d, b * s, s).contiguous().to(
                        self.grid[r, b]) for b in range(self.m)]
            for b, t in enumerate(part):
                blocks[tuple(r if i == 1 else b if i == d else 0
                             for i in range(len(shape)))] = t
        return Sharded(NamedSharding(self.mesh, spec), shape, blocks)

    def cache_rows(self, cache: dict) -> list:
        """A decode cache (placed by ``stitch_cache``) as one dict a row of
        ``CacheRow``s, each holding the row's blocks where they lie."""
        if self.grid is None:
            return [{name: CacheRow([t], None) for name, t in cache.items()}]
        out = [{} for _ in range(self.n)]
        for name, t in cache.items():
            if not isinstance(t, Sharded) or t.counts()[1] != self.n:
                raise ValueError(f"cache leaf {name!r} is not cut into "
                                 f"{self.n} rows along dim 1")
            d = t.model_dim
            m = 1 if d is None else t.counts()[d]
            for r in range(self.n):
                out[r][name] = CacheRow(
                    [t.blocks[tuple(r if i == 1 else b if i == d else 0
                                    for i in range(len(t.shape)))]
                     for b in range(m)], d)
        return out

    def local(self, tree):
        """The running row's view of a parameter tree: a leaf cut over
        "model" stays ``Sharded`` (its products run per block), any other
        ``Sharded`` leaf is gathered whole on the row's device."""
        if isinstance(tree, dict):
            return {k: self.local(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.local(v) for v in tree)
        if isinstance(tree, Sharded) and tree.model_dim is None:
            return tree.gather(self.device())
        return tree

    def each(self, fn, params, *lists) -> list:
        """``fn(local params, *row args)`` for every row in order, with
        ``r`` set to it."""
        if self.lockstep:
            if _get_current_dispatch_mode() is not None:
                raise ValueError("rows in lockstep run in threads, which "
                                 "a dispatch mode does not reach")
            return self._each_lockstep(fn, params, lists)
        out, used = [], None
        try:
            for r, args in enumerate(zip(*lists, strict=True)):
                self.r = r
                if r and self.first_only:
                    where = dict(zip(self.grid[0], self.grid[r]))
                    where[None] = self.grid[r, 0]
                    if used is None:
                        used = _inputs_reached(out[0], first, local,
                                               self.grid[0, 0]) \
                            if torch.is_grad_enabled() else []
                    out.append(self._stand_in(
                        out[0], where, _flat_tensors(args) + used))
                else:
                    local, first = self.local(params), args
                    out.append(fn(local, *args))
        finally:
            self.r = 0
        return out


def _flat_tensors(tree) -> list:
    """The tensors of a tree of lists, tuples and dicts (a ``Sharded``
    leaf's blocks), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Sharded):
        return tree.tensors()
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat_tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    return []


def _inputs_reached(out, args, local, home) -> list:
    """The tensors of row 0's parameter view ``local`` on ``home``
    (position 0's device: the blocks it owns, which every other row
    gathers) that row 0's ``out`` depends on, short of its own ``args``:
    what every other row takes from position 0 and so sends a gradient
    back to."""
    cands = {}
    for t in _flat_tensors(local):
        if t.requires_grad and t.device == home:
            cands[(t.grad_fn, t.output_nr) if t.grad_fn is not None
                  else ("leaf", id(t))] = t
    stop = {t.grad_fn for t in _flat_tensors(args) if t.grad_fn is not None}
    seen, found = set(), {}
    todo = [t.grad_fn for t in _flat_tensors(out) if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        for nxt, nr in node.next_functions:
            if nxt is None:
                continue
            var = getattr(nxt, "variable", None)
            key = ("leaf", id(var)) if var is not None else (nxt, nr)
            if key in cands:
                found[key] = cands[key]
            elif var is None:
                todo.append(nxt)
    return list(found.values())


class _StandIn(torch.autograd.Function):
    """Empty outputs (``specs``: shape, dtype, device and whether it takes
    a gradient, each) that depend on ``inputs``: the backward hands each
    input a gradient made on ``dev`` and copied to the input's device, as
    the skipped work's backward would."""

    @staticmethod
    def forward(ctx, dev, specs, *inputs):
        ctx.dev = dev
        ctx.meta = [(t.shape, t.dtype, t.device) for t in inputs]
        # a saved tensor, as the skipped work saves some: a checkpointed
        # function's recomputation then runs as far as the work it skips
        # would make it run (non-reentrant checkpoint stops early)
        ctx.save_for_backward(inputs[0])
        outs = tuple(torch.empty(shape, dtype=dt, device=d)
                     for shape, dt, d, _ in specs)
        ctx.mark_non_differentiable(*[o for o, (*_, grad) in zip(outs, specs)
                                      if not grad])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        return (None, None) + tuple(
            torch.empty(shape, dtype=dt, device=ctx.dev).to(d)
            if need else None
            for (shape, dt, d), need in zip(ctx.meta,
                                            ctx.needs_input_grad[2:]))


def cache_model_dim(name: str, shape, msize: int) -> Optional[int]:
    """The dim of decode-cache leaf ``name`` cut over a model axis of
    ``msize``, as the JAX package's ``_cache_pspec`` cuts it (None: the
    leaf stays whole over "model"): k/v (L, B, S, Hkv, dh) by KV head,
    else by head dim; RWKV's state S (L, B, H, dk, dv) by head; any other
    leaf of 3 or more dims along its trailing channels; each where it
    divides."""
    nd = len(shape)
    if name in ("k", "v") and nd == 5:
        return 3 if shape[3] % msize == 0 else \
            4 if shape[4] % msize == 0 else None
    if name == "S" and nd == 5:
        return 2 if shape[2] % msize == 0 else None
    if nd >= 3 and shape[-1] % msize == 0:
        return nd - 1
    return None


class CacheRow:
    """One row's part of a decode-cache leaf: its blocks along the dim cut
    over "model" (``dim``; None: one block), each on its block's device.
    Indexing takes a layer (dim 0) of every block."""

    def __init__(self, parts: list, dim: Optional[int]):
        self.parts, self.dim = parts, dim

    def __getitem__(self, i) -> "CacheRow":
        return CacheRow([p[i] for p in self.parts],
                        None if self.dim is None else self.dim - 1)

    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0].shape)
        if self.dim is not None:
            shape[self.dim] *= len(self.parts)
        return tuple(shape)

    def whole(self) -> torch.Tensor:
        """The row's leaf on block 0's device (block 0 itself when it is
        all of it: writes to it land in the cache)."""
        if len(self.parts) == 1:
            return self.parts[0]
        home = self.parts[0].device
        with moving("all-gather"):
            return torch.cat([p.to(home) for p in self.parts], self.dim)

    def write(self, value: torch.Tensor) -> None:
        """Copy ``value`` (the whole leaf of the row) into the blocks."""
        if len(self.parts) == 1:
            self.parts[0].copy_(value)
            return
        s = self.parts[0].shape[self.dim]
        for b, p in enumerate(self.parts):
            p.copy_(value.narrow(self.dim, b * s, s).to(p.device))


_MOVING = threading.local()


@contextlib.contextmanager
def moving(kind: str):
    """Name the copies between mesh positions made inside by the kind of
    collective they stand for ("all-gather", "all-reduce",
    "reduce-scatter", "all-to-all"; a copy outside any is a
    "collective-permute"), in this thread. Only the dry run's cost
    counter (``analysis.op_cost``) reads it."""
    kinds = _MOVING.__dict__.setdefault("kinds", [])
    kinds.append(kind)
    try:
        yield
    finally:
        kinds.pop()


def moving_kind() -> Optional[str]:
    """The innermost ``moving`` kind of this thread (None outside one)."""
    kinds = getattr(_MOVING, "kinds", None)
    return kinds[-1] if kinds else None


_ONE_ROW = Rows()
_RUNNING: list = []


def rows() -> Rows:
    """The rows installed by the running step (one row without one)."""
    return _RUNNING[-1] if _RUNNING else _ONE_ROW


@contextlib.contextmanager
def running(r: Rows):
    """Install ``r`` for the model code inside (autograd's backward and
    the recomputation of checkpointed layers included)."""
    _RUNNING.append(r)
    try:
        yield r
    finally:
        _RUNNING.pop()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def tree_blocks(tree) -> list:
    """Every stored tensor of a tree, in leaf order (sorted keys): a
    ``Sharded`` leaf's blocks in block order, a tensor leaf itself. Each
    distinct block appears once."""
    return [t for x in _leaves(tree)
            for t in (x.tensors() if isinstance(x, Sharded) else [x])]


def map_blocks(fn, tree):
    """``fn`` over every stored tensor (``tree_blocks``' order); a
    ``Sharded`` leaf keeps its layout."""
    if isinstance(tree, dict):
        return {k: map_blocks(fn, tree[k]) for k in sorted(tree)}
    return tree.map(fn) if isinstance(tree, Sharded) else fn(tree)


def from_blocks(tree, tensors):
    """A tree laid out as ``tree`` over other tensors (``tree_blocks``'
    order; an iterator is consumed as far as the tree reaches)."""
    it = iter(tensors)

    def rebuild(x):
        if isinstance(x, dict):
            return {k: rebuild(x[k]) for k in sorted(x)}
        if isinstance(x, Sharded):
            return x.with_tensors([next(it) for _ in x.blocks])
        return next(it)
    return rebuild(tree)
