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
``with mesh:``; the model code reads it (``rows``).

Not ported: ``shard_map_compat`` (JAX only).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "Placed", "placed_or", "rules", "axis_extent",
           "data_axis_extent", "device_grid", "shard", "gather",
           "gather_max", "PartitionSpec", "P", "NamedSharding", "pspec",
           "named_sharding", "tree_shardings", "batch_pspec", "constrain",
           "Sharded", "place_tree", "gather_tree", "tree_blocks",
           "map_blocks", "from_blocks", "Rows", "running", "rows"]


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

    def __init__(self, mesh: Optional[Mesh] = None, dp=None):
        self.mesh, self.dp, self.r = mesh, dp, 0
        self.grid = None if mesh is None else \
            device_grid(mesh, dp, "model")
        self.n = 1 if mesh is None else self.grid.shape[0]

    def device(self, b: int = 0) -> Optional[torch.device]:
        """Where the running row computes model block b (None: anywhere,
        the one-device case)."""
        return None if self.grid is None else self.grid[self.r, b]

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
        return torch.cat([p.to(home) for p in parts], dim)

    def stitch(self, parts: list, dim: int):
        """The rows' parts as one tensor cut along ``dim`` over the data
        axes: a ``Sharded`` whose row-r block is part r, where it lies
        (part 0 itself without a mesh)."""
        if self.grid is None:
            return parts[0]
        shape = list(parts[0].shape)
        shape[dim] *= len(parts)
        spec = [None] * len(shape)
        spec[dim] = self.dp
        return Sharded(NamedSharding(self.mesh, spec), shape,
                       {tuple(r if d == dim else 0 for d in range(len(shape))):
                        p for r, p in enumerate(parts)})

    def cache_rows(self, cache: dict, dim: int = 1) -> list:
        """A decode cache (leaves cut along ``dim`` by ``stitch``) as one
        dict of its blocks a row, each on its row's device."""
        if self.grid is None:
            return [cache]
        out = [{} for _ in range(self.n)]
        for name, t in cache.items():
            if not isinstance(t, Sharded) or t.counts()[dim] != self.n:
                raise ValueError(f"cache leaf {name!r} is not cut into "
                                 f"{self.n} rows along dim {dim}")
            for r in range(self.n):
                out[r][name] = t.blocks[tuple(r if d == dim else 0
                                              for d in range(len(t.shape)))]
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
        out = []
        try:
            for r, args in enumerate(zip(*lists, strict=True)):
                self.r = r
                out.append(fn(self.local(params), *args))
        finally:
            self.r = 0
        return out


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
