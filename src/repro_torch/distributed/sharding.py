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

Not ported: ``shard_map_compat`` (JAX only); the LM parameter
placement (``pspec``, ``tree_shardings``, ``constrain``) comes with the
LM substrate.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "Placed", "placed_or", "rules", "axis_extent",
           "data_axis_extent", "device_grid", "shard", "gather",
           "gather_max"]


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
