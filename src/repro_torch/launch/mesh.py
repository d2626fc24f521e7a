"""The meshes of the launchers (the port's counterpart of
``repro.launch.mesh``).

``make_serving_mesh(data, model)`` takes distinct CUDA cards when there
are enough. ``host_devices=N`` (the launchers' ``--host-devices N``)
lays N logical devices over the physical ones instead: ``cuda:i mod
count``, or the CPU N times; this is the counterpart of the JAX
package's forced host device count, without a re-exec, and lets one
card run every slab shape of a larger mesh through the real kernels.
Asking for more devices than exist, without ``host_devices``, raises:
the port does not hide the device count. A mesh over ``cuda`` without a
card raises.

The LM meshes, as the JAX package's: ``make_mesh_for`` factors any
device count into (pods ×) data × model with the model axis at the
per-pod TP degree; ``make_production_mesh`` is the (16, 16) pod or the
(2, 16, 16) pair of pods; ``make_host_mesh`` the (n, 1) data × model
mesh of whatever this host has. Each is built over ``logical_devices``,
so 256 or 512 logical entries stand for a production mesh on one card
(or the CPU) given ``host_devices``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["logical_devices", "make_serving_mesh", "make_mesh_for",
           "make_production_mesh", "make_host_mesh"]


def logical_devices(device="cuda", host_devices: int = 0) -> list:
    """The devices a mesh may take: every card (or the one CPU), or with
    ``host_devices`` that many logical devices laid over them."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        physical = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    else:
        physical = [torch.device(dev.type)]
    if host_devices > 0:
        return [physical[i % len(physical)] for i in range(host_devices)]
    return physical


def make_serving_mesh(data: int, model: int = 1, *, host_devices: int = 0,
                      device="cuda") -> Mesh:
    """A ``data`` × ``model`` serving mesh: axes ("data", "model") where
    ``model`` > 1, else the data-only ("data",) mesh, as the JAX
    launcher builds them."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got {data}×{model}")
    if model > 1:
        return _mesh((data, model), ("data", "model"), device, host_devices)
    return _mesh((data,), ("data",), device, host_devices,
                 f"{data}×{model}")


def _mesh(shape: tuple, axes: tuple, device, host_devices: int,
          label: str = "") -> Mesh:
    """A mesh of ``shape`` over the first devices of
    ``logical_devices(device, host_devices)``; raises if there are too
    few."""
    pool = logical_devices(device, host_devices)
    need = int(np.prod(shape))
    if need > len(pool):
        what = (f"--host-devices {host_devices} gives {len(pool)}"
                if host_devices > 0 else
                f"this machine has {len(pool)} {pool[0].type} device(s); "
                f"pass --host-devices N to lay N logical devices over them")
        label = label or "×".join(map(str, shape))
        raise ValueError(f"a {label} mesh needs {need} devices: {what}")
    devs = np.empty(need, dtype=object)
    devs[:] = pool[:need]
    return Mesh(devs.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         host_devices: int = 0) -> Mesh:
    """The (16, 16) data × model pod, or (2, 16, 16) pod × data × model."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device,
                     host_devices)
    return _mesh((16, 16), ("data", "model"), device, host_devices)


def make_mesh_for(n_devices: int, model_parallel: int = 16,
                  chips_per_pod: int = 256, *, device="cuda",
                  host_devices: int = 0) -> Mesh:
    """The elastic mesh for ``n_devices``: (data, model) within a pod,
    (pods, data, model) past it, the model axis at ``model_parallel``
    (all of ``n_devices`` when fewer), as the JAX package factors it."""
    if n_devices <= chips_per_pod:
        data = n_devices // model_parallel
        if data == 0:
            return _mesh((1, n_devices), ("data", "model"), device,
                         host_devices)
        return _mesh((data, model_parallel), ("data", "model"), device,
                     host_devices)
    pods = n_devices // chips_per_pod
    data = chips_per_pod // model_parallel
    return _mesh((pods, data, model_parallel), ("pod", "data", "model"),
                 device, host_devices)


def make_host_mesh(device="cuda") -> Mesh:
    """Every device this host has (the cards, or the CPU): (n, 1) data ×
    model."""
    n = len(logical_devices(device))
    return _mesh((n, 1), ("data", "model"), device, 0)
