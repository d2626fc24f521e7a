"""The serving mesh of the launchers (the port's counterpart of
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

Not ported yet (they come with the LM substrate): ``make_mesh_for``,
``make_production_mesh``, ``make_host_mesh``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["logical_devices", "make_serving_mesh"]


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
    pool = logical_devices(device, host_devices)
    need = data * model
    if need > len(pool):
        what = (f"--host-devices {host_devices} gives {len(pool)}"
                if host_devices > 0 else
                f"this machine has {len(pool)} {pool[0].type} device(s); "
                f"pass --host-devices N to lay N logical devices over them")
        raise ValueError(f"a {data}×{model} mesh needs {need} devices: "
                         f"{what}")
    devs = np.empty(need, dtype=object)
    devs[:] = pool[:need]
    if model > 1:
        return Mesh(devs.reshape(data, model), ("data", "model"))
    return Mesh(devs, ("data",))
