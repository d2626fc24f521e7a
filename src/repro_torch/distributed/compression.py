"""int8 gradient compression for the cross-pod mean, with error feedback
(the port's counterpart of ``repro.distributed.compression``).

Each pod's gradient leaf is quantized to int8 and one fp32 scale; the
int8 payloads travel around a ring over the "pod" axis of the mesh and
each pod sums the dequantized payloads in fp32, in the ring's order: its
own, then pod i−1's, then i−2's, and so on (the JAX package's
``ppermute`` by one each step). The quantization residual is kept as
error feedback and added to the next step's gradient.

One process drives every pod here, so the ring's ``ppermute`` is a copy
to the next pod's device. A pod's gradients are plain tensors on its
device (the mesh's device at that pod and index 0 of every other axis).
As in the JAX package, no launcher wires this in:
``RunConfig.grad_compression`` stays unused.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import divide
from repro_torch.models.param import tree_leaves, tree_map

__all__ = ["compress_leaf", "decompress_leaf", "compressed_grad_mean",
           "init_error_state", "pod_devices"]


def compress_leaf(g: torch.Tensor, bits: int = 8):
    """(int8 q, fp32 scale, residual g − q·scale) of one leaf; the scale
    is abs-max / qmax, divided on ``g``'s device (never by the reciprocal
    of a host number)."""
    qm = 2 ** (bits - 1) - 1
    scale = divide(torch.clamp_min(g.abs().amax(), 1e-12), qm)
    q = torch.clamp(torch.round(g / scale), -qm, qm).to(torch.int8)
    err = g - q.to(g.dtype) * scale.to(g.dtype)
    return q, scale, err


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def pod_devices(mesh) -> list:
    """The device of each pod: the mesh's device at that pod and index 0
    of every other axis (one pod, the mesh's first, without a "pod"
    axis)."""
    if "pod" not in mesh.axis_names:
        return [mesh.first]
    i = mesh.axis_names.index("pod")
    return [mesh.devices[tuple(p if a == i else 0
                               for a in range(mesh.devices.ndim))]
            for p in range(mesh.shape["pod"])]


def compressed_grad_mean(grads: list, err_state: list, mesh) -> tuple:
    """The compressed mean over the pod axis, error feedback included.

    ``grads`` and ``err_state``: one tree a pod (``pod_devices`` order),
    its tensors on that pod's device. Returns (one tree of global-mean
    gradients a pod, in each leaf's dtype; one tree of fp32 residuals a
    pod)."""
    devs = pod_devices(mesh)
    n = len(devs)
    if len(grads) != n or len(err_state) != n:
        raise ValueError(f"{len(grads)} gradient and {len(err_state)} "
                         f"error trees for {n} pods")
    leaves = [tree_leaves(g) for g in grads]
    errs = [tree_leaves(e) for e in err_state]
    outs = [[] for _ in range(n)]
    new_errs = [[] for _ in range(n)]
    for j in range(len(leaves[0])):
        packs = []
        for i in range(n):
            gf = leaves[i][j].float() + errs[i][j]
            q, s, err = compress_leaf(gf)
            packs.append((q, s))
            new_errs[i].append(err)
        for i in range(n):
            total = decompress_leaf(*packs[i])
            for step in range(1, n):
                q, s = packs[(i - step) % n]
                total = total + decompress_leaf(q.to(devs[i]), s.to(devs[i]))
            outs[i].append(divide(total, n).to(leaves[i][j].dtype))
    it = [iter(o) for o in outs]
    ie = [iter(e) for e in new_errs]
    return ([tree_map(lambda _: next(it[i]), grads[i]) for i in range(n)],
            [tree_map(lambda _: next(ie[i]), grads[i]) for i in range(n)])


def init_error_state(params: dict) -> dict:
    """fp32 zeros like every leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
