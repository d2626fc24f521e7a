"""One CUDA graph per serving geometry: the port's counterpart of the JAX
package's one compiled program per bucket.

``GraphedForward`` wraps an eager forward (images → outputs). The first
call at a new input shape runs the forward eagerly once, which builds any
kernel library and the lazily made operand tables on the device, then
captures it into a CUDA graph over a static input buffer; every later
call copies its input into that buffer and replays the graph. A replay
runs no Python between the kernels, so a served batch costs the device
time of its kernels plus one launch.

Contracts:

* ``captures`` counts the graphs captured (the counterpart of a jit
  cache's size): the serving loop asserts it does not grow after
  warm-up. A capture that fails raises; nothing serves eagerly behind
  the caller's back.
* The output of a call is the graph's static output buffer: the next
  call at the same shape overwrites it. Copy the rows out, on the same
  stream, before that call is enqueued (``serving.loop`` does).
* ``_build.LAUNCHES`` counts Python-side launches, so a replay adds
  none: ``launches_per_capture[shape]`` holds the launches recorded into
  that shape's graph and ``replays[shape]`` the replays since, whose
  product is the launches the replays ran.

On the CPU there are no graphs: the forward runs eagerly at every call
and ``captures`` stays 0.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import _build

__all__ = ["GraphedForward"]


class GraphedForward:
    """A serving forward with one CUDA graph per input shape (see the
    module docstring). ``fn``: the eager forward; ``device``: where it
    runs."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], device):
        self.fn = fn
        self.device = torch.device(device)
        self.captures = 0
        self.launches_per_capture: dict[tuple, dict] = {}
        self.replays: dict[tuple, int] = {}
        self._graphs: dict[tuple, tuple] = {}

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.fn(x)
        key = tuple(x.shape)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(x)
        graph, static_in, static_out = entry
        static_in.copy_(x, non_blocking=True)
        graph.replay()
        self.replays[key] += 1
        return static_out

    def _capture(self, x: torch.Tensor) -> tuple:
        key = tuple(x.shape)
        static_in = torch.empty_like(x, device=self.device)
        static_in.copy_(x)
        # Eagerly first: kernel builds, operand tables and cuDNN plans
        # must exist before capture, which forbids their host syncs.
        self.fn(static_in)
        torch.cuda.synchronize(self.device)
        before = dict(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                static_out = self.fn(static_in)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the serving forward "
                               f"at input shape {key} failed: {e}") from e
        self.launches_per_capture[key] = {
            k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
            if v != before.get(k, 0)}
        self.replays[key] = 0
        self.captures += 1
        return graph, static_in, static_out
