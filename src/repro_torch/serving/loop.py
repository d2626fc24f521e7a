"""Continuous-batching serving loop: an online request queue over a
bucketed, graph-captured forward (the port's counterpart of
``repro.serving.loop``).

One dispatcher thread, a depth-2 pipeline:

    clients ──submit()──▶ FIFO queue ──coalesce──▶ bucket-pad ──▶
        pinned copy to the card + graph replay + rows copied out into
        pinned memory (all enqueued on one stream) ──▶ pending ring ──▶
        event wait → rows → complete futures

* **Coalescing** — the dispatcher takes the oldest waiting request and
  keeps pulling until ``max(buckets)`` requests are in hand or
  ``max_wait_ms`` has passed since the batch opened.
* **Bucketing** — the batch is zero-padded up to the smallest registered
  bucket (``serving.buckets``), so every dispatch replays a CUDA graph
  captured at start-up: no capture and no kernel build on the hot path
  (``compiles_after_warmup`` counts both).
* **Double buffering** — the copy in, the replay and the copy out are
  enqueued without waiting, so the loop forms and enqueues batch k+1
  while batch k runs, and only then waits on k's event. A replay writes
  its graph's one static output buffer, so each batch's rows are copied
  out into their own pinned buffer on the same stream before any later
  replay is enqueued; delivery waits on the event recorded after that
  copy. When the queue goes idle the pending batch is delivered at once.
* **Ordering** — one FIFO dispatcher forms and delivers batches in
  arrival order, so completion is in submission order, per client too.
* **Drain** — ``shutdown(drain=True)`` stops intake, flushes the queue
  and the pending ring, completes every future and joins the thread.

The loop is model-agnostic: ``forward`` maps a ``(B, *input_shape)``
tensor on the loop's device to per-row outputs (rows independent: the
padded-parity contract).
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.serving.buckets import (DEFAULT_BUCKETS, bucket_for,
                                         device_put, pad_batch, to_numpy,
                                         validate_buckets)

__all__ = ["ServeConfig", "ServingLoop", "RequestRecord", "BatchRecord",
           "capture_count"]


def capture_count(fn) -> Optional[int]:
    """CUDA graphs a ``serving.graphs.GraphedForward`` has captured, or
    None for another callable: the instrumentation behind the
    no-capture-after-warm-up contract."""
    n = getattr(fn, "captures", None)
    return None if n is None else int(n)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the online loop (see the module docstring)."""
    buckets: tuple = DEFAULT_BUCKETS
    max_wait_ms: float = 2.0     # partial-batch flush deadline
    pipeline_depth: int = 2      # in-flight batches (2 = double buffer)
    poll_ms: float = 20.0        # idle wakeup for drain/shutdown checks

    def __post_init__(self):
        object.__setattr__(self, "buckets",
                           validate_buckets(self.buckets))
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]


@dataclasses.dataclass
class RequestRecord:
    """Per-request accounting, appended at delivery."""
    rid: int
    client: Optional[str]
    t_submit: float
    t_dispatch: float
    t_done: float
    batch_n: int                 # real requests in the dispatched batch
    bucket: int                  # geometry it was padded into

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class BatchRecord:
    """Per-dispatch accounting (padding, service time) and the requests
    it held, in row order."""
    n: int
    bucket: int
    t_open: float                # first request dequeued
    t_dispatch: float
    t_done: float
    rids: tuple = ()


@dataclasses.dataclass
class _Request:
    rid: int
    client: Optional[str]
    x: np.ndarray
    future: Future
    t_submit: float


@dataclasses.dataclass
class _InFlight:
    requests: list
    rows: object                 # host rows (pinned tensor or ndarray)
    ready: Optional[torch.cuda.Event]   # recorded after the copy out
    t_open: float
    t_dispatch: float
    bucket: int


_SENTINEL = object()


class ServingLoop:
    """Request-level continuous batching over a bucketed forward.

    ``forward``: callable ``(B, *input_shape) -> (B, ...)``;
    ``input_shape``: one request's shape (one request = one row);
    ``engine``: optional ``ConvEngine`` — ``start()`` then warms the
    buckets through ``engine.warmup`` and dispatches to its device;
    ``device``: where batches go without an engine (the CPU when None).
    """

    def __init__(self, forward, input_shape: Sequence[int],
                 config: ServeConfig = ServeConfig(), engine=None,
                 device=None):
        self.forward = forward
        self.input_shape = tuple(int(d) for d in input_shape)
        self.config = config
        self.engine = engine
        if device is None:
            device = engine.device if engine is not None else "cpu"
        self.device = torch.device(device)
        self.records: list[RequestRecord] = []
        self.batches: list[BatchRecord] = []
        self.warmup_times: dict = {}
        self._queue: _queue.Queue = _queue.Queue()
        self._pending: list[_InFlight] = []
        self._thread: Optional[threading.Thread] = None
        self._accepting = False
        self._stopping = False
        self._lock = threading.Lock()
        self._next_rid = 0
        self._outstanding = 0        # accepted but not yet delivered
        self._warm: Optional[tuple] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, warmup: bool = True) -> "ServingLoop":
        """Warm every bucket geometry, then start the dispatcher."""
        if self._thread is not None:
            raise RuntimeError("loop already started")
        if warmup:
            geoms = [(b, *self.input_shape) for b in self.config.buckets]
            if self.engine is not None:
                self.warmup_times = self.engine.warmup(geoms, self.forward)
            else:
                for g in geoms:
                    # to_numpy copies the output to the host, which waits
                    # for the device: the window ends after its work
                    t0 = time.perf_counter()
                    to_numpy(self.forward(device_put(
                        np.zeros(g, np.float32), self.device)))
                    self.warmup_times[g] = time.perf_counter() - t0  # lint: waive=unsynced-timing,cuda-unsynced-timing
        self._warm = (capture_count(self.forward), len(_build.BUILDS))
        self._accepting = True
        self._thread = threading.Thread(target=self._run,
                                        name="serving-loop", daemon=True)
        self._thread.start()
        return self

    @property
    def compiles_after_warmup(self) -> Optional[int]:
        """CUDA graphs captured and kernel libraries built since
        ``start()`` — 0 is the contract (every serving geometry was
        captured at warm-up); None when ``forward`` captures no graphs
        (not a ``GraphedForward``)."""
        cur = capture_count(self.forward)
        if cur is None or self._warm is None or self._warm[0] is None:
            return None
        return (cur - self._warm[0]) + (len(_build.BUILDS) - self._warm[1])

    def submit(self, x: np.ndarray, client: Optional[str] = None) -> Future:
        """Enqueue one request (shape ``input_shape``); the Future
        (its ``rid`` the request's id) resolves to that request's output
        row, sliced out of whatever bucket it was served in."""
        x = np.asarray(x)
        if x.shape != self.input_shape:
            raise ValueError(f"request shape {x.shape} != registered "
                             f"input shape {self.input_shape}")
        if not self._accepting:
            raise RuntimeError("serving loop is not accepting requests "
                               "(not started, or shut down)")
        fut: Future = Future()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._outstanding += 1
        fut.rid = rid
        self._queue.put(_Request(rid, client, x, fut, time.perf_counter()))
        return fut

    def drain(self, timeout: Optional[float] = None):
        """Block until every accepted request has been delivered."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._outstanding > 0:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("drain timed out")
            time.sleep(self.config.poll_ms / 1e3)

    def shutdown(self, drain: bool = True):
        """Stop intake; flush (``drain=True``) or abandon the queue."""
        self._accepting = False
        if self._thread is None:
            return
        if not drain:
            self._stopping = True
        self._queue.put(_SENTINEL)
        self._thread.join()
        self._thread = None

    # -- dispatcher ---------------------------------------------------------

    def _run(self):
        cfg = self.config
        poll_s = cfg.poll_ms / 1e3
        while True:
            # Deliver when the pipeline is full, or when there is nothing
            # new to coalesce (an idle tail never waits for a successor).
            if self._pending and (len(self._pending) >= cfg.pipeline_depth
                                  or self._queue.empty()):
                self._deliver(self._pending.pop(0))
                continue
            try:
                item = self._queue.get(timeout=poll_s)
            except _queue.Empty:
                if self._stopping and not self._pending:
                    return
                continue
            if item is _SENTINEL:
                self._stopping = True     # flush queue + pending, then exit
                continue
            self._dispatch(*self._coalesce(item))

    def _coalesce(self, first: _Request):
        """Pull requests until the largest bucket is full or the batch
        deadline (``max_wait_ms`` after the batch opened) passes."""
        cfg = self.config
        t_open = time.perf_counter()
        deadline = t_open + cfg.max_wait_ms / 1e3
        batch = [first]
        while len(batch) < cfg.max_batch:
            remain = deadline - time.perf_counter()
            if remain <= 0:
                break
            try:
                item = self._queue.get(timeout=remain)
            except _queue.Empty:
                break
            if item is _SENTINEL:
                self._stopping = True
                break
            batch.append(item)
        return batch, t_open

    @torch.inference_mode()
    def _dispatch(self, batch: list, t_open: float):
        n = len(batch)
        bucket = bucket_for(n, self.config.buckets)
        x = device_put(pad_batch(np.stack([r.x for r in batch]), bucket),
                       self.device)
        y = self.forward(x)
        rows, ready = _stage_rows(y, n)
        self._pending.append(_InFlight(batch, rows, ready, t_open,
                                       time.perf_counter(), bucket))

    def _deliver(self, inflight: _InFlight):
        if inflight.ready is not None:
            inflight.ready.synchronize()
        y = to_numpy(inflight.rows)
        t_done = time.perf_counter()
        n = len(inflight.requests)
        self.batches.append(BatchRecord(
            n, inflight.bucket, inflight.t_open, inflight.t_dispatch,
            t_done, tuple(r.rid for r in inflight.requests)))
        for i, req in enumerate(inflight.requests):
            self.records.append(RequestRecord(
                req.rid, req.client, req.t_submit, inflight.t_dispatch,
                t_done, n, inflight.bucket))
            req.future.set_result(y[i])
        with self._lock:
            self._outstanding -= n


def _stage_rows(y, n: int):
    """The first ``n`` rows of a forward's result, copied into memory of
    their own: into pinned host memory on the current stream, with an
    event recorded after the copy, for a card tensor (the graph's static
    output may be overwritten by the next replay); a copy for a host
    tensor; an array otherwise."""
    if isinstance(y, torch.Tensor):
        if y.device.type == "cuda":
            rows = torch.empty((n, *y.shape[1:]), dtype=y.dtype,
                               pin_memory=True)
            rows.copy_(y[:n], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            return rows, ready
        return y[:n].clone(), None
    return np.array(np.asarray(y)[:n]), None
