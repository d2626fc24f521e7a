"""Poisson load generator and latency report for the online serving
loop (the port's counterpart of ``repro.serving.loadgen``).

The generator lays out a deterministic Poisson arrival process
(exponential gaps from a seeded generator), submits one request per
arrival to a running ``ServingLoop`` and waits for every response before
it reports: an open-loop arrival process (offered load does not slow
when the server falls behind, which is what puts queueing into the p99)
in a closed experiment (every latency is collected).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.metrics import percentile, union_length

__all__ = ["LoadReport", "run_poisson_load", "solo_latencies"]


@dataclasses.dataclass
class LoadReport:
    """One load run: offered rate, measured latency and throughput."""
    rate_rps: float              # offered (nominal Poisson) rate
    n_requests: int
    wall_s: float
    latencies_s: list            # per request, submit → delivery
    mean_batch: float            # real requests per dispatched batch
    padding_frac: float          # padded rows / dispatched rows
    in_flight_frac: float        # share of the wall with some batch
                                 # between dispatch and delivery
    compiles: Optional[int]      # captures and kernel builds in the run
    rids: Optional[list] = None      # with keep_outputs: per request, in
    outputs: Optional[list] = None   # submission order, its id and row

    @property
    def throughput_rps(self) -> float:
        return self.n_requests / max(self.wall_s, 1e-9)

    def p50_ms(self) -> float:
        return percentile(self.latencies_s, 50.0) * 1e3

    def p99_ms(self) -> float:
        return percentile(self.latencies_s, 99.0) * 1e3

    def describe(self, label: str = "") -> str:
        return (f"{label}rate {self.rate_rps:.2f}/s → "
                f"{self.throughput_rps:.2f}/s served, "
                f"p50 {self.p50_ms():.3f}ms p99 {self.p99_ms():.3f}ms, "
                f"mean batch {self.mean_batch:.2f}, "
                f"padding {self.padding_frac:.1%}, "
                f"in flight {self.in_flight_frac:.1%}, "
                f"compiles {self.compiles}")


def run_poisson_load(loop, rate_rps: float, n_requests: int,
                     make_request: Callable[[int], np.ndarray],
                     seed: int = 0,
                     keep_outputs: bool = False) -> LoadReport:
    """Drive ``loop`` with ``n_requests`` Poisson arrivals at
    ``rate_rps``, wait for every response, report the latencies.

    ``make_request(i)`` gives the i-th payload (shape
    ``loop.input_shape``); make them in bulk beforehand, as its cost
    delays the arrivals. Arrivals follow the wall clock, so a late
    submit does not compress the gaps after it. ``keep_outputs`` keeps
    each request's id and output row in the report.
    """
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_requests))
    first_batch = len(loop.batches)
    first_rec = len(loop.records)

    # The window ends once every future's row is on the host (the loop
    # resolves a request after its batch's copy-out event), so the device
    # work it times is done: no barrier is missing.
    t0 = time.perf_counter()
    futures = []
    for i in range(n_requests):
        lag = arrivals[i] - (time.perf_counter() - t0)  # lint: waive=cuda-unsynced-timing
        if lag > 0:
            time.sleep(lag)
        futures.append(loop.submit(make_request(i), client="loadgen"))
    outputs = [f.result() for f in futures]   # rows on the host: done
    wall = time.perf_counter() - t0  # lint: waive=unsynced-timing

    recs = loop.records[first_rec:]
    batches = loop.batches[first_batch:]
    real = sum(b.n for b in batches)
    rows = sum(b.bucket for b in batches)
    return LoadReport(
        rate_rps=rate_rps, n_requests=n_requests, wall_s=wall,
        latencies_s=[r.latency_s for r in recs],
        mean_batch=real / max(len(batches), 1),
        padding_frac=0.0 if rows == 0 else 1.0 - real / rows,
        in_flight_frac=union_length(
            (b.t_dispatch, b.t_done) for b in batches) / wall,
        compiles=loop.compiles_after_warmup,
        rids=[f.rid for f in futures] if keep_outputs else None,
        outputs=outputs if keep_outputs else None)


def solo_latencies(forward, requests: Sequence[np.ndarray],
                   bucket: int = 1, device=None) -> list[float]:
    """Serve each request alone (one dispatch each, padded to
    ``bucket``), synchronously; wall seconds per request. The
    serve-each-request-alone baseline continuous batching is measured
    against."""
    from repro_torch.serving.buckets import serve_padded
    dev = torch.device("cpu" if device is None else device)
    out = []
    for x in requests:
        t0 = time.perf_counter()
        serve_padded(forward, np.asarray(x)[None], bucket, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t0)  # lint: waive=unsynced-timing
    return out
