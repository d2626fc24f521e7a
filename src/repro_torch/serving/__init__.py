"""Online serving front end: continuous batching over the int8 conv
engine's bucketed, graph-captured geometries (the port's counterpart of
``repro.serving``).

* ``buckets`` — the fixed serving geometries ragged traffic is padded
  into, and the padded-parity contract.
* ``graphs`` — one CUDA graph per geometry (``GraphedForward``).
* ``loop`` — the queue, coalescing and double-buffered dispatch
  (``ServingLoop``), with the capture count.
* ``loadgen`` — deterministic Poisson load and the latency report.
* ``metrics`` — p50/p99/histogram.

Entry point: ``repro_torch.launch.serve``.
"""
from repro_torch.serving.buckets import (DEFAULT_BUCKETS, bucket_for,
                                         device_put, pad_batch,
                                         serve_padded, slice_batch,
                                         validate_buckets)
from repro_torch.serving.graphs import GraphedForward
from repro_torch.serving.loadgen import (LoadReport, run_poisson_load,
                                         solo_latencies)
from repro_torch.serving.loop import (BatchRecord, RequestRecord,
                                      ServeConfig, ServingLoop,
                                      capture_count)
from repro_torch.serving.metrics import (latency_histogram, p50, p99,
                                         percentile)

__all__ = [
    "DEFAULT_BUCKETS", "bucket_for", "device_put", "pad_batch",
    "slice_batch", "serve_padded", "validate_buckets",
    "GraphedForward",
    "ServeConfig", "ServingLoop", "RequestRecord", "BatchRecord",
    "capture_count",
    "LoadReport", "run_poisson_load", "solo_latencies",
    "percentile", "p50", "p99", "latency_histogram",
]
