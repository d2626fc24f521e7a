"""The port's online serving front end on the CPU: the bucket helpers
against the JAX package's, the bitwise padded-parity contract on the
port's calibrated int8 engine, the queue semantics of the JAX package's
``tests/test_serving.py`` (max-wait flush, max-batch cap, order per
client, drain) against the port's loop with a fake forward, the warm-up
and capture count, the Poisson load report, and ``launch/serve`` end to
end in-process.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving import buckets as jbuckets
from repro.serving import metrics as jmetrics
from repro_torch.conv import ConvEngine, ConvPolicy
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.serving import (DEFAULT_BUCKETS, GraphedForward,
                                 ServeConfig, ServingLoop, bucket_for,
                                 capture_count, latency_histogram, p50,
                                 p99, pad_batch, percentile,
                                 run_poisson_load, serve_padded,
                                 slice_batch, solo_latencies,
                                 validate_buckets)

# One intra-op thread: under pytest-xdist the workers share the cores.
torch.set_num_threads(1)


def test_bucket_helpers_and_metrics_equal_jax():
    assert DEFAULT_BUCKETS == jbuckets.DEFAULT_BUCKETS
    for b in ([8, 1, 4, 2], (3, 3, 5), (7,)):
        assert validate_buckets(b) == jbuckets.validate_buckets(b)
    for bad in ((), (0, 2), (1, 2.5)):
        with pytest.raises(ValueError):
            validate_buckets(bad)
    buckets = (1, 2, 4, 8)
    assert [bucket_for(n, buckets) for n in range(1, 9)] == \
        [jbuckets.bucket_for(n, buckets) for n in range(1, 9)]
    for n in (0, 9):
        with pytest.raises(ValueError):
            bucket_for(n, buckets)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(pad_batch(x, 8), jbuckets.pad_batch(x, 8))
    assert pad_batch(x, 3) is x
    np.testing.assert_array_equal(slice_batch(pad_batch(x, 8), 3), x)
    with pytest.raises(ValueError):
        pad_batch(x, 2)
    calls = []

    def fwd(t):
        calls.append(tuple(t.shape))
        return t * 2.0
    np.testing.assert_array_equal(serve_padded(fwd, x, 8), x * 2.0)
    assert calls == [(8, 4)]
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=101).tolist()
    for q in (0, 1, 50, 99, 100):
        assert percentile(xs, q) == jmetrics.percentile(xs, q)
    assert (p50(xs), p99(xs)) == (jmetrics.p50(xs), jmetrics.p99(xs))
    assert latency_histogram(xs, bins=7) == \
        jmetrics.latency_histogram(xs, bins=7)


@pytest.mark.parametrize("base", ["canonical", "legendre"])
def test_padded_parity_bitwise_on_the_port_engine(base):
    """A request served in a zero-padded bucket is bit for bit the same
    request served alone, on the prepared + calibrated int8 path, at
    every fill level across the (1, 2, 4, 8) boundaries."""
    spec = WinogradSpec(m=4, r=3, base=base,
                        quant=QuantConfig(hadamard_bits=9))
    eng = ConvEngine(spec, ConvPolicy(backend="winograd_int8"),
                     device="cpu")
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.normal(size=(3, 3, 5, 7)) * 0.2)
                         .astype(np.float32))
    xs = rng.normal(size=(8, 10, 10, 5)).astype(np.float32)
    eng.prepare([("c", w)])
    with torch.inference_mode():
        with eng.calibration():
            eng.conv2d(torch.from_numpy(xs), None, layer="c")

        def fwd(x):
            return eng.conv2d(x, None, layer="c")
        solo = [serve_padded(fwd, xs[i:i + 1], 1)[0] for i in range(8)]
        for n in (1, 2, 3, 5, 8):
            y = serve_padded(fwd, xs[:n], 8)
            assert y.shape[0] == n
            for i in range(n):
                np.testing.assert_array_equal(
                    y[i].view(np.int32), solo[i].view(np.int32),
                    err_msg=f"{base} n={n} row {i}")


class FakeForward:
    """Records each dispatched batch shape; optional service delay so the
    queue accumulates. Rows are x + 1."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.shapes = []
        self.lock = threading.Lock()

    def __call__(self, x):
        with self.lock:
            self.shapes.append(tuple(x.shape))
        if self.delay_s:
            time.sleep(self.delay_s)
        return x + 1.0


def _loop(fwd, **cfg):
    defaults = dict(buckets=(1, 2, 4, 8), max_wait_ms=30.0, poll_ms=5.0)
    defaults.update(cfg)
    return ServingLoop(fwd, (4,), ServeConfig(**defaults))


def test_results_are_per_request_rows_and_lifecycle_is_checked():
    fwd = FakeForward()
    loop = _loop(fwd)
    with pytest.raises(RuntimeError):      # not started yet
        loop.submit(np.zeros((4,), np.float32))
    loop.start()
    with pytest.raises(ValueError):
        loop.submit(np.zeros((5,), np.float32))
    xs = [np.full((4,), i, np.float32) for i in range(5)]
    futs = [loop.submit(x) for x in xs]
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(f.result(timeout=10), x + 1.0)
    assert [f.rid for f in futs] == list(range(5))
    loop.shutdown()
    assert all(s[0] in DEFAULT_BUCKETS for s in fwd.shapes)


def test_max_wait_flushes_and_max_batch_caps():
    """A lone request ships padded within about max_wait_ms; a backlog
    past the largest bucket splits into largest-bucket dispatches."""
    fwd = FakeForward()
    loop = _loop(fwd, max_wait_ms=25.0).start()
    t0 = time.perf_counter()
    y = loop.submit(np.zeros((4,), np.float32)).result(timeout=10)
    waited = time.perf_counter() - t0
    loop.shutdown()
    np.testing.assert_array_equal(y, 1.0)
    assert waited < 5.0 and fwd.shapes[0] == (1, 4)

    fwd = FakeForward(delay_s=0.05)
    loop = _loop(fwd, buckets=(1, 2, 4), max_wait_ms=100.0).start()
    futs = [loop.submit(np.zeros((4,), np.float32)) for _ in range(11)]
    for f in futs:
        f.result(timeout=30)
    loop.shutdown()
    assert max(s[0] for s in fwd.shapes) <= 4
    assert sum(b.n for b in loop.batches) == 11
    assert any(b.n > 1 for b in loop.batches)
    assert sorted(r for b in loop.batches for r in b.rids) == \
        [f.rid for f in futs]


def test_completion_in_submission_order_per_client_and_drain():
    fwd = FakeForward(delay_s=0.01)
    loop = _loop(fwd).start()
    done, futs = [], []
    for i in range(16):
        client = f"c{i % 3}"
        fut = loop.submit(np.full((4,), i, np.float32), client=client)
        fut.add_done_callback(lambda f, i=i, c=client: done.append((c, i)))
        futs.append(fut)
    for f in futs:
        f.result(timeout=30)
    loop.drain(timeout=10)
    loop.shutdown()
    for c in ("c0", "c1", "c2"):
        seq = [i for cc, i in done if cc == c]
        assert seq == sorted(seq), (c, seq)
    assert [r.rid for r in loop.records] == sorted(r.rid
                                                   for r in loop.records)

    fwd = FakeForward(delay_s=0.02)
    loop = _loop(fwd, max_wait_ms=50.0).start()
    futs = [loop.submit(np.zeros((4,), np.float32)) for _ in range(9)]
    loop.shutdown(drain=True)              # flush queue + in-flight ring
    assert all(f.done() for f in futs) and len(loop.records) == 9
    with pytest.raises(RuntimeError):
        loop.submit(np.zeros((4,), np.float32))


def test_warmup_and_capture_count():
    """A GraphedForward is counted (0 captures on the CPU, where there
    are no graphs, and none after warm-up); a plain callable is not."""
    fwd = GraphedForward(lambda x: x * 2.0 + 1.0, "cpu")
    loop = ServingLoop(fwd, (4,), ServeConfig(buckets=(1, 2, 4),
                                              max_wait_ms=5.0, poll_ms=5.0))
    loop.start()
    assert set(loop.warmup_times) == {(1, 4), (2, 4), (4, 4)}
    futs = [loop.submit(np.full((4,), i, np.float32)) for i in range(7)]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=10), i * 2.0 + 1.0)
    assert capture_count(fwd) == 0 and loop.compiles_after_warmup == 0
    loop.shutdown()
    assert capture_count(lambda x: x) is None
    loop = _loop(FakeForward()).start()
    assert loop.compiles_after_warmup is None
    loop.shutdown()


def test_make_engine_warmup_serves_a_resnet_through_the_loop():
    from repro_torch.models import resnet as RN
    from repro_torch.models.param import init_params
    cfg = RN.ResNetConfig(width_mult=0.125,
                          wino=WinogradSpec(m=4, r=3, base="legendre",
                                            quant=QuantConfig(
                                                hadamard_bits=9)))
    params = init_params(RN.param_specs(cfg), torch.Generator().manual_seed(0))
    state = init_params(RN.state_specs(cfg), torch.Generator().manual_seed(1))
    geoms = [(1, 32, 32, 3), (2, 32, 32, 3)]
    eng = RN.make_engine(cfg, backend="winograd_fp", device="cpu",
                         warmup=(params, state, geoms))
    assert isinstance(eng.serve_fn, GraphedForward)
    loop = ServingLoop(eng.serve_fn, (32, 32, 3),
                       ServeConfig(buckets=(1, 2), max_wait_ms=10.0,
                                   poll_ms=5.0), engine=eng)
    loop.start()
    assert set(loop.warmup_times) == set(geoms)
    futs = [loop.submit(np.zeros((32, 32, 3), np.float32))
            for _ in range(3)]
    for f in futs:
        assert f.result(timeout=60).shape == (RN.NUM_CLASSES,)
    assert loop.compiles_after_warmup == 0
    loop.shutdown()


def test_poisson_load_report_and_solo_baseline():
    fwd = FakeForward(delay_s=0.005)
    loop = _loop(fwd, max_wait_ms=10.0).start()
    rep = run_poisson_load(loop, rate_rps=200.0, n_requests=20,
                           make_request=lambda i: np.full((4,), i,
                                                          np.float32),
                           seed=3, keep_outputs=True)
    loop.shutdown()
    assert rep.n_requests == 20 and len(rep.latencies_s) == 20
    assert rep.throughput_rps > 0 and 0.0 <= rep.padding_frac < 1.0
    assert rep.p50_ms() <= rep.p99_ms() and rep.mean_batch >= 1.0
    assert 0.0 < rep.in_flight_frac <= 1.0
    assert sum(b.n for b in loop.batches) == 20
    for i, (rid, y) in enumerate(zip(rep.rids, rep.outputs)):
        np.testing.assert_array_equal(y, i + 1.0)
    solo = solo_latencies(fwd, [np.zeros((4,), np.float32)] * 3)
    assert len(solo) == 3 and all(s > 0 for s in solo)


def test_serve_launcher_end_to_end_on_cpu():
    """``launch/serve --device cpu --width 0.125 --buckets 1,2 --requests
    8``: every request answered, 0 captures after warm-up, the served
    rows bit for bit with the eager forward, drained. Without
    ``--device cpu`` and without a card it raises."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--width", "0.125", "--buckets",
                      "1,2", "--requests", "8", "--rate", "200",
                      "--solo-requests", "2", "--calib-steps", "1",
                      "--calib-batch", "2", "--autotune"])
    assert out["answered"] == 8 and out["compiles_after_warmup"] == 0
    assert out["captures"] == 0 and out["packed_layers"] == 14
    assert sum(out["batches_by_bucket"].values()) >= 4
    assert out["rows_checked"] and all(v >= 1 for v in
                                       out["rows_checked"].values())
    assert 0.0 <= out["padding_frac"] < 1.0 and out["p50_ms"] > 0
    assert set(out["tuned_tiles"].values()) <= {(16, 32), (32, 32)}
    # bucket 2 is the calibration batch; warm-up tunes bucket 1's T
    assert set(out["warmup_tiles"]) == set(out["tuned_tiles"])
    for layer, per in out["warmup_tiles"].items():
        assert len(per) == 1 and out["tuned_at_T"][layer] not in per
        assert set(per.values()) <= {(16, 32), (32, 32)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--width", "0.125", "--buckets", "1,2"])


def test_in_flight_share_counts_only_the_runs_own_batches():
    """A second load on the same loop reports the share of its own wall
    that its own batches spent between dispatch and delivery."""
    from repro_torch.serving.metrics import union_length
    assert union_length([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert union_length([]) == 0.0
    loop = _loop(FakeForward(delay_s=0.005), max_wait_ms=10.0).start()
    reps, firsts = [], []
    for seed in (1, 2):
        firsts.append(len(loop.batches))
        reps.append(run_poisson_load(
            loop, rate_rps=400.0, n_requests=12,
            make_request=lambda i: np.full((4,), i, np.float32), seed=seed))
    loop.shutdown()
    own = loop.batches[firsts[1]:]
    assert sum(b.n for b in own) == 12
    assert reps[1].in_flight_frac == pytest.approx(union_length(
        (b.t_dispatch, b.t_done) for b in own) / reps[1].wall_s)
    assert all(0.0 < r.in_flight_frac <= 1.0 for r in reps)
