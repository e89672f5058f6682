"""MicroBatcher (infer/microbatch.py): request aggregation semantics."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import os

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.infer.microbatch import MicroBatcher
from mit_driverless_cv_traininginfra.infer.pipeline import (
    PipelineOut,
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import init_params

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _runner():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    yp, ys = init_params(spec, jax.random.PRNGKey(0))
    rp, rs = rektnet.init(jax.random.PRNGKey(1))

    def run(frames):
        return two_stage_pipeline(
            spec, yp, ys, rp, rs, jnp.asarray(frames, jnp.float32),
            conf_thresh=0.1, nms_thresh=0.25, max_det=4)

    return run


def test_batched_results_match_single_frame():
    """Batching must be result-transparent: a frame served in a padded
    batch returns exactly what a B=1 call returns (dense capacity — every
    stage is per-sample)."""
    run = _runner()
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)

    with MicroBatcher(run, bucket_sizes=(1, 2, 4), max_wait_ms=40) as mb:
        futs = [mb.submit(f) for f in frames]
        results = [f.result(timeout=120) for f in futs]

    for f, r in zip(frames, results):
        solo = run(f[None])
        np.testing.assert_allclose(r["boxes"], np.asarray(solo.boxes)[0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["mask"], np.asarray(solo.mask)[0])
        np.testing.assert_allclose(r["keypoints"],
                                   np.asarray(solo.keypoints)[0],
                                   rtol=1e-4, atol=1e-4)


def test_coarrivals_aggregate_into_one_bucket():
    """Near-simultaneous submissions (the two-camera case) must ride one
    batched call, padded up to the bucket."""
    calls = []

    def run(frames):
        calls.append(frames.shape[0])
        B = frames.shape[0]
        z = jnp.zeros((B, 4, 4))
        return PipelineOut(z, jnp.zeros((B, 4)), jnp.zeros((B, 4), bool),
                           jnp.zeros((B, 4, 7, 2)))

    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(run, bucket_sizes=(1, 2, 4), max_wait_ms=150) as mb:
        futs = [mb.submit(frame), mb.submit(frame), mb.submit(frame)]
        for f in futs:
            f.result(timeout=30)
        st = mb.stats()
    assert calls == [4]                    # 3 co-arrivals → one 4-bucket
    assert st["batches"] == 1 and st["frames"] == 3
    assert st["padded_frames"] == 1
    assert st["bucket_histogram"][4] == 1


def test_spaced_arrivals_serve_individually():
    calls = []

    def run(frames):
        calls.append(frames.shape[0])
        B = frames.shape[0]
        z = jnp.zeros((B, 4, 4))
        return PipelineOut(z, jnp.zeros((B, 4)), jnp.zeros((B, 4), bool),
                           jnp.zeros((B, 4, 7, 2)))

    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(run, bucket_sizes=(1, 2, 4), max_wait_ms=1) as mb:
        for _ in range(3):
            mb.submit(frame).result(timeout=30)
    assert calls == [1, 1, 1]


def test_runner_failure_fails_the_futures():
    def run(frames):
        raise RuntimeError("boom")

    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(run, bucket_sizes=(1,), max_wait_ms=1) as mb:
        fut = mb.submit(frame)
        try:
            fut.result(timeout=30)
            raised = False
        except RuntimeError:
            raised = True
    assert raised


def test_shape_mismatch_raises_in_caller_not_collector():
    """A frame that can't stack with the batcher's first frame must raise
    in submit() (the caller), never inside the collector thread — a dead
    collector would wedge every later request forever."""
    def run(frames):
        B = frames.shape[0]
        z = jnp.zeros((B, 4, 4))
        return PipelineOut(z, jnp.zeros((B, 4)), jnp.zeros((B, 4), bool),
                           jnp.zeros((B, 4, 7, 2)))

    with MicroBatcher(run, bucket_sizes=(1, 2), max_wait_ms=1) as mb:
        mb.submit(np.zeros((8, 8, 3), np.float32)).result(timeout=30)
        try:
            mb.submit(np.zeros((16, 16, 3), np.float32))
            raised = False
        except ValueError:
            raised = True
        assert raised
        # the collector must still be alive and serving
        r = mb.submit(np.zeros((8, 8, 3), np.float32)).result(timeout=30)
        assert r["boxes"].shape == (4, 4)


def test_cancelled_future_does_not_kill_collector():
    """A client that times out and cancels its Future (cancel always
    succeeds — these futures are never marked running) must not crash the
    collector when it later tries to resolve that future."""
    release = threading.Event()

    def run(frames):
        release.wait(timeout=30)
        B = frames.shape[0]
        z = jnp.zeros((B, 4, 4))
        return PipelineOut(z, jnp.zeros((B, 4)), jnp.zeros((B, 4), bool),
                           jnp.zeros((B, 4, 7, 2)))

    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(run, bucket_sizes=(1,), max_wait_ms=1) as mb:
        fut = mb.submit(frame)          # runner blocks on `release`
        time.sleep(0.05)
        assert fut.cancel()             # client gives up
        release.set()                   # runner finishes; collector
        # resolves the cancelled future (must not raise) and lives on
        r = mb.submit(frame).result(timeout=30)
        assert r["scores"].shape == (4,)


def test_concurrent_submitters_all_resolve():
    def run(frames):
        B = frames.shape[0]
        # result row encodes the frame's content so routing is checkable
        s = jnp.asarray(frames[:, 0, 0, 0])
        z = jnp.zeros((B, 4, 4))
        return PipelineOut(z, jnp.broadcast_to(s[:, None], (B, 4)),
                           jnp.zeros((B, 4), bool), jnp.zeros((B, 4, 7, 2)))

    results = {}

    def client(i, mb):
        frame = np.full((8, 8, 3), i / 10.0, np.float32)
        results[i] = mb.submit(frame).result(timeout=60)

    with MicroBatcher(run, bucket_sizes=(1, 2, 4, 8), max_wait_ms=30) as mb:
        threads = [threading.Thread(target=client, args=(i, mb))
                   for i in range(8)]
        for t in threads:
            t.start()
            time.sleep(0.002)
        for t in threads:
            t.join()
        st = mb.stats()
    assert len(results) == 8
    for i, r in results.items():
        np.testing.assert_allclose(r["scores"], i / 10.0, atol=1e-6)
    assert st["frames"] == 8


def test_request_latency_percentiles():
    """Per-request submit→resolve latency is ring-buffered and surfaced as
    p50/p95/p99 in stats() (VERDICT r3 #2)."""
    run = _runner()
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    with MicroBatcher(run, bucket_sizes=(1, 2, 4), max_wait_ms=5) as mb:
        futs = [mb.submit(f) for f in frames]
        for f in futs:
            f.result(timeout=120)
        st = mb.stats()
    d = st["request_ms"]
    assert set(d) == {50, 95, 99}
    assert d[50] > 0 and d[99] >= d[50]
    assert len(mb.request_ms) == 4
