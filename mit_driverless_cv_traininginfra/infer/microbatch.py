"""Micro-batching request aggregator for the serving frontend.

The deployment-latency study (PERF.md, tools/bench_latency.py) showed the
B=1 frame pays a fixed cost of an under-filled device while the marginal
frame costs far less — batching the vehicle's camera streams (B=2) cuts
per-frame device time for a short queueing delay. ``MicroBatcher`` is
the host-side piece that realises that: concurrent ``submit(frame)``
calls are aggregated into the smallest precompiled batch bucket, run as
one device program, and the per-frame results are fanned back out.

The reference has no serving runtime at all (its two stages are separate
TensorRT engines chained by hand, README.md:59); this plus
``TwoStageServer.warmup`` is the production front half the deployment
needs.

Design:
- one collector thread; requests queue in; the collector waits up to
  ``max_wait_ms`` after the first pending request for co-arrivals (camera
  streams are near-synchronous, so the wait is normally ~0);
- batch = smallest bucket ≥ pending (buckets must be precompiled —
  pair with ``TwoStageServer.warmup(bucket_sizes, ...)``); the batch is
  padded by repeating the first frame (padding rows are discarded);
- results resolve per-request ``Future``s after ONE ``jax.device_get``
  of all four outputs (the single-RTT fan-out; it doubles as the device
  fence), so a completed future's arrays are immediately host-readable.

Batching is result-transparent: every pipeline stage is per-sample except
the batch-global crop capacity — run the batcher with per-bucket capacity
≥ bucket·max_det (or accept the same lowest-score-drop semantics the
batched server already has).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import jax
import numpy as np


class MicroBatcher:
    """Aggregate concurrent single-frame requests into batched device calls.

    Args:
        runner: ``fn(frames (B, H, W, C)) -> PipelineOut`` — typically a
            warmed :class:`~.serving.TwoStageServer`. Called only with
            batch sizes from ``bucket_sizes``.
        bucket_sizes: ascending precompiled batch buckets.
        max_wait_ms: co-arrival window after the first pending request.
    """

    def __init__(self, runner: Callable, bucket_sizes: Sequence[int] = (1, 2, 4, 8),
                 max_wait_ms: float = 2.0):
        self.runner = runner
        self.buckets = sorted(bucket_sizes)
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._frame_spec: Optional[tuple] = None  # (shape, dtype) of frame 0
        self._spec_lock = threading.Lock()
        # serialises submit() against stop(): without it a submit that
        # passed the started-check could enqueue AFTER stop()'s drain and
        # leave its Future unresolved forever
        self._lifecycle_lock = threading.Lock()
        # stats
        self.batches = 0
        self.frames = 0
        self.padded_frames = 0
        self.batch_counts: Counter = Counter()
        # per-request submit→resolve wall latency (ms): includes the
        # co-arrival wait, device time, and the single device_get fan-out
        # — the full client-visible latency
        self.request_ms: deque = deque(maxlen=1024)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        with self._lifecycle_lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lifecycle_lock:
            if self._thread is None:
                return
            self._stop.set()
            self._q.put(None)  # wake the collector
            thread = self._thread
            # mark stopped under the lock: no submit() can enqueue past
            # this point, so the drain below is complete
            self._thread = None
        thread.join()
        # drain: fail any stragglers rather than hang their futures
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._resolve(item[1],
                              exc=RuntimeError("MicroBatcher stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ---------------------------------------------------------

    def submit(self, frame) -> Future:
        """Enqueue one (H, W, C) frame; the Future resolves to a dict with
        per-frame ``boxes``/``scores``/``mask``/``keypoints`` numpy rows.

        All frames must share one shape/dtype (the precompiled buckets key
        on it); a mismatch raises here, in the caller, rather than inside
        the collector thread where it would wedge every pending request.
        """
        arr = np.asarray(frame)
        spec = (arr.shape, arr.dtype)
        with self._spec_lock:
            if self._frame_spec is None:
                self._frame_spec = spec
        if spec != self._frame_spec:
            raise ValueError(
                f"frame {spec} does not match the batcher's first frame "
                f"{self._frame_spec}; all submissions must share one "
                f"shape/dtype")
        fut: Future = Future()
        with self._lifecycle_lock:
            if self._thread is None:
                raise RuntimeError("MicroBatcher not started")
            self._q.put((arr, fut, time.perf_counter()))
        return fut

    # -- collector ----------------------------------------------------------

    def _collect(self):
        """Block for the first request, then gather co-arrivals up to the
        largest bucket or the wait window."""
        first = self._q.get()
        if first is None:
            return None
        pending = [first]
        deadline = time.perf_counter() + self.max_wait_s
        max_b = self.buckets[-1]
        while len(pending) < max_b:
            budget = deadline - time.perf_counter()
            if budget <= 0:
                break
            try:
                item = self._q.get(timeout=budget)
            except queue.Empty:
                break
            if item is None:
                break
            pending.append(item)
        return pending

    @staticmethod
    def _resolve(fut: Future, result=None, exc=None):
        """Resolve one future without ever raising: a caller that timed out
        and ``cancel()``-ed (these futures are never marked running, so
        cancel always succeeds) must not kill the collector thread."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # noqa: BLE001 — cancelled/already-resolved
            pass

    def _loop(self):
        while not self._stop.is_set():
            futs = []
            try:
                pending = self._collect()
                if not pending:
                    continue
                frames = [p[0] for p in pending]
                futs = [p[1] for p in pending]
                n = len(frames)
                bucket = next((b for b in self.buckets if b >= n),
                              self.buckets[-1])
                pad = bucket - n
                batch = np.stack(frames + [frames[0]] * pad)
                out = self.runner(batch)
                # ONE device→host transfer for all four outputs instead of
                # four separate pulls; device_get also waits for completion
                boxes, scores, mask, kpts = jax.device_get(
                    (out.boxes, out.scores, out.mask, out.keypoints))
            except Exception as e:  # noqa: BLE001 — fail the callers,
                for f in futs:      # NEVER the collector thread itself
                    self._resolve(f, exc=e)
                continue
            self.batches += 1
            self.frames += n
            self.padded_frames += pad
            self.batch_counts[bucket] += 1
            done = time.perf_counter()
            for t in (p[2] for p in pending):
                self.request_ms.append((done - t) * 1000.0)
            for i, f in enumerate(futs):
                self._resolve(f, {"boxes": boxes[i], "scores": scores[i],
                                  "mask": mask[i], "keypoints": kpts[i]})

    def stats(self) -> dict:
        counts = self.batch_counts
        total = sum(counts.values())
        weighted = sum(b * c for b, c in counts.items())
        lat = np.asarray(self.request_ms, np.float64)
        return {
            "batches": self.batches,
            "frames": self.frames,
            "padded_frames": self.padded_frames,
            "mean_batch": (weighted / total if total else None),
            "bucket_histogram": {b: counts.get(b, 0) for b in self.buckets},
            "request_ms": ({p: round(float(np.percentile(lat, p)), 3)
                            for p in (50, 95, 99)} if lat.size else None),
        }
