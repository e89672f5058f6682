"""Tracing / profiling utilities (SURVEY.md §5: the reference has only
wall-clock accumulation in the train loop, train.py:53,77-79; here it is
``jax.profiler`` traces plus host-side step timing kept off the hot path).

- :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace directory.
- :func:`time_ms` — steady-state milliseconds per call, timed with
  ``jax.block_until_ready``.
- :func:`device_memory_stats` — per-device live/peak bytes.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str = "outputs/profile"):
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_ms(fn, iters: int = 20) -> float:
    """Steady-state milliseconds per call of ``fn()``: one untimed call
    (compilation), then ``iters`` calls timed on the host clock up to
    ``jax.block_until_ready`` of the last output (the device runs calls in
    order, so the last one finishing means all have)."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1000 / iters


def device_memory_stats():
    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
    return out


# ---------------------------------------------------------------------------
# analytic FLOP accounting (for achieved-TFLOP/s bench reporting)
# ---------------------------------------------------------------------------


def conv_graph_flops(spec, height=None, width=None) -> int:
    """Multiply-add FLOPs (2·MACs) of one forward pass through the conv
    graph of ``spec`` at the given input resolution (torch conv/pool output
    arithmetic, incl. the k=2,s=1 maxpool zero-pad special case)."""
    from mit_driverless_cv_traininginfra.config.darknet_cfg import (
        ConvBlock,
        MaxPoolBlock,
        RouteBlock,
        ShortcutBlock,
        UpsampleBlock,
    )

    h = height or spec.net.height
    w = width or spec.net.width
    chans = spec.out_channels
    res = []
    cur = (h, w)
    flops = 0
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock):
            p = (b.size - 1) // 2
            ho = (cur[0] + 2 * p - b.size) // b.stride + 1
            wo = (cur[1] + 2 * p - b.size) // b.stride + 1
            flops += 2 * ho * wo * b.size * b.size * chans[i] * b.filters
            cur = (ho, wo)
        elif isinstance(b, MaxPoolBlock):
            if b.size == 2 and b.stride == 1:
                pass  # zero-padded to keep the resolution
            else:
                p = (b.size - 1) // 2
                cur = ((cur[0] + 2 * p - b.size) // b.stride + 1,
                       (cur[1] + 2 * p - b.size) // b.stride + 1)
        elif isinstance(b, UpsampleBlock):
            cur = (cur[0] * b.stride, cur[1] * b.stride)
        elif isinstance(b, RouteBlock):
            cur = res[b.layers[0]]
        elif isinstance(b, ShortcutBlock):
            pass
        res.append(cur)
    return flops


def rektnet_flops(size: int = 80, net_size: int = 16, num_kpt: int = 7) -> int:
    """Forward FLOPs of one RektNet crop (keypoint_net.py:17-25 topology:
    7×7 stem, four residual blocks, 1×1 head — all at full resolution)."""
    hw = size * size
    f = 2 * hw * 7 * 7 * 3 * net_size  # stem
    cin = net_size
    for mult in (1, 2, 4, 8):
        cout = net_size * mult
        f += 2 * hw * (3 * 3 * cin * cout    # conv1 (dilated, same res)
                       + 3 * 3 * cout * cout  # conv2
                       + 1 * 1 * cin * cout)  # shortcut
        cin = cout
    f += 2 * hw * cin * num_kpt  # 1×1 head
    return f
