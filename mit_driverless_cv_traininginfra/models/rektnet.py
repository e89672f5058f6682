"""RektNet: 7-keypoint cone regressor, functional form.

Capability parity with the reference ``RektNet/keypoint_net.py:12-70`` and
``RektNet/resnet.py:8-27``:

- 3→16ch 7×7 stem (conv+BN+ReLU), four residual blocks (16→16→32→64→128)
  with a dilation-2 first conv and a 1×1 BN shortcut, 1×1 conv to ``num_kpt``
  heatmap channels. Spatial dims stay 80×80 throughout (no downsampling).
- ``flat_softmax`` over the H·W grid per keypoint, then ``soft_argmax`` —
  the expectation of normalised coordinates under the heatmap
  (keypoint_net.py:46-56).

Design choices (not translation):
- NHWC layout with HWIO conv kernels, the layout the rest of the stack
  uses, so crops from the detector feed the convs without a transpose.
- pure functions over a params/state pytree: ``init`` → ``apply``; BN batch
  stats live in a separate ``state`` pytree updated functionally in train
  mode, so the whole train step stays jit-compiled with no Python state.
- the softmax/soft-argmax pair is algebraically fused here into a single
  normalised-expectation (one exp, one reduce) — see :func:`soft_argmax_2d`
  — instead of materialising the softmaxed heatmap twice.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

BN_EPS = 1e-5       # torch BatchNorm2d default
BN_MOMENTUM = 0.1   # torch default: running = (1-m)*running + m*batch


# ---------------------------------------------------------------------------
# primitive layers (shared with the Darknet executor)
# ---------------------------------------------------------------------------

def conv2d(x, w, b=None, stride: int = 1, padding: int = 0, dilation: int = 1):
    """NHWC conv with HWIO weights; symmetric spatial padding like torch."""
    out = jax.lax.conv_general_dilated(
        x,
        w,
        window_strides=(stride, stride),
        padding=[(padding, padding), (padding, padding)],
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if b is not None:
        out = out + b
    return out


def batch_norm(x, bn: Dict[str, jnp.ndarray], train: bool = False):
    """BatchNorm over NHWC with torch semantics.

    Returns (y, batch_stats) where batch_stats is (mean, var_unbiased) for
    the running-stat update (torch tracks the *unbiased* variance in
    ``running_var`` but normalises with the biased one).
    """
    if train:
        # batch statistics always accumulate in f32 — bf16 mean/var over
        # hundreds of thousands of elements loses too many mantissa bits
        xf = x.astype(jnp.float32)
        mean = jnp.mean(xf, axis=(0, 1, 2))
        var = jnp.var(xf, axis=(0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        var_unbiased = var * n / max(n - 1, 1)
        stats = (mean, var_unbiased)
    else:
        mean, var = bn["mean"], bn["var"]
        stats = None
    inv = jax.lax.rsqrt(var.astype(jnp.float32) + BN_EPS)
    scale = (inv * bn["scale"].astype(jnp.float32)).astype(x.dtype)
    bias = bn["bias"].astype(x.dtype)
    return (x - mean.astype(x.dtype)) * scale + bias, stats


def update_running(bn_state, batch_stats, momentum: float = BN_MOMENTUM):
    mean, var = batch_stats
    return {
        "mean": (1 - momentum) * bn_state["mean"] + momentum * mean,
        "var": (1 - momentum) * bn_state["var"] + momentum * var,
    }


def _kaiming_conv(key, ksize: int, cin: int, cout: int, dtype=jnp.float32):
    """Kaiming-normal fan_out/relu init, matching the reference's
    ``nn.init.kaiming_normal_(mode='fan_out', nonlinearity='relu')``
    (keypoint_net.py:33-44). fan_out = k*k*cout; std = sqrt(2/fan_out)."""
    fan_out = ksize * ksize * cout
    std = (2.0 / fan_out) ** 0.5
    return jax.random.normal(key, (ksize, ksize, cin, cout), dtype) * std


# ---------------------------------------------------------------------------
# the fused decode
# ---------------------------------------------------------------------------

def flat_softmax(hm_logits):
    """Softmax over the flattened spatial grid per (batch, keypoint)
    (keypoint_net.py:46-49). Input/output (B, K, H, W)."""
    b, k, h, w = hm_logits.shape
    flat = hm_logits.reshape(b * k, h * w)
    flat = jax.nn.softmax(flat, axis=1)
    return flat.reshape(b, k, h, w)


def soft_argmax_2d(hm_logits):
    """Fused flat-softmax + soft-argmax: E[(x, y)] under softmax(hm).

    Matches ``flat_softmax`` → ``soft_argmax`` (keypoint_net.py:46-56) with
    coordinate grids ``linspace(0, (N-1)/N, N)``, but computes the softmax
    normalisation once and contracts against the coordinate vectors without
    materialising the (B,K,H,W) probability tensor a second time. Returns
    (points (B,K,2) in [0,1) xy order, probs (B,K,H,W)).
    """
    from mit_driverless_cv_traininginfra.ops.fused import (
        fused_softargmax,
    )

    b, k, h, w = hm_logits.shape
    pts, probs = fused_softargmax(hm_logits.reshape(b * k, h, w))
    return (pts.reshape(b, k, 2).astype(hm_logits.dtype),
            probs.reshape(b, k, h, w))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

NET_SIZE = 16


def _res_block_channels(net_size: int = NET_SIZE) -> Tuple[Tuple[int, int], ...]:
    return (
        (net_size, net_size),
        (net_size, net_size * 2),
        (net_size * 2, net_size * 4),
        (net_size * 4, net_size * 8),
    )


def init(key, num_kpt: int = 7, in_channels: int = 3, net_size: int = NET_SIZE,
         dtype=jnp.float32):
    """Initialise (params, state) pytrees.

    params holds conv weights/biases and BN scale/bias; state holds BN
    running mean/var (functional twin of torch buffers).
    """
    keys = iter(jax.random.split(key, 32))

    def bn_params(c):
        return {"scale": jnp.ones((c,), dtype), "bias": jnp.zeros((c,), dtype)}

    def bn_state(c):
        return {"mean": jnp.zeros((c,), dtype), "var": jnp.ones((c,), dtype)}

    params = {
        "stem": {
            "w": _kaiming_conv(next(keys), 7, in_channels, net_size, dtype),
            "b": jnp.zeros((net_size,), dtype),
            "bn": bn_params(net_size),
        },
        "out": {
            "w": _kaiming_conv(next(keys), 1, net_size * 8, num_kpt, dtype),
            "b": jnp.zeros((num_kpt,), dtype),
        },
    }
    state = {"stem": bn_state(net_size)}
    for i, (cin, cout) in enumerate(_res_block_channels(net_size), start=1):
        params[f"res{i}"] = {
            "conv1": {"w": _kaiming_conv(next(keys), 3, cin, cout, dtype),
                      "b": jnp.zeros((cout,), dtype)},
            "bn1": bn_params(cout),
            "conv2": {"w": _kaiming_conv(next(keys), 3, cout, cout, dtype),
                      "b": jnp.zeros((cout,), dtype)},
            "bn2": bn_params(cout),
            "shortcut_conv": {"w": _kaiming_conv(next(keys), 1, cin, cout, dtype),
                              "b": jnp.zeros((cout,), dtype)},
            "shortcut_bn": bn_params(cout),
        }
        state[f"res{i}"] = {
            "bn1": bn_state(cout),
            "bn2": bn_state(cout),
            "shortcut_bn": bn_state(cout),
        }
    return params, state


def _merge_bn(p_bn, s_bn):
    return {**p_bn, **s_bn}


def _res_block(p, s, x, train: bool):
    """Residual block (resnet.py:8-27): dilation-2 3×3 → BN → ReLU → 3×3 →
    BN, plus 1×1-conv/BN shortcut, ReLU on the sum."""
    new_s = {}
    c1 = conv2d(x, p["conv1"]["w"], p["conv1"]["b"], padding=2, dilation=2)
    b1, st1 = batch_norm(c1, _merge_bn(p["bn1"], s["bn1"]), train)
    a1 = jax.nn.relu(b1)
    c2 = conv2d(a1, p["conv2"]["w"], p["conv2"]["b"], padding=1)
    b2, st2 = batch_norm(c2, _merge_bn(p["bn2"], s["bn2"]), train)
    sc = conv2d(x, p["shortcut_conv"]["w"], p["shortcut_conv"]["b"])
    bsc, st3 = batch_norm(sc, _merge_bn(p["shortcut_bn"], s["shortcut_bn"]), train)
    out = jax.nn.relu(bsc + b2)
    if train:
        new_s = {
            "bn1": update_running(s["bn1"], st1),
            "bn2": update_running(s["bn2"], st2),
            "shortcut_bn": update_running(s["shortcut_bn"], st3),
        }
    return out, new_s


@functools.partial(jax.jit, static_argnames=("train", "hm_only"))
def apply(params, state, x, train: bool = False, hm_only: bool = False):
    """Forward pass.

    Args:
        x: (B, H, W, C) float images in [0, 1] (NHWC; the loaders emit this).
        train: use batch statistics + return updated running stats.
        hm_only: reference ``onnx_mode`` — return raw heatmap logits only
            (keypoint_net.py:65-66), channels-last (B, H, W, K).

    Returns:
        (heatmap_probs (B,K,H,W), points (B,K,2), new_state) — or raw logits
        if ``hm_only``.
    """
    new_state = {}
    h = conv2d(x, params["stem"]["w"], params["stem"]["b"], padding=3)
    h, st = batch_norm(h, _merge_bn(params["stem"]["bn"], state["stem"]), train)
    if train:
        new_state["stem"] = update_running(state["stem"], st)
    h = jax.nn.relu(h)
    for i in range(1, 5):
        h, ns = _res_block(params[f"res{i}"], state[f"res{i}"], h, train)
        if train:
            new_state[f"res{i}"] = ns
    logits = conv2d(h, params["out"]["w"], params["out"]["b"])  # (B,H,W,K)
    if hm_only:
        return logits
    logits_bkhw = jnp.transpose(logits, (0, 3, 1, 2))
    points, probs = soft_argmax_2d(logits_bkhw)
    if not train:
        new_state = state
    return probs, points, new_state


# ---------------------------------------------------------------------------
# serving: BN folding
# ---------------------------------------------------------------------------


def fold_bn(params, state):
    """Fold BN into each conv for inference: w' = w·γ/σ,
    b' = β + (b − μ)·γ/σ. Output tree has {w, b} per conv only; use with
    :func:`apply_folded`."""

    def fold(conv, bn_p, bn_s):
        inv = bn_p["scale"] / jnp.sqrt(bn_s["var"] + BN_EPS)
        return {
            "w": conv["w"] * inv[None, None, None, :],
            "b": bn_p["bias"] + (conv["b"] - bn_s["mean"]) * inv,
        }

    out = {
        "stem": fold({"w": params["stem"]["w"], "b": params["stem"]["b"]},
                     params["stem"]["bn"], state["stem"]),
        "out": dict(params["out"]),
    }
    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        out[f"res{i}"] = {
            "conv1": fold(p["conv1"], p["bn1"], s["bn1"]),
            "conv2": fold(p["conv2"], p["bn2"], s["bn2"]),
            "shortcut_conv": fold(p["shortcut_conv"], p["shortcut_bn"],
                                  s["shortcut_bn"]),
        }
    return out


@functools.partial(jax.jit, static_argnames=("hm_only",))
def apply_folded(folded, x, hm_only: bool = False):
    """Inference twin of :func:`apply` on BN-folded params — the serving
    path (no BN reads, every conv is conv+bias+activation)."""
    h = jax.nn.relu(conv2d(x, folded["stem"]["w"], folded["stem"]["b"], padding=3))
    for i in range(1, 5):
        p = folded[f"res{i}"]
        a1 = jax.nn.relu(conv2d(h, p["conv1"]["w"], p["conv1"]["b"],
                                padding=2, dilation=2))
        b2 = conv2d(a1, p["conv2"]["w"], p["conv2"]["b"], padding=1)
        sc = conv2d(h, p["shortcut_conv"]["w"], p["shortcut_conv"]["b"])
        h = jax.nn.relu(sc + b2)
    logits = conv2d(h, folded["out"]["w"], folded["out"]["b"])
    if hm_only:
        return logits
    logits_bkhw = jnp.transpose(logits, (0, 3, 1, 2))
    points, probs = soft_argmax_2d(logits_bkhw)
    return probs, points


# ---------------------------------------------------------------------------
# legacy checkpoint import (RektNet .pt → pytree)
# ---------------------------------------------------------------------------

_TORCH_PREFIXES = {
    "conv": ("stem", "w", "b"),
    "bn": ("stem", "bn"),
    "out": ("out", "w", "b"),
}


def params_from_torch_state_dict(sd, num_kpt: int = 7, net_size: int = NET_SIZE,
                                 dtype=jnp.float32):
    """Map a reference ``KeypointNet`` state_dict (train_eval.py:103-110
    checkpoints store it under key 'model') onto our (params, state) pytrees.

    Accepts either a dict of torch tensors or of numpy arrays. Conv weights
    transpose OIHW→HWIO.
    """
    import numpy as np

    def arr(k):
        v = sd[k]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return jnp.asarray(v, dtype)

    def conv(prefix):
        w = arr(f"{prefix}.weight")
        return {"w": jnp.transpose(w, (2, 3, 1, 0)), "b": arr(f"{prefix}.bias")}

    def bn_p(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    def bn_s(prefix):
        return {"mean": arr(f"{prefix}.running_mean"), "var": arr(f"{prefix}.running_var")}

    params = {
        "stem": {**conv("conv"), "bn": bn_p("bn")},
        "out": conv("out"),
    }
    state = {"stem": bn_s("bn")}
    for i in range(1, 5):
        params[f"res{i}"] = {
            "conv1": conv(f"res{i}.conv1"),
            "bn1": bn_p(f"res{i}.bn1"),
            "conv2": conv(f"res{i}.conv2"),
            "bn2": bn_p(f"res{i}.bn2"),
            "shortcut_conv": conv(f"res{i}.shortcut_conv"),
            "shortcut_bn": bn_p(f"res{i}.shortcut_bn"),
        }
        state[f"res{i}"] = {
            "bn1": bn_s(f"res{i}.bn1"),
            "bn2": bn_s(f"res{i}.bn2"),
            "shortcut_bn": bn_s(f"res{i}.shortcut_bn"),
        }
    return params, state


def load_torch_checkpoint(path: str, dtype=jnp.float32):
    """Load a reference ``.pt`` checkpoint ({epoch, model, optimizer} dict or
    bare state_dict) into (params, state). Uses CPU torch only for IO."""
    import torch

    from mit_driverless_cv_traininginfra.data.uri import resolve_uri

    path = resolve_uri(path)  # gs:// via local mirror

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return params_from_torch_state_dict(sd, dtype=dtype)
