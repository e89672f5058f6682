"""Space-to-depth stem rewrite — exact, wider first convolutions.

The Darknet-53 stem (3→32 3×3 s1 at full resolution, then 32→64 3×3 s2)
is a poor fit for matrix units: a 3-input-channel conv contracts only
K=27 values per output.

This pass rewrites the stem *exactly* (same arithmetic, reordered):

1. the input is packed 2×2 space-to-depth: (B, H, W, 3) → (B, H/2, W/2, 12),
   packed channel = (row_parity, col_parity, c);
2. conv1 becomes a 3×3 conv over the packed grid with 12 input and
   4·32 = 128 output channels (output packed the same way) — K=108, N=128;
3. the leaky activation is elementwise and commutes with packing;
4. conv2 (s2) consumes the packed tensor directly as a 2×2-tap conv with
   128 input channels and stride 1 — its output grid IS the packed grid, so
   nothing is ever unpacked.

Tap algebra: an original source offset s ∈ {-1..2} maps to packed offset
D = s >> 1 (floor) and parity p = s − 2D; every original weight lands in
exactly one packed-kernel slot. Padding 1 on the packed grid covers the
original 1-pixel zero padding (the extra covered row has zero weights).

Applies to any spec whose first two blocks are [Conv(k=3, s=1, BN-folded),
Conv(k=3, s=2, BN-folded)] — i.e. the standard YOLOv3 stem. Used on the
serving path only (inference, folded BN); training keeps the plain graph.

On the int8 serving path this packed stem is superseded by the entry path
(ops/entry): conv1p is algebraically a 4×4 stride-2
conv on the raw frames (same integers, half the MACs, no space-to-depth
transpose). The packed form remains the bf16-serving and
fallback-spec path, and quantize_packed_stem still derives the entry's
conv2p weights from ``build_packed_stem``.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra.config.darknet_cfg import ConvBlock, NetworkSpec


def stem_is_packable(spec: NetworkSpec) -> bool:
    b = spec.blocks
    return (
        len(b) >= 2
        and isinstance(b[0], ConvBlock) and b[0].size == 3 and b[0].stride == 1
        and isinstance(b[1], ConvBlock) and b[1].size == 3 and b[1].stride == 2
        and spec.net.width % 2 == 0 and spec.net.height % 2 == 0
    )


def pack_input(x):
    """(B, H, W, C) → (B, H/2, W/2, 4C), channel order (p, q, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x = jnp.transpose(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(B, H // 2, W // 2, 4 * C)


def build_packed_stem(folded_params: Dict[str, dict]) -> Dict[str, jnp.ndarray]:
    """Rewrite folded (BN-free) stem weights into the packed form.

    folded_params: the ``fold_bn`` output — blocks '0' and '1' hold
    {w (3,3,Cin,Cout), b (Cout,)}.
    """
    w1 = np.asarray(folded_params["0"]["w"], np.float32)  # (3,3,C,C1)
    b1 = np.asarray(folded_params["0"]["b"], np.float32)
    w2 = np.asarray(folded_params["1"]["w"], np.float32)  # (3,3,C1,C2)
    b2 = np.asarray(folded_params["1"]["b"], np.float32)
    C, C1 = w1.shape[2], w1.shape[3]
    C2 = w2.shape[3]

    # conv1: (3,3, 4C, 4C1); output channel = (a, b, co)
    w1p = np.zeros((3, 3, 4 * C, 4 * C1), np.float32)
    for a in range(2):
        for bb in range(2):
            for dy in range(3):
                for dx in range(3):
                    sy, sx = a + dy - 1, bb + dx - 1
                    Dy, Dx = sy >> 1, sx >> 1
                    p, q = sy - 2 * Dy, sx - 2 * Dx
                    w1p[Dy + 1, Dx + 1,
                        (p * 2 + q) * C:(p * 2 + q + 1) * C,
                        (a * 2 + bb) * C1:(a * 2 + bb + 1) * C1] = w1[dy, dx]
    b1p = np.concatenate([b1] * 4)

    # conv2 (s2): 2×2-tap conv over the packed grid, Dy ∈ {-1, 0} → pad (1,0)
    w2p = np.zeros((2, 2, 4 * C1, C2), np.float32)
    for dy in range(3):
        for dx in range(3):
            sy, sx = dy - 1, dx - 1
            Dy, Dx = sy >> 1, sx >> 1
            a, bb = sy - 2 * Dy, sx - 2 * Dx
            w2p[Dy + 1, Dx + 1,
                (a * 2 + bb) * C1:(a * 2 + bb + 1) * C1, :] += w2[dy, dx]
    dtype = folded_params["0"]["w"].dtype
    return {
        "w1": jnp.asarray(w1p, dtype), "b1": jnp.asarray(b1p, dtype),
        "w2": jnp.asarray(w2p, dtype), "b2": jnp.asarray(b2, dtype),
    }


def pack_stem_weights_jnp(w1, w2):
    """Differentiable (jnp) packed-stem weight construction — the TRAINING
    twin of :func:`build_packed_stem` (which is numpy over folded
    weights). Same tap algebra; biases stay with the BatchNorms.

    Returns (w1p (3,3,4C,4C1), w2p (2,2,4C1,C2)). Each original w1 weight
    lands in exactly one w1p slot and each w2 weight accumulates into
    exactly one w2p slot, so the map is a fixed linear scatter and
    gradients flow back to w1/w2 exactly. Built inside the train step
    (36 static-index set/add ops — trace-time constants, negligible next
    to the convs they enable)."""
    C, C1 = w1.shape[2], w1.shape[3]
    C2 = w2.shape[3]
    w1p = jnp.zeros((3, 3, 4 * C, 4 * C1), w1.dtype)
    for a in range(2):
        for bb in range(2):
            for dy in range(3):
                for dx in range(3):
                    sy, sx = a + dy - 1, bb + dx - 1
                    Dy, Dx = sy >> 1, sx >> 1
                    p, q = sy - 2 * Dy, sx - 2 * Dx
                    w1p = w1p.at[
                        Dy + 1, Dx + 1,
                        (p * 2 + q) * C:(p * 2 + q + 1) * C,
                        (a * 2 + bb) * C1:(a * 2 + bb + 1) * C1,
                    ].set(w1[dy, dx])
    w2p = jnp.zeros((2, 2, 4 * C1, C2), w2.dtype)
    for dy in range(3):
        for dx in range(3):
            sy, sx = dy - 1, dx - 1
            Dy, Dx = sy >> 1, sx >> 1
            a, bb = sy - 2 * Dy, sx - 2 * Dx
            w2p = w2p.at[
                Dy + 1, Dx + 1,
                (a * 2 + bb) * C1:(a * 2 + bb + 1) * C1, :,
            ].add(w2[dy, dx])
    return w1p, w2p


def slice_preyolo(spec: NetworkSpec, folded_params):
    """Serving-time head slice: drop the class output channels of every
    pre-yolo conv.

    The reference trains 80-class-wide heads (a COCO-warm-start artefact,
    model_cfg/yolo_baseline.cfg:5) but the cone pipeline is single-class:
    detect/NMS use conf only (detect.py:84-93) and even validate.py's class
    argmax is never used in matching (validate.py:126 'TODO fix for
    multi-class'). Each anchor's 5+C channel block keeps only its first 5
    — at B=128/416² the class channels are ~220 GFLOP + ~220 MB of writes
    per batch of pure waste.

    Returns (spec', folded') where spec'.net.num_classes == 0 and the
    pre-yolo convs are (5·A)-wide. Decode with ``with_classes=False``.
    """
    import dataclasses

    nattr = 5 + spec.net.num_classes
    new_params = dict(folded_params)
    new_blocks = []
    yolo_masks = list(spec.net.yolo_masks)
    yolo_i = 0
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock) and b.is_preyolo:
            na = len(yolo_masks[yolo_i])
            yolo_i += 1
            keep = np.concatenate(
                [np.arange(a * nattr, a * nattr + 5) for a in range(na)])
            p = folded_params[str(i)]
            new_params[str(i)] = {
                "w": p["w"][..., keep],
                "b": p["b"][..., keep],
            }
            new_blocks.append(dataclasses.replace(b, filters=5 * na))
        else:
            new_blocks.append(b)
    new_net = dataclasses.replace(spec.net, num_classes=0)
    new_spec = dataclasses.replace(spec, net=new_net, blocks=tuple(new_blocks))
    return new_spec, new_params


def apply_packed_stem(packed: Dict[str, jnp.ndarray], x, leaky_slope: float):
    """x (B, H, W, C) → conv2 output (B, H/2, W/2, C2), exactly equal to
    leaky(conv2(leaky(conv1(x))))."""
    xp = pack_input(x)
    h = jax.lax.conv_general_dilated(
        xp, packed["w1"], (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + packed["b1"]
    h = jnp.where(h >= 0, h, h * leaky_slope)
    out = jax.lax.conv_general_dilated(
        h, packed["w2"], (1, 1), [(1, 0), (1, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + packed["b2"]
    return jnp.where(out >= 0, out, out * leaky_slope)
