import numpy as np
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.ops.nms import batched_nms, nms


def _ref_nms(boxes, scores, overlap=0.5, top_k=200):
    """Direct numpy re-statement of the reference greedy semantics
    (utils/nms.py:4-62) used as the test oracle."""
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")[:top_k]
    order = order[np.isfinite(scores[order])]
    keep = []
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    suppressed = np.zeros(len(boxes), dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes[i, 0], boxes[order, 0])
        y1 = np.maximum(boxes[i, 1], boxes[order, 1])
        x2 = np.minimum(boxes[i, 2], boxes[order, 2])
        y2 = np.minimum(boxes[i, 3], boxes[order, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        union = area[order] + area[i] - inter
        iou = inter / np.where(union == 0, 1, union)
        suppressed[order[iou > overlap]] = True
    return keep


def test_nms_simple_suppression():
    boxes = jnp.array(
        [
            [0, 0, 10, 10],
            [1, 1, 11, 11],     # IoU with box0 ≈ 0.68 → suppressed
            [50, 50, 60, 60],   # far away → kept
        ],
        dtype=jnp.float32,
    )
    scores = jnp.array([0.9, 0.8, 0.7])
    idx, mask = nms(boxes, scores, overlap=0.5, top_k=3)
    kept = list(np.asarray(idx)[np.asarray(mask)])
    assert kept == [0, 2]


def test_nms_matches_reference_oracle_random():
    rng = np.random.default_rng(0)
    for trial in range(8):
        n = 64
        xy = rng.uniform(0, 100, size=(n, 2))
        wh = rng.uniform(1, 40, size=(n, 2))
        boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
        scores = rng.uniform(0.01, 1.0, size=(n,)).astype(np.float32)
        # distinct scores so ordering is unambiguous across sort impls
        scores = np.unique(scores)[:n]
        scores = np.pad(scores, (0, n - len(scores)), constant_values=0.005)
        expected = _ref_nms(boxes, scores, overlap=0.4, top_k=50)
        idx, mask = nms(jnp.asarray(boxes), jnp.asarray(scores), overlap=0.4, top_k=50)
        got = list(np.asarray(idx)[np.asarray(mask)])
        assert got == expected, f"trial {trial}: {got} != {expected}"


def test_nms_padded_rows_never_kept():
    boxes = jnp.array([[0, 0, 10, 10], [20, 20, 30, 30]], dtype=jnp.float32)
    boxes = jnp.concatenate([boxes, jnp.zeros((6, 4))], axis=0)
    scores = jnp.concatenate(
        [jnp.array([0.9, 0.8]), jnp.full((6,), -jnp.inf)], axis=0
    )
    idx, mask = nms(boxes, scores, overlap=0.5, top_k=8)
    assert int(mask.sum()) == 2
    assert set(np.asarray(idx)[np.asarray(mask)]) == {0, 1}


def test_batched_nms_shapes():
    boxes = jnp.zeros((4, 16, 4))
    scores = jnp.full((4, 16), -jnp.inf)
    idx, mask = batched_nms(boxes, scores, top_k=8)
    assert idx.shape == (4, 8) and mask.shape == (4, 8)
    assert not bool(mask.any())
