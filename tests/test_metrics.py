import numpy as np
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.ops.metrics import (
    average_precision,
    compute_ap,
    evaluate_image_batch,
    greedy_match,
    summarize,
)


def test_compute_ap_perfect():
    # monotone recall with precision 1 everywhere → AP = 1
    r = jnp.asarray([0.25, 0.5, 0.75, 1.0])
    p = jnp.ones((4,))
    assert float(compute_ap(r, p)) == 1.0


def _oracle_ap(tp, conf, n_gt):
    """numpy restatement of utils/utils.py:58-119."""
    order = np.argsort(-conf)
    tp = tp[order].astype(float)
    fpc = np.cumsum(1 - tp)
    tpc = np.cumsum(tp)
    recall = tpc / (n_gt + 1e-16)
    precision = tpc / (tpc + fpc)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    ap = np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])
    return ap, tpc[-1] / (n_gt + 1e-16), tpc[-1] / (tpc[-1] + fpc[-1])


def test_average_precision_matches_oracle():
    rng = np.random.default_rng(0)
    for trial in range(5):
        k = 20
        tp = (rng.uniform(size=k) > 0.5).astype(np.float32)
        conf = rng.uniform(0.01, 1, size=k).astype(np.float32)
        n_gt = int(tp.sum() + rng.integers(1, 4))
        ap, r, p = average_precision(jnp.asarray(tp), jnp.asarray(conf), n_gt)
        eap, er, ep = _oracle_ap(tp, conf, n_gt)
        assert abs(float(ap) - eap) < 1e-5, trial
        assert abs(float(r) - er) < 1e-6 and abs(float(p) - ep) < 1e-6


def test_average_precision_with_padding():
    tp = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    conf = jnp.asarray([0.9, 0.8, 0.7, 0.6])
    valid = jnp.asarray([True, True, False, False])
    ap, r, p = average_precision(tp, conf, 2, valid=valid)
    assert float(ap) == 1.0 and float(r) == 1.0 and float(p) == 1.0


def test_greedy_match_one_det_per_target():
    gt = jnp.asarray([[0.0, 0.0, 10.0, 10.0]])
    dets = jnp.asarray([[0.0, 0.0, 10.0, 10.0], [1.0, 1.0, 11.0, 11.0]])
    correct = greedy_match(dets, jnp.asarray([True, True]), gt,
                           jnp.asarray([True]), iou_thresh=0.5)
    # both overlap the single GT, only the first (higher conf) counts
    np.testing.assert_array_equal(np.asarray(correct), [1.0, 0.0])


def test_evaluate_image_batch_perfect_detections():
    W = H = 128
    # two GT boxes per image, normalised xywh
    labels = np.zeros((2, 3, 5), np.float32)
    labels[0, 0] = [0, 0.25, 0.25, 0.2, 0.2]
    labels[0, 1] = [0, 0.7, 0.7, 0.25, 0.25]
    labels[1, 0] = [0, 0.5, 0.5, 0.3, 0.3]

    # detections exactly on the GT in pixels, high conf, plus junk low-conf
    dets = np.zeros((2, 8, 6), np.float32)
    for b in range(2):
        k = 0
        for t in range(3):
            if labels[b, t].sum() == 0:
                continue
            dets[b, k, 0:4] = labels[b, t, 1:5] * [W, H, W, H]
            dets[b, k, 4] = 0.95 - 0.01 * k
            k += 1
        dets[b, k:, 4] = 0.01  # below conf thresh

    ev = evaluate_image_batch(
        jnp.asarray(dets), jnp.asarray(labels), W, H,
        conf_thresh=0.8, nms_thresh=0.25, iou_thresh=0.5, top_k=8,
    )
    mAP, mR, mP = summarize(ev)
    assert mAP == 1.0 and mR == 1.0 and mP == 1.0


def test_evaluate_image_batch_skips_empty():
    labels = np.zeros((1, 2, 5), np.float32)
    labels[0, 0] = [0, 0.5, 0.5, 0.2, 0.2]
    dets = np.zeros((1, 4, 6), np.float32)  # all conf 0 → no detections
    ev = evaluate_image_batch(jnp.asarray(dets), jnp.asarray(labels), 64, 64,
                              conf_thresh=0.8, nms_thresh=0.25, iou_thresh=0.5,
                              top_k=4)
    assert not bool(ev.valid[0])
    assert summarize(ev) == (0.0, 0.0, 0.0)
