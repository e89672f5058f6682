import os

import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.infer.detect import (
    detect_batch,
    detect_image,
    unletterbox_boxes,
)
from mit_driverless_cv_traininginfra.infer.pipeline import two_stage_pipeline
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import init_params

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _setup():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    yp, ys = init_params(spec, jax.random.PRNGKey(0))
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    return spec, yp, ys, rp, rs


def test_detect_batch_shapes():
    spec, yp, ys, _, _ = _setup()
    imgs = jnp.zeros((2, 64, 64, 3))
    det = detect_batch(spec, yp, ys, imgs, conf_thresh=0.0, nms_thresh=0.25, top_k=8)
    assert det.boxes.shape == (2, 8, 4)
    assert det.scores.shape == (2, 8) and det.mask.shape == (2, 8)
    # conf_thresh=0 with random init keeps something
    assert bool(det.mask.any())


def test_detect_image_host_roundtrip():
    spec, yp, ys, _, _ = _setup()
    img = np.random.default_rng(0).uniform(0, 255, (100, 60, 3)).astype(np.uint8)
    boxes, scores = detect_image(spec, yp, ys, img, conf_thresh=0.0, top_k=8)
    assert boxes.ndim == 2 and boxes.shape[1] == 4
    assert len(boxes) == len(scores)


def test_unletterbox_inverse():
    boxes = jnp.asarray([[10.0, 20.0, 30.0, 40.0]])
    out = unletterbox_boxes(boxes, pad_h=5, pad_w=3, ratio=2.0)
    np.testing.assert_allclose(np.asarray(out), [[2.0, 5.0, 12.0, 15.0]])


def test_two_stage_pipeline_end_to_end():
    spec, yp, ys, rp, rs = _setup()
    frames = jnp.asarray(
        np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)), jnp.float32
    )
    out = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.0, nms_thresh=0.25, max_det=4,
    )
    assert out.boxes.shape == (2, 4, 4)
    assert out.keypoints.shape == (2, 4, 7, 2)
    # keypoints of valid detections live inside their boxes
    m = np.asarray(out.mask)
    kx = np.asarray(out.keypoints[..., 0])
    bx0 = np.asarray(out.boxes[..., 0:1])
    bx1 = np.asarray(out.boxes[..., 2:3])
    valid = m[..., None] & np.ones_like(kx, bool)
    assert (kx[valid.astype(bool)] >= (bx0 - 1e-3 + np.zeros_like(kx))[valid]).all()
    assert (kx[valid] <= (bx1 + 1e-3 + np.zeros_like(kx))[valid]).all()


def test_crop_capacity_compaction_matches_dense():
    """crop_capacity ≥ #valid must be bit-identical to the dense path on
    valid slots (and zero on invalid ones)."""
    spec, yp, ys, rp, rs = _setup()
    frames = jnp.asarray(
        np.random.default_rng(2).uniform(0, 1, (4, 64, 64, 3)), jnp.float32
    )
    dense = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.3, nms_thresh=0.25, max_det=4,
    )
    n_valid = int(np.asarray(dense.mask).sum())
    cap = max(n_valid, 1)
    comp = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.3, nms_thresh=0.25, max_det=4, crop_capacity=cap,
    )
    m = np.asarray(dense.mask)
    np.testing.assert_array_equal(np.asarray(comp.mask), m)
    np.testing.assert_allclose(np.asarray(comp.keypoints)[m],
                               np.asarray(dense.keypoints)[m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(comp.boxes),
                                  np.asarray(dense.boxes))


def test_crop_capacity_overflow_drops_lowest_scores():
    spec, yp, ys, rp, rs = _setup()
    frames = jnp.asarray(
        np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)), jnp.float32
    )
    dense = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.0, nms_thresh=0.25, max_det=4,
    )
    m = np.asarray(dense.mask)
    n_valid = int(m.sum())
    if n_valid < 2:
        return  # nothing to drop with this seed
    cap = n_valid - 1
    comp = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.0, nms_thresh=0.25, max_det=4, crop_capacity=cap,
    )
    # boxes/scores/mask untouched; exactly the lowest-score valid detection
    # lost its keypoints (zeros before the box offset is applied)
    np.testing.assert_array_equal(np.asarray(comp.mask), m)
    scores = np.asarray(dense.scores)
    valid_scores = scores[m]
    drop = valid_scores.argsort()[:1]
    kept_sc = np.sort(valid_scores)[::-1][:cap]
    kc = np.asarray(comp.keypoints)[m]
    kd = np.asarray(dense.keypoints)[m]
    match = np.isclose(kc, kd, rtol=1e-5, atol=1e-5).all(axis=(1, 2))
    assert match.sum() == cap, (match.sum(), cap)
    assert not match[valid_scores.argsort()[0]]


def _walk_jaxpr_eqns(jaxpr):
    """Yield every eqn in a (closed)jaxpr, recursing into sub-jaxprs."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                yield from _walk_jaxpr_eqns(sub)
            if isinstance(v, (list, tuple)):
                for vi in v:
                    sub = getattr(vi, "jaxpr", None)
                    if sub is not None:
                        yield from _walk_jaxpr_eqns(sub)


def test_bf16_pipeline_dtype_discipline():
    """Regression precedent cf4ed24: an f32 leak in the bf16 serving graph
    was caught by the driver bench, not the suite. Pin it here: the bf16
    pipeline's jaxpr must contain NO f32 convolutions and no f32
    high-rank contractions (the crop einsums) — the compute-heavy ops must
    all ride bf16."""
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn

    spec, yp, ys, rp, rs = _setup()
    folded = fold_bn(yp, ys, spec)
    rpf = rektnet.fold_bn(rp, rs)
    to_c = lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), t)
    folded, rpf = to_c(folded), to_c(rpf)
    frames = jnp.zeros((2, 64, 64, 3), jnp.bfloat16)

    fn = lambda f: two_stage_pipeline(spec, folded, {}, rpf, {}, f,
                                      conf_thresh=0.1, max_det=4,
                                      crop_capacity=4)
    jaxpr = jax.make_jaxpr(fn)(frames)
    bad = []
    for eqn in _walk_jaxpr_eqns(jaxpr.jaxpr):
        name = eqn.primitive.name
        in_dtypes = [getattr(v.aval, "dtype", None) for v in eqn.invars]
        if name == "conv_general_dilated":
            if any(d == jnp.float32 for d in in_dtypes):
                bad.append((name, in_dtypes,
                            [getattr(v.aval, "shape", ()) for v in eqn.invars]))
        elif name == "dot_general":
            shapes = [getattr(v.aval, "shape", ()) for v in eqn.invars]
            # the crop einsums are >2-D contractions over the frame pixels;
            # small f32 dots (soft-argmax grids, decode) are fine
            if (all(len(s) >= 3 for s in shapes)
                    and any(d == jnp.float32 for d in in_dtypes)):
                bad.append((name, in_dtypes, shapes))
    assert not bad, f"f32 leaked into the bf16 serving graph: {bad}"


def test_bf16_keypoint_deviation_bounded():
    """bf16 serving (frames + params) vs f32 on the crop→keypoint stage
    with FIXED boxes (so detect-stage score noise can't reorder slots),
    including far-coordinate boxes (> 256 px — the advisor-r2 bf16
    precision regression). Keypoint deviation must stay within a few
    bf16 ulps of the crop values, not pixels."""
    rng = np.random.default_rng(11)
    _, _, _, rp, rs = _setup()
    rpf = rektnet.fold_bn(rp, rs)
    frames = jnp.asarray(rng.uniform(0, 1, (1, 416, 416, 3)), jnp.float32)
    boxes = jnp.asarray(
        [[[300.0, 310.0, 390.0, 400.0], [20.0, 30.0, 90.0, 110.0]]])

    from mit_driverless_cv_traininginfra.ops.image import (
        roi_crop_bilinear,
    )

    def kpts(fr, params):
        crops = roi_crop_bilinear(fr, boxes, 80, 80)
        flat = crops.reshape(-1, 80, 80, 3)
        return rektnet.apply_folded(params, flat)[1]

    p32 = np.asarray(kpts(frames, rpf), np.float32)
    to_c = lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), t)
    pbf = np.asarray(kpts(frames.astype(jnp.bfloat16), to_c(rpf)),
                     np.float32)
    dev = np.abs(pbf - p32).max()  # [0,1] crop coords; 80 px crop
    assert dev < 0.02, f"bf16 keypoint deviation {dev} (= {dev*80:.2f} px)"


def test_pipeline_bf16_params():
    """bf16 serving params + bf16 frames must run end-to-end: NMS emits f32
    boxes, and the crop must follow the FRAME dtype (regression: f32 boxes
    used to promote the crops and crash the folded keypoint conv)."""
    import jax

    from mit_driverless_cv_traininginfra.models.darknet import fold_bn

    spec, yp, ys, rp, rs = _setup()
    folded = fold_bn(yp, ys, spec)
    rpf = rektnet.fold_bn(rp, rs)
    to_c = lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), t)
    frames = jnp.asarray(
        np.random.default_rng(5).random((2, 64, 64, 3)), jnp.bfloat16)
    for cap in (None, 4):
        out = two_stage_pipeline(spec, to_c(folded), {}, to_c(rpf), {},
                                 frames, conf_thresh=0.1, max_det=4,
                                 crop_capacity=cap)
        assert out.keypoints.shape == (2, 4, 7, 2)
        assert np.all(np.isfinite(np.asarray(out.keypoints, np.float32)))


def test_overflow_dropped_keypoints_are_zero_sentinels():
    """A dropped detection's frame-space keypoints must come out as
    all-zeros (a detectable sentinel), NOT as 7 copies of the box's
    top-left corner that look like plausible in-frame points."""
    spec, yp, ys, rp, rs = _setup()
    frames = jnp.asarray(
        np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)), jnp.float32
    )
    dense = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.0, nms_thresh=0.25, max_det=4,
    )
    m = np.asarray(dense.mask)
    n_valid = int(m.sum())
    if n_valid < 2:
        return
    cap = n_valid - 1
    comp = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.0, nms_thresh=0.25, max_det=4, crop_capacity=cap,
    )
    kc = np.asarray(comp.keypoints)[m]
    valid_scores = np.asarray(dense.scores)[m]
    dropped = valid_scores.argsort()[0]
    assert np.all(kc[dropped] == 0.0)
    boxes = np.asarray(comp.boxes)[m]
    x0y0 = boxes[dropped, 0:2]
    assert not np.allclose(kc[dropped], np.tile(x0y0, (7, 1)), atol=1e-3)
    # invalid slots are zero too
    if (~m).any():
        assert np.all(np.asarray(comp.keypoints)[~m] == 0.0)


def test_kpt_pad_multiple_is_value_preserving():
    """kpt_pad_multiple runs the keypoint net on a zero-padded crop buffer
    (128-multiple scheduling A/B, VERDICT r3 #6) — outputs must be
    unchanged vs the unpadded compacted pipeline."""
    spec, yp, ys, rp, rs = _setup()
    frames = jnp.asarray(
        np.random.default_rng(7).uniform(0, 1, (4, 64, 64, 3)), jnp.float32
    )
    base = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.3, nms_thresh=0.25, max_det=4, crop_capacity=3,
    )
    padded = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.3, nms_thresh=0.25, max_det=4, crop_capacity=3,
        kpt_pad_multiple=8,
    )
    np.testing.assert_array_equal(np.asarray(padded.mask),
                                  np.asarray(base.mask))
    np.testing.assert_array_equal(np.asarray(padded.boxes),
                                  np.asarray(base.boxes))
    np.testing.assert_allclose(np.asarray(padded.keypoints),
                               np.asarray(base.keypoints),
                               rtol=1e-5, atol=1e-5)
    # multiple-of-pad capacity is a no-op (same program either way)
    same = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.3, nms_thresh=0.25, max_det=4, crop_capacity=8,
        kpt_pad_multiple=8,
    )
    ref8 = two_stage_pipeline(
        spec, yp, ys, rp, rs, frames,
        conf_thresh=0.3, nms_thresh=0.25, max_det=4, crop_capacity=8,
    )
    np.testing.assert_array_equal(np.asarray(same.keypoints),
                                  np.asarray(ref8.keypoints))


def test_uint8_feed_matches_host_normalize():
    """uint8 frames are a wire-efficient feed (serve CLI default): the
    pipeline normalizes on device in f32 then casts to the params' float
    dtype. XLA folds the /255 into a reciprocal multiply, so the inputs
    match the host f32/255 feed to 1 ulp (measured 6e-8) — downstream
    compute is the same program, so outputs must agree to float-noise
    tolerance with identical detection masks."""
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline_int8,
    )
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate,
        calibrate_rektnet,
        quantize_params,
        quantize_rektnet_params,
    )

    spec, yp, ys, rp, rs = _setup()
    u8 = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
    f32 = jnp.asarray(u8.astype(np.float32) / 255.0)

    a = two_stage_pipeline(spec, yp, ys, rp, rs, jnp.asarray(u8),
                           conf_thresh=0.0, nms_thresh=0.25, max_det=4)
    b = two_stage_pipeline(spec, yp, ys, rp, rs, f32,
                           conf_thresh=0.0, nms_thresh=0.25, max_det=4)
    np.testing.assert_array_equal(np.asarray(a.mask), np.asarray(b.mask))
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32),
                                   rtol=1e-4, atol=1e-4)

    folded = fold_bn(yp, ys, spec)
    amax = calibrate(spec, folded, f32)
    yq = quantize_params(spec, folded, amax)
    rpf = rektnet.fold_bn(rp, rs)
    rq = quantize_rektnet_params(
        rpf, calibrate_rektnet(rpf, f32[:, :40, :40, :]))
    a8 = two_stage_pipeline_int8(spec, yq, None, rq, jnp.asarray(u8),
                                 conf_thresh=0.0, nms_thresh=0.25, max_det=4)
    b8 = two_stage_pipeline_int8(spec, yq, None, rq,
                                 f32.astype(jnp.bfloat16),
                                 conf_thresh=0.0, nms_thresh=0.25, max_det=4)
    # int8 path: the 1-ulp f32 normalize difference is mostly absorbed by
    # the bf16 cast; the first conv's int8 quantization grid absorbs the
    # rest at all but exact rounding boundaries
    np.testing.assert_array_equal(np.asarray(a8.mask), np.asarray(b8.mask))
    for x, y in zip(a8, b8):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32),
                                   rtol=1e-3, atol=1e-3)
