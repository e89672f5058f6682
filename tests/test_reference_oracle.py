"""Parity tests against the ACTUAL reference implementation.

Unlike the hand-built torch oracles elsewhere in the suite (which could share
a misreading of the reference with the implementation under test), these
import ``/root/reference`` directly — the installed CPU torch runs the
reference's own ``build_targets`` (CVC-YOLOv3/utils/utils.py:195-275),
``nms`` (utils/nms.py:4-62), ``average_precision`` (utils/utils.py:58-119),
``affine_labels`` (utils/datasets.py:317-382), ``KeypointNet``
(RektNet/keypoint_net.py:12-70) and ``CrossRatioLoss``
(RektNet/cross_ratio_loss.py:20-63) on shared random inputs.

The reference tree is treated strictly as an oracle (outputs only).
"""

import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "CVC-YOLOv3")),
    reason="reference tree not mounted",
)

torch = pytest.importorskip("torch")

_loaded = {}


def _ref_modules():
    """Import the reference modules once, with stubs for the deps this image
    lacks (imgaug, torchvision — only touched at call time, not by the
    functions under test)."""
    if _loaded:
        return _loaded
    for name in ("imgaug", "imgaug.augmenters"):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
    sys.modules["imgaug"].augmenters = sys.modules["imgaug.augmenters"]
    if "torchvision" not in sys.modules:
        tv = types.ModuleType("torchvision")
        tv.set_image_backend = lambda *_: None
        tv.transforms = types.ModuleType("torchvision.transforms")
        tv.transforms.functional = types.ModuleType(
            "torchvision.transforms.functional")
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.transforms"] = tv.transforms
        sys.modules["torchvision.transforms.functional"] = tv.transforms.functional
    paths = [os.path.join(REF, "CVC-YOLOv3"), os.path.join(REF, "RektNet")]
    sys.path[0:0] = paths
    try:
        import cross_ratio_loss as ref_crl
        import keypoint_net as ref_kpn
        import utils.datasets as ref_datasets
        import utils.nms as ref_nms
        import utils.utils as ref_utils
    finally:
        for p in paths:
            sys.path.remove(p)
    _loaded.update(utils=ref_utils, nms=ref_nms, datasets=ref_datasets,
                   kpn=ref_kpn, crl=ref_crl)
    return _loaded


def _rand_targets(B, T, rng):
    """(B, T, 5) normalised [cls, cx, cy, w, h]; row 0 always valid (the
    reference's padding-fill trick requires >=1 target per image)."""
    t = np.zeros((B, T, 5), np.float32)
    n_valid = rng.integers(1, T + 1, size=B)
    for b in range(B):
        k = n_valid[b]
        t[b, :k, 1:3] = rng.uniform(0.05, 0.95, (k, 2))
        t[b, :k, 3:5] = rng.uniform(0.02, 0.4, (k, 2))
    return t


@pytest.mark.parity
@pytest.mark.parametrize("grid", [(13, 13), (10, 16)])
def test_build_targets_matches_reference(grid):
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.models.yolo_loss import (
        build_targets,
    )

    gh, gw = grid
    rng = np.random.default_rng(0)
    targets = _rand_targets(4, 6, rng)
    anchors = rng.uniform(0.5, 6.0, (3, 2)).astype(np.float32)  # grid units

    r = ref["utils"].build_targets(
        torch.from_numpy(targets), torch.from_numpy(anchors),
        num_anchors=3, num_classes=2, grid_size_h=gh, grid_size_w=gw,
        ignore_thres=0.5)
    mask_r, conf_r, tx_r, ty_r, tw_r, th_r, tconf_r, tcls_r = [
        v.numpy() for v in r]

    mine = build_targets(targets, anchors, num_classes=2, grid_h=gh,
                         grid_w=gw, ignore_thresh=0.5)

    np.testing.assert_array_equal(np.asarray(mine.mask, np.uint8), mask_r)
    np.testing.assert_array_equal(np.asarray(mine.conf_mask, np.uint8), conf_r)
    for got, want in [(mine.tx, tx_r), (mine.ty, ty_r),
                      (mine.tw, tw_r), (mine.th, th_r),
                      (mine.tconf, tconf_r)]:
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(mine.tcls, np.uint8), tcls_r)


@pytest.mark.parity
@pytest.mark.parametrize("top_k", [200, 10])
def test_nms_matches_reference(top_k):
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.ops.nms import nms

    rng = np.random.default_rng(1)
    # overlapping clusters so suppression actually fires
    centers = rng.uniform(30, 370, (12, 2))
    boxes = []
    for cx, cy in centers:
        for _ in range(5):
            w, h = rng.uniform(20, 60, 2)
            jx, jy = rng.normal(0, 6, 2)
            boxes.append([cx + jx - w / 2, cy + jy - h / 2,
                          cx + jx + w / 2, cy + jy + h / 2])
    boxes = np.asarray(boxes, np.float32)
    scores = rng.uniform(0.01, 1.0, boxes.shape[0]).astype(np.float32)

    keep_ref = ref["nms"].nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              overlap=0.25, top_k=top_k).numpy()
    keep_idx, keep_mask = nms(boxes, scores, overlap=0.25, top_k=top_k)
    keep_mine = np.asarray(keep_idx)[np.asarray(keep_mask)]
    np.testing.assert_array_equal(keep_mine, keep_ref)


@pytest.mark.parity
def test_average_precision_matches_reference():
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.ops.metrics import (
        average_precision,
    )

    rng = np.random.default_rng(2)
    for n_det, n_gt in [(20, 12), (7, 30), (1, 1)]:
        tp = (rng.uniform(size=n_det) > 0.5).astype(np.float32)
        conf = rng.uniform(size=n_det).astype(np.float32)
        ap_r, r_r, p_r = ref["utils"].average_precision(
            torch.from_numpy(tp), torch.from_numpy(conf), n_gt)
        ap, r, p = average_precision(tp, conf, n_gt)
        np.testing.assert_allclose(float(ap), float(ap_r), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(r), float(r_r), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(p), float(p_r), rtol=1e-5, atol=1e-7)


@pytest.mark.parity
@pytest.mark.parametrize(
    "angle,translate,scale,shear",
    [
        (0.0, (0, 0), 1.0, (0, 0)),
        (8.5, (17, -23), 1.07, (2.0, -1.5)),
        (-10.0, (-40, 12), 0.9, (-3.0, 3.0)),
    ],
)
def test_affine_labels_matches_reference(angle, translate, scale, shear):
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.data.augment import affine_labels

    rng = np.random.default_rng(3)
    h, w = 416, 416
    n = 14
    x1 = rng.uniform(0, w - 60, n)
    y1 = rng.uniform(0, h - 60, n)
    bw = rng.uniform(3, 120, n)  # include sub-4px boxes → rejection branch
    bh = rng.uniform(3, 120, n)
    targets = np.stack([np.zeros(n), x1, y1, x1 + bw, y1 + bh],
                       axis=1).astype(np.float32)

    out_ref = ref["datasets"].affine_labels(
        h, w, torch.from_numpy(targets.copy()), angle=angle,
        translate=translate, scale=scale, shear=shear).numpy()
    out_mine = affine_labels(h, w, targets, angle=angle,
                             translate=translate, scale=scale, shear=shear)
    np.testing.assert_allclose(out_mine, out_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parity
def test_keypoint_net_forward_matches_reference():
    ref = _ref_modules()
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.models import rektnet

    torch.manual_seed(0)
    net = ref["kpn"].KeypointNet(num_kpt=7, image_size=(80, 80),
                                 onnx_mode=False, init_weight=True)
    net.eval()
    # randomise BN running stats so eval-mode normalisation is non-trivial
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 1.5)

    params, state = rektnet.params_from_torch_state_dict(net.state_dict())
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, 80, 80, 3)).astype(np.float32)

    with torch.no_grad():
        hm_ref, pts_ref = net(torch.from_numpy(
            np.transpose(x, (0, 3, 1, 2)).copy()))
    hm, pts, _ = rektnet.apply(params, state, jnp.asarray(x), train=False)

    np.testing.assert_allclose(np.asarray(hm), hm_ref.numpy(),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(pts), pts_ref.numpy(),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parity
@pytest.mark.parametrize("loss_type", ["l2_softargmax", "l2_heatmap",
                                       "l1_softargmax"])
@pytest.mark.parametrize("include_geo", [False, True])
def test_cross_ratio_loss_matches_reference(loss_type, include_geo):
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.models.cross_ratio_loss import (
        cross_ratio_loss,
    )

    rng = np.random.default_rng(5)
    B = 4
    hm = rng.uniform(0, 1, (B, 7, 80, 80)).astype(np.float32)
    hm /= hm.sum(axis=(2, 3), keepdims=True)
    t_hm = rng.uniform(0, 1, (B, 7, 80, 80)).astype(np.float32)
    t_hm /= t_hm.sum(axis=(2, 3), keepdims=True)
    pts = rng.uniform(0.1, 0.9, (B, 7, 2)).astype(np.float32)
    t_pts = rng.uniform(0.1, 0.9, (B, 7, 2)).astype(np.float32)

    crit = ref["crl"].CrossRatioLoss(loss_type, include_geo,
                                     geo_loss_gamma_horz=0.05,
                                     geo_loss_gamma_vert=0.07)
    with torch.no_grad():
        loc_r, geo_r, tot_r = crit(torch.from_numpy(hm),
                                   torch.from_numpy(pts),
                                   torch.from_numpy(t_hm),
                                   torch.from_numpy(t_pts))
    loc, geo, tot = cross_ratio_loss(
        hm, pts, t_hm, t_pts, loss_type=loss_type, include_geo=include_geo,
        geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.07, cross_batch=True)
    np.testing.assert_allclose(float(loc), float(loc_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(geo), float(geo_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tot), float(tot_r), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# geometry / tiling oracles (utils/utils.py)
# ---------------------------------------------------------------------------


@pytest.mark.parity
def test_box_conversions_match_reference():
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.ops.boxes import (
        add_padding_on_each_side,
        scale_labels,
        xyhw2xyxy_corner,
        xywh2xyxy,
        xyxy2xywh,
    )

    rng = np.random.default_rng(10)
    xywh = rng.uniform(10, 300, (16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(xywh2xyxy(xywh)),
        ref["utils"].xywh2xyxy(torch.from_numpy(xywh)).numpy(), rtol=1e-6)
    xyxy = rng.uniform(10, 300, (16, 4)).astype(np.float32)
    xyxy[:, 2:] += xyxy[:, :2]
    np.testing.assert_allclose(
        np.asarray(xyxy2xywh(xyxy)),
        ref["utils"].xyxy2xywh(torch.from_numpy(xyxy)).numpy(), rtol=1e-6)

    # CSV-format labels [class, x, y, h, w] (h before w — reference quirk)
    import jax.numpy as jnp

    lab = np.zeros((8, 5), np.float32)
    lab[:, 1:] = rng.uniform(5, 200, (8, 4))
    np.testing.assert_allclose(
        np.asarray(xyhw2xyxy_corner(jnp.asarray(lab))),
        ref["utils"].xyhw2xyxy_corner(torch.from_numpy(lab.copy())).numpy(),
        rtol=1e-6)
    corner = np.asarray(xyhw2xyxy_corner(jnp.asarray(lab)))
    np.testing.assert_allclose(
        np.asarray(scale_labels(jnp.asarray(corner), 1.37)),
        ref["utils"].scale_labels(torch.from_numpy(corner.copy()), 1.37).numpy(),
        rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(add_padding_on_each_side(jnp.asarray(corner), 12, 7)),
        ref["utils"].add_padding_on_each_side(
            torch.from_numpy(corner.copy()), 12, 7).numpy(), rtol=1e-6)


@pytest.mark.parity
@pytest.mark.parametrize("hw", [(600, 400), (400, 600), (800, 800)])
def test_calculate_padding_matches_reference(hw):
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.ops.boxes import calculate_padding

    h, w = hw
    assert (calculate_padding(h, w, 416, 416)
            == ref["utils"].calculate_padding(h, w, 416, 416))


@pytest.mark.parity
def test_patch_tiling_matches_reference():
    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.ops.patches import (
        filter_and_offset_labels,
        get_patch_bounds,
        get_patch_spacings,
        pre_tile_padding,
    )

    for iw, ih, pw, ph in [(1000, 700, 416, 416), (416, 416, 416, 416),
                           (900, 900, 300, 450)]:
        assert (pre_tile_padding(iw, ih, pw, ph)
                == ref["utils"].pre_tile_padding(iw, ih, pw, ph))
        padded_w, padded_h = iw + 2 * ref["utils"].pre_tile_padding(
            iw, ih, pw, ph)[1], ih + 2 * ref["utils"].pre_tile_padding(
            iw, ih, pw, ph)[0]
        assert (get_patch_spacings(padded_w, padded_h, pw, ph)
                == ref["utils"].get_patch_spacings(padded_w, padded_h, pw, ph))
        n = get_patch_spacings(padded_w, padded_h, pw, ph)[2]

        class FakeImg:  # the reference's get_patch only reads .size/.crop
            size = (padded_w, padded_h)

            def crop(self, b):
                return b

        for pi in range(n):
            _, boundary = ref["utils"].get_patch(FakeImg(), pw, ph, pi)
            assert tuple(get_patch_bounds(padded_w, padded_h, pw, ph, pi)) \
                == tuple(boundary)

    # label filtering against the patch boundary
    rng = np.random.default_rng(11)
    lab = np.zeros((10, 5), np.float32)
    lab[:, 1:3] = rng.uniform(0, 800, (10, 2))
    lab[:, 3:5] = lab[:, 1:3] + rng.uniform(10, 120, (10, 2))
    boundary = (200.0, 150.0, 616.0, 566.0)
    got = filter_and_offset_labels(lab.copy(), boundary)
    want = ref["datasets"].filter_and_offset_labels(
        torch.from_numpy(lab.copy()), boundary).numpy()
    # both return zeros-of-input-shape when nothing survives (quirk kept)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# full-graph oracle: our executor + byte-format weights vs reference Darknet
# ---------------------------------------------------------------------------


@pytest.mark.parity
def test_darknet_full_forward_matches_reference(tmp_path):
    """Round-trip the strongest cross-check available: our params are saved
    through save_darknet_weights, loaded by the REFERENCE's own
    Darknet.load_weights (models.py:339-397), and the reference's eval
    forward (models.py:312-338) must match our ``detections`` on the same
    frames — covering the cfg parse, graph build, executor, head decode and
    the .weights byte format in one assertion."""
    import jax
    import jax.numpy as jnp

    ref = _ref_modules()
    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.models.darknet import (
        detections,
        init_params,
        save_darknet_weights,
    )

    # cfg with a readable train_uri (the reference reads the anchors CSV
    # even under vanilla_anchor=True, models.py:28-36)
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "tiny_test.cfg")
    dummy_csv = tmp_path / "train.csv"
    dummy_csv.write_text("10,13|16,30|33,23\n")
    cfg_text = open(fixture).read().replace(
        "train_uri=", f"train_uri={dummy_csv}")
    cfg = tmp_path / "oracle.cfg"
    cfg.write_text(cfg_text)

    spec = load_network_spec(str(cfg), vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(3))
    # randomise BN stats so eval normalisation is non-trivial
    state = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(
            np.random.default_rng(4).uniform(0.1, 0.5, x.shape), x.dtype),
        state)
    wfile = str(tmp_path / "oracle.weights")
    save_darknet_weights(spec, params, state, wfile)

    sys.path.insert(0, os.path.join(REF, "CVC-YOLOv3"))
    try:
        import models as ref_models
    finally:
        sys.path.remove(os.path.join(REF, "CVC-YOLOv3"))
    net = ref_models.Darknet(str(cfg), xy_loss=2.0, wh_loss=1.6,
                             no_object_loss=25.0, object_loss=0.1,
                             vanilla_anchor=True)
    net.load_weights(wfile, net.start_weights_dim)
    net.eval()

    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        out_ref = net(torch.from_numpy(
            np.transpose(x, (0, 3, 1, 2)).copy())).numpy()

    out_mine = np.asarray(detections(spec, params, state, jnp.asarray(x)))
    assert out_mine.shape == out_ref.shape, (out_mine.shape, out_ref.shape)
    np.testing.assert_allclose(out_mine, out_ref, rtol=1e-4, atol=2e-4)


@pytest.mark.parity
def test_rektnet_pt_optimizer_state_resumable_by_torch(tmp_path):
    """The .pt checkpoint's ``optimizer`` slot must be a real
    ``torch.optim.Adam.state_dict()`` (train_eval.py:108-110), not ``{}`` —
    the reference's resume path calls ``optimizer.load_state_dict`` on it
    and then keeps training. Round-trip: our optax Adam state → .pt →
    reference KeypointNet + torch Adam → one real torch step."""
    ref = _ref_modules()
    import jax
    import jax.numpy as jnp
    import optax

    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.train.checkpoints import (
        _find_adam_state,
        save_rektnet_pt,
    )
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer

    params, state = rektnet.init(jax.random.PRNGKey(0))
    tx = make_optimizer("Adam", lr=1e-3)
    opt_state = tx.init(params)
    rng = np.random.default_rng(6)
    for _ in range(3):  # populate nonzero, step-dependent moments
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 0.01, p.shape), p.dtype),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    path = str(tmp_path / "resume.pt")
    save_rektnet_pt(path, params, state, epoch=3, optimizer_state=opt_state)

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert ckpt["epoch"] == 3
    net = ref["kpn"].KeypointNet(num_kpt=7, image_size=(80, 80),
                                 onnx_mode=False, init_weight=False)
    net.load_state_dict(ckpt["model"])
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    opt.load_state_dict(ckpt["optimizer"])  # the reference resume call

    # moments landed on the RIGHT parameters: shape match per-param, and the
    # stem conv's exp_avg equals our mu (transposed HWIO→OIHW)
    adam = _find_adam_state(opt_state)
    assert int(np.asarray(adam.count)) == 3
    torch_params = list(net.parameters())
    assert len(torch_params) == len(ckpt["optimizer"]["state"])
    for p in torch_params:
        st = opt.state[p]
        assert tuple(st["exp_avg"].shape) == tuple(p.shape)
        assert tuple(st["exp_avg_sq"].shape) == tuple(p.shape)
        assert int(st["step"]) == 3
    mu_stem = np.transpose(np.asarray(adam.mu["stem"]["w"]), (3, 2, 0, 1))
    np.testing.assert_allclose(
        opt.state[torch_params[0]]["exp_avg"].numpy(), mu_stem,
        rtol=1e-6, atol=1e-7)

    # and torch can actually continue training from it
    before = torch_params[0].detach().clone()
    net.train()
    hm, pts = net(torch.randn(2, 3, 80, 80))
    (hm.sum() + pts.sum()).backward()
    opt.step()
    assert not torch.equal(before, torch_params[0])
