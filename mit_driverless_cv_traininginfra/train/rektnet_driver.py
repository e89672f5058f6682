"""RektNet training driver — ``train_eval.py`` equivalent
(RektNet/train_eval.py:45-186), DP over the device mesh.

Parity: per-epoch train→validate, ExponentialLR(γ) stepped per epoch,
best-model ONNX export on validation improvement, periodic full-state
resume checkpoints (plus ``.pt`` files in the reference layout with
``save_checkpoints``), early stop after ``max_tolerance=8``
non-improving epochs, per-keypoint L2 distance report + the
``logs/<study>.txt`` score file for the sweep layer.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np

from mit_driverless_cv_traininginfra import backend
from mit_driverless_cv_traininginfra.data.rektnet_data import (
    DEFAULT_KEYPOINT_KEYS,
    ConeDataset,
    RektNetLoader,
    load_train_csv_dataset,
)
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.ops.heatmap import (
    keypoint_distance_summary,
    keypoint_l2_distances,
)
from mit_driverless_cv_traininginfra.parallel.mesh import (
    make_mesh,
    pad_batch_to_devices,
    replicate,
    shard_batch,
)
from mit_driverless_cv_traininginfra.train.checkpoints import (
    STATE_FILE,
    require_torch,
    restore_state,
    save_rektnet_pt,
    save_state,
)
from mit_driverless_cv_traininginfra.train.optim import (
    exponential_lr,
    make_optimizer,
    set_lr,
)
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    rektnet_eval_step,
    rektnet_train_step,
)
from mit_driverless_cv_traininginfra.utils.logger import write_score_file

MAX_TOLERANCE = 8  # train_eval.py:49


def eval_model(params, mstate, dataloader, loss_kw):
    loss_sums = [0.0, 0.0, 0.0]
    batch_num = 0
    for imgs, hms, pts, _, _ in dataloader:
        total, loc, geo, _ = rektnet_eval_step(params, mstate, imgs, hms, pts,
                                               **loss_kw)
        loss_sums[0] += float(loc)
        loss_sums[1] += float(geo)
        loss_sums[2] += float(total)
        batch_num += 1
    n = max(batch_num, 1)
    out = [s / n for s in loss_sums]
    print(f"\tValidation: MSE/Geometric/Total Loss: "
          f"{round(out[0], 10)}/{round(out[1], 10)}/{round(out[2], 10)}")
    return out


def print_kpt_l2_distance(params, mstate, dataloader, kpt_keys, study_name,
                          evaluate_mode: bool, input_size, loss_kw):
    """Per-keypoint distance stats + score file (train_eval.py:140-186)."""
    kpt_distances = []
    os.makedirs("logs", exist_ok=True)
    val_file = open("logs/rektnet_validation.txt", "a") if evaluate_mode else None
    for imgs, hms, pts, _, shapes in dataloader:
        _, _, _, pred = rektnet_eval_step(params, mstate, imgs, hms, pts, **loss_kw)
        # Reference quirk (train_eval.py:155-160): scales by
        # ``x_batch.shape[1]`` — which under NCHW is the CHANNEL count (3),
        # not the crop size — then by input_size. Reproduced exactly so the
        # reported distances (and the sweep score files) are comparable.
        scale = 3
        pred_px = np.asarray(pred) * scale * np.asarray(input_size)
        tgt_px = np.asarray(pts) * scale * np.asarray(input_size)
        d = np.asarray(keypoint_l2_distances(tgt_px, pred_px))
        for row, shape in zip(d, shapes):
            kpt_distances.append(row)
            if val_file is not None:
                h, w = shape[0], shape[1]
                val_file.write(f"{[w, h]}:{float(row.sum())}\n")
    if val_file is not None:
        val_file.close()
    means, total_dist, stds = keypoint_distance_summary(np.asarray(kpt_distances))
    print("Mean distance error of each keypoint is:")
    for k, m in zip(kpt_keys, means):
        print(f"\t{k}: {m}")
    print("Standard deviation of each keypoint is:")
    for k, s in zip(kpt_keys, stds):
        print(f"\t{k}: {s}")
    print(f"Total distance error is: {total_dist}")
    write_score_file(os.path.join("logs", study_name + ".txt"), total_dist)
    return total_dist


def main(*, train_dataset_uri: str, dataset_path: str,
         output_path: str = "outputs/", batch_size: int = 32,
         num_epochs: int = 1024, lr: float = 0.1, lr_gamma: float = 0.999,
         validation_ratio: float = 0.15, loss_type: str = "l1_softargmax",
         include_geo: bool = True, geo_loss_gamma_horz: float = 0.0,
         geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True,
         checkpoint_interval: int = 4, input_size=(80, 80), num_kpt: int = 7,
         study_name: str = "rektnet", evaluate_mode: bool = False,
         save_checkpoints: bool = True, cache_location: Optional[str] = None,
         checkpoint_path: Optional[str] = None, num_workers: int = 0,
         n_devices: Optional[int] = None, seed: int = 17,
         mixed_precision="auto", device_targets: bool = False,
         resume: bool = False, vis_upload_data: bool = False,
         post_run_shutdown: bool = False,
         kpt_keys: Sequence[str] = tuple(DEFAULT_KEYPOINT_KEYS)):
    os.makedirs(output_path, exist_ok=True)
    # mixed_precision="auto": bf16 compute on the GPU
    # (backend.mixed_precision); parity runs pass --no_mixed_precision.
    mixed_precision = backend.mixed_precision(mixed_precision)
    if save_checkpoints and not evaluate_mode:
        require_torch("save_checkpoints")
    ti, tl, vi, vl = load_train_csv_dataset(
        train_dataset_uri, validation_percent=validation_ratio,
        keypoint_keys=kpt_keys, dataset_path=dataset_path,
        cache_location=cache_location)

    if vis_upload_data:
        # "Become one with the data" pass (train_eval.py:249-252): render
        # the whole dataset, then stop. The reference hard-shuts the cloud
        # instance here; we gate that behind the explicit ops flag.
        from mit_driverless_cv_traininginfra.utils.vis import (
            visualize_dataset,
        )

        n = visualize_dataset(ti, tl, dataset_path,
                              os.path.join(output_path, "visualization"))
        print(f"visualized {n} dataset images")
        if post_run_shutdown:
            print("Shutting down instance...")
            os.system("shutdown now")
        return None
    train_loader = RektNetLoader(
        ConeDataset(ti, tl, dataset_path, input_size,
                    compute_heatmaps=not device_targets),
        batch_size, num_workers)
    val_loader = RektNetLoader(ConeDataset(vi, vl, dataset_path, input_size),
                               batch_size, num_workers)

    mesh = make_mesh(n_devices) if n_devices else None
    if checkpoint_path:
        params, mstate = rektnet.load_torch_checkpoint(checkpoint_path)
    else:
        params, mstate = rektnet.init(jax.random.PRNGKey(seed), num_kpt=num_kpt)
    tx = make_optimizer("Adam", lr=lr)
    ts = init_train_state(params, mstate, tx)

    start_epoch = 0
    state_path = os.path.join(output_path, STATE_FILE)
    if resume and os.path.exists(state_path):
        ts, meta = restore_state(state_path, ts)
        start_epoch = int(meta["epoch"])
        print(f"Resumed from {state_path} at epoch {start_epoch}")
    if mesh is not None:
        ts = replicate(mesh, ts)

    loss_kw = dict(loss_type=loss_type, include_geo=include_geo,
                   geo_loss_gamma_horz=geo_loss_gamma_horz,
                   geo_loss_gamma_vert=geo_loss_gamma_vert,
                   cross_batch=cross_batch)

    best_val_loss = float("inf")
    best_epoch = 0
    tolerance = 0
    if evaluate_mode:
        print_kpt_l2_distance(ts.params, ts.model_state, val_loader, kpt_keys,
                              study_name, True, input_size, loss_kw)
        return best_val_loss

    for epoch in range(start_epoch, num_epochs):
        print(f"EPOCH {epoch}")
        total_loss = [0.0, 0.0, 0.0]
        batch_num = 0
        for imgs, hms, pts, _, _ in train_loader:
            if mesh is not None:
                n_dev = len(mesh.devices.ravel())
                imgs, _ = pad_batch_to_devices(imgs, n_dev)
                hms, _ = pad_batch_to_devices(hms, n_dev)
                pts, _ = pad_batch_to_devices(pts, n_dev)
                imgs, hms, pts = shard_batch(mesh, (imgs, hms, pts))
            ts, total, loc, geo = rektnet_train_step(
                tx, ts, imgs, hms, pts,
                compute_dtype="bfloat16" if mixed_precision else "float32",
                synth_target_sigma=1.0 if device_targets else 0.0,
                **loss_kw)
            total_loss[0] += float(loc)
            total_loss[1] += float(geo)
            total_loss[2] += float(total)
            batch_num += 1
        n = max(batch_num, 1)
        print(f"\tTraining: MSE/Geometric/Total Loss: "
              f"{round(total_loss[0] / n, 10)}/{round(total_loss[1] / n, 10)}"
              f"/{round(total_loss[2] / n, 10)}")
        _, _, val_loss = eval_model(ts.params, ts.model_state, val_loader, loss_kw)
        # ExponentialLR stepped after eval (train_eval.py:85)
        ts = ts._replace(opt_state=set_lr(ts.opt_state,
                                          exponential_lr(lr, lr_gamma, epoch + 1)))

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            best_epoch = epoch
            tolerance = 0
            if save_checkpoints:
                try:
                    from mit_driverless_cv_traininginfra.export.pt_to_onnx import (
                        export_rektnet_onnx,
                    )

                    onnx_uri = os.path.join(
                        output_path,
                        f"best_keypoints_{input_size[0]}{input_size[1]}.onnx")
                    export_rektnet_onnx(ts.params, ts.model_state, onnx_uri,
                                        input_size=input_size, num_kpt=num_kpt)
                    print(f"Saving ONNX model to {onnx_uri}")
                except ImportError:
                    pass
        else:
            tolerance += 1

        if epoch != 0 and (epoch + 1) % checkpoint_interval == 0:
            if save_checkpoints:
                pt_uri = os.path.join(output_path,
                                      f"{epoch}_loss_{round(val_loss, 2)}.pt")
                print(f"Saving model to {pt_uri}")
                save_rektnet_pt(pt_uri, ts.params, ts.model_state,
                                epoch=epoch, optimizer_state=ts.opt_state)
            save_state(state_path, ts, epoch=epoch + 1)
        if tolerance >= MAX_TOLERANCE:
            print(f"Training is stopped due; loss no longer decreases. "
                  f"Epoch {best_epoch} is has the best validation loss.")
            break

    print_kpt_l2_distance(ts.params, ts.model_state, val_loader, kpt_keys,
                          study_name, evaluate_mode, input_size, loss_kw)
    return best_val_loss
