"""YOLO training driver — the ``train.py main``/``run_epoch`` equivalent
(CVC-YOLOv3/train.py:49-259), DP over the device mesh.

Behavioural parity: per-epoch StepLR at the top of the epoch, per-batch loss
logging with component percentages, checkpoint each ``checkpoint_interval``
epochs (legacy ``.weights`` + full resume state), validation loss + mAP at each
checkpoint, best-loss bookkeeping into ``logs/result.txt`` (the sweep-layer
score channel), early stop after ``val_tolerance`` non-improving checkpoints
past ``min_epochs``, then ONNX export of the final weights.

Differences from the reference: one jitted SPMD step per batch (no ``.item()``
sync per loss component — components come back as one array), async device
prefetch, BN stats over the global batch.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra import backend
from mit_driverless_cv_traininginfra.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra.data.loader import DataLoader, prefetch_to_device
from mit_driverless_cv_traininginfra.data.yolo_dataset import ImageLabelDataset
from mit_driverless_cv_traininginfra.models.darknet import (
    detections,
    init_params,
    load_darknet_weights,
    save_darknet_weights,
)
from mit_driverless_cv_traininginfra.ops.metrics import evaluate_image_batch
from mit_driverless_cv_traininginfra.parallel.mesh import (
    make_mesh,
    pad_batch_to_devices,
    replicate,
)
from mit_driverless_cv_traininginfra.train.checkpoints import (
    STATE_FILE,
    restore_state,
    save_state,
)
from mit_driverless_cv_traininginfra.train.optim import make_optimizer, set_lr, step_lr
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    yolo_eval_step,
    yolo_train_step,
    yolo_train_step_device_aug,
)
from mit_driverless_cv_traininginfra.utils.logger import write_score_file

# Reference quirk: train.py:56 labels the last two columns "L-noobj, L-obj"
# while the component tuple it prints is (x,y,w,h,obj,noobj) (models.py:211)
# — the printed names are swapped relative to the values. Log-parsing
# tooling keyed on the reference's column headers expects this order, so we
# reproduce the mislabeling; the VALUES (losses[5]=obj, losses[6]=noobj)
# match the reference's positions exactly.
LOSS_LABELS = ["Total", "L-x", "L-y", "L-w", "L-h", "L-noobj", "L-obj"]


def run_epoch(*, label_prefix: str, data_loader, spec, tx, ts, mesh,
              num_steps: int, step, epoch: int, loss_consts, optimize: bool,
              compute_dtype: str = "float32", device_aug: bool = False,
              aug_key=None, aug_flags=None, packed_stem: bool = False,
              lr_warmup=None):
    """Shared train/validate epoch loop (train.py:49-93). Returns
    (epoch_losses[7], epoch_time_total, epoch_num_targets, ts)."""
    print(f"Model in {label_prefix} mode")
    epoch_losses = [0.0] * 7
    epoch_time_total = 0.0
    epoch_num_targets = 1e-12
    t1 = time.time()
    xy, wh, obj, noobj = loss_consts
    n_dev = len(mesh.devices.ravel()) if mesh is not None else 1

    def with_host_counts(batches):
        # count targets on the HOST batch before device_put — a device-side
        # count would force a D2H sync per step and stall the prefetch queue
        for u, imgs, labels in batches:
            if mesh is not None:
                imgs, labels = pad_pair(imgs, labels, n_dev)
            n_t = float(((labels[:, :, 1:5] > 0).sum(axis=2) > 1).sum()) + 1e-12
            yield u, imgs, labels, n_t

    it = with_host_counts(iter(data_loader))
    if mesh is not None:
        it = prefetch_to_device(it, mesh)
    for i, (img_uri, imgs, targets, step_num_targets) in enumerate(it):
        if step[0] >= num_steps:
            break
        epoch_num_targets += step_num_targets

        if optimize and lr_warmup is not None:
            # linear lr warmup over the first N global steps (host-side
            # scalar swap via inject_hyperparams — no recompile). The
            # epoch-level StepLR value is the warmup ceiling.
            warm_n, epoch_lr = lr_warmup
            if step[0] < warm_n:
                ts = ts._replace(opt_state=set_lr(
                    ts.opt_state, epoch_lr * (step[0] + 1) / warm_n))
            elif step[0] == warm_n:
                ts = ts._replace(opt_state=set_lr(ts.opt_state, epoch_lr))
        if optimize and device_aug:
            key = jax.random.fold_in(aug_key, step[0])
            ts, loss, comps = yolo_train_step_device_aug(
                spec, tx, ts, imgs, targets, key,
                xy_loss=xy, wh_loss=wh, object_loss=obj, no_object_loss=noobj,
                compute_dtype=compute_dtype, packed_stem=packed_stem,
                **(aug_flags or {}),
            )
        elif optimize:
            ts, loss, comps = yolo_train_step(
                spec, tx, ts, imgs, targets,
                xy_loss=xy, wh_loss=wh, object_loss=obj, no_object_loss=noobj,
                compute_dtype=compute_dtype, packed_stem=packed_stem,
            )
        else:
            loss, comps = yolo_eval_step(
                spec, ts.params, ts.model_state, imgs, targets,
                xy_loss=xy, wh_loss=wh, object_loss=obj, no_object_loss=noobj,
            )
        losses = [float(loss)] + [float(c) for c in np.asarray(comps)]
        for j in range(7):
            epoch_losses[j] += losses[j]
        epoch_time_total = time.time() - t1

        statement = (f"{label_prefix} Epoch: {epoch}, Batch: {i + 1}/{len(data_loader)}"
                     f", Total: {losses[0] / step_num_targets:10.6f}")
        for lbl, val in zip(LOSS_LABELS[1:], losses[1:]):
            pct = val / losses[0] * 100 if losses[0] else 0.0
            statement += f",   {lbl}: {pct:5.2f}%"
        print(statement)
        if optimize:
            step[0] += 1
    return epoch_losses, epoch_time_total, epoch_num_targets, ts


def pad_pair(imgs, labels, n_dev):
    imgs, _ = pad_batch_to_devices(imgs, n_dev)
    labels, _ = pad_batch_to_devices(labels, n_dev)
    return imgs, labels


@functools.partial(jax.jit, static_argnames=("spec",))
def _detect_eval(spec, params, model_state, imgs):
    # module-level jit with params as ARGUMENTS: a closure jit bakes the
    # weights in as constants and recompiles the whole detection graph at
    # every checkpoint
    return detections(spec, params, model_state, imgs)


def validate_map(*, data_loader, spec, params, model_state, mesh, top_k=200):
    """mAP/R/P over a loader (validate.validate, validate.py:61-182)."""
    t0 = time.time()
    aps, rs, ps, valids = [], [], [], []
    n_images = 0
    for _, imgs, targets in data_loader:
        n_images += imgs.shape[0]
        dets = _detect_eval(spec, params, model_state, imgs)
        ev = evaluate_image_batch(
            dets, targets, spec.net.width, spec.net.height,
            conf_thresh=spec.net.conf_thresh, nms_thresh=spec.net.nms_thresh,
            iou_thresh=spec.net.iou_thresh, top_k=top_k,
        )
        aps.append(np.asarray(ev.ap)); rs.append(np.asarray(ev.recall))
        ps.append(np.asarray(ev.precision)); valids.append(np.asarray(ev.valid))
    valid = (np.concatenate(valids) if valids
             else np.zeros((0,), bool))  # empty validation set
    if valid.sum() == 0:
        mAP = mR = mP = 0.0
    else:
        mAP = float(np.concatenate(aps)[valid].mean())
        mR = float(np.concatenate(rs)[valid].mean())
        mP = float(np.concatenate(ps)[valid].mean())
    dt = time.time() - t0
    print("mAP: {0:5.2%}, Recall: {1:5.2%}, Precision: {2:5.2%}".format(mAP, mR, mP))
    return mAP, mR, mP, dt / (n_images + 1e-12)


def main(*, model_cfg: str, weights_path: Optional[str], output_path: str,
         dataset_path: str, batch_size: int = 8, optimizer_pick: str = "Adam",
         num_epochs: int = 100, num_steps: int = 10**9,
         checkpoint_interval: int = 1, lr: float = 1e-3, momentum: float = 0.9,
         gamma: float = 0.95, weight_decay: float = 0.0,
         xy_loss: float = 2.0, wh_loss: float = 1.6,
         no_object_loss: float = 25.0, object_loss: float = 0.1,
         vanilla_anchor: bool = False, ts: bool = True,
         augment_affine: bool = False, augment_hsv: bool = False,
         lr_flip: bool = False, ud_flip: bool = False, data_aug: bool = False,
         blur: bool = False, salt: bool = False, noise: bool = False,
         contrast: bool = False, sharpen: bool = False,
         val_tolerance: int = 3, min_epochs: int = 3,
         vis_batch: int = 0, resume: bool = False,
         mixed_precision="auto", device_aug: bool = False,
         packed_stem: bool = False,
         grad_clip: float = 0.0, lr_warmup_steps: int = 0,
         val_batch_size: Optional[int] = None,
         preload_device: bool = False, preload_num: Optional[int] = None,
         preload_budget_gb: float = 6.0,
         debug_mode: bool = False, evaluate: bool = False,
         num_workers: int = 8, n_devices: Optional[int] = None,
         seed: int = 17):
    spec = load_network_spec(model_cfg, vanilla_anchor=vanilla_anchor)
    os.makedirs(output_path, exist_ok=True)
    os.makedirs("logs", exist_ok=True)

    # mixed_precision="auto": bf16 compute (f32 master weights/BN/loss) on
    # the GPU (backend.mixed_precision); parity runs pass
    # --no_mixed_precision to pin f32.
    mixed_precision = backend.mixed_precision(mixed_precision)
    # packed_stem: opt-in exact space-to-depth training stem (conv1 is the
    # step's layout-bound stage — darknet._packed_stem_train); only valid
    # on the standard YOLOv3 stem
    if packed_stem:
        from mit_driverless_cv_traininginfra.models.stem_opt import (
            stem_is_packable,
        )

        if not stem_is_packable(spec):
            raise ValueError("--packed_stem requires the standard YOLOv3 "
                             "stem (conv3x3/s1 then conv3x3/s2, even input)")

    common = dict(dataset_path=dataset_path, width=spec.net.width,
                  height=spec.net.height, bw=spec.net.bw, ts=ts,
                  debug_mode=debug_mode, seed=seed)
    train_ds = ImageLabelDataset(
        spec.net.train_uri, num_images=spec.net.num_train_images,
        augment_affine=augment_affine, augment_hsv=augment_hsv,
        lr_flip=lr_flip, ud_flip=ud_flip, data_aug=data_aug, blur=blur,
        salt=salt, noise=noise, contrast=contrast, sharpen=sharpen,
        vis_batch=vis_batch, device_aug=device_aug, **common)
    val_ds = ImageLabelDataset(
        spec.net.validate_uri, num_images=spec.net.num_validate_images, **common)
    bs = 1 if debug_mode else batch_size
    # val_batch_size: checkpoint evaluation runs an f32 detection forward
    # ON TOP of the resident train state (+ any device pool) — at large
    # train batches that combination can exceed HBM, so validation may
    # need its own smaller batch (None = same as training)
    val_bs = 1 if debug_mode else (val_batch_size or batch_size)
    train_loader = DataLoader(train_ds, bs, shuffle=not debug_mode,
                              num_workers=num_workers, seed=seed)
    val_loader = DataLoader(val_ds, val_bs, shuffle=False,
                            num_workers=num_workers)
    print("Num train images: ", len(train_ds))
    print("Num validate images: ", len(val_ds))

    mesh = make_mesh(n_devices) if (n_devices or jax.device_count() > 1) else None

    if preload_device and not debug_mode:
        # host-bound machines (the host input path feeds far fewer
        # images/s than the device consumes): materialise the dataset
        # once and train from a device-resident pool. Pair
        # with --device_aug so photometric augmentation stays fresh.
        from mit_driverless_cv_traininginfra.data.device_pool import (
            DevicePool,
        )

        # bf16 pool when the step computes in bf16 (it casts images there
        # anyway): halves HBM, doubling the images that fit the budget
        pool = DevicePool.from_dataset(
            train_ds, num=preload_num, mesh=mesh,
            budget_bytes=preload_budget_gb * 1e9,
            dtype=jnp.bfloat16 if mixed_precision else jnp.float32)
        print(f"Device pool: {len(pool)} samples, "
              f"{pool.nbytes / 1e9:.2f} GB in HBM")
        train_loader = pool.loader(bs, shuffle=True, seed=seed)

    params, mstate = init_params(spec, jax.random.PRNGKey(seed))
    if weights_path:
        params, mstate, _ = load_darknet_weights(spec, params, mstate, weights_path)
    tx = make_optimizer(optimizer_pick, lr=lr, momentum=momentum,
                        weight_decay=weight_decay, grad_clip=grad_clip)
    ts_state = init_train_state(params, mstate, tx)

    # full-state resume (params, BN stats, optimizer, step) — the
    # capability the reference lacks (SURVEY §5: "no resume codepath")
    start_epoch = 0
    state_path = os.path.join(output_path, STATE_FILE)
    if resume and os.path.exists(state_path):
        ts_state, meta = restore_state(state_path, ts_state)
        start_epoch = int(meta["epoch"])
        print(f"Resumed from {state_path} at epoch {start_epoch}")
    if mesh is not None:
        ts_state = replicate(mesh, ts_state)

    loss_consts = (xy_loss, wh_loss, object_loss, no_object_loss)
    val_loss = 999.0
    val_loss_counter = 0
    step = [0]
    epoch = start_epoch
    while epoch < num_epochs and step[0] < num_steps and not evaluate:
        epoch += 1
        # fresh augmentation draws each epoch (per-item RNGs are keyed on
        # (seed, epoch, index) for thread-safe reproducibility); val keeps
        # epoch 0 so its random patch picks are stable between checkpoints
        train_ds.set_epoch(epoch)
        # StepLR stepped at the top of the epoch (train.py:199,207)
        epoch_lr = step_lr(lr, gamma, epoch)
        ts_state = ts_state._replace(
            opt_state=set_lr(ts_state.opt_state, epoch_lr))
        _, _, _, ts_state = run_epoch(
            label_prefix="train", data_loader=train_loader, spec=spec, tx=tx,
            ts=ts_state, mesh=mesh, num_steps=num_steps, step=step,
            epoch=epoch, loss_consts=loss_consts, optimize=True,
            compute_dtype="bfloat16" if mixed_precision else "float32",
            device_aug=device_aug, packed_stem=packed_stem,
            lr_warmup=((lr_warmup_steps, epoch_lr)
                       if lr_warmup_steps else None),
            aug_key=jax.random.PRNGKey(seed * 7919 + epoch),
            # honour the user's augmentation flags on the device path with
            # the HOST path's semantics (yolo_dataset.__getitem__, matching
            # the reference): data_aug turns on color jitter (+affine,
            # handled host-side), while lr_flip and noise need their own
            # flags in both modes
            aug_flags=dict(
                lr_flip=bool(lr_flip),
                jitter=bool(augment_hsv or data_aug),
                noise=bool(noise),
            ))
        print("Completed epoch: ", epoch)

        if epoch % checkpoint_interval == 0 or epoch == num_epochs or step[0] >= num_steps:
            save_weights_uri = os.path.join(output_path, f"{epoch}.weights")
            save_darknet_weights(spec, ts_state.params, ts_state.model_state,
                                 save_weights_uri)
            save_state(state_path, ts_state, epoch=epoch)
            print("Calculating loss on validate data")
            epoch_losses, _, epoch_num_targets, _ = run_epoch(
                label_prefix="validate", data_loader=val_loader, spec=spec,
                tx=tx, ts=ts_state, mesh=mesh, num_steps=10**12, step=step,
                epoch=epoch, loss_consts=loss_consts, optimize=False)
            avg_epoch_loss = epoch_losses[0] / epoch_num_targets
            print("Average Validation Loss: {0:10.6f}".format(avg_epoch_loss))
            if avg_epoch_loss > val_loss and epoch > min_epochs:
                val_loss_counter += 1
                print(f"Validation loss did not decrease for {val_loss_counter}"
                      f" consecutive check(s)")
            else:
                print("Validation loss decreased. Yay!!")
                val_loss_counter = 0
                val_loss = avg_epoch_loss
                write_score_file("logs/result.txt", avg_epoch_loss)
            validate_map(data_loader=val_loader, spec=spec,
                         params=ts_state.params, model_state=ts_state.model_state,
                         mesh=mesh)
            if val_loss_counter == val_tolerance:
                print(f"Validation loss stopped decreasing over the last "
                      f"{val_tolerance} checkpoints, creating onnx file")
                try:
                    from mit_driverless_cv_traininginfra.export.yolo2onnx import (
                        export_yolo_onnx,
                    )

                    onnx_uri = os.path.join(output_path, spec.net.onnx_name(model_cfg))
                    export_yolo_onnx(spec, ts_state.params, ts_state.model_state,
                                     onnx_uri)
                except ImportError:
                    print("ONNX export module unavailable; skipping export")
                break
    if evaluate:
        validate_map(data_loader=val_loader, spec=spec, params=ts_state.params,
                     model_state=ts_state.model_state, mesh=mesh)
    return val_loss
