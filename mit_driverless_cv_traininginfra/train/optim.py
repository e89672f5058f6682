"""Optimizers + LR schedules with torch-parity semantics.

Reference operating points:
- YOLO: Adam(lr, weight_decay) or SGD(lr, momentum, weight_decay) selected
  by flag (CVC-YOLOv3/train.py:180-189), StepLR(step_size=1, gamma) stepped
  once per epoch (train.py:199,207).
- RektNet: Adam(lr) + ExponentialLR(gamma=0.999) per epoch
  (RektNet/train_eval.py:263-264).

The learning rate is injected as a dynamic hyperparameter so epoch-level
schedules run on the host without recompiling the train step (the schedule
is a scalar update, not part of the traced graph).
"""

from __future__ import annotations

import optax


def make_optimizer(kind: str = "Adam", lr: float = 1e-3, momentum: float = 0.9,
                   weight_decay: float = 0.0, grad_clip: float = 0.0):
    """Returns an ``optax.inject_hyperparams`` optimizer whose ``lr`` can be
    reassigned between steps (``set_lr``).

    ``grad_clip`` (global-norm clip, 0 = off) is an extension beyond the
    reference's surface: the flagship graph trained from
    scratch at large batch (B≥32) NaNs in the first few hundred steps
    without it (the noobj-25 BCE spikes early — measured,
    tools/train_to_map.py); the reference never hits this because it
    trains at B=7. Defaults off for parity."""
    kind_l = kind.lower()
    if kind_l == "adam":
        # torch.optim.Adam applies L2 into the gradient (not decoupled).
        def build(lr):
            tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
            if weight_decay:
                tx = optax.chain(optax.add_decayed_weights(weight_decay), tx)
            return tx
    elif kind_l == "sgd":
        def build(lr):
            tx = optax.sgd(lr, momentum=momentum if momentum else None)
            if weight_decay:
                tx = optax.chain(optax.add_decayed_weights(weight_decay), tx)
            return tx
    else:
        raise ValueError(f"Invalid optimizer name: {kind}")
    if grad_clip:
        return optax.inject_hyperparams(
            lambda lr: optax.chain(optax.clip_by_global_norm(grad_clip),
                                   build(lr)))(lr=lr)
    return optax.inject_hyperparams(lambda lr: build(lr))(lr=lr)


def step_lr(base_lr: float, gamma: float, epoch: int, step_size: int = 1) -> float:
    """torch StepLR: lr = base · γ^(epoch // step_size). The reference calls
    ``scheduler.step()`` at the TOP of each epoch (train.py:207), so epoch 1
    already trains at base·γ — pass the same epoch counter for parity."""
    return base_lr * (gamma ** (epoch // step_size))


def exponential_lr(base_lr: float, gamma: float, epoch: int) -> float:
    """torch ExponentialLR: lr = base · γ^epoch (stepped per epoch,
    train_eval.py:85)."""
    return base_lr * (gamma ** epoch)


def set_lr(opt_state, lr: float):
    """Update the injected lr in an inject_hyperparams state (host-side
    scalar swap; no recompile)."""
    import jax.numpy as jnp

    opt_state.hyperparams["lr"] = jnp.asarray(lr, jnp.float32)
    return opt_state
