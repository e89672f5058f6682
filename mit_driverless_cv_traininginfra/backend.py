"""What the accelerator backend can do — the one place the rest of the code
asks.

The serving, training and measurement paths never branch on a platform
string themselves; they call these functions:

- :func:`accelerator` — the device a measurement runs on. It raises when
  JAX finds no GPU: a device metric taken on the CPU is not a device
  metric, so measurement paths fail instead of falling back.
- :func:`mixed_precision` — resolves the drivers' ``mixed_precision="auto"``
  (bf16 compute with f32 master weights on the GPU, f32 on the CPU, where
  the test suite pins float32 numerics).
"""

from __future__ import annotations

from typing import Union

import jax


def platform() -> str:
    """Platform of JAX's default backend ("gpu" or "cpu")."""
    return jax.default_backend()


def accelerator():
    """The first GPU device. Raises RuntimeError when JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's default backend is {dev.platform!r} "
            f"({jax.devices()}); device measurements need the GPU")
    return dev


def mixed_precision(setting: Union[str, bool]) -> bool:
    """Resolve a driver's ``mixed_precision`` flag: True/False pass through,
    "auto" means bf16 compute on the GPU and f32 elsewhere."""
    if setting == "auto":
        return platform() == "gpu"
    if isinstance(setting, bool):
        return setting
    raise ValueError(f"mixed_precision must be 'auto', True or False, "
                     f"got {setting!r}")

