"""Image-decode seam for the host input pipeline.

The reference decodes with PIL/accimage inside DataLoader worker processes
(utils/datasets.py:159 ``Image.open``; ``torchvision.set_image_backend
('accimage')`` — accimage being its native-decode fast path). Our
equivalent native fast path is the repo-root C++ core (``native/``:
libjpeg/libpng decode + thread pool); this module routes decodes through
it when the shared library builds, with a PIL/cv2 fallback.

Downstream geometry keeps PIL semantics either way (the decoded pixels are
wrapped back into a PIL Image), so training parity is unaffected: baseline
JPEG/PNG decode is deterministic per spec.
"""

from __future__ import annotations

import numpy as np

_native = None
_checked = False


def _native_mod():
    global _native, _checked
    if not _checked:
        _checked = True
        try:
            import native  # repo-root package, built on demand

            if native.available():
                _native = native
        except Exception:
            _native = None
    return _native


def native_active() -> bool:
    return _native_mod() is not None


def open_rgb(uri: str) -> Image.Image:
    """Decode to a PIL RGB image — native C++ decode when available."""
    from PIL import Image

    nat = _native_mod()
    if nat is not None:
        try:
            with open(uri, "rb") as f:
                return Image.fromarray(nat.decode_image(f.read()))
        except Exception:
            pass  # unsupported format / corrupt header → PIL fallback
    return Image.open(uri).convert("RGB")


def imread_bgr(uri: str):
    """cv2.imread-compatible decode: (H, W, 3) uint8 BGR, or None on
    failure (the RektNet loaders keep the reference's cv2-BGR parity,
    RektNet/utils.py:73-76)."""
    nat = _native_mod()
    if nat is not None:
        try:
            with open(uri, "rb") as f:
                return np.ascontiguousarray(nat.decode_image(f.read())[..., ::-1])
        except Exception:
            pass
    import cv2

    return cv2.imread(uri)
