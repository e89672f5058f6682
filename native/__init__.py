"""ctypes bindings for the native input-pipeline core (``cvloader.cc``).

Builds ``build/libcvloader.so`` from the source on first use with g++
(the build directory is not committed; rebuilt when the source is newer). Python↔C++ crossing is via the
plain C ABI — no pybind11 in this image.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cvloader.cc")
_SO = os.path.join(_DIR, "build", "libcvloader.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        # build under a private name, then rename: concurrent first users
        # (test workers, loader processes) never load a half-written file
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", tmp, "-ljpeg", "-lpng", "-lpthread"]
        subprocess.check_call(cmd)
        os.replace(tmp, _SO)
    return _SO


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lp = ctypes.POINTER(ctypes.c_long)
        ip = ctypes.POINTER(ctypes.c_int)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.cv_init_pool.argtypes = [ctypes.c_int]
        lib.cv_probe.argtypes = [u8p, ctypes.c_long, ip, ip]
        lib.cv_probe.restype = ctypes.c_int
        lib.cv_decode_jpeg.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_int,
                                       ctypes.c_int, ip, ip]
        lib.cv_decode_png.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_int,
                                      ctypes.c_int, ip, ip]
        lib.cv_letterbox.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_uint8]
        lib.cv_resize.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                  ctypes.c_int, ctypes.c_int]
        lib.cv_affine_warp.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                       ctypes.c_int, ctypes.c_int, fp,
                                       ctypes.c_uint8]
        lib.cv_extract_patch.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint8]
        lib.cv_decode_letterbox_batch.argtypes = [u8p, lp, lp, ctypes.c_int,
                                                  u8p, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_uint8,
                                                  ctypes.c_int]
        lib.cv_decode_letterbox_batch.restype = ctypes.c_int
        lib.cv_decode_jpeg.restype = ctypes.c_int
        lib.cv_decode_png.restype = ctypes.c_int
        lib.cv_pool_threads.argtypes = []
        lib.cv_pool_threads.restype = ctypes.c_int
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def decode_image(data: bytes) -> np.ndarray:
    """Decode a JPEG/PNG byte blob to an (H, W, 3) RGB uint8 array."""
    lib = load()
    arr = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.cv_probe(_u8(arr), len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError("unrecognised image data")
    buf = np.empty((h.value, w.value, 3), np.uint8)
    if len(data) >= 8 and data[0] == 0x89 and data[1:2] == b"P":
        rc = lib.cv_decode_png(_u8(arr), len(data), _u8(buf), h.value, w.value,
                               ctypes.byref(h), ctypes.byref(w))
    else:
        rc = lib.cv_decode_jpeg(_u8(arr), len(data), _u8(buf), h.value,
                                w.value, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"decode failed (rc={rc})")
    return buf


def letterbox(img: np.ndarray, dh: int, dw: int, fill: int = 127) -> np.ndarray:
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw, 3), np.uint8)
    lib.cv_letterbox(_u8(img), img.shape[0], img.shape[1], _u8(out), dh, dw,
                     fill)
    return out


def resize(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw, 3), np.uint8)
    lib.cv_resize(_u8(img), img.shape[0], img.shape[1], _u8(out), dh, dw)
    return out


def affine_warp(img: np.ndarray, m_inv: np.ndarray, fill: int = 127) -> np.ndarray:
    """Inverse-affine bilinear warp; m_inv is the 2×3 output→input map."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    m = np.ascontiguousarray(m_inv, np.float32).reshape(6)
    lib.cv_affine_warp(_u8(img), img.shape[0], img.shape[1], _u8(out),
                       img.shape[0], img.shape[1],
                       m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), fill)
    return out


def extract_patch(img: np.ndarray, top: int, left: int, ph: int, pw: int,
                  fill: int = 127) -> np.ndarray:
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((ph, pw, 3), np.uint8)
    lib.cv_extract_patch(_u8(img), img.shape[0], img.shape[1], _u8(out),
                         top, left, ph, pw, fill)
    return out


def decode_letterbox_batch(blobs: List[bytes], dh: int, dw: int,
                           fill: int = 127, n_threads: int = 8) -> Tuple[np.ndarray, int]:
    """Decode+letterbox a batch of image blobs across the C++ thread pool.
    Returns ((N, dh, dw, 3) uint8, n_failures).

    The pool is sized ONCE, on its first use in the process (resizing
    under concurrent batch calls is unsafe); a later call with a different
    ``n_threads`` keeps the first size and warns."""
    import warnings

    lib = load()
    built = int(lib.cv_pool_threads())
    if built and built != n_threads:
        warnings.warn(
            f"native thread pool was sized at first use ({built} workers); "
            f"n_threads={n_threads} has no effect", stacklevel=2)
    data = np.frombuffer(b"".join(blobs), np.uint8)
    sizes = np.asarray([len(b) for b in blobs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.empty((len(blobs), dh, dw, 3), np.uint8)
    lp = ctypes.POINTER(ctypes.c_long)
    failures = lib.cv_decode_letterbox_batch(
        _u8(data), offsets.ctypes.data_as(lp), sizes.ctypes.data_as(lp),
        len(blobs), _u8(out), dh, dw, fill, n_threads)
    return out, int(failures)
