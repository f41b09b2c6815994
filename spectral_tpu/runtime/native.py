"""ctypes bindings for the native framebuffer ops (native/fbops.cpp).

The runtime around the device compute path stays native where the reference's
was: frame conversion (XYZ accumulator -> sRGB uint8, the reference's
save_to_fb + image_channels path) and BMP encoding run in the C++ library
when present, with a bit-identical numpy fallback. The library is built by
``make -C native`` (attempted automatically once per process).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_NAME = "libspectral_fbops.so"
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = os.path.abspath(os.path.join(_NATIVE_DIR, _LIB_NAME))
    if not os.path.exists(path):
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.stpu_xyz_to_srgb_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.stpu_bmp_size.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.stpu_bmp_size.restype = ctypes.c_int64
    lib.stpu_encode_bmp.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def xyz_to_srgb_u8(xyz: np.ndarray, samples_per_pixel: int) -> np.ndarray | None:
    """[H, W, 3] float32 accumulated XYZ -> uint8 sRGB via the native
    multithreaded converter; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(xyz, np.float32)
    h, w, _ = arr.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.stpu_xyz_to_srgb_u8(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(h * w),
        ctypes.c_float(1.0 / float(samples_per_pixel)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def encode_bmp(img: np.ndarray) -> bytes | None:
    """uint8 [H, W, 3] -> BMP bytes via the native encoder; None when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(img, np.uint8)
    h, w, _ = arr.shape
    size = lib.stpu_bmp_size(w, h)
    out = np.empty((size,), np.uint8)
    lib.stpu_encode_bmp(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(w),
        ctypes.c_int32(h),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.tobytes()
