"""ctypes binding for the repository's native C++ slide reader
(native/wsireader.cpp), as the port uses it.

The port's own copy of hipt_abmil_atec23_tpu/slideio/native.py. Both
packages load the same ``native/libwsireader.so`` from the repository root,
which lies outside either package; it is built with ``make -C native`` when
it is missing or older than its source (that needs g++ and the libtiff /
libjpeg headers).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libwsireader.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

COMPRESSION_NONE = 1
COMPRESSION_JPEG = 7
COMPRESSION_DEFLATE = 8


def _build() -> None:
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = os.path.join(_NATIVE_DIR, "wsireader.cpp")
        if not os.path.exists(_SO_PATH) or (
                os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(_SO_PATH)):
            _build()  # missing OR stale (source newer than the .so)
        lib = ctypes.CDLL(_SO_PATH)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.ws_open.restype = vp
        lib.ws_open.argtypes = [ctypes.c_char_p]
        lib.ws_close.argtypes = [vp]
        lib.ws_level_count.argtypes = [vp]
        lib.ws_level_count.restype = i32
        lib.ws_level_dims.argtypes = [
            vp, i32, ctypes.POINTER(i64), ctypes.POINTER(i64)]
        lib.ws_read_region.argtypes = [vp, i32] + [i64] * 4 + [vp]
        lib.ws_read_region.restype = i32
        lib.ws_read_regions.argtypes = [vp, i32, vp, i32, i64, i64, vp, i32]
        lib.ws_read_regions.restype = i32
        lib.ws_write_pyramid2.argtypes = [
            ctypes.c_char_p, vp, i64, i64, i32, i32, i32, i32, i32]
        lib.ws_write_pyramid2.restype = i32
        lib.ws_supports_yuv420.argtypes = [vp, i32]
        lib.ws_supports_yuv420.restype = i32
        lib.ws_read_regions_yuv420.argtypes = [
            vp, i32, vp, i32, i64, i64, vp, vp, vp, i32]
        lib.ws_read_regions_yuv420.restype = i32
        lib.ws_dct_probe.argtypes = [vp, i32, vp]
        lib.ws_dct_probe.restype = i32
        lib.ws_read_regions_dct2.argtypes = (
            [vp, i32, vp, i32, i64, i64] + [vp] * 5 + [i32])
        lib.ws_read_regions_dct2.restype = i32
        lib.ws_dct_group_size.restype = i32
        lib.ws_dct_group_size.argtypes = []
        lib.ws_level_compression.argtypes = [vp, i32]
        lib.ws_level_compression.restype = i32
        lib.ws_compression_supported.argtypes = [i32]
        lib.ws_compression_supported.restype = i32
        lib.ws_yuv_layout.argtypes = [vp, i32]
        lib.ws_yuv_layout.restype = i32
        lib.ws_read_regions_planes.argtypes = [
            vp, i32, vp, i32, i64, i64, vp, vp, vp, i32, i32, i32]
        lib.ws_read_regions_planes.restype = i32
        _lib = lib
        return lib


def write_pyramid(path: str, level0: np.ndarray, tile: int = 256,
                  n_levels: int = 4, compression: int = COMPRESSION_JPEG,
                  quality: int = 80, ycbcr420: bool = False) -> None:
    """Write an RGB [H, W, 3] uint8 array as a tiled pyramidal TIFF.
    ycbcr420 stores JPEG tiles as YCbCr with 2x2 chroma subsampling (the
    TCGA .svs convention) — enables the raw-plane and DCT read paths."""
    lib = get_lib()
    level0 = np.ascontiguousarray(level0, dtype=np.uint8)
    h, w = level0.shape[:2]
    r = lib.ws_write_pyramid2(
        path.encode(), level0.ctypes.data_as(ctypes.c_void_p),
        w, h, tile, n_levels, compression, quality, int(ycbcr420))
    if r != 0:
        raise IOError(f"ws_write_pyramid failed ({r}) for {path}")
