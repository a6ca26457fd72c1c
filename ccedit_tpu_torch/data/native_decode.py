"""ctypes binding of the native threaded video decode (the port's own copy of
``ccedit_tpu/data/native_decode.py``; the port imports nothing of the JAX
package).

The library is ``native/decode/libvideo_decode.so``, the repository's build
of ``native/decode/video_decode.cpp`` by ``native/build.sh`` (it links
OpenCV).  Clip decode, bicubic resize and conversion run in C++, writing
straight into numpy-owned buffers, so the loaders hold no GIL for the
decode.  ``available()`` says whether the library loads; the loaders take
the cv2/PIL path when it does not (host IO: the choice changes no device
path).  Keyframe selection stays in Python (``data/video.py``).
"""

from __future__ import annotations

import ctypes
import itertools
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

LIBRARY = Path(__file__).resolve().parents[2] / "native" / "decode" / "libvideo_decode.so"
_LIB = None
_LIB_TRIED = False
_INT_P, _FLOAT_P, _U8_P = (ctypes.POINTER(t) for t in (ctypes.c_int, ctypes.c_float,
                                                       ctypes.c_ubyte))


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(str(LIBRARY))
    except OSError:  # not built, or OpenCV is not installed
        return None
    c_int, c_char_p, c_void_p, c_u64 = ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64
    signatures = {
        "vd_decode_clip": (c_int, [c_char_p, _INT_P, c_int, c_int, c_int, _FLOAT_P]),
        "vd_decode_clip_u8": (c_int, [c_char_p, _INT_P, c_int, c_int, c_int, _U8_P]),
        "vd_decode_images": (c_int, [ctypes.POINTER(c_char_p), c_int, c_int, c_int, _FLOAT_P]),
        "vd_pool_create": (c_void_p, [c_int]),
        "vd_pool_submit_clip": (c_int, [c_void_p, c_u64, c_char_p, _INT_P, c_int, c_int, c_int,
                                        _FLOAT_P]),
        "vd_pool_submit_images": (c_int, [c_void_p, c_u64, ctypes.POINTER(c_char_p), c_int,
                                          c_int, c_int, _FLOAT_P]),
        "vd_pool_wait": (c_int, [c_void_p, c_u64]),
        "vd_pool_destroy": (None, [c_void_p]),
    }
    try:
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    except AttributeError:  # a stale build without one of the calls
        return None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native decode library does not load: {LIBRARY} "
                           "(build it with native/build.sh; it needs OpenCV)")
    return lib


def _indices(indices: Sequence[int], h: int, w: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    if idx.ndim != 1 or (idx < 0).any() or h <= 0 or w <= 0:
        raise ValueError(f"frame indices {indices} and size {h}x{w}")
    return idx


def decode_clip(path: str, indices: Sequence[int], h: int, w: int) -> np.ndarray:
    """The given frame indices of a video file -> (T, H, W, 3) float32 in
    [-1, 1], bicubic-resized to (h, w)."""
    idx = _indices(indices, h, w)
    out = np.empty((len(idx), h, w, 3), np.float32)
    rc = _lib().vd_decode_clip(str(path).encode(), idx.ctypes.data_as(_INT_P), len(idx), h, w,
                               out.ctypes.data_as(_FLOAT_P))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out


def decode_clip_u8(path: str, indices: Sequence[int], h: int, w: int) -> np.ndarray:
    """The given frame indices of a video file -> (T, H, W, 3) uint8 RGB,
    bicubic-resized to (h, w) (untouched at the file's own size)."""
    idx = _indices(indices, h, w)
    out = np.empty((len(idx), h, w, 3), np.uint8)
    rc = _lib().vd_decode_clip_u8(str(path).encode(), idx.ctypes.data_as(_INT_P), len(idx), h,
                                  w, out.ctypes.data_as(_U8_P))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out


def decode_images(paths: Sequence[str], h: int, w: int) -> np.ndarray:
    """Image files -> (N, H, W, 3) float32 in [-1, 1]."""
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    out = np.empty((len(paths), h, w, 3), np.float32)
    rc = _lib().vd_decode_images(arr, len(paths), h, w, out.ctypes.data_as(_FLOAT_P))
    if rc != 0:
        raise IOError(f"native image decode failed ({rc})")
    return out


class DecodePool:
    """The library's threaded prefetch pool: submit clips or image lists,
    wait per job.  numpy owns the buffers, kept alive until ``wait``."""

    def __init__(self, n_threads: int = 4):
        self._lib = _lib()
        self._pool = self._lib.vd_pool_create(n_threads)
        self._ids = itertools.count(1)
        self._bufs = {}
        self._lock = threading.Lock()

    def _register(self, out, keepalive) -> int:
        with self._lock:
            job = next(self._ids)
            self._bufs[job] = (out, keepalive)
        return job

    def submit_clip(self, path: str, indices: Sequence[int], h: int, w: int) -> int:
        idx = _indices(indices, h, w)
        out = np.empty((len(idx), h, w, 3), np.float32)
        job = self._register(out, idx)
        self._lib.vd_pool_submit_clip(self._pool, job, str(path).encode(),
                                      idx.ctypes.data_as(_INT_P), len(idx), h, w,
                                      out.ctypes.data_as(_FLOAT_P))
        return job

    def submit_images(self, paths: Sequence[str], h: int, w: int) -> int:
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        out = np.empty((len(paths), h, w, 3), np.float32)
        job = self._register(out, arr)
        self._lib.vd_pool_submit_images(self._pool, job, arr, len(paths), h, w,
                                        out.ctypes.data_as(_FLOAT_P))
        return job

    def wait(self, job: int) -> np.ndarray:
        rc = self._lib.vd_pool_wait(self._pool, job)
        with self._lock:
            out, _ = self._bufs.pop(job)
        if rc != 0:
            raise IOError(f"native decode job {job} failed ({rc})")
        return out

    def close(self) -> None:
        if self._pool:
            self._lib.vd_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
