"""ctypes bindings of the native host library ``libfealess_host``
(``native/fealess_host``): the port's own copy of the parts of
``fealess_tpu.io.native`` that its training path calls.

- ``select_scattered_features``: the greedy scattered-feature pick of
  ``QuantizedPyramid::selectScatteredFeatures`` (linemod.cpp:135-164);
- ``chamfer_chessboard``: the exact DIST_C 3x3 distance transform
  (``cv::distanceTransform`` at linemod.cpp:763);
- ``extract_gradient_template`` / ``extract_normal_template``: a whole
  modality's feature extraction in one call that releases the GIL.

:class:`FrameLoader`, the JAX package's threaded RGB-D frame stream, needs
no native library here: its threads decode through ``io/png.py`` (zlib
and the C un-filter release the interpreter lock) and resize with
``ops/resize`` on CPU tensors.

:func:`load_library` builds the library at its first call
(``ops/_build.build_native_host``: ``scatter.cc``, ``chamfer.cc`` and
``extract.cc`` with the host C++ compiler into
``build/fealess_tpu_torch/``, no CMake, no OpenCV) and raises, with the
compiler's errors, if the build fails; nothing falls back to numpy on its
own.  ``load_library(path)`` loads a given file instead.  ``training.py``
calls the bindings while :func:`have_native` is true, and runs its numpy
twin (equal views) only where a caller set the library aside first:
``_LIB = None`` and ``_SEARCHED = True``, as the tests do.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False
_LOCK = threading.Lock()

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "fealess_select_scattered_features": (
        ctypes.c_int, [_I32P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       _I32P]),
    "fealess_chamfer_chessboard": (
        None, [_U8P, ctypes.c_int, ctypes.c_int, _F32P]),
    "fealess_extract_gradient_template": (
        ctypes.c_int, [_U8P, _F32P, _U8P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, _I32P]),
    "fealess_extract_normal_template": (
        ctypes.c_int, [_U8P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _I32P]),
}


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_library(path=None) -> Optional[ctypes.CDLL]:
    """The loaded library.  With ``path``, that file is loaded and becomes
    the library the bindings call (an error if it does not load).
    Without, the first call builds the port's own from the repo's sources
    (``ops/_build.build_native_host``) and loads it; a failed build or
    load raises.  None only after a caller set the library aside
    (``_LIB = None``, ``_SEARCHED = True``)."""
    global _LIB, _SEARCHED
    if path is not None:
        _LIB, _SEARCHED = _bind(path), True
        return _LIB
    with _LOCK:
        if not _SEARCHED:
            from fealess_tpu_torch.ops import _build
            _LIB = _bind(_build.build_native_host())
            _SEARCHED = True
    return _LIB


def have_native() -> bool:
    return load_library() is not None


def _lib() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("libfealess_host is not loaded; check "
                           "have_native() before calling a native binding")
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def select_scattered_features(candidates: np.ndarray, num_features: int,
                              distance: float) -> np.ndarray:
    """Greedy scattered selection; ``candidates`` (K, 3) int32 sorted by
    descending score.  Returns (n, 3) int32."""
    cand = np.ascontiguousarray(candidates, np.int32)
    out = np.empty((num_features, 3), np.int32)
    n = _lib().fealess_select_scattered_features(
        _ptr(cand, _I32P), len(cand), num_features, ctypes.c_float(distance),
        _ptr(out, _I32P))
    return out[:n]


def chamfer_chessboard(nonzero: np.ndarray) -> np.ndarray:
    """Exact Chebyshev distance of nonzero pixels to the nearest zero."""
    src = np.ascontiguousarray(nonzero.astype(np.uint8))
    h, w = src.shape
    out = np.empty((h, w), np.float32)
    _lib().fealess_chamfer_chessboard(_ptr(src, _U8P), h, w,
                                      _ptr(out, _F32P))
    return out


def _mask_ptr(mask: Optional[np.ndarray]):
    if mask is None:
        return None, None
    m = np.ascontiguousarray(mask.astype(np.uint8))
    return m, _ptr(m, _U8P)


def extract_gradient_template(angle_bits: np.ndarray, magnitude: np.ndarray,
                              mask: Optional[np.ndarray], num_features: int,
                              strong_threshold: float
                              ) -> Optional[np.ndarray]:
    """ColorGradient extraction (erode, candidates, stable sort, greedy):
    (num_features, 3) int32, or None when too few candidates."""
    bits = np.ascontiguousarray(angle_bits, np.uint8)
    mag = np.ascontiguousarray(magnitude, np.float32)
    h, w = bits.shape
    m, m_ptr = _mask_ptr(mask)
    out = np.empty((num_features, 3), np.int32)
    n = _lib().fealess_extract_gradient_template(
        _ptr(bits, _U8P), _ptr(mag, _F32P), m_ptr, h, w, num_features,
        ctypes.c_float(strong_threshold), _ptr(out, _I32P))
    return out if n == num_features else None


def extract_normal_template(normal_bits: np.ndarray,
                            mask: Optional[np.ndarray], num_features: int,
                            extract_threshold: int) -> Optional[np.ndarray]:
    """DepthNormal extraction (erode x2, per-label chamfer, count
    balancing, stable sort, greedy); returns as
    :func:`extract_gradient_template`."""
    bits = np.ascontiguousarray(normal_bits, np.uint8)
    h, w = bits.shape
    m, m_ptr = _mask_ptr(mask)
    out = np.empty((num_features, 3), np.int32)
    n = _lib().fealess_extract_normal_template(
        _ptr(bits, _U8P), m_ptr, h, w, num_features, extract_threshold,
        _ptr(out, _I32P))
    return out if n == num_features else None


class FrameLoader:
    """Threaded in-order RGB-D frame stream (``fealess_tpu.io.native.
    FrameLoader``): iterates ``(index, bgr u8 (H, W, 3), depth u16 (H,
    W))``.  ``threads`` decode up to ``capacity`` frames ahead of the
    consumer through ``io/png.read_png``; a pair whose colour or depth
    file is missing or does not decode (``png.DecodeError``) is skipped
    and its index is not reused.  With ``target_wh`` each frame is
    resized on the pool's threads (colour INTER_LINEAR, depth
    INTER_NEAREST, as cv2 does)."""

    def __init__(self, color_paths: Sequence[str],
                 depth_paths: Sequence[str],
                 target_wh: Optional[Tuple[int, int]] = None,
                 threads: int = 4, capacity: int = 8):
        if len(color_paths) != len(depth_paths):
            raise ValueError(f"{len(color_paths)} colour paths, "
                             f"{len(depth_paths)} depth paths")
        self._pairs = list(zip(color_paths, depth_paths))
        self._target = target_wh
        self._capacity = max(1, capacity)
        self._pool = ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="frame-loader")
        self._ahead = collections.deque()    # (index, future), in order
        self._submitted = 0

    def _load(self, color_path: str, depth_path: str):
        from fealess_tpu_torch.io.png import DecodeError, read_png
        from fealess_tpu_torch.ops.resize import resize_host
        try:
            bgr = read_png(color_path, color=True)
            depth = read_png(depth_path)
        except (DecodeError, FileNotFoundError):     # cv2.imread: None
            return None
        if self._target:
            bgr = resize_host(bgr, self._target)
            depth = resize_host(depth, self._target, nearest=True)
        return bgr, np.asarray(depth, np.uint16)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            while (len(self._ahead) < self._capacity
                   and self._submitted < len(self._pairs)):
                self._ahead.append((self._submitted, self._pool.submit(
                    self._load, *self._pairs[self._submitted])))
                self._submitted += 1
            if not self._ahead:
                self.close()
                raise StopIteration
            idx, fut = self._ahead.popleft()
            frame = fut.result()
            if frame is not None:
                return (idx,) + frame

    def close(self) -> None:
        """Stop the threads (frames not yet read are dropped)."""
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._ahead.clear()
        self._submitted = len(self._pairs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
