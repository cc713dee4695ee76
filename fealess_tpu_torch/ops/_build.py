"""Build and load the port's CUDA kernels (``fealess_tpu_torch/csrc``).

The ``.cu`` sources have a plain C interface: ``nvcc`` compiles them for
Hopper (``sm_90a``) into one shared library under
``<repo>/build/fealess_tpu_torch/``, named by a hash of the sources and
flags, so the build runs at first use and again only when a source
changes.  The library is loaded with ``ctypes``; every pointer and the
CUDA stream are passed as ``c_void_p`` and every entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fealess_tpu_torch"
# -fmad=false: no multiply-add contraction anywhere (K3's d2 must round
# like the twin's separate multiply and add; the score kernels are
# integer-only).  -Xptxas -v writes registers/spills into build.log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # planes, hd, wd, c, ry, rx, bstart, n, nf, nb1, out, stream
    "fl_coarse_scores": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    # planes, hd, wd, c, ry, rx, bstart, k, nf, nb1, px0, py0, out, stream
    "fl_local_scores": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                        _P),
    # query, nq, ref, nr, idx, d2, stream
    "fl_nearest_neighbor": (_P, _I, _P, _I, _P, _P, _P),
}

_lib = None
build_seconds = None   # wall time of the nvcc run in this process, if any


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfealess_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``device`` (what the kernels take)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
