"""Build and load the port's CUDA kernels (``fealess_tpu_torch/csrc``)
and its host C helpers.

The ``.cu`` sources have a plain C interface: ``nvcc`` compiles them for
Hopper (``sm_90a``) into one shared library under
``<repo>/build/fealess_tpu_torch/``, named by a hash of the sources and
flags, so the build runs at first use and again only when a source
changes.  The library is loaded with ``ctypes``; every pointer and the
CUDA stream are passed as ``c_void_p`` and every entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

A host C source (``csrc/*.c``: the PNG un-filter) is compiled with the
host compiler (``cc -O2 -shared -fPIC``) by :func:`build_host` into the
same directory, named by a hash of the source and flags, at first use on
any machine.  :func:`build_native_host` compiles the training path's
native extraction the same way, with the host C++ compiler, from three
sources of ``native/fealess_host`` (``scatter.cc``, ``chamfer.cc``,
``extract.cc``; ``frame_loader.cc`` needs OpenCV and is left out), so it
needs neither CMake nor OpenCV.  Concurrent builds (test workers, a frame
loader's or an extraction pool's threads) wait on a lock file and load
the one library; a failed build raises with the compiler's errors.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` without a card.
"""

from __future__ import annotations

import ctypes
import fcntl
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
HOST_CFLAGS = ("-O2", "-shared", "-fPIC")
# The repo's native extraction (read, never edited).  No -march=native and
# no contraction: the views must not drift from the numpy twin's with the
# machine's instruction set.
NATIVE_HOST = _PKG.parent / "native" / "fealess_host"
NATIVE_SOURCES = ("scatter.cc", "chamfer.cc", "extract.cc")
HOST_CXXFLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC",
                 "-ffp-contract=off")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # planes, channels, hd, wd, c, ry, rx, bstart, n, nf, nb1, out, stream
    "fl_coarse_scores": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                         _P),
    # planes, channels, hd, wd, c, ry, rx, bstart, k, nf, nb1, px0, py0,
    # out, stream
    "fl_local_scores": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                        _P, _P),
    # planes, channels, hd, wd, c, ry, rx, bstart, nf, nb1, slot, x, y, k,
    # width, height, nfeat, levels, level, t, w, h, offset, scores, x_out,
    # y_out, best, nf_out, stream
    "fl_local_refine": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                        _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P, _P),
    # query, nq, ref, nr, chunk, nchunks, part_idx, part_d2, idx, d2, stream
    "fl_nearest_neighbor": (_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    "fl_nn_query_tile": (),
    "fl_nn_ref_tile": (),
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


def _find_compiler(env: str, names, what: str) -> str:
    for name in (os.environ.get(env), *names):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no host {what} compiler ({', '.join(names)}; or "
                       f"set {env})")


def _host_cc() -> str:
    return _find_compiler("CC", ("cc", "gcc", "clang"), "C")


def _host_cxx() -> str:
    return _find_compiler("CXX", ("c++", "g++", "clang++"), "C++")


def _build_host_library(stem: str, compiler, flags, sources) -> pathlib.Path:
    """Compile ``sources`` into ``lib<stem>_<hash>.so`` under BUILD_DIR
    unless the library for these sources and flags exists; the hash
    covers the flags and each source's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{so.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():                  # built while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode})"
                               f":\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def build_host(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.c`` with the host compiler unless the library
    for this source and these flags exists; return its path."""
    return _build_host_library(name, _host_cc, HOST_CFLAGS,
                               [CSRC / f"{name}.c"])


def build_native_host() -> pathlib.Path:
    """Compile ``libfealess_host`` (the training path's extraction) from
    ``NATIVE_SOURCES`` with the host C++ compiler unless the library for
    these sources and flags exists; return its path."""
    return _build_host_library("fealess_host", _host_cxx, HOST_CXXFLAGS,
                               [NATIVE_HOST / f for f in NATIVE_SOURCES])


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
