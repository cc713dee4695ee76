"""Zstandard frames (RFC 8878) on the host, and the two checksums of the
checkpoint format: XXH64 and CRC-32C.

The JAX package's checkpoints are compressed with zstd (each OCDBT file's
body and each zarr chunk), and neither the card's machine nor the port
has a zstd package, so frames are decoded here in C
(``csrc/zstd_decode.c``: built with the host compiler at first use and
called through ctypes, which releases the interpreter lock; a failed
build raises, and there is no Python fallback).  Decoding stays on the
host, as tensorstore's does.

- :func:`decode`: every frame of ``data`` (skippable frames skipped),
  into at most ``capacity`` and ``limit`` bytes; corrupt or truncated
  data, a frame that needs a dictionary, a content checksum that differs
  or content (declared or decoded) past the bound raise
  :class:`DecodeError`.
- :func:`encode_raw`: a valid frame of raw (stored) blocks, which any
  zstd decoder reads; the checkpoint writer's compression.
- :func:`xxh64`, :func:`crc32c`.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

from fealess_tpu_torch.io.png import DecodeError

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
_ERRORS = {-1: "the data ends inside a frame", -2: "not a zstd frame",
           -3: "the frame needs a dictionary",
           -4: "reserved bit set in the frame header",
           -5: "reserved block type or block past its size limit",
           -6: "content larger than the capacity",
           -7: "content checksum differs", -8: "corrupt literals section",
           -9: "corrupt Huffman table or stream",
           -10: "corrupt FSE table description",
           -11: "corrupt sequences section",
           -12: "match offset before the start of the frame",
           -13: "content size differs from the frame header's",
           -14: "out of memory"}
_OUTPUT = -6

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("zstd_decode")))
            p, n = ctypes.c_char_p, ctypes.c_size_t
            lib.fl_zstd_decode.argtypes = (p, n, ctypes.c_void_p, n,
                                           ctypes.c_void_p)
            lib.fl_zstd_decode.restype = ctypes.c_longlong
            lib.fl_zstd_content_size.argtypes = (p, n)
            lib.fl_zstd_content_size.restype = ctypes.c_longlong
            lib.fl_xxh64.argtypes = (p, n, ctypes.c_uint64)
            lib.fl_xxh64.restype = ctypes.c_uint64
            lib.fl_crc32c.argtypes = (p, n, ctypes.c_uint32)
            lib.fl_crc32c.restype = ctypes.c_uint32
            _LIB = lib
    return _LIB


def _error(rc: int, info: int, what: str) -> DecodeError:
    msg = _ERRORS.get(rc, f"error {rc}")
    if rc == -3:
        msg += f" (dictionary id {info}), which the port does not read"
    return DecodeError(f"{what}: zstd: {msg}")


def content_size(data: bytes) -> Optional[int]:
    """The content size the frames of ``data`` declare, summed, or None
    where a frame does not declare it."""
    data = bytes(data)
    rc = _lib().fl_zstd_content_size(data, len(data))
    if rc < -1:
        raise _error(rc, 0, "zstd data")
    return None if rc == -1 else rc


def decode(data: bytes, capacity: Optional[int] = None, *,
           limit: int = 1 << 31, what: str = "zstd data") -> bytes:
    """The content of every frame of ``data``.  ``capacity`` and
    ``limit`` both bound it: content past either raises, and a declared
    size past either raises before any buffer is taken.  The buffer is
    the frames' declared size, else it grows up to the bound."""
    data = bytes(data)
    lib = _lib()
    bound = limit if capacity is None else min(capacity, limit)
    # below 0: no declared size, or a fault the decoder reports in full
    declared = lib.fl_zstd_content_size(data, len(data))
    if declared > bound:
        raise _error(_OUTPUT, 0, what)
    grow = declared < 0
    size = min(bound, max(1 << 16, 4 * len(data))) if grow else declared
    info = ctypes.c_uint64(0)
    while True:
        out = ctypes.create_string_buffer(max(size, 1))
        rc = lib.fl_zstd_decode(data, len(data), out, size,
                                ctypes.byref(info))
        if rc >= 0:
            return ctypes.string_at(out, rc)
        if rc == _OUTPUT and grow and size < bound:
            size = min(bound, 2 * size)
            continue
        raise _error(rc, info.value, what)


def encode_raw(data: bytes) -> bytes:
    """One zstd frame holding ``data`` in raw blocks: a single-segment
    header with the content size, then blocks of up to 128 KiB."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        flag, fcs = 0, struct.pack("<B", n)
    elif n < 65536 + 256:
        flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 1 << 32:
        flag, fcs = 2, struct.pack("<I", n)
    else:
        flag, fcs = 3, struct.pack("<Q", n)
    parts = [struct.pack("<IB", MAGIC, flag << 6 | 0x20), fcs]
    for at in range(0, n, BLOCK_MAX) if n else [0]:
        block = data[at:at + BLOCK_MAX]
        last = at + BLOCK_MAX >= n
        parts += [(len(block) << 3 | last).to_bytes(3, "little"), block]
    return b"".join(parts)


def xxh64(data: bytes, seed: int = 0) -> int:
    data = bytes(data)
    return _lib().fl_xxh64(data, len(data), seed)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return _lib().fl_crc32c(data, len(data), crc)
