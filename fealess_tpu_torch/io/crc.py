"""The CRC-32 of polynomial 0x04C11DB7, most significant bit first, with
no final XOR (FFmpeg's ``ff_crc04C11DB7_update``), which ``zlib.crc32``
(the reflected polynomial) does not compute: Ogg's page CRC and NUT's
checksums start from 0, MPEG-TS section CRCs from 0xFFFFFFFF.  A
checksum stored big-endian after the bytes it covers brings the CRC of
both to 0.  Computed on the host in C (``csrc/crc04c11db7.c``, built at
first use and called through ctypes), as a page can hold a 640x480
frame."""

from __future__ import annotations

import ctypes
import threading

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The host library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from fealess_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_host("crc04c11db7")))
            lib.fl_crc04c11db7.argtypes = (ctypes.c_uint32, ctypes.c_char_p,
                                           ctypes.c_long)
            lib.fl_crc04c11db7.restype = ctypes.c_uint32
            _LIB = lib
    return _LIB


def crc32(data: bytes, crc: int = 0) -> int:
    """The CRC of ``data`` from the register value ``crc``."""
    return _lib().fl_crc04c11db7(crc, bytes(data), len(data))
