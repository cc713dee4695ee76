"""zarr v2 arrays in a key-value map: how orbax stores each leaf of a
checkpoint (``<name>/.zarray`` and the chunks ``<name>/<i>.<j>...``).

:func:`read_array` assembles the chunk grid of one array (edge chunks
are stored whole and cut to the array; a chunk left out holds the fill
value), for the dtypes a template bank has: ``<i4``, ``|b1`` and
``<f4``.  Chunks are zstd-compressed (``io/zstd``) or stored raw; C
order, no filters.  Anything else raises
:class:`~fealess_tpu_torch.io.png.DecodeError` naming it.
:func:`array_items` writes a bank's leaf as orbax does: one chunk
covering it, zstd.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict, Mapping

import numpy as np

from fealess_tpu_torch.io import zstd
from fealess_tpu_torch.io.png import DecodeError

DTYPES = {"<i4": np.dtype("<i4"), "|b1": np.dtype("bool"),
          "<f4": np.dtype("<f4")}
_NAMES = {v: k for k, v in DTYPES.items()}


def read_array(items: Mapping[bytes, bytes], name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``items`` (key -> value)."""
    what = f"zarr array {name!r}"
    raw = items.get(f"{name}/.zarray".encode())
    if raw is None:
        raise DecodeError(f"{what}: no .zarray")
    try:
        meta = json.loads(raw)
        shape = [int(s) for s in meta["shape"]]
        chunks = [int(c) for c in meta["chunks"]]
        dtype_name = meta["dtype"]
    except (ValueError, KeyError, TypeError) as e:
        raise DecodeError(f"{what}: bad .zarray ({e})") from None
    if meta.get("zarr_format") != 2:
        raise DecodeError(f"{what}: zarr_format {meta.get('zarr_format')}")
    if dtype_name not in DTYPES:
        raise DecodeError(f"{what}: dtype {dtype_name!r} is not read "
                          f"(a bank has {', '.join(DTYPES)})")
    if meta.get("order", "C") != "C":
        raise DecodeError(f"{what}: order {meta['order']!r} is not read")
    if meta.get("filters"):
        raise DecodeError(f"{what}: filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise DecodeError(f"{what}: compressor {comp.get('id')!r} is not "
                          f"read")
    if len(chunks) != len(shape) or any(c < 1 for c in chunks) or \
            any(s < 0 for s in shape):
        raise DecodeError(f"{what}: chunks {chunks} for shape {shape}")
    dtype = DTYPES[dtype_name]
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = items.get(key.encode())
        if data is None:
            continue
        if comp is not None:
            data = zstd.decode(data, nbytes, what=f"{what} chunk {key}")
        if len(data) != nbytes:
            raise DecodeError(f"{what}: chunk {key} holds {len(data)} "
                              f"bytes, expected {nbytes}")
        if dtype == np.bool_:
            raw = np.frombuffer(data, np.uint8)
            if raw.max(initial=0) > 1:
                raise DecodeError(f"{what}: chunk {key} holds a bool "
                                  f"other than 0 and 1")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def array_items(name: str, arr: np.ndarray) -> Dict[bytes, bytes]:
    """``arr`` as orbax writes it: ``.zarray`` (compact JSON, sorted keys)
    and one zstd chunk covering the array."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NAMES:
        raise TypeError(f"{name}: dtype {arr.dtype} is not written (a "
                        f"bank has int32, bool and float32)")
    meta = {"chunks": list(arr.shape),
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _NAMES[arr.dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    key = ".".join("0" for _ in arr.shape) or "0"
    return {f"{name}/.zarray".encode():
            json.dumps(meta, separators=(",", ":"), sort_keys=True).encode(),
            f"{name}/{key}".encode(): zstd.encode_raw(arr.tobytes())}
