"""Re-encode VP9 frames with header fields or the tiling changed, for the
tests and ``tests/make_torch_video.py``.

The port's decoder (``io/vp9.Vp9Decoder.trace``) gives the bools a frame's
partitions decode (the compressed header, then each tile) with the
superblocks' starts; :func:`read_header` and :func:`write_header` read and
write the uncompressed header (the VP9 specification's section 6.2), and
:func:`rewrite` replays the bools on the changed header
(``Vp9Decoder.replay``), which gives the probabilities they are read with
there, and codes them again with the boolean encoder (``vp8_edit``'s: VP9
codes bools as VP8 does).  A stream changed this way is a valid stream that
decodes as its changed header says: cv2 and the port are then held to
each other on it.  :func:`superframe` and :func:`show_existing` build the
packets the specification's Annex B and ``show_existing_frame`` describe.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tests.vp8_edit import BoolEncoder

# the fields that follow each other in the header, by frame kind
Fields = Dict[str, object]


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def bit(self) -> int:
        v = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return v

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def signed(self, n: int) -> int:
        v = self.lit(n)
        return -v if self.bit() else v


class _Writer:
    def __init__(self):
        self.bits: List[int] = []

    def lit(self, v: int, n: int) -> None:
        self.bits += [(v >> (n - 1 - k)) & 1 for k in range(n)]

    def signed(self, v: int, n: int) -> None:
        self.lit(abs(v), n)
        self.lit(int(v < 0), 1)

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def tile_log2_range(width: int):
    """(min, max) log2 of the tile columns a frame of ``width`` allows."""
    sb_cols = (((width + 7) >> 3) + 7) >> 3
    lo, hi = 0, 1
    while (64 << lo) < sb_cols:
        lo += 1
    while (sb_cols >> hi) >= 4:
        hi += 1
    return lo, hi - 1


def read_header(data: bytes, sizes: Optional[Dict[int, tuple]] = None
                ) -> Fields:
    """The uncompressed header's fields (profile 0, no segmentation), with
    ``"bytes"``, its length.  ``sizes`` maps a reference slot to its frame
    size (for a frame that takes its size from a reference)."""
    r, f = _Bits(data), {}
    assert r.lit(2) == 2
    f["profile"] = r.bit() | r.bit() << 1
    assert f["profile"] == 0
    f["show_existing"] = r.bit()
    if f["show_existing"]:
        f["slot"] = r.lit(3)
        f["bytes"] = 1
        return f
    f["key"] = 1 - r.bit()
    f["show"] = r.bit()
    f["error_res"] = r.bit()
    if f["key"]:
        assert r.lit(24) == 0x498342
        f["color_space"], f["color_range"] = r.lit(3), r.bit()
        f["width"], f["height"] = r.lit(16) + 1, r.lit(16) + 1
        f["render"] = (r.lit(16) + 1, r.lit(16) + 1) if r.bit() else None
    else:
        f["intra_only"] = 0 if f["show"] else r.bit()
        assert not f["intra_only"]
        f["reset_ctx"] = 0 if f["error_res"] else r.lit(2)
        f["refresh"] = r.lit(8)
        f["refs"] = [(r.lit(3), r.bit()) for _ in range(3)]
        f["size_from"] = None
        for k in range(3):
            if r.bit():
                f["size_from"] = k
                break
        if f["size_from"] is None:
            f["width"], f["height"] = r.lit(16) + 1, r.lit(16) + 1
        else:
            f["width"], f["height"] = sizes[f["refs"][f["size_from"]][0]]
        f["render"] = (r.lit(16) + 1, r.lit(16) + 1) if r.bit() else None
        f["allow_hp"] = r.bit()
        f["filter"] = 4 if r.bit() else r.lit(2)
    if not f["error_res"]:
        f["refresh_ctx"], f["parallel"] = r.bit(), r.bit()
    f["ctx_idx"] = r.lit(2)
    f["lf_level"], f["sharpness"] = r.lit(6), r.lit(3)
    f["delta_enabled"] = r.bit()
    f["ref_deltas"], f["mode_deltas"] = [None] * 4, [None] * 2
    f["delta_update"] = f["delta_enabled"] and r.bit()
    if f["delta_update"]:
        for k in range(4):
            if r.bit():
                f["ref_deltas"][k] = r.signed(6)
        for k in range(2):
            if r.bit():
                f["mode_deltas"][k] = r.signed(6)
    f["base_q"] = r.lit(8)
    f["delta_q"] = [r.signed(4) if r.bit() else 0 for _ in range(3)]
    assert not r.bit(), "segmentation"
    lo, hi = tile_log2_range(f["width"])
    f["log2_tile_cols"] = lo
    while f["log2_tile_cols"] < hi and r.bit():
        f["log2_tile_cols"] += 1
    f["log2_tile_rows"] = r.bit()
    if f["log2_tile_rows"]:
        f["log2_tile_rows"] += r.bit()
    f["header_size"] = r.lit(16)
    f["bytes"] = (r.pos + 7) >> 3
    return f


def write_header(f: Fields) -> bytes:
    """The uncompressed header of ``f`` (:func:`read_header`'s fields)."""
    w = _Writer()
    w.lit(2, 2)
    w.lit(0, 2)
    if f["show_existing"]:
        w.lit(1, 1)
        w.lit(f["slot"], 3)
        return w.bytes()
    w.lit(0, 1)
    w.lit(1 - f["key"], 1)
    w.lit(f["show"], 1)
    w.lit(f["error_res"], 1)
    if f["key"]:
        w.lit(0x498342, 24)
        w.lit(f["color_space"], 3)
        w.lit(f["color_range"], 1)
        w.lit(f["width"] - 1, 16)
        w.lit(f["height"] - 1, 16)
    else:
        if not f["show"]:
            w.lit(0, 1)
        if not f["error_res"]:
            w.lit(f["reset_ctx"], 2)
        w.lit(f["refresh"], 8)
        for slot, bias in f["refs"]:
            w.lit(slot, 3)
            w.lit(bias, 1)
        if f["size_from"] is None:
            w.lit(0, 3)
            w.lit(f["width"] - 1, 16)
            w.lit(f["height"] - 1, 16)
        else:
            w.lit(0, f["size_from"])
            w.lit(1, 1)
    w.lit(int(f["render"] is not None), 1)
    if f["render"] is not None:
        w.lit(f["render"][0] - 1, 16)
        w.lit(f["render"][1] - 1, 16)
    if not f["key"]:
        w.lit(f["allow_hp"], 1)
        w.lit(int(f["filter"] == 4), 1)
        if f["filter"] != 4:
            w.lit(f["filter"], 2)
    if not f["error_res"]:
        w.lit(f["refresh_ctx"], 1)
        w.lit(f["parallel"], 1)
    w.lit(f["ctx_idx"], 2)
    w.lit(f["lf_level"], 6)
    w.lit(f["sharpness"], 3)
    w.lit(f["delta_enabled"], 1)
    if f["delta_enabled"]:
        w.lit(int(bool(f["delta_update"])), 1)
        if f["delta_update"]:
            for v in list(f["ref_deltas"]) + list(f["mode_deltas"]):
                w.lit(int(v is not None), 1)
                if v is not None:
                    w.signed(v, 6)
    w.lit(f["base_q"], 8)
    for v in f["delta_q"]:
        w.lit(int(v != 0), 1)
        if v:
            w.signed(v, 4)
    for bit in f.get("segmentation", [0]):       # enabled, its updates
        w.lit(bit, 1)
    lo, hi = tile_log2_range(f["width"])
    for _ in range(lo, f["log2_tile_cols"]):
        w.lit(1, 1)
    if f["log2_tile_cols"] < hi:
        w.lit(0, 1)
    w.lit(int(f["log2_tile_rows"] > 0), 1)
    if f["log2_tile_rows"]:
        w.lit(f["log2_tile_rows"] - 1, 1)
    w.lit(f["header_size"], 16)
    return w.bytes()


def encode(probs: np.ndarray, bits: np.ndarray) -> bytes:
    """A partition: the bools, then 32 zero bits, as libvpx's
    vpx_stop_encode pads them."""
    enc = BoolEncoder()
    for prob, bit in zip(probs.tolist(), bits.tolist()):
        enc.put(prob, bit)
    for _ in range(32):
        enc.put(128, 0)
    return enc.flush()


def _tiles(f: Fields):
    """The (row, col) superblock ranges of each tile, in order."""
    sb_cols = (((f["width"] + 7) >> 3) + 7) >> 3
    sb_rows = (((f["height"] + 7) >> 3) + 7) >> 3
    lc, lr = f["log2_tile_cols"], f["log2_tile_rows"]
    out = []
    for tr in range(1 << lr):
        for tc in range(1 << lc):
            out.append((range((tr * sb_rows) >> lr,
                              ((tr + 1) * sb_rows) >> lr),
                        range((tc * sb_cols) >> lc,
                              ((tc + 1) * sb_cols) >> lc)))
    return out


def _regroup(bits, parts, marks, old: Fields, new: Fields):
    """The bits of the partitions of ``new``'s tiling: the compressed
    header as it was, each tile its marker bit and its superblocks' bits
    (a superblock's bits do not depend on the tiling of the rows)."""
    ends = list(parts[1:]) + [len(bits)]
    chunks = {}
    m = 0
    for k, (rows, cols) in enumerate(_tiles(old)):
        for r in rows:
            for c in cols:
                start = marks[m]
                stop = marks[m + 1] if m + 1 < len(marks) and \
                    marks[m + 1] < ends[k + 1] else ends[k + 1]
                chunks[(r, c)] = bits[start:stop]
                m += 1
    out, starts = [bits[:ends[0]]], [0]
    for rows, cols in _tiles(new):
        starts.append(sum(len(b) for b in out))
        out.append(np.zeros(1, np.uint8))          # the marker bit
        out += [chunks[(r, c)] for r in rows for c in cols]
    return np.concatenate(out), np.array(starts, np.int64)


def _drop(bits, parts, marks, drop):
    """``bits`` without the ``drop`` ones, the starts moved with them."""
    kept = np.concatenate([[0], np.cumsum(~drop)])
    return bits[~drop], kept[parts], kept[marks]


def rewrite(packets: Sequence[bytes],
            edit: Callable[[int, Fields], Optional[Fields]]) -> List[bytes]:
    """``packets`` (one frame each, profile 0) re-encoded with
    ``edit(i, fields)``'s header fields (None: as they were)."""
    from fealess_tpu_torch.io.vp9 import TAGS, Vp9Decoder
    src, dst, check = Vp9Decoder(), Vp9Decoder(), Vp9Decoder()
    src.trace()
    dst.trace()
    check.trace()
    sizes = {}
    out = []
    for i, packet in enumerate(packets):
        old = read_header(packet, sizes)
        src.decode_frame(packet)
        if old["show_existing"]:
            dst.decode_frame(packet)
            check.decode_frame(packet)
            out.append(packet)
            continue
        _, bits, tags, parts, marks = src.traced()
        new = edit(i, dict(old)) or dict(old)
        if new.pop("swap_golden_altref", 0):     # blocks take the other
            bits = bits ^ (tags == TAGS["golden_altref"]).astype(np.uint8)
        if new.pop("swap_golden_altref", 0):     # blocks take the other
            bits = bits ^ (tags == TAGS["golden_altref"]).astype(np.uint8)
        drop = np.zeros(len(bits), bool)
        if old.get("filter") == 4 and new.get("filter") != 4:
            drop |= tags == TAGS["filter"]
        if old.get("allow_hp") and not new.get("allow_hp"):
            drop |= tags == TAGS["hp"]
        if drop.any():
            bits, parts, marks = _drop(bits, parts, marks, drop)
        if (new["log2_tile_rows"], new["log2_tile_cols"]) != \
                (old["log2_tile_rows"], old["log2_tile_cols"]):
            bits, parts = _regroup(bits, parts, marks, old, new)
        dst.replay(write_header(new) + bytes(64), bits, parts)
        probs, bits, _, parts, _ = dst.traced()
        ends = list(parts[1:]) + [len(bits)]
        coded = [encode(probs[a:b], bits[a:b]) for a, b in zip(parts, ends)]
        new["header_size"] = len(coded[0])
        tiles = b"".join(len(t).to_bytes(4, "big") + t for t in coded[1:-1])
        frame = write_header(new) + coded[0] + tiles + coded[-1]
        check.decode_frame(frame)
        assert np.array_equal(check.traced()[1], bits), f"frame {i}"
        for k in range(8):
            if new.get("key") or (new["refresh"] >> k) & 1:
                sizes[k] = (new["width"], new["height"])
        out.append(frame)
    return out


def superframe(frames: Sequence[bytes]) -> bytes:
    """One packet of ``frames`` with a superframe index (Annex B): 4-byte
    sizes, little-endian, between two marker bytes."""
    marker = 0xC0 | (3 << 3) | (len(frames) - 1)
    index = bytes([marker]) + b"".join(len(f).to_bytes(4, "little")
                                       for f in frames) + bytes([marker])
    return b"".join(frames) + index


def show_existing(slot: int) -> bytes:
    """A one-byte packet that shows reference slot ``slot`` again."""
    return bytes([0x88 | slot])
