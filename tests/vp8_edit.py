"""Re-encode VP8 frames with a header field or the token partitioning
changed, for the tests and ``tests/make_torch_video.py``.

The port's decoder (``io/vp8.Vp8Decoder.trace``) gives the bools a packet's
partitions decode with their probabilities; :func:`read_header` walks the
first partition's into the frame header's fields (RFC 6386 section 19.2),
:func:`header_bools` writes the fields back, and :class:`BoolEncoder` (RFC
6386 section 7.3) codes the bools into partitions again.  A field changed
this way changes no bool past the header, so the stream decodes as the
changed header says: cv2 and the port are then held to each other on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Bools = List[Tuple[int, int]]
# header fields that change no decoding: a rewrite writes them and replays
# the stream as it was (the port refuses clamping_type 1)
INERT = ("clamping_type",)


class BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self) -> None:
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def encode(bools: Sequence[Tuple[int, int]]) -> bytes:
    enc = BoolEncoder()
    for prob, bit in bools:
        enc.put(int(prob), int(bit))
    return enc.flush()


class _Reader:
    def __init__(self, probs, bits):
        self.probs, self.bits, self.at = probs, bits, 0

    def take(self, n: int = 1) -> Bools:
        out = [(int(self.probs[self.at + k]), int(self.bits[self.at + k]))
               for k in range(n)]
        self.at += n
        return out

    def uint(self, n: int) -> int:
        v = 0
        for _, b in self.take(n):
            v = (v << 1) | b
        return v

    def flag(self) -> int:
        return self.take()[0][1]


def _signed(r: _Reader, bits: int) -> Optional[int]:
    """A flag-guarded magnitude and sign; None where the flag is 0."""
    if not r.flag():
        return None
    v = r.uint(bits)
    return -v if r.flag() else v


def read_header(probs, bits, key: bool) -> Tuple[Dict, int]:
    """The frame header's fields from a first partition's traced bools,
    and the index of the first macroblock's bool.  The coefficient and MV
    probability updates are kept as their bools."""
    r = _Reader(probs, bits)
    f: Dict = {}
    if key:
        f["color_space"], f["clamping_type"] = r.flag(), r.flag()
    f["segmentation"] = r.flag()
    assert not f["segmentation"], "segmentation is not re-encoded"
    f["filter_type"], f["filter_level"] = r.flag(), r.uint(6)
    f["sharpness"] = r.uint(3)
    f["lf_delta"] = r.flag()
    f["lf_update"] = None
    if f["lf_delta"] and r.flag():
        f["lf_update"] = [_signed(r, 6) for _ in range(8)]
    f["partitions"] = r.uint(2)
    f["q"] = r.uint(7)
    f["q_delta"] = [_signed(r, 4) for _ in range(5)]
    if not key:
        f["refresh_golden"], f["refresh_altref"] = r.flag(), r.flag()
        f["copy_to_golden"] = 0 if f["refresh_golden"] else r.uint(2)
        f["copy_to_altref"] = 0 if f["refresh_altref"] else r.uint(2)
        f["sign_bias_golden"], f["sign_bias_altref"] = r.flag(), r.flag()
    f["refresh_probs"] = r.flag()
    if not key:
        f["refresh_last"] = r.flag()
    start = r.at
    for _ in range(4 * 8 * 3 * 11):
        if r.flag():
            r.uint(8)
    f["coef_updates"] = [(int(probs[k]), int(bits[k]))
                         for k in range(start, r.at)]
    f["skip_flag"] = r.flag()
    f["prob_skip"] = r.uint(8) if f["skip_flag"] else None
    if not key:
        f["prob_intra"], f["prob_last"] = r.uint(8), r.uint(8)
        f["prob_golden"] = r.uint(8)
        f["ymode_probs"] = [r.uint(8) for _ in range(4)] if r.flag() \
            else None
        f["uvmode_probs"] = [r.uint(8) for _ in range(3)] if r.flag() \
            else None
        start = r.at
        for _ in range(2 * 19):
            if r.flag():
                r.uint(7)
        f["mv_updates"] = [(int(probs[k]), int(bits[k]))
                           for k in range(start, r.at)]
    return f, r.at


def _uint(v: int, n: int) -> Bools:
    return [(128, (v >> (n - 1 - k)) & 1) for k in range(n)]


def _put_signed(v: Optional[int], bits: int) -> Bools:
    if v is None:
        return [(128, 0)]
    return [(128, 1)] + _uint(abs(v), bits) + [(128, int(v < 0))]


def header_bools(f: Dict, key: bool) -> Bools:
    """The bools of a header with fields ``f`` (:func:`read_header`'s)."""
    out: Bools = []
    if key:
        out += _uint(f["color_space"], 1) + _uint(f["clamping_type"], 1)
    out += _uint(f["segmentation"], 1)
    out += _uint(f["filter_type"], 1) + _uint(f["filter_level"], 6)
    out += _uint(f["sharpness"], 3) + _uint(f["lf_delta"], 1)
    if f["lf_delta"]:
        out += _uint(f["lf_update"] is not None, 1)
        for v in f["lf_update"] or ():
            out += _put_signed(v, 6)
    out += _uint(f["partitions"], 2) + _uint(f["q"], 7)
    for v in f["q_delta"]:
        out += _put_signed(v, 4)
    if not key:
        out += _uint(f["refresh_golden"], 1) + _uint(f["refresh_altref"], 1)
        if not f["refresh_golden"]:
            out += _uint(f["copy_to_golden"], 2)
        if not f["refresh_altref"]:
            out += _uint(f["copy_to_altref"], 2)
        out += _uint(f["sign_bias_golden"], 1)
        out += _uint(f["sign_bias_altref"], 1)
    out += _uint(f["refresh_probs"], 1)
    if not key:
        out += _uint(f["refresh_last"], 1)
    out += f["coef_updates"]
    out += _uint(f["skip_flag"], 1)
    if f["skip_flag"]:
        out += _uint(f["prob_skip"], 8)
    if not key:
        out += _uint(f["prob_intra"], 8) + _uint(f["prob_last"], 8)
        out += _uint(f["prob_golden"], 8)
        for name in ("ymode_probs", "uvmode_probs"):
            out += _uint(f[name] is not None, 1)
            for v in f[name] or ():
                out += _uint(v, 8)
        out += f["mv_updates"]
    return out


def frame(key: bool, version: int, show: int, key_header: bytes,
          first: bytes, parts: Sequence[bytes]) -> bytes:
    """A packet: the frame tag, the key frame's start code and size, the
    first partition, the token partitions' sizes, the partitions."""
    tag = int(not key) | (version << 1) | (show << 4) | (len(first) << 5)
    out = tag.to_bytes(3, "little") + (key_header if key else b"") + first
    out += b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
    return out + b"".join(parts)


def tag_fields(packet: bytes) -> Tuple[bool, int, int]:
    """(key frame, version, show_frame) of a packet's frame tag."""
    return not packet[0] & 1, (packet[0] >> 1) & 7, (packet[0] >> 4) & 1


def _bools(dec, k: int):
    """(bools, marks) of the last packet's trace of partition ``k``."""
    probs, bits, marks = dec.traced(k)
    return list(zip(probs.tolist(), bits.tolist())), marks.tolist()


def _split(bools, marks):
    cuts = list(marks) + [len(bools)]
    return [bools[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def rewrite(packets: Sequence[bytes], edit) -> List[bytes]:
    """``packets`` re-encoded with ``edit(i, fields, mbs, toks)`` applied
    to each frame.  ``edit`` may change the header ``fields``
    (:func:`read_header`'s, plus ``"show"``, ``"version"`` and
    ``"parts"``, the number of token partitions), the first partition's
    bits past the header (``mbs``, a list of (prob, bit) for each
    macroblock) and the token partitions' (``toks``, the same), and
    returns nothing.  ``fields["modes"]`` holds the macroblocks' modes
    (:meth:`~fealess_tpu_torch.io.vp8.Vp8Decoder.modes`, flattened).

    The bits are the original stream's; a second decoder replays them on
    the stream as edited so far, which gives the probabilities each is read
    with there (changed where the edit changes the probabilities, the MV
    predictions or the references), and those are coded."""
    from fealess_tpu_torch.io.vp8 import Vp8Decoder
    src, dst = Vp8Decoder(), Vp8Decoder()
    src.trace()
    dst.trace()
    out = []
    src_w = src_h = 0
    for i, p in enumerate(packets):
        src.decode(p)
        key, version, show = tag_fields(p)
        if key:
            src_w = int.from_bytes(p[6:8], "little") & 0x3FFF
            src_h = int.from_bytes(p[8:10], "little") & 0x3FFF
        first, marks = _bools(src, 0)
        tokens, tmarks = _bools(src, 1)
        f, end = read_header([b[0] for b in first], [b[1] for b in first],
                             key)
        mbs, toks = _split(first, marks), _split(tokens, tmarks)
        f.update(show=show, version=version, parts=1 << f["partitions"],
                 modes=src.modes(src_w, src_h).ravel().tolist())
        original = dict(f)
        edit(i, f, mbs, toks)
        f["partitions"] = f["parts"].bit_length() - 1
        # a field the port refuses and that changes no decoding is
        # replayed as it was and written as edited
        replayed = dict(f, **{k: v for k, v in original.items()
                              if k in INERT})
        head = header_bools(replayed, key)
        bits0 = [b for _, b in head] + [b for mb in mbs for _, b in mb]
        bits1 = [b for mb in toks for _, b in mb]
        shell = frame(key, f["version"], f["show"], p[3:10], bytes(64),
                      [bytes(64)] * f["parts"])
        dst.replay(shell, np.array(bits0, np.uint8), np.array(bits1,
                                                               np.uint8))
        first, marks = _bools(dst, 0)
        tokens, tmarks = _bools(dst, 1)
        assert [b for _, b in first] == bits0
        first = header_bools(f, key) + first[len(head):]
        mb_w = (src_w + 15) // 16
        toks = _split(tokens, tmarks)
        parts = [encode([b for m, mb in enumerate(toks)
                         if (m // mb_w) % f["parts"] == k for b in mb])
                 for k in range(f["parts"])]
        out.append(frame(key, f["version"], f["show"], p[3:10],
                         encode(first), parts))
    src.close()
    dst.close()
    return out


def refusal_frame(packet: bytes, bools: Bools) -> bytes:
    """``packet``'s frame tag (and key-frame size) with a first partition
    of ``bools`` and then zeros, and an empty token partition: a header
    cut where the decoder refuses it."""
    key, version, show = tag_fields(packet)
    first = encode(list(bools) + [(128, 0)] * 64)
    return frame(key, version, show, packet[3:10], first, [bytes(16)])
