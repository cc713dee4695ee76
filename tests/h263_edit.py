"""Hand edits of H.263 and Sorenson Spark pictures, for the sources of
``tests/make_torch_video.py``'s ``h263`` group and for
``tests/test_torch_h263.py``: header fields set in place, PSPARE bytes
inserted after PTYPE's fields, a Sorenson version 1 picture rewritten to
version 0 (each escape re-coded as H.263's LAST RUN LEVEL with an 8-bit
level), a GOB header inserted after a macroblock row, and pictures built
from nothing (intra macroblocks with only their DC, skipped macroblocks).

The pictures are walked with the decoder's own VLC tables, read from
``fealess_tpu_torch/csrc/h263_mb.h``; every edit works on a string of
'0' and '1' characters and pads the result with zero bits to a byte.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

_HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "fealess_tpu_torch", "csrc", "h263_mb.h")


def _tables() -> Dict[str, List[int]]:
    with open(_HEADER) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r"static const u?int\d+_t (\w+)\[\d+\] = \{([^}]*)\}",
                         text):
        out[m.group(1)] = [int(v) for v in m.group(2).replace("\n", " ")
                           .split(",") if v.strip()]
    return out


_T = _tables()
ESCAPE, INTER_LAST = 102, 58


def _vlc(code: Sequence[int], length: Sequence[int]) -> Dict[str, int]:
    return {format(c, f"0{n}b"): s
            for s, (c, n) in enumerate(zip(code, length)) if n}


TCOEF = _vlc(_T["inter_code"], _T["inter_len"])
INTRA_MCBPC = _vlc(_T["intra_mcbpc_code"], _T["intra_mcbpc_len"])
INTER_MCBPC = _vlc(_T["inter_mcbpc_code"], _T["inter_mcbpc_len"])
CBPY = _vlc(_T["cbpy_code"], _T["cbpy_len"])
MVD = _vlc(_T["mv_code"], _T["mv_len"])
# the codes of the macroblock header's symbols, for hand-built pictures
CODES = {name: {s: c for c, s in table.items()} for name, table in (
    ("intra_mcbpc", INTRA_MCBPC), ("inter_mcbpc", INTER_MCBPC),
    ("cbpy", CBPY))}

# H.263 source formats 1-5: (width, height)
FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288), 4: (704, 576),
           5: (1408, 1152)}
# (first bit, width) of the H.263 picture header's fields (22-bit PSC)
H263_FIELDS = {"tr": (22, 8), "marker": (30, 1), "id": (31, 1),
               "format": (35, 3), "pframe": (38, 1), "umv": (39, 1),
               "sac": (40, 1), "ap": (41, 1), "pb": (42, 1),
               "pquant": (43, 5), "cpm": (48, 1), "pei": (49, 1)}
# Sorenson's fields up to the size (17-bit PSC); the rest follow it
FLV_FIELDS = {"version": (17, 5), "tr": (22, 8), "form": (30, 3)}
# Sorenson's fixed sizes, forms 2-6
FLV_SIZES = {2: (352, 288), 3: (176, 144), 4: (128, 96), 5: (320, 240),
             6: (160, 120)}


def bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def unbits(b: str) -> bytes:
    b += "0" * (-len(b) % 8)
    return int(b, 2).to_bytes(len(b) // 8, "big") if b else b""


def _set(b: str, at: int, width: int, value: int) -> str:
    return b[:at] + format(value & ((1 << width) - 1), f"0{width}b") + \
        b[at + width:]


def flv_fields(packet: bytes) -> Dict[str, Tuple[int, int]]:
    """Every field of a Sorenson picture header: name -> (bit, width)."""
    b = bits(packet)
    form = int(b[30:33], 2)
    at = 33
    out = dict(FLV_FIELDS)
    if form < 2:
        n = 16 if form else 8
        out["width"], out["height"] = (at, n), (at + n, n)
        at += 2 * n
    out.update({"type": (at, 2), "deblocking": (at + 2, 1),
                "quant": (at + 3, 5), "pei": (at + 8, 1)})
    return out


def set_field(packet: bytes, field: str, value: int) -> bytes:
    """``packet`` with a picture header field set: H.263's where the
    packet starts with its 22-bit PSC, else Sorenson's."""
    fields = H263_FIELDS if is_h263(packet) else flv_fields(packet)
    at, width = fields[field]
    return unbits(_set(bits(packet), at, width, value)[:len(packet) * 8])


def is_h263(packet: bytes) -> bool:
    return bits(packet[:3])[:22] == "0" * 16 + "100000"


def insert_spare(packet: bytes, spare: bytes) -> bytes:
    """``packet`` with PEI set and ``spare`` as PSPARE bytes before the
    PEI of 0 that ends the header."""
    fields = H263_FIELDS if is_h263(packet) else flv_fields(packet)
    at = fields["pei"][0]
    b = bits(packet)
    assert b[at] == "0"
    extra = "".join("1" + f"{s:08b}" for s in spare)
    return unbits(b[:at] + extra + b[at:])


# ---- walking a picture ----

class _Reader:
    def __init__(self, b: str, at: int):
        self.b, self.at = b, at

    def get(self, n: int) -> int:
        field = self.b[self.at:self.at + n]
        if len(field) < n:
            raise ValueError("the picture ends early")
        self.at += n
        return int(field, 2) if n else 0

    def vlc(self, table: Dict[str, int]) -> int:
        for n in range(1, 14):
            s = table.get(self.b[self.at:self.at + n])
            if s is not None:
                self.at += n
                return s
        raise ValueError(f"no code at bit {self.at}")


def walk(packet: bytes) -> dict:
    """The syntax of an H.263 or Sorenson picture as the writer writes it
    (no annex, no DQUANT): ``mb_end`` (the bit after each macroblock),
    ``escapes`` (the bit after each escape code, with its form: "8", "7"
    or "11") and ``mb_w``."""
    b = bits(packet)
    if is_h263(packet):
        f = H263_FIELDS
        w, h = FORMATS[int(b[35:38], 2)]
        pframe = int(b[38])
        at = f["pei"][0]
        version = None
    else:
        f = flv_fields(packet)

        def field(name: str) -> int:
            at, n = f[name]
            return int(b[at:at + n], 2)
        version = field("version")
        if "width" in f:
            w, h = field("width"), field("height")
        else:
            w, h = FLV_SIZES[field("form")]
        pframe = field("type") > 0
        at = f["pei"][0]
    r = _Reader(b, at)
    while r.get(1):
        r.get(8)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    out = {"mb_end": [], "escapes": [], "mb_w": mb_w}

    def block(intra: bool) -> None:
        if intra:
            r.get(8)
        while True:
            s = r.vlc(TCOEF)
            if s == ESCAPE:
                if version == 1:
                    form = "11" if r.b[r.at] == "1" else "7"
                    out["escapes"].append((r.at, form))
                    r.get(1 + 1 + 6 + int(form))
                    last = r.b[r.at - int(form) - 7]
                else:
                    out["escapes"].append((r.at, "8"))
                    r.get(1 + 6 + 8)
                    last = r.b[r.at - 15]
                if last == "1":
                    return
                continue
            r.get(1)
            if s >= INTER_LAST:
                return

    for _ in range(mb_w * mb_h):
        intra = not pframe
        if pframe:
            if r.get(1):
                out["mb_end"].append(r.at)
                continue
            cbpc = r.vlc(INTER_MCBPC)
            intra = bool(cbpc & 4)
        else:
            cbpc = r.vlc(INTRA_MCBPC)
        assert not cbpc & 8 and not (not pframe and cbpc & 4), "DQUANT"
        cbpy = r.vlc(CBPY)
        cbp = (cbpc & 3) | ((cbpy if intra else cbpy ^ 0xF) << 2)
        if not intra:
            for _ in range(2):
                if r.vlc(MVD):
                    r.get(1)
        for n in range(6):
            if cbp & (32 >> n):
                block(intra)
            elif intra:
                r.get(8)
        out["mb_end"].append(r.at)
    return out


def to_version0(packet: bytes) -> bytes:
    """A Sorenson version 1 picture as version 0: the version field 0 and
    each escape re-coded with H.263's 8-bit level (the picture must hold
    no level outside -127..127)."""
    b = bits(packet)
    w = walk(packet)
    for at, form in reversed(w["escapes"]):
        n = int(form)
        last, run = b[at + 1], b[at + 2:at + 8]
        level = int(b[at + 8:at + 8 + n], 2)
        level -= (1 << n) * (level >> (n - 1))
        assert level and -127 <= level <= 127, level
        b = b[:at] + last + run + format(level & 0xFF, "08b") + \
            b[at + 8 + n:]
    return unbits(_set(b, 17, 5, 0))


def insert_gob(packet: bytes, row: int = 1) -> bytes:
    """An H.263 ``packet`` with a GOB header (stuffed to a byte, GBSC, GN
    ``row``, GFID 0, GQUANT the picture's PQUANT) before macroblock row
    ``row``."""
    w = walk(packet)
    at = w["mb_end"][row * w["mb_w"] - 1]
    b = bits(packet)
    q = int(b[43:48], 2)
    gob = "0" * (-at % 8) + "0" * 16 + "1" + f"{row:05b}" + "00" + f"{q:05b}"
    return unbits(b[:at] + gob + b[at:])


# ---- pictures built from nothing ----

def h263_header(fmt: int, pframe: bool, q: int, tr: int = 0) -> str:
    """An H.263 picture header: source format ``fmt``, no annex, PQUANT
    ``q``, no PSPARE."""
    return ("0" * 16 + "100000" + f"{tr:08b}" + "10" + "000" +
            f"{fmt:03b}" + str(int(pframe)) + "0000" + f"{q:05b}" + "00")


def intra_mb(dcs: Sequence[int], dquant: Optional[int] = None,
             pframe: bool = False) -> str:
    """An intra macroblock with six DC-only blocks (``dcs``, 8-bit codes):
    in an I picture, or in a P picture after COD 0; with DQUANT (its 2-bit
    code) where ``dquant`` is given."""
    if pframe:
        mcbpc = "0" + CODES["inter_mcbpc"][12 if dquant is not None else 4]
    else:
        mcbpc = CODES["intra_mcbpc"][4 if dquant is not None else 0]
    return (mcbpc + CODES["cbpy"][0] +
            ("" if dquant is None else f"{dquant:02b}") +
            "".join(f"{d:08b}" for d in dcs))


def picture(header: str, mbs: Sequence[str]) -> bytes:
    return unbits(header + "".join(mbs))
