"""Edit MPEG-2 video packets at the level of start codes and header bits,
for the committed clips of ``tests/data/torch_mpeg2`` and the refusal
tests of ``tests/test_torch_mpeg2.py``.

A packet is a run of units, each from a start code (``00 00 01 xx``) to
the next.  :func:`units` splits a packet, :func:`join` puts it back; the
builders make the units ``cv2.VideoWriter``'s encoder never writes
(loaded matrices, the sequence display, quant matrix, copyright and
picture display extensions, user data); :func:`set_field` sets header
bits; :func:`requantise` rewrites each slice's first macroblock to carry
a new quantiser (and, on request, extra slice information), and
:func:`push_first_vector` makes the first vector of a P picture's slice
reach past the picture's left edge; :func:`b_intra_slice` builds a B
picture's slice that opens with an intra macroblock (which FFmpeg's
encoder never puts in a B picture).  Every field position is ISO/IEC
13818-2's, counted from the bit after the unit's start code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

SEQ, EXT, GOP, PICTURE = 0xB3, 0xB5, 0xB8, 0x00
# (first bit, width) of the fields edited, by unit
SEQ_FIELDS = {"width": (0, 12), "height": (12, 12), "aspect": (24, 4)}
SEQ_EXT_FIELDS = {"progressive_sequence": (12, 1), "chroma_format": (13, 2),
                  "low_delay": (40, 1)}
GOP_FIELDS = {"closed_gop": (25, 1), "broken_link": (26, 1)}
PICTURE_FIELDS = {"picture_coding_type": (10, 3)}
CODING_EXT_FIELDS = {"intra_dc_precision": (20, 2),
                     "picture_structure": (22, 2),
                     "frame_pred_frame_dct": (25, 1),
                     "concealment_motion_vectors": (26, 1),
                     "q_scale_type": (27, 1), "intra_vlc_format": (28, 1),
                     "alternate_scan": (29, 1)}
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def units(packet: bytes) -> List[bytes]:
    """The packet's units in order (bytes before the first start code, if
    any, make a unit of their own)."""
    starts, at = [], packet.find(b"\x00\x00\x01")
    while at >= 0:
        starts.append(at)
        at = packet.find(b"\x00\x00\x01", at + 3)
    if not starts or starts[0]:
        starts.insert(0, 0)
    return [packet[a:b] for a, b in zip(starts, starts[1:] + [len(packet)])]


def join(parts: Sequence[bytes]) -> bytes:
    return b"".join(parts)


def code(unit: bytes) -> int:
    """The unit's start code value (-1 for bytes before a start code)."""
    return unit[3] if unit[:3] == b"\x00\x00\x01" else -1


def ext_id(unit: bytes) -> int:
    """An extension unit's extension_start_code_identifier, else -1."""
    return unit[4] >> 4 if code(unit) == EXT else -1


def _bits(data: bytes) -> str:
    return "".join(format(b, "08b") for b in data)


def _unbits(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def set_field(unit: bytes, at: int, width: int, value: int) -> bytes:
    """``unit`` with ``width`` bits from bit ``at`` past its start code
    set to ``value``."""
    bits = _bits(unit[4:])
    bits = bits[:at] + format(value, f"0{width}b") + bits[at + width:]
    return unit[:4] + _unbits(bits)[:len(unit) - 4]


def _unit(start: int, bits: str) -> bytes:
    return bytes((0, 0, 1, start)) + _unbits(bits)


def _matrix(values: Sequence[int]) -> str:
    """A matrix (raster order) as 64 bytes in zigzag order."""
    return "".join(format(values[z], "08b") for z in ZIGZAG)


def sequence_header(unit: bytes, intra: Optional[Sequence[int]] = None,
                    inter: Optional[Sequence[int]] = None) -> bytes:
    """A sequence header unit like ``unit`` (its first 62 bits: size,
    aspect, frame rate, bit rate, VBV, constrained parameters) that loads
    ``intra`` and ``inter`` (raster order), where given."""
    bits = _bits(unit[4:])[:62]
    for m in (intra, inter):
        bits += "1" + _matrix(m) if m is not None else "0"
    return _unit(SEQ, bits)


def display_extension(width: int, height: int,
                      matrix: Optional[int] = None) -> bytes:
    """A sequence display extension: video_format 5 (unspecified), a
    colour description with matrix_coefficients ``matrix`` (primaries and
    transfer 2, unspecified) where given, the display size."""
    bits = "0010" + "101"
    bits += "1" + "00000010" * 2 + format(matrix, "08b") \
        if matrix is not None else "0"
    bits += format(width, "014b") + "1" + format(height, "014b")
    return _unit(EXT, bits)


def quant_matrix_extension(intra=None, inter=None, chroma_intra=None,
                           chroma_inter=None) -> bytes:
    """A quant matrix extension loading the matrices given."""
    bits = "0011"
    for m in (intra, inter, chroma_intra, chroma_inter):
        bits += "1" + _matrix(m) if m is not None else "0"
    return _unit(EXT, bits)


def copyright_extension() -> bytes:
    """A copyright extension (copyright_flag 1, identifier 7, numbers
    1, 2, 3)."""
    bits = "0100" + "1" + format(7, "08b") + "1" + "0" * 7 + "1" + \
        format(1, "020b") + "1" + format(2, "022b") + "1" + \
        format(3, "022b")
    return _unit(EXT, bits)


def picture_display_extension(dx: int = 16, dy: int = -8) -> bytes:
    """A picture display extension with one frame centre offset (a
    progressive frame without repeat_first_field)."""
    bits = "0111" + format(dx & 0xFFFF, "016b") + "1" + \
        format(dy & 0xFFFF, "016b") + "1"
    return _unit(EXT, bits)


def user_data(text: bytes) -> bytes:
    return b"\x00\x00\x01\xb2" + text


# macroblock_type codes (tables B-2 to B-4) of coded macroblocks, each
# with the code of the same type that carries a new quantiser
_QUANT_TYPES = {
    1: {"1": "01"},
    2: {"1": "00010", "01": "00001", "00011": "000001"},
    3: {"11": "00010", "011": "000010", "0011": "000011",
        "00011": "000001"}}
# every macroblock_type code, to read past one that takes no quantiser
_TYPES = {1: ("1", "01"),
          2: ("1", "01", "001", "00011", "00010", "00001", "000001"),
          3: ("10", "11", "010", "011", "0010", "0011", "00011", "00010",
              "000011", "000010", "000001")}
# table B-10 without the sign: motion_code 0-16
_MOTION = ("1", "01", "001", "0001", "000011", "0000101", "0000100",
           "0000011", "000001011", "000001010", "000001001", "0000010001",
           "0000010000", "0000001111", "0000001110", "0000001101",
           "0000001100")


def _prefix(bits: str, at: int, codes: Sequence[str]) -> Optional[str]:
    for c in codes:
        if bits.startswith(c, at):
            return c
    return None


def picture_type(packet: bytes) -> int:
    for u in units(packet):
        if code(u) == PICTURE:
            return int(_bits(u[4:6])[10:13], 2)
    return 0


def requantise(packet: bytes, qcode: int, extra: bool = False) -> bytes:
    """The packet with each slice's first macroblock, where it is coded,
    given the macroblock type that carries quantiser_scale_code ``qcode``
    (the slice's later macroblocks keep it); with ``extra``, each slice
    also carries one byte of extra slice information (intra_slice 1)."""
    ptype = picture_type(packet)
    out = []
    for u in units(packet):
        c = code(u)
        if not 0x01 <= c <= 0xAF:
            out.append(u)
            continue
        bits = _bits(u[4:])
        # quantiser_scale_code, extra_bit_slice 0, the first increment 1
        assert bits[5] == "0" and bits[6] == "1", "a slice of another form"
        head = bits[:5] + ("1" + "10000000" if extra else "") + "0"
        t = _prefix(bits, 7, sorted(_TYPES[ptype], key=len))
        assert t is not None
        new = _QUANT_TYPES[ptype].get(t)
        if new is None:
            new = t
        else:
            new += format(qcode, "05b")
        out.append(u[:4] + _unbits(head + "1" + new + bits[7 + len(t):]))
    return join(out)


def push_first_vector(packet: bytes, fcode: int) -> bytes:
    """A P picture's packet whose slices' first macroblocks, where they
    are forward predicted (type "1"), take a horizontal vector of -2
    half-pels (one pixel left of the picture at the row's start);
    ``fcode`` is the picture's horizontal f_code."""
    out = []
    for u in units(packet):
        if not 0x01 <= code(u) <= 0xAF:
            out.append(u)
            continue
        bits = _bits(u[4:])
        if bits[5:8] != "011":          # extra bit 0, increment 1, type 1
            out.append(u)
            continue
        at = 8
        m = _prefix(bits, at, _MOTION)
        end = at + len(m) + (0 if m == "1" else 1 + fcode - 1)
        # |vector| 2 at this f_code, negative
        r = fcode - 1
        mag = ((2 - 1) >> r) + 1
        new = _MOTION[mag] + "1" + (format((2 - 1) & ((1 << r) - 1),
                                           f"0{r}b") if r else "")
        out.append(u[:4] + _unbits(bits[:at] + new + bits[end:]))
    return join(out)


# macroblock_address_increment codes (table B-1) of 1-15
_INCREMENT = ("1", "011", "010", "0011", "0010", "00011", "00010",
              "0000111", "0000110", "00001011", "00001010", "00001001",
              "00001000", "00000111", "00000110")


def b_intra_slice(row: int, mb_w: int, qcode: int = 3) -> bytes:
    """A B picture's slice for macroblock row ``row`` of a picture
    ``mb_w`` macroblocks wide (3 to 16): an intra macroblock whose blocks
    hold only the DC predictor's 128 (a grey block), then an interpolated
    macroblock with both vectors 0 and no coded blocks, the ones after it
    skipped (they keep its vectors), and the row's last macroblock coded
    as the second."""
    assert 3 <= mb_w <= 16
    intra = "00011" + ("100" + "10") * 4 + ("00" + "10") * 2
    bidir = "10" + "1111"             # no coded blocks; motion codes 0
    bits = format(qcode, "05b") + "0" + "1" + intra + "1" + bidir + \
        _INCREMENT[mb_w - 3] + bidir
    return bytes((0, 0, 1, row + 1)) + _unbits(bits)
