"""Take the MS MPEG-4 v2 / v3, WMV7 and WMV8 tables from the libavcodec that
cv2 bundles, and write ``fealess_tpu_torch/csrc/msmpeg4_tables.h``.

    python -m tests.msmpeg4_tables          # rewrite the header
    python -m tests.msmpeg4_tables --check  # exit 1 unless it is current

Microsoft never published these tables; FFmpeg's ``msmpeg4data.c`` and
``msmpeg4_vc1_data.c`` hold them.  The library is stripped, so each table
is found in ``.rodata`` by its content (a prefix of its first entries, and
for the run/level tables the ``RLTable`` structs in ``.data`` whose
pointers the dynamic relocations give), then checked for its shape: every
VLC is a complete prefix code, every scan a permutation of 0..63.  The
decoder reads the committed header; nothing reads the library at run
time.  Needs cv2 (``opencv-python``, whose wheel carries the library).
"""

from __future__ import annotations

import glob
import os
import struct
import sys
from typing import Dict, List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "fealess_tpu_torch", "csrc", "msmpeg4_tables.h")
# the libavcodec version the header was taken from
LAVC_VERSION = "62.28.101"


def libavcodec() -> str:
    """The path of cv2's bundled libavcodec."""
    import cv2
    site = os.path.dirname(os.path.dirname(cv2.__file__))
    found = glob.glob(os.path.join(site, "opencv_python*.libs",
                                   f"libavcodec-*.so.{LAVC_VERSION}"))
    if len(found) != 1:
        raise FileNotFoundError(f"cv2's libavcodec {LAVC_VERSION}: "
                                f"{found or 'none'}")
    return found[0]


class Elf:
    """The sections and relative relocations of an ELF64 shared object."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.raw = f.read()
        shoff, = struct.unpack_from("<Q", self.raw, 0x28)
        shentsize, shnum, shstrndx = struct.unpack_from("<HHH", self.raw,
                                                        0x3A)
        heads = [struct.unpack_from("<IIQQQQIIQQ", self.raw,
                                    shoff + i * shentsize)
                 for i in range(shnum)]
        names = heads[shstrndx][4]
        self.sections = {}
        for h in heads:
            end = self.raw.index(b"\0", names + h[0])
            self.sections[self.raw[names + h[0]:end].decode()] = h
        self.relative = {}
        _, _, _, _, off, size, _, _, _, _ = self.sections[".rela.dyn"]
        for at in range(off, off + size, 24):
            where, info, addend = struct.unpack_from("<QQq", self.raw, at)
            if info & 0xFFFFFFFF == 8:            # R_X86_64_RELATIVE
                self.relative[where] = addend

    def section(self, name: str) -> Tuple[int, bytes]:
        """(address, contents) of a section."""
        h = self.sections[name]
        return h[3], self.raw[h[4]:h[4] + h[5]]


def _unique(data: bytes, head: bytes, what: str, align: int = 1) -> int:
    hits, at = [], data.find(head)
    while at >= 0:
        if at % align == 0:
            hits.append(at)
        at = data.find(head, at + 1)
    if len(hits) != 1:
        raise LookupError(f"{what}: {len(hits)} places in .rodata")
    return hits[0]


def _pairs(data: bytes, at: int, n: int, fmt: str) -> List[Tuple[int, int]]:
    size = struct.calcsize(fmt)
    return [struct.unpack_from("<" + fmt * 2, data, at + 2 * size * i)
            for i in range(n)]


def check_prefix_code(codes: Sequence[int], lens: Sequence[int],
                      what: str, complete: bool = True) -> None:
    """Raise unless the codes (each ``lens[i]`` bits) are a prefix code
    (no code a prefix of another) and, where ``complete``, a complete one
    (Kraft's sum exactly 1)."""
    words = sorted(format(c, f"0{n}b") for c, n in zip(codes, lens) if n)
    if any(n and (c >> n) for c, n in zip(codes, lens)):
        raise ValueError(f"{what}: a code longer than its length")
    if any(b.startswith(a) for a, b in zip(words, words[1:])):
        raise ValueError(f"{what}: a code is a prefix of another")
    top = max(lens)
    if complete and sum(1 << (top - n) for n in lens if n) != 1 << top:
        raise ValueError(f"{what}: not complete")


def codes_from_lengths(lens: Sequence[int]) -> List[int]:
    """ff_vlc_init_from_lengths' codes: each the next in a left-to-right
    walk of the tree, in the order of the lengths."""
    out, code = [], 0
    for n in lens:
        if code & ((1 << (32 - n)) - 1):
            raise ValueError("lengths out of order")
        out.append(code >> (32 - n))
        code += 1 << (32 - n)
    if code != 1 << 32:
        raise ValueError("lengths do not make a complete code")
    return out


def extract(path: str) -> Dict[str, object]:
    """Every table the decoder needs, by the names of the header."""
    elf = Elf(path)
    ro_addr, ro = elf.section(".rodata")
    t: Dict[str, object] = {}

    # ff_msmp4_mb_i_table: 64 (code, length) pairs of u16
    at = _unique(ro, struct.pack("<6H", 1, 1, 0x17, 6, 9, 5), "mb_i", 2)
    t["mb_i"] = _pairs(ro, at, 64, "H")
    # ff_table_mb_non_intra (ff_wmv2_inter_table[3]): 128 pairs of u32
    at = _unique(ro, struct.pack("<6I", 0x40, 7, 0x13C9, 13, 0x9FD, 12),
                 "mb_non_intra", 4)
    t["mb_non_intra"] = _pairs(ro, at, 128, "I")
    # ff_wmv2_inter_table: four pointers (relative relocations) to 128
    # pairs of u32, the last ff_table_mb_non_intra; [0..2] are WMV8's other
    # P picture MB tables (cbp_index and the qscale band pick one)
    arrays = [where for where, to in elf.relative.items()
              if to == ro_addr + at and all(where - 8 * k in elf.relative
                                            for k in (1, 2, 3))]
    if len(arrays) != 1:
        raise LookupError(f"ff_wmv2_inter_table: {len(arrays)} places")
    t["wmv2_inter"] = [_pairs(ro, elf.relative[arrays[0] - 8 * (3 - k)] -
                              ro_addr, 128, "I") for k in range(3)]
    # ff_msmp4_dc_tables[2][2][120]: dc table 0 luma, chroma, table 1 ...
    at = _unique(ro, struct.pack("<10I", 1, 1, 1, 2, 1, 4, 1, 5, 5, 5),
                 "dc", 4)
    t["dc"] = [_pairs(ro, at + 960 * k, 120, "I") for k in range(4)]
    # ff_wmv1_scantable[4][64]: four permutations of 0..63 back to back
    zz = bytes([0, 8, 1, 2, 9, 16, 24, 17])
    starts = [a for a in range(0, len(ro) - 256, 64) if ro[a:a + 8] == zz and
              all(sorted(ro[a + 64 * k:a + 64 * k + 64]) == list(range(64))
                  for k in range(4))]
    if len(starts) != 1:
        raise LookupError(f"wmv1 scan tables: {len(starts)} places")
    t["wmv1_scan"] = [list(ro[starts[0] + 64 * k:starts[0] + 64 * k + 64])
                      for k in range(4)]
    # the DC scale tables by qscale (32 bytes each), the inter-intra VLC
    # and v2's MB type and intra CBPC VLCs ((code, length) bytes)
    old_y = _unique(ro, bytes([0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19,
                               20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                               31, 32, 33]), "old y dc scale")
    t["old_y_dc_scale"] = list(ro[old_y:old_y + 32])
    at = _unique(ro, bytes([0, 8, 8, 8, 8, 8, 9, 9, 10, 10]),
                 "wmv1 y dc scale")
    t["wmv1_y_dc_scale"] = list(ro[at:at + 32])
    at = _unique(ro, bytes([0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13,
                            13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18, 19,
                            19]), "wmv1 c dc scale")
    t["wmv1_c_dc_scale"] = list(ro[at:at + 32])
    # the three small VLCs sit in the 32 bytes before the old y table and
    # the 32 after the WMV1 ones (msmpeg4data.c's order)
    t["inter_intra"] = _pairs(ro, old_y - 32, 4, "B")
    t["v2_intra_cbpc"] = _pairs(ro, old_y + 96, 4, "B")
    t["v2_mb_type"] = _pairs(ro, old_y + 112, 8, "B")
    # the MV tables: two of 1100 lengths (ff_vlc_init_from_lengths order)
    # then their u16 symbols (mx << 8 | my, 0 the escape), each array
    # 64-aligned, right after v2's MB types; the first in memory is the
    # one mv_table_index 1 picks (as decoding the writer's streams shows)
    mv, at = [], old_y + 128
    for _ in range(2):
        lens = list(ro[at:at + 1100])
        syms_at = (at + 1100 + 63) // 64 * 64
        syms = list(struct.unpack_from("<1100H", ro, syms_at))
        mv.append((lens, syms))
        at = (syms_at + 2200 + 31) // 32 * 32
    t["mv"] = mv[::-1]

    # ff_rl_table[6]: RLTable {int n, last; table_vlc, table_run,
    # table_level; ...} in .data, found by (n, last) of tables 0, 2 and 5
    d_addr, d = elf.section(".data")
    firsts = [a for a in range(0, len(d) - 8, 8)
              if struct.unpack_from("<ii", d, a) == (132, 85)]
    rls = None
    for a in firsts:
        for stride in range(64, 1024, 8):
            if a + 5 * stride + 8 <= len(d) and \
                    struct.unpack_from("<ii", d, a + 2 * stride) == \
                    (102, 67) and \
                    struct.unpack_from("<ii", d, a + 5 * stride) == (102, 58):
                rls = (a, stride)
    if rls is None:
        raise LookupError("ff_rl_table")
    t["rl"] = []
    for k in range(6):
        a = rls[0] + k * rls[1]
        n, last = struct.unpack_from("<ii", d, a)
        vlc, run, level = (elf.relative[d_addr + a + 8 + 8 * j] - ro_addr
                           for j in range(3))
        t["rl"].append({
            "n": n, "last": last, "vlc": _pairs(ro, vlc, n + 1, "H"),
            "run": list(struct.unpack_from(f"<{n}b", ro, run)),
            "level": list(struct.unpack_from(f"<{n}b", ro, level))})
    check(t)
    return t


def check(t: Dict[str, object]) -> None:
    """Raise unless every table has its shape."""
    for name in ("mb_i", "mb_non_intra", "inter_intra", "v2_intra_cbpc",
                 "v2_mb_type"):
        check_prefix_code(*zip(*t[name]), name)
    for k, table in enumerate(t["wmv2_inter"]):
        check_prefix_code(*zip(*table), f"wmv2 inter {k}")
    for k, dc in enumerate(t["dc"]):
        check_prefix_code(*zip(*dc), f"dc {k}")
    for k, rl in enumerate(t["rl"]):
        # 2 and 5 are MPEG-4's intra and H.263's inter TCOEF VLCs, which
        # leave codes unused
        check_prefix_code(*zip(*rl["vlc"]), f"rl {k}", k not in (2, 5))
    for k, (lens, syms) in enumerate(t["mv"]):
        check_prefix_code(codes_from_lengths(lens), lens, f"mv {k}")
        if sorted(syms).count(0) != 1 or len(set(syms)) != 1100 or \
                any((s >> 8) > 63 or (s & 0xFF) > 63 for s in syms):
            raise ValueError(f"mv {k}: symbols")
    for k, scan in enumerate(t["wmv1_scan"]):
        if sorted(scan) != list(range(64)):
            raise ValueError(f"wmv1 scan {k}")
    for name in ("old_y_dc_scale", "wmv1_y_dc_scale", "wmv1_c_dc_scale"):
        s = t[name]
        if s[0] != 0 or any(b < a for a, b in zip(s[1:], s[2:])):
            raise ValueError(name)


def _array(ctype: str, name: str, values: Sequence[int], per: int = 12,
           shape: Sequence[int] = ()) -> str:
    """A C array of ``values``, of ``shape`` (default: one dimension)."""
    shape = tuple(shape) or (len(values),)

    def rows(vals, indent):
        return f",\n{indent}".join(", ".join(str(v) for v in vals[i:i + per])
                                    for i in range(0, len(vals), per))

    def nest(vals, dims, indent):
        if len(dims) == 1:
            return "{" + rows(vals, indent + " ") + "}"
        step = len(vals) // dims[0]
        return "{" + f",\n{indent} ".join(
            nest(vals[i:i + step], dims[1:], indent + " ")
            for i in range(0, len(vals), step)) + "}"
    dims = "".join(f"[{n}]" for n in shape)
    return f"static const {ctype} {name}{dims} =\n    " + \
        nest(list(values), shape, "    ") + ";\n"


def header(t: Dict[str, object]) -> str:
    """The C header for ``t``."""
    out = [f"""/* The MS MPEG-4 v2 / v3, WMV7 and WMV8 tables of FFmpeg's
 * msmpeg4data.c and msmpeg4_vc1_data.c, as the libavcodec {LAVC_VERSION}
 * that cv2 5.0.0 bundles holds them.  Written by tests/msmpeg4_tables.py, which finds
 * them in that library; do not edit.
 *
 *   msmp4_mb_i            ff_msmp4_mb_i_table: I picture MB (coded block
 *                         pattern before prediction), code and length
 *   msmp4_mb_non_intra    ff_table_mb_non_intra (ff_wmv2_inter_table[3]):
 *                         P picture MB, bit 6 set for inter, bits 0-5 CBP
 *   wmv2_inter            ff_wmv2_inter_table[0..2]: WMV8's P picture MB
 *                         tables of the same form, code and length
 *   msmp4_dc              ff_msmp4_dc_tables[table][chroma]: DC level
 *                         magnitude 0-118, 119 the escape
 *   msmp4_mv_len / _sym   the two MV tables, in ff_vlc_init_from_lengths
 *                         order: symbol mx << 8 | my, 0 the escape
 *   msmp4_rl<k>_*         ff_rl_table[k]: code and length (index n the
 *                         escape), run, level, n and last; 0-2 intra
 *                         luma, 3-5 inter and intra chroma
 *   wmv1_scan             ff_wmv1_scantable: inter, intra, intra h, v
 *   *_dc_scale            the DC scales by qscale
 *   inter_intra, v2_*     the three small VLCs: code and length
 */
#ifndef FL_MSMPEG4_TABLES_H
#define FL_MSMPEG4_TABLES_H

#include <stdint.h>
"""]

    def codelen(name: str, pairs, ctype: str) -> None:
        out.append(_array(ctype, f"{name}_code", [c for c, _ in pairs]))
        out.append(_array("uint8_t", f"{name}_len", [n for _, n in pairs]))

    codelen("msmp4_mb_i", t["mb_i"], "uint16_t")
    codelen("msmp4_mb_non_intra", t["mb_non_intra"], "uint32_t")
    out.append(_array("uint32_t", "wmv2_inter_code",
                      [c for table in t["wmv2_inter"] for c, _ in table],
                      shape=(3, 128)))
    out.append(_array("uint8_t", "wmv2_inter_len",
                      [n for table in t["wmv2_inter"] for _, n in table],
                      shape=(3, 128)))
    out.append(_array("uint32_t", "msmp4_dc_code",
                      [c for dc in t["dc"] for c, _ in dc],
                      shape=(2, 2, 120)))
    out.append(_array("uint8_t", "msmp4_dc_len",
                      [n for dc in t["dc"] for _, n in dc],
                      shape=(2, 2, 120)))
    out.append(_array("uint8_t", "msmp4_mv_len",
                      [n for lens, _ in t["mv"] for n in lens],
                      shape=(2, 1100), per=20))
    out.append(_array("uint16_t", "msmp4_mv_sym",
                      [s for _, syms in t["mv"] for s in syms],
                      shape=(2, 1100)))
    for k, rl in enumerate(t["rl"]):
        out.append(f"#define MSMP4_RL{k}_N {rl['n']}\n"
                   f"#define MSMP4_RL{k}_LAST {rl['last']}\n")
        codelen(f"msmp4_rl{k}", rl["vlc"], "uint16_t")
        out.append(_array("int8_t", f"msmp4_rl{k}_run", rl["run"]))
        out.append(_array("int8_t", f"msmp4_rl{k}_level", rl["level"]))
    out.append(_array("uint8_t", "wmv1_scan", sum(t["wmv1_scan"], []),
                      shape=(4, 64), per=16))
    for name in ("old_y_dc_scale", "wmv1_y_dc_scale", "wmv1_c_dc_scale"):
        out.append(_array("uint8_t", name, t[name], per=16))
    for name in ("inter_intra", "v2_intra_cbpc", "v2_mb_type"):
        codelen(name, t[name], "uint8_t")
    out.append("\n#endif\n")
    return "\n".join(out)


def main(argv: Sequence[str]) -> int:
    text = header(extract(libavcodec()))
    if "--check" in argv:
        with open(HEADER) as f:
            return 0 if f.read() == text else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
