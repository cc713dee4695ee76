"""Re-encode WMV8 pictures with other run/level tables and other CBP
tables, for the sources of ``tests/make_torch_video.py``'s ``wmv2`` group
and for ``tests/test_torch_wmv2.py``: the writer's wmv2 encoder always
writes run/level table index 0 and cbp_index 0, so no stream of its own
takes the decoder through tables 1 and 2 or through the CBP tables
cbp_index 1 and 2 pick.

:func:`walk` reads a picture into its header fields and each macroblock's
symbols with the decoder's own tables (``fealess_tpu_torch/csrc/
msmpeg4_tables.h``): the macroblock type, the AC prediction flag, the
vector and each block's DC as the bits they are, and each block's
coefficients as (run, level, last) events.  :func:`encode` writes the
picture again under other table indices: every event in the new table's
direct code, its first or second escape, or the third escape, whose field
lengths it sets at the picture's first one.  The coefficients, and so the
decoded picture, stay the same.  Bits are strings of '0' and '1'; the
result is padded with zero bits to a byte.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from tests.msmpeg4_tables import HEADER, codes_from_lengths

# wmv2_get_cbp_table_index: the CBP table of [qscale band][cbp_index]
CBP_MAP = ((0, 2, 1), (1, 0, 2), (2, 1, 0))
DC_ESCAPE = 119


def _arrays() -> Dict[str, List[int]]:
    """Every array of the tables header, flattened, and its defines."""
    with open(HEADER) as f:
        text = f.read()
    out: Dict[str, List[int]] = {}
    for m in re.finditer(r"static const \w+ (\w+)(?:\[\d+\])+ =([^;]*);",
                         text):
        out[m.group(1)] = [int(v) for v in re.findall(r"-?\d+",
                                                       m.group(2))]
    for m in re.finditer(r"#define (MSMP4_RL\d_\w+) (\d+)", text):
        out[m.group(1)] = [int(m.group(2))]
    return out


_A = _arrays()


def _vlc(codes: Sequence[int], lens: Sequence[int]) -> Dict[str, int]:
    return {format(c, f"0{n}b"): s
            for s, (c, n) in enumerate(zip(codes, lens)) if n}


class _Rl:
    """ff_rl_table[k]: its VLC, the codes by (last, run, level), and
    ff_rl_init's largest level of each run and run of each level."""

    def __init__(self, k: int):
        self.n = _A[f"MSMP4_RL{k}_N"][0]
        self.last = _A[f"MSMP4_RL{k}_LAST"][0]
        codes, lens = _A[f"msmp4_rl{k}_code"], _A[f"msmp4_rl{k}_len"]
        self.vlc = _vlc(codes, lens)
        self.run, self.level = _A[f"msmp4_rl{k}_run"], _A[f"msmp4_rl{k}_level"]
        self.bits = [format(c, f"0{n}b") for c, n in zip(codes, lens)]
        self.code = {(int(i >= self.last), self.run[i], self.level[i]):
                     self.bits[i] for i in range(self.n)}
        self.max_level = [dict(), dict()]
        self.max_run = [dict(), dict()]
        for i in range(self.n):
            last, r, lv = int(i >= self.last), self.run[i], self.level[i]
            self.max_level[last][r] = max(self.max_level[last].get(r, 0), lv)
            self.max_run[last][lv] = max(self.max_run[last].get(lv, 0), r)


RL = [_Rl(k) for k in range(6)]
MB_I = _vlc(_A["msmp4_mb_i_code"], _A["msmp4_mb_i_len"])
INTER = [_vlc(_A["wmv2_inter_code"][128 * k:128 * k + 128],
              _A["wmv2_inter_len"][128 * k:128 * k + 128]) for k in range(3)]
INTER_CODE = [{s: c for c, s in t.items()} for t in INTER]
DC = [_vlc(_A["msmp4_dc_code"][240 + 120 * c:360 + 120 * c],
           _A["msmp4_dc_len"][240 + 120 * c:360 + 120 * c]) for c in (0, 1)]
_MV_LENS = _A["msmp4_mv_len"][1100:]
MV = {format(c, f"0{n}b"): s for c, n, s in zip(
    codes_from_lengths(_MV_LENS), _MV_LENS, _A["msmp4_mv_sym"][1100:])}


def _bits(data: bytes) -> str:
    return "".join(format(b, "08b") for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


class _Reader:
    def __init__(self, bits: str):
        self.bits, self.pos = bits, 0

    def get(self, n: int) -> str:
        out = self.bits[self.pos:self.pos + n].ljust(n, "0")
        self.pos += n
        return out

    def vlc(self, table: Dict[str, int]) -> Tuple[int, str]:
        for n in range(1, 33):
            code = self.bits[self.pos:self.pos + n]
            if code in table:
                self.pos += n
                return table[code], code
        raise ValueError(f"no code at bit {self.pos}")

    def decode012(self) -> int:
        return 0 if self.get(1) == "0" else 1 + int(self.get(1))


def _code012(v: int) -> str:
    return ("0", "10", "11")[v]


def _events(r: _Reader, rl: _Rl, q: int, state: dict) -> list:
    """A block's coefficients as (run, level, last) events: run the zeros
    before the coefficient, level its quantised signed value."""
    out = []
    while True:
        s, _ = r.vlc(rl.vlc)
        if s == rl.n:
            if r.get(1) == "1":                      # first escape
                t, _ = r.vlc(rl.vlc)
                last = int(t >= rl.last)
                run = rl.run[t]
                level = rl.level[t] + rl.max_level[last][run]
            elif r.get(1) == "1":                    # second escape
                t, _ = r.vlc(rl.vlc)
                last = int(t >= rl.last)
                level = rl.level[t]
                run = rl.run[t] + rl.max_run[last][level] + 1
            else:                                    # third escape
                last = int(r.get(1))
                if not state.get("esc3"):
                    if q < 8:
                        ll = int(r.get(3), 2) or 8 + int(r.get(1))
                    else:
                        ll = 2
                        while ll < 8 and r.get(1) == "0":
                            ll += 1
                    state["esc3"] = (int(r.get(2), 2) + 3, ll)
                run_len, level_len = state["esc3"]
                run = int(r.get(run_len), 2)
                sign = r.get(1) == "1"
                level = int(r.get(level_len), 2)
                out.append((run, -level if sign else level, last))
                if last:
                    return out
                continue
        else:
            last, run, level = int(s >= rl.last), rl.run[s], rl.level[s]
        out.append((run, -level if r.get(1) == "1" else level, last))
        if last:
            return out


def walk(packet: bytes, mb_w: int, mb_h: int) -> dict:
    """The header fields and the macroblocks' symbols of a picture of
    ``mb_w`` x ``mb_h`` macroblocks that the writer wrote (its extension
    header's tools present and off, one slice)."""
    r = _Reader(_bits(packet))
    pic = {"p": r.get(1) == "1"}
    if not pic["p"]:
        pic["code7"] = r.get(7)
    q = pic["q"] = int(r.get(5), 2)
    if pic["p"]:
        assert r.get(2) == "00", "skip type"
        pic["cbp_index"] = r.decode012()
        assert r.get(4) == "0100", "mspel, ABT type 0, per-MB run/level"
        pic["rl"] = pic["rl_chroma"] = r.decode012()
    else:
        assert r.get(2) == "00", "j_type, per-MB run/level"
        pic["rl_chroma"] = r.decode012()
        pic["rl"] = r.decode012()
    pic["tables"] = r.get(2 if pic["p"] else 1)     # DC (and MV) table 1
    band = (q > 10) + (q > 20)
    inter = INTER[CBP_MAP[band][pic["cbp_index"]]] if pic["p"] else None
    coded = {}
    state: dict = {}
    mbs = []
    for y in range(mb_h):
        for x in range(mb_w):
            mb = {}
            if pic["p"]:
                sym, _ = r.vlc(inter)
                mb["type"] = sym
                intra, cbp = not sym & 0x40, sym & 0x3F
            else:
                sym, code = r.vlc(MB_I)
                mb["type_bits"] = code
                intra, cbp = True, 0
                for n in range(6):
                    val = (sym >> (5 - n)) & 1
                    if n < 4:
                        bx, by = 2 * x + (n & 1), 2 * y + (n >> 1)
                        a = coded.get((bx - 1, by), 0)
                        b = coded.get((bx - 1, by - 1), 0)
                        c = coded.get((bx, by - 1), 0)
                        val ^= a if b == c else c
                        coded[bx, by] = val
                    cbp |= val << (5 - n)
            mb["intra"] = intra
            if intra:
                mb["ac_pred"] = r.get(1)
            else:
                start = r.pos
                if r.vlc(MV)[0] == 0:                # the escape: 6 + 6
                    r.get(12)
                mb["mv"] = r.bits[start:r.pos]
            blocks = []
            for n in range(6):
                blk = {}
                if intra:
                    start = r.pos
                    s, _ = r.vlc(DC[n >= 4])
                    if s == DC_ESCAPE:
                        r.get(9)
                    elif s:
                        r.get(1)
                    blk["dc"] = r.bits[start:r.pos]
                if (cbp >> (5 - n)) & 1:
                    k = (pic["rl"] if n < 4 else 3 + pic["rl_chroma"]) \
                        if intra else 3 + pic["rl"]
                    blk["events"] = _events(r, RL[k], q, state)
                blocks.append(blk)
            mb["blocks"] = blocks
            mbs.append(mb)
    pic["mbs"] = mbs
    return pic


def _event_bits(rl: _Rl, run: int, level: int, last: int, q: int,
                state: dict) -> str:
    """One event in table ``rl``: its direct code, else the first escape,
    the second, or the third (its lengths written at the picture's
    first, set to their largest)."""
    a, sign = abs(level), "1" if level < 0 else "0"
    esc = rl.bits[rl.n]
    if (last, run, a) in rl.code:
        return rl.code[last, run, a] + sign
    lv = a - rl.max_level[last].get(run, 0)
    if lv > 0 and (last, run, lv) in rl.code:
        return esc + "1" + rl.code[last, run, lv] + sign
    rn = run - rl.max_run[last].get(a, 0) - 1
    if rn >= 0 and (last, rn, a) in rl.code:
        return esc + "01" + rl.code[last, rn, a] + sign
    out = esc + "00" + str(last)
    if not state.get("esc3"):
        state["esc3"] = True
        out += ("0001" if q < 8 else "000000") + "11"   # 9 (8) and 6 bits
    level_len = 9 if q < 8 else 8
    assert run < 64 and a < 1 << level_len, (run, a)
    return out + format(run, "06b") + sign + format(a, f"0{level_len}b")


def encode(pic: dict, rl: int, rl_chroma: int, cbp_index: int) -> bytes:
    """The walked picture ``pic`` written with run/level table indices
    ``rl`` and ``rl_chroma`` (a P picture takes ``rl`` for both) and, in a
    P picture, ``cbp_index``."""
    q = pic["q"]
    out = ["1" if pic["p"] else "0"]
    if not pic["p"]:
        out.append(pic["code7"])
    out.append(format(q, "05b"))
    if pic["p"]:
        rl_chroma = rl
        out += ["00", _code012(cbp_index), "0100", _code012(rl)]
        table = INTER_CODE[CBP_MAP[(q > 10) + (q > 20)][cbp_index]]
    else:
        out += ["00", _code012(rl_chroma), _code012(rl)]
    out.append(pic["tables"])
    state: dict = {}
    for mb in pic["mbs"]:
        out.append(table[mb["type"]] if pic["p"] else mb["type_bits"])
        out.append(mb["ac_pred"] if mb["intra"] else mb["mv"])
        for n, blk in enumerate(mb["blocks"]):
            out.append(blk.get("dc", ""))
            if "events" in blk:
                k = (rl if n < 4 else 3 + rl_chroma) if mb["intra"] \
                    else 3 + rl
                out += [_event_bits(RL[k], *e, q, state)
                        for e in blk["events"]]
    return _bytes("".join(out))


def retable(packets: Sequence[bytes], width: int, height: int, rl: int,
            rl_chroma: int, cbp_index: int) -> List[bytes]:
    """Every picture of a stream re-encoded by :func:`encode`."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    return [encode(walk(p, mb_w, mb_h), rl, rl_chroma, cbp_index)
            for p in packets]
