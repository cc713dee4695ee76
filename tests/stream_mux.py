"""Hand muxers for the containers ``io/mpegps``, ``io/mpegts``,
``io/isobmff`` (fragments), ``io/ogg``, ``io/flv``, ``io/asf`` and
``io/nut`` read: each lays out given video packets in a form
``cv2.VideoWriter`` does not write (another pack or PES header form,
padding and foreign streams, adaptation-field stuffing and null packets,
fragments whose sample sizes come from their defaults, packets that span
pages, media objects in fragments, syncpoints and elided headers), so
that ``tests/test_torch_streams.py`` can hold the demuxers to
``cv2.VideoCapture`` on them, ``tests/make_torch_video.py demux`` can
commit some, and ``chip_smoke.py`` can time each demuxer on 640x480
frames.  Plain Python and numpy: no cv2, no JAX."""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence

from fealess_tpu_torch.io.crc import crc32


# ---- MPEG program stream ----

def _ts33(prefix: int, t: int) -> bytes:
    """A PTS or DTS field: the 4-bit prefix and 33 bits with markers."""
    v = (prefix << 36) | (((t >> 30) & 7) << 33) | (1 << 32) | \
        (((t >> 15) & 0x7FFF) << 17) | (1 << 16) | ((t & 0x7FFF) << 1) | 1
    return v.to_bytes(5, "big")


def pack_header(form: str, scr: int, stuffing: int = 0) -> bytes:
    """An MPEG-1 (``0010`` marker) or MPEG-2 (``01`` marker, with
    ``stuffing`` 0xFF bytes) pack header."""
    rate = 2520
    if form == "mpeg1":
        return b"\x00\x00\x01\xba" + _ts33(0b0010, scr) + \
            ((1 << 23) | (rate << 1) | 1).to_bytes(3, "big")
    v = (1 << 46) | (((scr >> 30) & 7) << 43) | (1 << 42) | \
        (((scr >> 15) & 0x7FFF) << 27) | (1 << 26) | \
        ((scr & 0x7FFF) << 11) | (1 << 10) | 1
    return b"\x00\x00\x01\xba" + v.to_bytes(6, "big") + \
        ((rate << 2) | 3).to_bytes(3, "big") + \
        bytes([0xF8 | stuffing]) + b"\xff" * stuffing


def system_header() -> bytes:
    body = bytes([0x80, 0x04, 0xED, 0x04, 0xE1, 0xFF, 0xE0, 0xE0, 0x2E])
    return b"\x00\x00\x01\xbb" + struct.pack(">H", len(body)) + body


def pes(stream_id: int, payload: bytes, form: str, pts: Optional[int] = None,
        dts: Optional[int] = None, stuffing: int = 0,
        std: bool = False) -> bytes:
    """A PES packet with a header of MPEG-1 (0xFF stuffing, the STD
    buffer, PTS / DTS or ``0x0F``) or MPEG-2 form (flags, header
    length)."""
    if form == "mpeg1":
        head = b"\xff" * stuffing
        if std:
            head += b"\x60\x2e"                  # '01', scale 1, size 46
        if pts is None:
            head += b"\x0f"
        elif dts is None:
            head += _ts33(0b0010, pts)
        else:
            head += _ts33(0b0011, pts) + _ts33(0b0001, dts)
    else:
        fields = b""
        flags = 0
        if pts is not None:
            flags = 0x80
            fields = _ts33(0b0010, pts)
            if dts is not None:
                flags = 0xC0
                fields = _ts33(0b0011, pts) + _ts33(0b0001, dts)
        fields += b"\xff" * stuffing
        head = bytes([0x80, flags, len(fields)]) + fields
    body = head + payload
    return b"\x00\x00\x01" + bytes([stream_id]) + \
        struct.pack(">H", len(body)) + body


def mux_ps(units: Sequence[bytes], pack: str = "mpeg2",
           form: str = "mpeg2", chunk: int = 1500, pack_every: int = 1,
           stuffing: int = 0, padding: bool = False, foreign: bool = False,
           end_code: bool = True) -> bytes:
    """A program stream of the video ``units`` (the whole payload, or its
    pictures: each cut on its own) cut into PES packets of ``chunk``
    bytes (so a picture's PES packets split across packs), a pack header
    before every ``pack_every``-th, a system header after the first;
    ``padding`` adds a padding packet after each PES packet, ``foreign``
    an audio PES packet and a private stream 2 packet, both of junk
    holding no start code."""
    out = bytearray()
    pieces = [u[at:at + chunk] for u in units
              for at in range(0, len(u), chunk)]
    for k, piece in enumerate(pieces):
        if k % pack_every == 0:
            out += pack_header(pack, 3600 * k, stuffing)
            if k == 0:
                out += system_header()
        out += pes(0xE0, piece, form,
                   pts=9000 + 3600 * k if k % 2 == 0 else None,
                   dts=5400 + 3600 * k if k % 4 == 0 else None,
                   stuffing=k % 3, std=form == "mpeg1" and k % 2 == 1)
        if foreign:
            out += pes(0xC0, bytes(range(7, 207)), form, pts=3600 * k)
            out += b"\x00\x00\x01\xbf" + struct.pack(">H", 40) + \
                bytes(range(1, 41))
        if padding:
            out += b"\x00\x00\x01\xbe" + struct.pack(">H", 30) + \
                b"\xff" * 30
    if end_code:
        out += b"\x00\x00\x01\xb9"
    return bytes(out)


# ---- MPEG transport stream ----

def _section(table_id: int, ext: int, body: bytes) -> bytes:
    """A PSI section with the syntax indicator, version 0, current, its
    CRC-32 (MPEG-2's, from 0xFFFFFFFF)."""
    n = 5 + len(body) + 4
    head = bytes([table_id, 0xB0 | (n >> 8), n & 0xFF]) + \
        struct.pack(">H", ext) + b"\xc1\x00\x00"
    sec = head + body
    return sec + struct.pack(">I", crc32(sec, 0xFFFFFFFF))


def _ts_packets(pid: int, data: bytes, start: bool, cc: List[int],
                pcr: Optional[int] = None, stuff_all: bool = False
                ) -> List[bytes]:
    """``data`` in 188-byte packets of ``pid``: the first with the unit
    start (and a PCR), the last filled by adaptation-field stuffing (or
    every one, with ``stuff_all``: 100 payload bytes a packet)."""
    out, at, first = [], 0, True
    while first or at < len(data):
        fields = b""
        if first and pcr is not None:
            fields = b"\x10" + ((pcr << 15) | (0x3F << 9)).to_bytes(6, "big")
        room = 184 - (1 + len(fields) if fields else 0)
        if stuff_all:
            room = min(room, 100)
        n = min(room, len(data) - at)
        if fields or n < 184:
            length = 183 - n
            body = fields or b"\x00"
            af = b"\x00" if length == 0 else \
                bytes([length]) + body + b"\xff" * (length - len(body))
            afc = 0x30
        else:
            af, afc = b"", 0x10
        head = bytes([0x47, (0x40 if first and start else 0) | (pid >> 8),
                      pid & 0xFF, afc | cc[0]])
        cc[0] = (cc[0] + 1) & 0x0F
        out.append(head + af + data[at:at + n])
        assert len(out[-1]) == 188
        at += n
        first = False
    return out


def mux_ts(frames: Sequence[bytes], stream_type: int, bdav: bool = False,
           null_every: int = 0, stuff_all: bool = False,
           pes_length: bool = False, pid: int = 0x100,
           pmt_pid: int = 0x1000, descriptors: bytes = b"") -> bytes:
    """A transport stream of one program: the PAT, its PMT (one stream of
    ``stream_type``), then each frame as a PES packet (MPEG-2 header with
    a PTS; ``PES_packet_length`` 0 unless ``pes_length``) over as many
    packets as it takes, a PCR on each first packet; ``null_every`` puts a
    null packet after every that many; ``bdav`` gives each packet BDAV's
    4-byte header and pads the stream with null packets to units of 32."""
    cc = {0: [0], pmt_pid: [0], pid: [0]}
    pat = _section(0x00, 1, struct.pack(">HH", 1, 0xE000 | pmt_pid))
    pmt_body = struct.pack(">HH", 0xE000 | pid, 0xF000) + \
        bytes([stream_type]) + struct.pack(">HH", 0xE000 | pid,
                                           0xF000 | len(descriptors)) + \
        descriptors
    pmt = _section(0x02, 1, pmt_body)
    pkts = _ts_packets(0, b"\x00" + pat, True, cc[0]) + \
        _ts_packets(pmt_pid, b"\x00" + pmt, True, cc[pmt_pid])
    for k, frame in enumerate(frames):
        head = bytes([0x80, 0x80, 5]) + _ts33(0b0010, 9000 + 3600 * k)
        length = len(head) + len(frame) if pes_length else 0
        unit = b"\x00\x00\x01\xe0" + struct.pack(">H", length) + head + frame
        pkts += _ts_packets(pid, unit, True, cc[pid], pcr=3600 * k,
                            stuff_all=stuff_all)
    if null_every:
        out = []
        for k, p in enumerate(pkts):
            out.append(p)
            if k % null_every == null_every - 1:
                out.append(b"\x47\x1f\xff\x10" + b"\xff" * 184)
        pkts = out
    if bdav:
        while len(pkts) % 32:
            pkts.append(b"\x47\x1f\xff\x10" + b"\xff" * 184)
        return b"".join(struct.pack(">I", (k * 1000) & 0x3FFFFFFF) + p
                        for k, p in enumerate(pkts))
    return b"".join(pkts)


# ---- fragmented MP4 ----

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def set_trex(head: bytes, duration: int, size: int) -> bytes:
    """``head`` (ftyp and moov) with its ``trex``'s default sample
    duration and size set."""
    at = head.index(b"trex") + 4 + 12
    return head[:at] + struct.pack(">II", duration, size) + head[at + 8:]


def mux_fmp4(head: bytes, samples: Sequence[bytes],
             fragments: Sequence[dict]) -> bytes:
    """``head`` (ftyp and a moov with mvex, track 1) followed by one moof
    and mdat a fragment: each ``fragments`` entry has ``"n"`` samples and
    ``"size"``: where the sizes come from (``"trun"``, ``"tfhd"``: one
    default size, ``"trex"``: the trex's), and ``"base"``: the base data
    offset (``"moof"``: default-base-is-moof, ``"explicit"``, ``"none"``:
    the moof's first byte for the first traf)."""
    out = bytearray(head)
    k = 0
    for seq, frag in enumerate(fragments):
        part = samples[k:k + frag["n"]]
        k += frag["n"]
        flags = 0x20 | (0x20000 if frag["base"] == "moof" else 0) | \
            (0x1 if frag["base"] == "explicit" else 0) | \
            (0x10 if frag["size"] == "tfhd" else 0)
        tfhd = struct.pack(">II", flags, 1)
        base_at = None
        if frag["base"] == "explicit":
            base_at = len(tfhd)
            tfhd += bytes(8)
        if frag["size"] == "tfhd":
            tfhd += struct.pack(">I", len(part[0]))
        tfhd += struct.pack(">I", 0x01010000)
        tflags = 0x1 | 0x100 | (0x200 if frag["size"] == "trun" else 0)
        trun = struct.pack(">II", tflags, len(part)) + bytes(4)
        for s in part:
            trun += struct.pack(">I", 1000)
            if frag["size"] == "trun":
                trun += struct.pack(">I", len(s))
        traf = _box(b"traf", _box(b"tfhd", tfhd) + _box(b"tfdt", bytes(
            4) + struct.pack(">I", 1000 * (k - len(part)))) + _box(
            b"trun", trun))
        moof = bytearray(_box(b"moof", _box(b"mfhd", struct.pack(
            ">II", 0, seq + 1)) + traf))
        moof_at = len(out)
        data_at = moof_at + len(moof) + 8
        trun_at = moof.index(b"trun") + 4 + 8
        base = moof_at
        if base_at is not None:
            base = 0
            at = moof.index(b"tfhd") + 4 + base_at
            moof[at:at + 8] = struct.pack(">Q", base)
        moof[trun_at:trun_at + 4] = struct.pack(">i", data_at - base)
        out += moof + _box(b"mdat", b"".join(part))
    return bytes(out)


# ---- Ogg ----

def ogg_page(serial: int, seq: int, flags: int, granule: int,
             lacing: bytes, body: bytes) -> bytes:
    head = b"OggS" + struct.pack("<BBqIIIB", 0, flags, granule, serial, seq,
                                 0, len(lacing)) + lacing
    crc = crc32(head + body)
    return head[:22] + struct.pack("<I", crc) + head[26:] + body


def mux_ogg(packets: Sequence[bytes], serial: int = 0x1234,
            max_segments: int = 255, per_page: int = 1,
            headers: int = 2) -> bytes:
    """An Ogg stream of ``packets`` (the first ``headers`` alone on their
    pages, the BOS page first), then ``per_page`` packets a page, a page
    holding at most ``max_segments`` lacing values (so a long packet
    continues on the next page, flagged continued)."""
    pages, seq = [], 0
    groups = [[p] for p in packets[:headers]] + \
        [list(packets[i:i + per_page])
         for i in range(headers, len(packets), per_page)]
    for g, group in enumerate(groups):
        lacing = bytearray()
        for p in group:
            lacing += b"\xff" * (len(p) // 255) + bytes([len(p) % 255])
        body = b"".join(group)
        cont, at, off = False, 0, 0
        while True:
            seg = bytes(lacing[at:at + max_segments])
            size = sum(seg)
            last = at + max_segments >= len(lacing)
            flags = (0x01 if cont else 0) | (0x02 if g == 0 and at == 0
                                             else 0)
            if last and g == len(groups) - 1:
                flags |= 0x04
            pages.append(ogg_page(serial, seq, flags, 1 << 33 if g else 0,
                                  seg, body[off:off + size]))
            seq += 1
            off += size
            at += max_segments
            cont = seg[-1] == 255
            if last:
                break
    return b"".join(pages)


# ---- FLV ----

def flv_tag(kind: int, ts: int, body: bytes) -> bytes:
    head = bytes([kind]) + len(body).to_bytes(3, "big") + \
        (ts & 0xFFFFFF).to_bytes(3, "big") + bytes([ts >> 24 & 0xFF]) + \
        bytes(3)
    return head + body + struct.pack(">I", 11 + len(body))


def flv_tags(data: bytes) -> List[tuple]:
    """(type, timestamp, body) of each tag of an FLV file."""
    out, at = [], int.from_bytes(data[5:9], "big") + 4
    while at + 11 <= len(data):
        size = int.from_bytes(data[at + 1:at + 4], "big")
        ts = int.from_bytes(data[at + 4:at + 7], "big") | data[at + 7] << 24
        out.append((data[at], ts, data[at + 11:at + 11 + size]))
        at += 11 + size + 4
    return out


def mux_flv(tags: Sequence[tuple]) -> bytes:
    return b"FLV\x01\x01" + struct.pack(">I", 9) + bytes(4) + \
        b"".join(flv_tag(*t) for t in tags)


# ---- ASF ----

def mux_asf(header: bytes, objects: Sequence[bytes], packet_size: int,
            multiple: bool = False, stream: int = 1) -> bytes:
    """The ASF file of ``header`` (a Header Object holding one video
    stream ``stream``; its packet size set to ``packet_size``) with the
    media ``objects`` in fixed-size packets: one payload a packet, or
    several (``multiple``: each object's fragments two at a time), each
    object in fragments over as many packets as it takes, each packet
    padded to the size."""
    fp = header.index(bytes.fromhex("a1dcab8c47a9cf118ee400c00c205365"))
    head = bytearray(header)
    struct.pack_into("<II", head, fp + 24 + 68, packet_size, packet_size)
    # property flags: replicated data by byte, offset by dword, object
    # number by byte, stream number by byte
    prop = 0x5D
    pkts = []
    todo = [(num, obj) for num, obj in enumerate(objects)]
    k, off = 0, 0
    while k < len(todo):
        num, obj = todo[k]
        body = bytearray()
        payloads = []
        room = packet_size - 3 - 1 - 1 - 2 - 6 - (1 if multiple else 0)
        while k < len(todo) and len(payloads) < (2 if multiple else 1):
            num, obj = todo[k]
            over = 1 + 1 + 4 + 1 + 8 + (2 if multiple else 0)
            n = min(len(obj) - off, room - over)
            if n <= 0:
                break
            payloads.append((num, off, obj, n))
            room -= over + n
            off += n
            if off == len(obj):
                k, off = k + 1, 0
        pad = room
        flags = 0x10 | (0x01 if multiple else 0)       # padding by word
        body += b"\x82\x00\x00" + bytes([flags, prop]) + \
            struct.pack("<H", pad) + struct.pack("<IH", 1000 * len(pkts),
                                                 100)
        if multiple:
            body += bytes([0x80 | len(payloads)])      # lengths by word
        for num, at, obj, n in payloads:
            body += bytes([0x80 * (at == 0) | stream, num & 0xFF])
            body += struct.pack("<I", at) + b"\x08" + \
                struct.pack("<II", len(obj), 1000 * num)
            if multiple:
                body += struct.pack("<H", n)
            body += obj[at:at + n]
        body += bytes(pad)
        assert len(body) == packet_size, (len(body), packet_size)
        pkts.append(bytes(body))
    data_guid = bytes.fromhex("3626b2758e66cf11a6d900aa0062ce6c")
    data = data_guid + struct.pack("<Q", 50 + packet_size * len(pkts)) + \
        bytes(16) + struct.pack("<QH", len(pkts), 0x0101)
    return bytes(head) + data + b"".join(pkts)


# ---- NUT ----

def _v(x: int) -> bytes:
    out = bytearray([x & 0x7F])
    x >>= 7
    while x:
        out.insert(0, 0x80 | (x & 0x7F))
        x >>= 7
    return bytes(out)


def _nut_packet(code: bytes, body: bytes) -> bytes:
    """A NUT packet: its start code, forward pointer (and header
    checksum past 4096), the body and its checksum."""
    size = len(body) + 4
    head = code + _v(size)
    if size > 4096:
        head += struct.pack(">I", crc32(head))
    return head + body + struct.pack(">I", crc32(body))


NUT_MAIN = b"NM" + (0x7A561F5F04AD).to_bytes(6, "big")
NUT_STREAM = b"NS" + (0x11405BF2F9DB).to_bytes(6, "big")
NUT_SYNC = b"NK" + (0xE4ADEECA4569).to_bytes(6, "big")
NUT_INFO = b"NI" + (0xAB68B596BA78).to_bytes(6, "big")


def mux_nut(frames: Sequence[bytes], fourcc: bytes, width: int, height: int,
            extradata: bytes = b"", sync_every: int = 1,
            elide: bytes = b"", info: bool = False,
            table: bool = True) -> bytes:
    """A NUT file (version 3) of one video stream: every frame through one
    coded frame code (its flags, stream id, coded pts, size and a frame
    checksum coded in the frame header), a syncpoint before every
    ``sync_every``-th frame; ``elide`` is an elision header, taken off the
    front of each frame that starts with it; ``info`` adds an info packet
    after each syncpoint; ``table`` False leaves the elision table out of
    the main header."""
    F_CODED, F_STREAM_ID, F_CODED_PTS, F_SIZE_MSB, F_CHECKSUM = \
        4096, 16, 8, 32, 64
    F_HEADER_IDX = 1024
    main = _v(3) + _v(1) + _v(65536) + _v(1) + _v(1) + _v(10)
    # one group of 255 codes: pts delta 0, size_mul 1, stream 0, size_lsb
    # 0 (and up), no reserved fields
    main += _v(F_CODED) + _v(6) + _v(0) + _v(1) + _v(0) + _v(0) + _v(0) + \
        _v(255)
    if table:
        main += _v(1) + _v(len(elide)) + elide if elide else _v(0)
    out = bytearray(b"nut/multimedia container\x00")
    out += _nut_packet(NUT_MAIN, main)
    stream = _v(0) + _v(0) + _v(4) + fourcc + _v(0) + _v(8) + _v(1 << 20) + \
        _v(0) + _v(0) + _v(len(extradata)) + extradata + _v(width) + \
        _v(height) + _v(1) + _v(1) + _v(0)
    out += _nut_packet(NUT_STREAM, stream)
    last_sync = 0
    for k, frame in enumerate(frames):
        if k % sync_every == 0:
            back = (len(out) - last_sync) // 16 if k else 0
            last_sync = len(out)
            out += _nut_packet(NUT_SYNC, _v(k) + _v(back))
            if info:
                out += _nut_packet(NUT_INFO, _v(0) + _v(0) + _v(0) + _v(0)
                                   + _v(0))
        flags = F_STREAM_ID | F_CODED_PTS | F_SIZE_MSB | F_CHECKSUM
        idx = 1 if elide and frame.startswith(elide) and \
            len(frame) <= 4096 else 0
        if idx:
            flags |= F_HEADER_IDX
        head = bytes([0]) + _v(flags ^ F_CODED) + _v(0) + \
            _v(k + (1 << 8)) + _v(len(frame))
        if idx:
            head += _v(idx)
        head += struct.pack(">I", zlib.crc32(frame))
        out += head + frame[len(elide) if idx else 0:]
    return bytes(out)
