"""An MPEG transport stream demuxer (``.ts``, and ``.m2ts``: BDAV's
192-byte packets, a 4-byte header before each): the packets of its first
video stream as FFmpeg's ``mpegts`` demuxer and its video parser hand them
to the decoder under ``cv2.VideoCapture``.

- Packets: 188 bytes, or 192 with the sync byte at offset 4 (BDAV), or
  204 (a 16-byte trailer), by the sync bytes of the first two; a packet
  whose sync byte is lost is resynced at the next sync byte that the
  packet after it confirms; a last packet cut short is dropped.
  Adaptation fields (stuffing, the PCR) are skipped, as are null packets
  (PID 0x1FFF, BDAV's padding) and scrambled ones.
- The PAT (PID 0) and the PMT of its first program, sections put
  together across packets from the pointer field, each held to its
  CRC-32 (a section that fails is dropped, as FFmpeg drops it).  The
  first elementary stream of a video type is the stream: types 0x01 and
  0x02 are MPEG-2 video (:mod:`~fealess_tpu_torch.io.mpeg2` names
  MPEG-1's sequence header), 0x10 MPEG-4 Part 2; H.264, HEVC, VVC, JPEG
  2000, CAVS, AVS2, AVS3, Dirac and VC-1 (by type or by a registration
  descriptor) raise :class:`UnsupportedMpegTs`.  Private data (type
  0x06) of no registration descriptor has its payload probed as FFmpeg
  probes it (:func:`~fealess_tpu_torch.io.mpegvideo.payload_codec`): the
  writer's BDAV files carry MPEG-4 Part 2 so.  A PMT of no video stream
  FFmpeg decodes (what ``cv2.VideoWriter`` writes for Motion JPEG, FFV1,
  raw video, VP8, ... in ``.ts`` and ``.m2ts``: private data no probe
  takes) and a file with no valid PMT raise :class:`MpegTsError`, as cv2
  does not open them.
- PES packets of that stream: each starts at a packet whose
  payload_unit_start_indicator is set and runs to the next one; data
  before the first is skipped.  The MPEG-2 PES header (flags, header
  length) is skipped; a ``PES_packet_length`` of 0 (what video carries)
  leaves the PES open to the next start; a length reached at a packet's
  end closes it, and packets after it are skipped to the next start, as
  FFmpeg skips them.  The payloads, joined, are
  cut by :func:`~fealess_tpu_torch.io.mpegvideo.packets` (MPEG-2) or
  :func:`~fealess_tpu_torch.io.mpegvideo.mpeg4_packets` (MPEG-4 Part 2),
  as the program stream's are.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from fealess_tpu_torch.io.crc import crc32
from fealess_tpu_torch.io.mpegvideo import (mpeg4_packets, packets,
                                            payload_codec)

_NULL_PID = 0x1FFF
# FFmpeg's ISO_types for video, and HDMV's VC-1
STREAM_TYPES = {0x01: "mpeg2", 0x02: "mpeg2", 0x10: "mpeg4",
                0x1B: "H.264", 0x20: "H.264", 0x21: "JPEG 2000",
                0x24: "HEVC", 0x33: "VVC", 0x42: "CAVS", 0xD1: "Dirac",
                0xD2: "AVS2", 0xD4: "AVS3", 0xEA: "VC-1"}
# registration descriptors (tag 5) of video codecs FFmpeg maps
_REGISTERED = {b"drac": "Dirac", b"VC-1": "VC-1", b"HEVC": "HEVC",
               b"AV01": "AV1"}
# PES stream ids whose packets carry no MPEG-2 PES header
_BARE_IDS = (0xBC, 0xBE, 0xBF, 0xF0, 0xF1, 0xFF, 0xF2, 0xF8)


class MpegTsError(ValueError):
    """A transport stream cv2 does not open: the message says why."""


class UnsupportedMpegTs(ValueError):
    """A transport stream cv2 reads and the port does not: the message
    names what."""


def packet_layout(head: bytes) -> Optional[Tuple[int, int]]:
    """(packet size, offset of the first sync byte) by FFmpeg's probe,
    reduced to the sync bytes of the first two packets, or None."""
    for size, at in ((188, 0), (192, 4), (204, 0)):
        if head[at:at + 1] == b"\x47" and \
                head[at + size:at + size + 1] == b"\x47":
            return size, at
    return None


def _packets(data: bytes, size: int, at: int) -> Iterator[bytes]:
    """The 188-byte packets of ``data``, resynced where a sync byte is
    lost."""
    while at + 188 <= len(data):
        if data[at] != 0x47:
            k = at
            while True:
                k = data.find(b"\x47", k + 1)
                if k < 0 or k + 188 > len(data):
                    return
                if k + size >= len(data) or data[k + size] == 0x47:
                    break
            at = k
            continue
        yield data[at:at + 188]
        at += size


def _payload(pkt: bytes) -> Optional[bytes]:
    """The packet's payload past its adaptation field, or None."""
    afc = (pkt[3] >> 4) & 3
    if afc == 0 or not afc & 1 or pkt[3] & 0xC0:   # none, or scrambled
        return None
    at = 4
    if afc & 2:
        at += 1 + pkt[4]
    return pkt[at:] if at < 188 else None


class _Sections:
    """PSI sections of one PID put together across packets."""

    def __init__(self):
        self.buf: Optional[bytearray] = None

    def feed(self, payload: bytes, start: bool) -> List[bytes]:
        out: List[bytes] = []
        if start:
            ptr = payload[0]
            if self.buf is not None:
                self.buf += payload[1:1 + ptr]
                out += self._complete()
            self.buf = bytearray(payload[1 + ptr:])
        elif self.buf is not None:
            self.buf += payload
        out += self._complete()
        return out

    def _complete(self) -> List[bytes]:
        out = []
        while self.buf is not None and len(self.buf) >= 3:
            if self.buf[0] == 0xFF:                  # stuffing
                self.buf = None
                break
            n = 3 + (((self.buf[1] & 0x0F) << 8) | self.buf[2])
            if len(self.buf) < n:
                break
            section = bytes(self.buf[:n])
            self.buf = self.buf[n:]
            if n >= 12 and crc32(section, 0xFFFFFFFF) == 0:
                out.append(section)
        return out


def _pmt_streams(section: bytes) -> List[Tuple[int, Optional[str], int]]:
    """(PID, codec, stream type) of each elementary stream of the PMT
    section, in order: the codec by type or registration descriptor,
    ``"probe"`` for private data (type 0x06) that names none, whose
    payload FFmpeg probes, else None."""
    out = []
    end = len(section) - 4
    at = 12 + (((section[10] & 0x0F) << 8) | section[11])
    while at + 5 <= end:
        kind = section[at]
        pid = ((section[at + 1] & 0x1F) << 8) | section[at + 2]
        n = ((section[at + 3] & 0x0F) << 8) | section[at + 4]
        codec = STREAM_TYPES.get(kind)
        d = at + 5
        while codec is None and d + 2 <= min(at + 5 + n, end):
            tag, size = section[d], section[d + 1]
            if tag == 0x05:
                codec = _REGISTERED.get(section[d + 2:d + 6])
            d += 2 + size
        if codec is None and kind == 0x06:
            codec = "probe"
        out.append((pid, codec, kind))
        at += 5 + n
    return out


class MpegTsFile:
    """The first video stream of the transport stream at ``path``:
    :attr:`codec` (``"mpeg2"`` or ``"mpeg4"``), :attr:`bdav` and
    :meth:`frames`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        layout = packet_layout(data[:512])
        if layout is None:
            raise MpegTsError(f"{path}: no MPEG-TS packet sync")
        self.bdav = layout == (192, 4)
        self._pkts = list(_packets(data, *layout))
        self.pid, codec, kind = self._video_stream()
        if codec not in ("mpeg2", "mpeg4"):
            raise UnsupportedMpegTs(
                f"{path}: an MPEG transport stream with {codec} video "
                f"(stream type {kind:#04x})")
        self.codec = codec
        self.width = self.height = 0       # the decoder's, from the stream

    def _video_stream(self) -> Tuple[int, Optional[str], int]:
        """(PID, codec, stream type) of the first stream of the PMT that
        is video by its type or by FFmpeg's probe of its payload."""
        for pid, codec, kind in self._pmt():
            if codec == "probe":
                self.pid = pid
                codec = payload_codec(self.payload())
            if codec:
                return pid, codec, kind
        raise MpegTsError(f"{self.path}: the PMT holds no video stream "
                          f"FFmpeg decodes")

    def _pmt(self) -> List[Tuple[int, Optional[str], int]]:
        psi: Dict[int, _Sections] = {0: _Sections()}
        pmt_pid, program = -1, -1
        for pkt in self._pkts:
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            if pid not in psi:
                continue
            payload = _payload(pkt)
            if not payload:
                continue
            for sec in psi[pid].feed(payload, bool(pkt[1] & 0x40)):
                if pid == 0 and sec[0] == 0x00 and pmt_pid < 0:
                    for k in range(8, len(sec) - 4 - 3, 4):
                        number = int.from_bytes(sec[k:k + 2], "big")
                        if number:
                            program = number
                            pmt_pid = int.from_bytes(sec[k + 2:k + 4],
                                                     "big") & 0x1FFF
                            psi[pmt_pid] = _Sections()
                            break
                elif pid == pmt_pid and sec[0] == 0x02 and \
                        int.from_bytes(sec[3:5], "big") == program:
                    return _pmt_streams(sec)
        raise MpegTsError(f"{self.path}: no valid PAT and PMT")

    def payload(self) -> bytes:
        """The stream's PES payloads, joined."""
        parts: List[bytes] = []
        unit: Optional[bytearray] = None

        def close(unit: bytearray) -> None:
            if unit[:3] != b"\x00\x00\x01" or len(unit) < 6:
                return
            at = 6
            if unit[3] not in _BARE_IDS:
                if len(unit) < 9:
                    return
                at = 9 + unit[8]
            parts.append(bytes(unit[at:]))

        for pkt in self._pkts:
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            if pid != self.pid or pid == _NULL_PID:
                continue
            payload = _payload(pkt)
            if payload is None:
                continue
            if pkt[1] & 0x40:
                if unit is not None:
                    close(unit)
                unit = bytearray(payload)
            elif unit is not None:
                unit += payload
            else:
                continue
            length = int.from_bytes(unit[4:6], "big") if len(unit) >= 6 \
                else 0
            if length and len(unit) == 6 + length:   # closed at its length
                close(unit)
                unit = None
        if unit is not None:
            close(unit)
        return b"".join(parts)

    def frames(self) -> Iterator[bytes]:
        split = packets if self.codec == "mpeg2" else mpeg4_packets
        yield from split(self.payload())

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""
