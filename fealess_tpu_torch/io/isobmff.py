"""An ISO base media (MP4 / QuickTime) demuxer: the samples of a file's
first video track, as FFmpeg's ``mov`` demuxer hands them to the decoder
under ``cv2.VideoCapture``.

- Boxes: a box's 32-bit size, or 64-bit (``size`` 1), or to the end of
  the file (``size`` 0).  ``moov`` may come before or after ``mdat``.
  ``moov/trak/mdia/hdlr`` names the track's kind (``vide``);
  ``mdia/minf/stbl`` holds its sample tables.
- ``stsd``: one sample entry (a VisualSampleEntry: width and height at
  bytes 24-28 of its body, child boxes from byte 78).  Its format picks
  the codec as FFmpeg's ``ff_codec_movvideo_tags`` and, for ``mp4v``, the
  ``esds`` object type (``ff_mp4_obj_type``) do: ``FFV1`` (extradata from
  its ``glbl`` box), ``mp4v`` with object type 0x6C (JPEG) or 0x6D (PNG),
  which ``cv2.VideoWriter`` writes for Motion JPEG and PNG, 0x20
  (MPEG-4 Part 2) or 0x60-0x65 (MPEG-2, 0x61 what the writer writes), each
  with its DecoderSpecificInfo as extradata, ``jpeg``, ``png ``, and
  MOV's ``m2v1`` and its HDV, XDCAM and IMX entries (``xd5b``, ``mp2v``,
  ...: MPEG-2, extradata from ``glbl``), ``DIVX``, ``XVID``, ``3IV2``
  (MPEG-4 Part 2), ``h263``, ``s263`` (3GP's), ``H263`` (H.263),
  ``FLV1`` (Sorenson Spark) and ``3IVD`` (MS MPEG-4 v3).  A format FFmpeg's table lacks is named by its
  fourcc (:attr:`Mp4Track.codec` ``"fourcc ..."``): FFmpeg then looks it
  up among the AVI fourccs (``HFYU`` in MOV, say).  A ``raw `` entry of
  depth 12 (what ``cv2.VideoWriter`` writes for I420 in MOV) names no
  pixel format FFmpeg's raw decoder knows, so the decoder does not open
  (:class:`Mp4Error`, as cv2 does not open the file).
- ``ctts``: each sample's composition offset (signed), zero without it.
- Samples: ``stsz`` (one size or a size a sample), ``stco`` / ``co64``
  (chunk offsets), ``stsc`` (samples a chunk, by runs of chunks).
- Edit lists (``edts/elst``): empty edits, and one edit from the
  smallest composition time (``stts`` plus ``ctts``) that ends past the
  largest, change no frame and are read: ``cv2.VideoWriter`` writes one
  from media time 0, or with B pictures from the one-frame delay its
  ``ctts`` gives them, and FFmpeg's mov demuxer drops no frame there; an
  edit that starts at another time or ends earlier (FFmpeg drops the
  frames outside it), or several, raise :class:`UnsupportedMp4`, as does a
  track of several sample descriptions.
- Fragments (``.ismv``, or any file whose ``moov`` holds ``mvex``): the
  samples of each ``moof``'s ``traf`` of the track follow the sample
  table's, in file order, as FFmpeg's mov demuxer reads them.  ``trex``
  gives the track's default sample size and duration; ``tfhd`` its base
  data offset (else the ``moof``'s first byte where default-base-is-moof
  is set, else where the track's data last ended, as FFmpeg takes it) and
  its own defaults; ``tfdt`` the decode time; each ``trun`` its data
  offset from that base and, by its flags, each sample's duration, size,
  flags and composition offset.  ``uuid`` (Smooth Streaming's ``tfxd``),
  ``mfra`` and ``sidx`` are skipped.  The composition offsets are held
  to the edit list as the sample table's are.

A file whose ``moov`` is missing or cut, or whose tables run past their
boxes, raises :class:`Mp4Error`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

# the first box types of an ISO base media file FFmpeg's mov probe takes
_TOP = (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip", b"pnot",
        b"udta", b"uuid", b"junk", b"styp", b"sidx")

# ff_mp4_obj_type (libavformat/isom.c): 0x20 (MPEG-4 Part 2) and 0x60-0x65
# (MPEG-2) are read, their DecoderSpecificInfo the extradata; the others
# are named when refused
OBJECT_TYPES = {0x20: "mpeg4", 0x21: "H.264", 0x23: "HEVC",
                0x60: "mpeg2", 0x61: "mpeg2", 0x62: "mpeg2",
                0x63: "mpeg2", 0x64: "mpeg2", 0x65: "mpeg2",
                0x6A: "MPEG-1", 0x6C: "mjpeg", 0x6D: "png", 0x6E: "JPEG 2000",
                0xA3: "VC-1", 0xA4: "Dirac", 0xB1: "VP9", 0xC0: "VP8"}

# sample entry formats FFmpeg maps to a decoder the port has, or names
FORMATS = {b"FFV1": "ffv1", b"jpeg": "mjpeg", b"png ": "png",
           b"mjpa": "mjpeg", b"avc1": "H.264", b"avc3": "H.264",
           b"hvc1": "HEVC", b"hev1": "HEVC", b"vp08": "VP8",
           b"vp09": "vp9", b"av01": "AV1", b"mp4v": "MPEG-4 Part 2",
           b"DIVX": "mpeg4", b"XVID": "mpeg4", b"3IV2": "mpeg4",
           b"s263": "h263", b"h263": "h263", b"H263": "h263",
           b"FLV1": "flv1",
           b"3IVD": "msmpeg4v3", b"raw ": "raw RGB", b"2vuy": "raw UYVY",
           b"apch": "ProRes", b"apcn": "ProRes", b"apcs": "ProRes",
           b"apco": "ProRes", b"ap4h": "ProRes", b"mjpb": "Motion JPEG B",
           b"SVQ3": "Sorenson Video 3", b"rle ": "QuickTime Animation",
           b"m2v1": "mpeg2", b"m1v ": "MPEG-1", b"m1v1": "MPEG-1",
           b"mpeg": "MPEG-1", b"mp1v": "MPEG-1"}
# ff_codec_movvideo_tags' other MPEG-2 entries (HDV, XDCAM, IMX): FFmpeg
# decodes them with mpeg2video, and so does the port (io/mpeg2 names what
# of them it does not decode: field pictures, 4:2:2, ...)
FORMATS.update({tag.encode(): "mpeg2" for tag in (
    "hdv1 hdv2 hdv3 hdv4 hdv5 hdv6 hdv7 hdv8 hdv9 hdva mx5n mx5p mx4n mx4p "
    "mx3n mx3p xd51 xd54 xd55 xd59 xd5a xd5b xd5c xd5d xd5e xd5f xdv1 xdv2 "
    "xdv3 xdv4 xdv5 xdv6 xdv7 xdv8 xdv9 xdva xdvb xdvc xdvd xdve xdvf xdhd "
    "xdh2 AVmp mp2v").split()})


class Mp4Error(ValueError):
    """An ISO base media file the demuxer cannot read: the message says
    why (cv2 opens no such file)."""


class UnsupportedMp4(ValueError):
    """An ISO base media file cv2 reads and the port does not: the
    message names what."""


def is_isobmff(head: bytes) -> bool:
    """FFmpeg's mov probe, reduced to a first box of a known type."""
    return len(head) >= 8 and head[4:8] in _TOP


@dataclass
class Mp4Track:
    codec: str      # "ffv1", "mjpeg", "png", "mpeg4", "mpeg2", "vp9",
    #                 "h263", "flv1", "msmpeg4v3", or a name refused
    fourcc: bytes           # the sample entry's format
    width: int
    height: int
    extradata: bytes


def _u32(b: bytes, at: int = 0) -> int:
    return struct.unpack_from(">I", b, at)[0]


def _descriptor(data: bytes, at: int) -> Tuple[int, int, int]:
    """(tag, body offset, body length) of the MPEG-4 descriptor at
    ``at`` (its length in up to four 7-bit bytes)."""
    tag, at, n = data[at], at + 1, 0
    for _ in range(4):
        b = data[at]
        at += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, at, n


def esds_config(body: bytes) -> Tuple[Optional[int], bytes]:
    """The DecoderConfigDescriptor's objectTypeIndication of an ``esds``
    box's body (past its version and flags), or None, and its
    DecoderSpecificInfo (FFmpeg's extradata), or b""."""
    try:
        tag, at, _ = _descriptor(body, 4)
        if tag == 0x03:                       # ES_Descriptor
            flags = body[at + 2]
            at += 3
            if flags & 0x80:
                at += 2
            if flags & 0x40:
                at += 1 + body[at]
            if flags & 0x20:
                at += 2
            tag, at, _ = _descriptor(body, at)
        if tag != 0x04:                       # DecoderConfigDescriptor
            return None, b""
        ot, info = body[at], b""
        if at + 13 < len(body):
            tag, dat, size = _descriptor(body, at + 13)
            if tag == 0x05:                   # DecoderSpecificInfo
                info = bytes(body[dat:dat + size])
        return ot, info
    except IndexError:
        return None, b""


class Mp4File:
    """The first video track of the ISO base media file at ``path``:
    :attr:`track` and :meth:`frames`.  Close it (or use it as a context
    manager)."""

    def __init__(self, path: str):
        self.path = path
        self._f: BinaryIO = open(path, "rb")
        try:
            self._size = self._f.seek(0, 2)
            moov, moofs = None, []
            for kind, at, size in self._boxes(0, self._size):
                if kind == b"moov" and moov is None:
                    moov = self._read(at, size)
                elif kind == b"moof":
                    moofs.append((at - 8, self._read(at, size)))
            if moov is None:
                raise Mp4Error(f"{path}: no moov box")
            try:
                self.track, self._samples = self._video_track(moov, moofs)
            except struct.error as e:          # a table past its box
                raise Mp4Error(f"{path}: a sample table is cut ({e})") \
                    from None
        except BaseException:
            self._f.close()
            raise

    def _read(self, at: int, n: int) -> bytes:
        self._f.seek(at)
        return self._f.read(n)

    def _boxes(self, start: int, end: int) -> Iterator[Tuple[bytes, int,
                                                              int]]:
        """(type, body offset, body size) of each box of the file in
        [start, end)."""
        at = start
        while at + 8 <= end:
            head = self._read(at, 16)
            size, kind = struct.unpack_from(">I4s", head)
            body = at + 8
            if size == 1:
                if len(head) < 16:
                    return
                size = struct.unpack_from(">Q", head, 8)[0]
                body = at + 16
            elif size == 0:
                size = end - at
            if size < body - at:
                raise Mp4Error(f"{self.path}: box {kind!r} of size {size}")
            yield kind, body, min(at + size, end) - body
            at += size

    # ---- boxes held in memory (moov) ----

    @staticmethod
    def _children(data: bytes, start: int = 0,
                  end: Optional[int] = None) -> Dict[bytes, List[bytes]]:
        end = len(data) if end is None else end
        out: Dict[bytes, List[bytes]] = {}
        at = start
        while at + 8 <= end:
            size, kind = struct.unpack_from(">I4s", data, at)
            head = 8
            if size == 1:
                size = struct.unpack_from(">Q", data, at + 8)[0]
                head = 16
            elif size == 0:
                size = end - at
            if size < head or at + size > end:
                break
            out.setdefault(kind, []).append(data[at + head:at + size])
            at += size
        return out

    def _one(self, boxes: Dict[bytes, List[bytes]], *kinds: bytes) -> bytes:
        for kind in kinds:
            if kind in boxes:
                return boxes[kind][0]
        raise Mp4Error(f"{self.path}: the video track has no "
                       f"{'/'.join(k.decode() for k in kinds)} box")

    def _video_track(self, moov: bytes, moofs):
        movie_scale = 0
        trex = {}
        for mvex in self._children(moov).get(b"mvex", []):
            for t in self._children(mvex).get(b"trex", []):
                if len(t) >= 24:
                    trex[_u32(t, 4)] = struct.unpack_from(">III", t, 8)
        mvhd = self._children(moov).get(b"mvhd")
        if mvhd:
            m = mvhd[0]
            movie_scale = _u32(m, 20 if m[0] == 1 else 12)
        for trak in self._children(moov).get(b"trak", []):
            tb = self._children(trak)
            mdia = self._children(tb.get(b"mdia", [b""])[0])
            hdlr = mdia.get(b"hdlr", [b""])[0]
            if hdlr[8:12] != b"vide":
                continue
            minf = self._children(self._one(mdia, b"minf"))
            stbl = self._children(self._one(minf, b"stbl"))
            track = self._sample_entry(self._one(stbl, b"stsd"))
            samples = self._sample_table(stbl)
            times = self._sample_times(stbl)
            tkhd = self._one(tb, b"tkhd")
            track_id = _u32(tkhd, 20 if tkhd[0] == 1 else 12)
            for at, moof in moofs:
                self._fragment(moof, at, track_id,
                               trex.get(track_id, (1, 0, 0)), samples, times)
            mdhd = self._one(mdia, b"mdhd")
            scale = _u32(mdhd, 20 if mdhd[0] == 1 else 12)
            if b"edts" in tb and times:
                cts = [d + o for d, o in times]
                self._check_edits(tb[b"edts"][0], movie_scale, scale,
                                  (min(cts), max(cts)))
            return track, samples
        raise Mp4Error(f"{self.path}: the file has no video track")

    def _sample_entry(self, stsd: bytes) -> Mp4Track:
        if len(stsd) < 16:
            raise Mp4Error(f"{self.path}: stsd is cut")
        if _u32(stsd, 4) != 1:
            raise UnsupportedMp4(f"{self.path}: MP4 track with "
                                 f"{_u32(stsd, 4)} sample descriptions")
        size, fmt = struct.unpack_from(">I4s", stsd, 8)
        entry = stsd[16:8 + size]
        if len(entry) < 78:
            raise Mp4Error(f"{self.path}: sample entry {fmt!r} is cut")
        width, height = struct.unpack_from(">HH", entry, 24)
        kids = self._children(entry, 78)
        codec = FORMATS.get(fmt, f"fourcc {fmt!r}")
        extradata = kids[b"glbl"][0] if b"glbl" in kids else b""
        if fmt == b"raw " and struct.unpack_from(">h", entry, 74)[0] == 12:
            raise Mp4Error(f"{self.path}: raw video of depth 12 (no pixel "
                           f"format FFmpeg's raw decoder opens)")
        if fmt == b"mp4v" and b"esds" in kids:
            ot, info = esds_config(kids[b"esds"][0])
            codec = OBJECT_TYPES.get(ot, f"MPEG-4 object type {ot!r}")
            if codec in ("mpeg4", "mpeg2"):
                extradata = info
        return Mp4Track(codec=codec, fourcc=fmt, width=width, height=height,
                        extradata=extradata)

    def _sample_table(self, stbl) -> List[Tuple[int, int]]:
        """(offset, size) of each sample, in order."""
        stsz = self._one(stbl, b"stsz")
        fixed, count = _u32(stsz, 4), _u32(stsz, 8)
        if fixed:
            sizes = [fixed] * count
        else:
            if len(stsz) < 12 + 4 * count:
                raise Mp4Error(f"{self.path}: stsz is cut")
            sizes = list(struct.unpack_from(f">{count}I", stsz, 12))
        if b"co64" in stbl:
            co = stbl[b"co64"][0]
            n = _u32(co, 4)
            offsets = list(struct.unpack_from(f">{n}Q", co, 8))
        else:
            co = self._one(stbl, b"stco")
            n = _u32(co, 4)
            offsets = list(struct.unpack_from(f">{n}I", co, 8))
        stsc = self._one(stbl, b"stsc")
        runs = [struct.unpack_from(">III", stsc, 8 + 12 * i)
                for i in range(_u32(stsc, 4))]
        out: List[Tuple[int, int]] = []
        k = 0
        for r, (first, per_chunk, _) in enumerate(runs):
            last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(offsets)
            for chunk in range(first - 1, min(last, len(offsets))):
                at = offsets[chunk]
                for _ in range(per_chunk):
                    if k >= count:
                        return out
                    out.append((at, sizes[k]))
                    at += sizes[k]
                    k += 1
        return out

    def _sample_times(self, stbl) -> List[Tuple[int, int]]:
        """(decode time, composition offset) of each sample of the sample
        table, in media units (``stts``, ``ctts``)."""
        stts = self._one(stbl, b"stts")
        dts, t = [], 0
        for i in range(_u32(stts, 4)):
            count, delta = struct.unpack_from(">II", stts, 8 + 8 * i)
            for _ in range(count):
                dts.append(t)
                t += delta
        offsets: List[int] = []
        if b"ctts" in stbl:
            ctts = stbl[b"ctts"][0]
            for i in range(_u32(ctts, 4)):
                count, off = struct.unpack_from(">Ii", ctts, 8 + 8 * i)
                offsets += [off] * count
        offsets += [0] * (len(dts) - len(offsets))
        self._next_dts = t
        return list(zip(dts, offsets))

    def _fragment(self, moof: bytes, moof_at: int, track_id: int,
                  trex: Tuple[int, int, int], samples: List[Tuple[int, int]],
                  times: List[Tuple[int, int]]) -> None:
        """Append the samples of the track's ``traf`` boxes in ``moof``
        (whose first byte is at ``moof_at``) to ``samples`` and their
        times to ``times``."""
        implicit = moof_at
        for traf in self._children(moof).get(b"traf", []):
            boxes = self._children(traf)
            tfhd = self._one(boxes, b"tfhd")
            flags, tid = _u32(tfhd) & 0xFFFFFF, _u32(tfhd, 4)
            if tid != track_id:
                continue
            at, fields = 8, {}
            for bit, name, width in ((0x1, "base", 8), (0x2, "index", 4),
                                     (0x8, "duration", 4),
                                     (0x10, "size", 4), (0x20, "flags", 4)):
                if flags & bit:
                    fields[name] = int.from_bytes(tfhd[at:at + width], "big")
                    at += width
            if fields.get("index", trex[0]) != 1:
                raise UnsupportedMp4(f"{self.path}: an MP4 fragment of "
                                     f"sample description "
                                     f"{fields.get('index', trex[0])}")
            base = fields["base"] if flags & 0x1 else \
                moof_at if flags & 0x20000 else implicit
            duration = fields.get("duration", trex[1])
            size = fields.get("size", trex[2])
            if b"tfdt" in boxes:
                tfdt = boxes[b"tfdt"][0]
                self._next_dts = int.from_bytes(
                    tfdt[4:12] if tfdt[0] == 1 else tfdt[4:8], "big")
            for trun in boxes.get(b"trun", []):
                tflags, count = _u32(trun) & 0xFFFFFF, _u32(trun, 4)
                at = 8
                offset = base
                if tflags & 0x1:
                    offset += struct.unpack_from(">i", trun, at)[0]
                    at += 4
                if tflags & 0x4:
                    at += 4
                per = [(0x100, "duration"), (0x200, "size"),
                       (0x400, "flags"), (0x800, "cto")]
                step = 4 * sum(1 for bit, _ in per if tflags & bit)
                if len(trun) < at + step * count:
                    raise Mp4Error(f"{self.path}: trun is cut")
                for _ in range(count):
                    got = {}
                    for bit, name in per:
                        if tflags & bit:
                            got[name] = struct.unpack_from(
                                ">i" if name == "cto" else ">I", trun, at)[0]
                            at += 4
                    n = got.get("size", size)
                    samples.append((offset, n))
                    times.append((self._next_dts, got.get("cto", 0)))
                    self._next_dts += got.get("duration", duration)
                    offset += n
                implicit = offset

    def _check_edits(self, edts: bytes, movie_scale: int, media_scale: int,
                     times: Tuple[int, int]) -> None:
        elst = self._children(edts).get(b"elst")
        if not elst:
            return
        e = elst[0]
        v1 = e[0] == 1
        n = _u32(e, 4)
        edits = []
        for i in range(n):
            if v1:
                dur, media = struct.unpack_from(">Qq", e, 8 + 20 * i)
            else:
                dur, media = struct.unpack_from(">Ii", e, 8 + 12 * i)
            if media != -1:
                edits.append((dur, media))
        if not edits:
            return
        dur, media = edits[0]
        first, last = times
        # the edit starts at the first frame shown and ends past the last
        # one's start (in seconds: dur / movie_scale against the media
        # time from its start over media_scale)
        covers = dur * media_scale > (last - media) * movie_scale
        if len(edits) > 1 or media != first or not covers:
            raise UnsupportedMp4(
                f"{self.path}: MP4 edit list that drops frames "
                f"({len(edits)} edits, the first from media time {media} "
                f"for {dur}/{movie_scale} s; frames shown from {first} to "
                f"{last} in units of 1/{media_scale} s)")

    # ---- reading ----

    def frames(self) -> Iterator[bytes]:
        """Each sample's bytes in order (a sample of size zero yields
        nothing)."""
        for at, size in self._samples:
            if size:
                data = self._read(at, size)
                if len(data) < size:
                    return
                yield data

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Mp4File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
