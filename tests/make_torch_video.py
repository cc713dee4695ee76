"""Write ``tests/data/torch_video/``: the AVI files that ``chip_smoke.py``
phase 7f decodes on the card, where there is no cv2, and the values it
holds them to, taken from cv2 and the JAX package on the CPU.

    python -m tests.make_torch_video          # everything
    python -m tests.make_torch_video vp8      # tests/data/torch_vp8 only
    python -m tests.make_torch_video vp9      # tests/data/torch_vp9 only
    python -m tests.make_torch_video mpeg2    # tests/data/torch_mpeg2 only
    python -m tests.make_torch_video raw      # tests/data/torch_raw only
    python -m tests.make_torch_video demux    # tests/data/torch_demux only
    python -m tests.make_torch_video h263     # tests/data/torch_h263 only
    python -m tests.make_torch_video msmpeg4  # tests/data/torch_msmpeg4 only
    python -m tests.make_torch_video wmv2     # tests/data/torch_wmv2 only

- ``clip.avi``: four panned 640x480 fixture frames (``apps/fixture.pan``)
  written by ``cv2.VideoWriter`` as Motion JPEG, with ``depth/<i>.png``
  (the fixture's depth, x10 as u16 PNG);
- ``ffv1.avi``: FFV1 from ``cv2.VideoWriter`` at 96x64, and
  ``ffv1_640.avi``: the clip's first frame at 640x480 (the decode that
  ``chip_smoke.py`` times);
- hand-muxed Motion JPEG AVIs of ``cv2.imencode`` JPEGs (:func:`mux_avi`):
  4:2:0, 4:2:2 (what UVC cameras send, with the DHT cut, as they send it),
  4:4:4 and gray; odd sizes (17x33 at 4:2:0 and 4:2:2, 64x47, 1x1);
  restart markers; a progressive
  frame; and one file with an OpenDML index whose last frame sits in a
  ``RIFF AVIX`` extension;
- the other sources ``cv2.VideoCapture`` opens (:func:`other_sources`):
  raw I420 from ``cv2.VideoWriter``'s fourcc 0 and hand-muxed IYUV at
  17x33; PNG video (``MPNG``) in AVI, MP4 and Matroska; Huffyuv
  (``HFYU``) in AVI; FFV1 and Motion JPEG in MP4 and Matroska; I420 in
  Matroska; single images (a JPEG at
  63x47, an 8-bit BMP, a 16-bit gray PNG); a printf pattern of three PNGs
  (``seq/f_%03d.png``, one of them gray); and at 640x480 the clip's
  first two frames as FFV1 in MP4 (``pan_ffv1.mp4``) and its four frames
  as ``cv2.imwrite`` JPEGs behind the pattern ``pan/%d.jpg``;
- MPEG-4 Part 2 from ``cv2.VideoWriter`` (:func:`mpeg4_sources`,
  ``m4_*``): each fourcc it writes MPEG-4 for (``mp4v``, ``MP4V``,
  ``XVID``, ``xvid``, ``FMP4``, ``DIVX``, ``DX50``) in AVI, ``mp4v`` in MP4
  and Matroska and ``XVID`` in Matroska (``V_MS/VFW/FOURCC``), frames of
  17x33 and 63x47 (the writer rounds them down to 16x32 and 62x46), the
  scene-cut clip with its VOL's width made odd (95, hand-edited: the
  writer writes even sizes), a scene cut in half of the frame mid-GOP (intra
  macroblocks in P-VOPs), motion of 13 and 7 pixels a frame past the
  frame's edge (``vop_fcode_forward`` 2, clamped reference samples),
  flat and blurred frames at 2 fps (QP rising, intra blocks with no AC
  coefficients) and noise at 60 fps (third-escape intra levels); a
  hand-muxed AVI with a VOP that is not coded (``m4_notcoded.avi``, which
  cv2 drops); and at 640x480 the clip's four frames as ``mp4v`` in AVI
  (``pan_mp4v.avi``);
- in ``tests/data/torch_vp8/`` (:func:`write_vp8`, with a
  ``digests.json`` and a ``recon.json`` of its own), VP8 from
  ``cv2.VideoWriter`` (:func:`vp8_sources`, ``vp8_*``; its libvpx, bundled
  with cv2 5.0.0 as ``libvpx.so.11``): a 96x64 pan in AVI,
  Matroska and WebM, a 640x480 pan of 24 frames (two golden refreshes,
  then a scene cut that makes a key frame), 95x63 (the writer writes
  94x62), 16x16, motion of 37 pixels a frame (clamped MV candidates),
  ramps at 2 fps (16x16 TM prediction) and noise at 60 fps; from the
  96x64 AVI's packets, re-encoded by ``tests/vp8_edit.py`` with the header
  fields :data:`VP8_EDITS` gives (a hidden frame, versions 1-3,
  ``color_space`` 1, reference copies and sign biases, kept
  probabilities and mode probability updates, the simple filter and
  sharpness, 2-8 token partitions, no skip flags) or hand-edited (the key
  frames' scale bits, their size made 93x61); and at 640x480 the clip's
  four frames in WebM (``pan_vp8.webm``);
- in ``tests/data/torch_vp9/`` (:func:`write_vp9`, with a ``digests.json``
  and a ``recon.json`` of its own), VP9 from ``cv2.VideoWriter``
  (:func:`vp9_sources`, ``vp9_*``; the same libvpx, profile 0): a 96x64
  pan in AVI, MP4 (``vp09``), Matroska and WebM, a 640x480 pan (two tile
  columns, a golden refresh), 1280x720 (four tile columns on the key
  frame, two after), 95x63 (the writer writes 94x62) with motion past the
  frame's edge, 16x16, motion of 37 pixels a frame, 2 and 60 fps; from
  the 96x64 AVI's packets, re-encoded by ``tests/vp9_edit.py`` with the
  header fields :data:`VP9_EDITS` gives (backward adaptation, kept and
  chosen probability contexts, error resilience, fixed interpolation
  filters and no high-precision MVs, loop-filter levels, sharpness and
  deltas, q indices and deltas), hand-edited in place (colour range and
  colour spaces cv2 converts with BT.601) or hand-built (a superframe of
  two shown frames, a superframe with a hidden frame, ``show_existing_frame``
  packets); tile rows on the 640x480 pan's packets; and at 640x480 the
  clip's four frames in WebM (``pan_vp9.webm``);
- in ``tests/data/torch_mpeg2/`` (:func:`write_mpeg2`, with a
  ``digests.json`` and a ``recon.json`` of its own), MPEG-2 from
  ``cv2.VideoWriter`` (:func:`mpeg2_sources`, ``mpeg2_*``; FFmpeg's
  mpeg2video encoder, B pictures, a closed then an open GOP): 16 panned
  fixture frames at 640x480 in AVI, MP4, MOV and Matroska, a 96x64 pan of
  16 frames, noise at 640x480 (I and B pictures only), motion of 37
  pixels a frame (f_code 2 and up), 1280x720 with a flat still lower
  half (address escapes), 95x63 (the writer writes 94x62), 16x16, 2 and 60 fps
  and the AVI fourcc ``MPEG``; from the 96x64 pan's packets, edited by
  ``tests/mpeg2_edit.py`` as :func:`mpeg2_edits` lists (loaded matrices,
  the display, quant matrix, copyright and picture display extensions,
  user data, broken_link, sequence end codes, the clip cut before its open
  GOP with closed_gop 0 and 1, low_delay, fine and coarse quantisers on
  each slice's first macroblock with extra slice information, a B
  picture's slice opening with an intra macroblock, an odd width, the
  sequence header as Matroska CodecPrivate); and at 640x480 the
  clip's four frames in MP4 (``pan_mpeg2.mp4``);
- in ``tests/data/torch_raw/`` (:func:`write_raw`, with a ``digests.json``
  and a ``recon.json`` of its own), what ``cv2.VideoCapture`` reads with
  no new decoder (:func:`raw_sources`): from ``cv2.VideoWriter``'s FFmpeg
  backend at 48x32, YUV4MPEG2 for ``I420``, ``Y800`` and ``YUY2`` (all
  written as ``C420jpeg``), AVI ``jpeg``, ``LJPG``, ``GEOX``, ``Y800``,
  ``GREY``, ``Y8  ``, ``NV12`` and ``RGBA``, Matroska ``Y800``, ``NV12``
  and ``RGBA``, MOV ``RGBA``, ``xd5b`` and ``mp2v``, raw Motion JPEG
  (``.mjpeg``) and an MPEG-2 elementary stream of 12 frames at 96x64
  (``.m2v``;
  edited: two streams, the first closed by a sequence end code, and the
  last picture cut inside its headers); hand-made YUV4MPEG2 (17x33, gray,
  full range, FRAME parameters, ``C420mpeg2``, a last frame cut short)
  and raw AVIs at odd widths (gray rows and NV12 planes padded to 4
  bytes, RGBA); PNG images back to back (``png_pipe.bin``); a PAM image
  (``image.pam``, which cv2 opens and reads no frame from); and at
  640x480 the clip's first two frames as YUV4MPEG2 (``pan_y4m.y4m``);
- in ``tests/data/torch_demux/`` (:func:`write_demux`, with a
  ``digests.json`` and a ``recon.json`` of its own), the containers
  demuxed for codecs the port already decodes (:func:`demux_sources`):
  from ``cv2.VideoWriter``'s FFmpeg backend, a 96x64 pan of 8 frames
  (MPEG-2, MPEG-4 Part 2, VP8, VP9, Motion JPEG) and 48x32 scenes of 3
  (FFV1, I420, PNG, Huffyuv) in MPEG program streams (``.mpg``: MPEG-1
  packs, ``.vob``: MPEG-2 packs), transport streams (``.ts``, BDAV's
  ``.m2ts``), fragmented MP4 (``.ismv``), Ogg, FLV, ASF (``.asf``,
  ``.wmv``) and NUT; hand-muxed by ``tests/stream_mux.py`` from those
  files' packets: both pack and PES header forms with padding, foreign
  streams and pictures split across packs, adaptation-field stuffing,
  PES lengths, private data that FFmpeg probes, BDAV with null packets,
  fragments whose sample sizes come from ``trex`` / ``tfhd`` / ``trun``,
  Ogg packets that span pages and a page with a wrong CRC, FLV metadata,
  script and sequence-end tags and CodedFramesX, ASF objects in
  fragments over 500-byte packets and several payloads a packet, NUT
  syncpoints with an elision header and info packets, a syncpoint with a
  wrong checksum and a main header without its elision table (no
  frame), and each container cut short at a packet or page boundary;
  and at 640x480 the clip's first two frames as MPEG-2 in a transport
  stream (``pan_ts.ts``);
- in ``tests/data/torch_wmv2/`` (:func:`write_wmv2`, with a
  ``digests.json`` and a ``recon.json`` of its own), WMV8 from
  ``cv2.VideoWriter``'s FFmpeg backend (:func:`wmv2_sources`): a 96x64
  pan in AVI, MOV, Matroska, ASF, WMV and NUT, a 14-frame pan (a second
  I picture), 128x96 at 30 fps, 640x480, checkerboards, halves moving
  apart, appearing squares, black and white halves, noise whose P
  pictures cross qscale 10 and 20 (the three CBP tables), that noise
  re-encoded by ``tests/wmv2_edit.py`` with run/level tables 1 and 2 and
  cbp_index 1 and 2, 95x63 as the writer writes it (94x62) and its
  packets under a 95x63 header; and at
  640x480 the clip's first two frames in a ``.wmv`` (``pan_wmv2.wmv``);
- ``digests.json``: for each source the frame count and each frame's
  shape and sha256 from ``cv2.VideoCapture``;
- ``recon.json``: the JAX CLI's ``acq`` output on ``clip.avi`` with its
  depth directory (the sha256 of each ``gray/`` and ``depth/`` PNG's
  pixels), its ``recon`` lines on that package with the fixture's
  features, with the default ICP settings ("a") and with iterations forced
  to the cap ("b", ``chip_smoke.FORCED``), and the JAX engine's match on
  each frame; under ``"sources"`` the same for ``pan_ffv1.mp4``,
  ``pan/%d.jpg`` and ``pan_mp4v.avi`` (``RECON_SOURCES``), and in
  ``tests/data/torch_vp8/recon.json`` for ``pan_vp8.webm`` and
  ``tests/data/torch_vp9/recon.json`` for ``pan_vp9.webm`` and
  ``tests/data/torch_mpeg2/recon.json`` for ``pan_mpeg2.mp4`` and
  ``tests/data/torch_raw/recon.json`` for ``pan_y4m.y4m`` and
  ``tests/data/torch_demux/recon.json`` for ``pan_ts.ts`` and
  ``tests/data/torch_h263/recon.json`` for ``pan_flv1.flv`` and
  ``tests/data/torch_msmpeg4/recon.json`` for ``pan_div3.avi`` and
  ``tests/data/torch_wmv2/recon.json`` for ``pan_wmv2.wmv`` (two
  frames, with the depth directory's first two by position).

``tests/test_torch_video.py`` holds the digests to cv2 on the CPU, so they
cannot go stale.  The muxer is shared with that test.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_video")
CLIP_FRAMES = 4
# the committed sources that are not container files, as VideoReader paths
# relative to OUT, and the directories that hold them
PATH_SOURCES = ("images/gray16.png", "images/one.bmp", "images/one.jpg",
                "pan/%d.jpg", "seq/f_%03d.png")
SOURCE_DIRS = ("images", "pan", "seq")
CONTAINERS = (".avi", ".mkv", ".mp4")
# the sources acq reads into recon (chip_smoke phase 7f): name -> frames
RECON_SOURCES = {"pan_ffv1.mp4": 2, "pan/%d.jpg": CLIP_FRAMES,
                 "pan_mp4v.avi": CLIP_FRAMES}
# the VP8 sources, in a directory of their own (OUT's files stay under
# test_torch_video's size budget); the one acq reads into recon
VP8_OUT = os.path.join(REPO, "tests", "data", "torch_vp8")
VP8_RECON_SOURCES = {"pan_vp8.webm": CLIP_FRAMES}
# the VP9 sources, in a directory of their own
VP9_OUT = os.path.join(REPO, "tests", "data", "torch_vp9")
VP9_RECON_SOURCES = {"pan_vp9.webm": CLIP_FRAMES}
# the MPEG-2 sources, in a directory of their own
MPEG2_OUT = os.path.join(REPO, "tests", "data", "torch_mpeg2")
MPEG2_RECON_SOURCES = {"pan_mpeg2.mp4": CLIP_FRAMES}
MPEG2_CONTAINERS = (".avi", ".mkv", ".mp4", ".mov")
# the sources read with no new decoder (YUV4MPEG2, the MPEG video
# elementary stream, raw gray / NV12 / RGBA, AVI's jpeg / LJPG / GEOX,
# MOV's MPEG-2 tags, raw Motion JPEG, PNG pipes), in a directory of their
# own; the 640x480 YUV4MPEG2 clip holds the clip's first two frames
RAW_OUT = os.path.join(REPO, "tests", "data", "torch_raw")
RAW_RECON_SOURCES = {"pan_y4m.y4m": 2}
# the H.263 and Sorenson Spark sources, in a directory of their own; the
# 640x480 Sorenson FLV holds the clip's first two frames
H263_OUT = os.path.join(REPO, "tests", "data", "torch_h263")
H263_RECON_SOURCES = {"pan_flv1.flv": 2}
H263_CONTAINERS = (".avi", ".mkv", ".mov", ".3gp", ".3g2", ".asf", ".nut",
                   ".flv", ".swf")
# the MS MPEG-4 v2 / v3 and WMV7 sources, in a directory of their own;
# the 640x480 DIV3 AVI holds the clip's first two frames
MSMPEG4_OUT = os.path.join(REPO, "tests", "data", "torch_msmpeg4")
MSMPEG4_RECON_SOURCES = {"pan_div3.avi": 2}
MSMPEG4_CONTAINERS = (".avi", ".mkv", ".mov", ".asf", ".wmv", ".nut")
# the fourccs cv2.VideoWriter writes each of the three codecs for
MSMPEG4_ALIASES = ("MP42", "DIV2", "DIV3", "MP43", "DIV4", "DIV5", "DIV6",
                   "MPG3", "AP41", "COL1", "COL0", "3IVD", "WMV1")
# the WMV8 sources, in a directory of their own; the 640x480 .wmv (ASF)
# holds the clip's first two frames
WMV2_OUT = os.path.join(REPO, "tests", "data", "torch_wmv2")
WMV2_RECON_SOURCES = {"pan_wmv2.wmv": 2}
WMV2_CONTAINERS = (".avi", ".mkv", ".mov", ".asf", ".wmv", ".nut")
# (rl, rl_chroma, cbp_index) the noise source is re-encoded with
# (tests/wmv2_edit.py): the run/level tables and CBP table choices the
# writer never makes
WMV2_RETABLED = ((1, 2, 1), (2, 1, 2))
# the containers demuxed for codecs the port already decodes, in a
# directory of their own; the 640x480 transport stream holds the clip's
# first two frames
DEMUX_OUT = os.path.join(REPO, "tests", "data", "torch_demux")
DEMUX_RECON_SOURCES = {"pan_ts.ts": 2}
# (fourcc, extension) of the writer's files there: the 96x64 pan, and the
# lossless codecs at 48x32
DEMUX_WRITER = (
    ("MPG2", "mpg"), ("mp4v", "mpg"), ("MPG2", "vob"), ("XVID", "vob"),
    ("MPG2", "ts"), ("mp4v", "ts"), ("MPG2", "m2ts"), ("DIVX", "m2ts"),
    ("MJPG", "ismv"), ("MPG2", "ismv"), ("mp4v", "ismv"), ("FFV1", "ismv"),
    ("MPNG", "ismv"), ("VP80", "ogv"), ("VP90", "flv"), ("MJPG", "asf"),
    ("mp4v", "asf"), ("VP80", "asf"), ("VP90", "asf"), ("FFV1", "asf"),
    ("I420", "asf"), ("HFYU", "asf"), ("MPNG", "asf"), ("MPG2", "wmv"),
    ("MJPG", "nut"), ("mp4v", "nut"), ("VP80", "nut"), ("VP90", "nut"),
    ("MPG2", "nut"), ("FFV1", "nut"), ("I420", "nut"), ("HFYU", "nut"),
    ("MPNG", "nut"))
LOSSLESS = ("FFV1", "I420", "MPNG", "HFYU")
# the fourccs cv2.VideoWriter writes MPEG-4 Part 2 for
MPEG4_FOURCCS = ("mp4v", "MP4V", "XVID", "xvid", "FMP4", "DIVX", "DX50")
# (first bit, width) of VOL fields past the start code in the VOL that
# FFmpeg's encoder writes (verid 1, vol_control_parameters 1 without VBV
# parameters, fixed_vop_rate 0)
VOL_FIELDS = {"vo_type": (1, 8), "verid": (10, 4), "aspect_ratio_info":
              (17, 4), "vbv_parameters": (25, 1), "shape": (26, 2),
              "fixed_vop_rate": (46, 1), "interlaced": (76, 1),
              "obmc_disable": (77, 1), "sprite_enable": (78, 1),
              "not_8_bit": (79, 1), "quant_type": (80, 1),
              "complexity_estimation_disable": (81, 1),
              "resync_marker_disable": (82, 1), "data_partitioned": (83, 1),
              "scalability": (84, 1)}


def _chunk(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, *chunks: bytes) -> bytes:
    return _chunk(b"LIST", kind + b"".join(chunks))


def mux_avi(frames, width: int, height: int, fourcc: bytes = b"MJPG",
            index: str = "idx1", extradata: bytes = b"", fps: int = 10,
            junk: bool = False, rec: bool = False, split: int = 0) -> bytes:
    """A one-stream video AVI holding ``frames`` (bytes each) as ``00dc``
    chunks.  ``index``: ``"idx1"`` (offsets relative to ``movi``),
    ``"odml"`` (an OpenDML super index in the stream header pointing at an
    ``ix00`` standard index at the end of each ``movi``; no ``idx1``) or
    ``"none"``.  ``junk`` puts a ``JUNK`` chunk before each frame, ``rec``
    wraps each frame in a ``LIST rec``; with ``split``, the frames from
    that one on go into a ``RIFF AVIX`` extension (which an ``idx1``, in
    the first RIFF, does not list)."""
    n = len(frames)
    odml = index == "odml"
    parts = [frames[:split], frames[split:]] if split else [frames]
    avih = struct.pack("<10I4I", 1000000 // fps, 0, 0,
                       0x10 if index != "none" else 0, len(parts[0]), 0, 1,
                       max((len(f) for f in frames), default=0), width,
                       height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0,
                       1, fps, 0, n, 0, 0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height,
                       1, 24, fourcc, width * height * 3, 0, 0, 0, 0)
    strf += extradata
    # the super index's entries are patched in once the ix00 chunks sit
    indx = struct.pack("<HBBI4sIII", 4, 0, 0, len(parts) if odml else 0,
                       b"00dc", 0, 0, 0) + bytes(16 * len(parts) * odml)
    strl = [_chunk(b"strh", strh), _chunk(b"strf", strf)]
    if odml:
        strl.append(_chunk(b"indx", indx))
    hdrl = _list(b"hdrl", _chunk(b"avih", avih), _list(b"strl", *strl))
    if odml:
        hdrl += _list(b"odml", _chunk(b"dmlh", struct.pack("<I", n)
                                      + bytes(244)))
    out, supers = bytearray(), []
    for k, part in enumerate(parts):
        riff_at = len(out)
        head = b"AVI " + hdrl if k == 0 else b"AVIX"
        movi_at = riff_at + 8 + len(head) + 8        # the 'movi' fourcc
        body, entries = b"", []
        for f in part:
            if junk:
                body += _chunk(b"JUNK", bytes(6))
            at = movi_at + 4 + len(body) + (12 if rec else 0)
            c = _chunk(b"00dc", f)
            body += _list(b"rec ", c) if rec else c
            entries.append((at, len(f)))
        if odml:
            base = movi_at
            ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(part), b"00dc", base,
                             0)
            ix += b"".join(struct.pack("<II", at + 8 - base, size)
                           for at, size in entries)
            supers.append((movi_at + 4 + len(body), 8 + len(ix), len(part)))
            body += _chunk(b"ix00", ix)
        riff = head + _list(b"movi", body)
        if index == "idx1" and k == 0:
            riff += _chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", 0x10, at - movi_at, size)
                for at, size in entries))
        out += b"RIFF" + struct.pack("<I", len(riff)) + riff
    if odml:
        at = out.index(b"indx") + 8 + 24
        for k, entry in enumerate(supers):
            out[at + 16 * k:at + 16 * k + 16] = struct.pack("<QII", *entry)
    return bytes(out)


def set_bits(data: bytes, at: int, width: int, value: int) -> bytes:
    """``data`` with the ``width`` bits from bit ``at`` set to ``value``."""
    n = len(data) * 8
    v = int.from_bytes(data, "big")
    mask = ((1 << width) - 1) << (n - at - width)
    v = (v & ~mask) | (value << (n - at - width))
    return v.to_bytes(len(data), "big")


def set_vp9_color_space(data: bytes, color_space: int,
                        color_range: int = 0) -> bytes:
    """``data`` (a VP9 packet or a whole file) with every profile-0 key
    frame's color_space and color_range set: the fields follow the
    frame's sync code 49 83 42, and no other bit moves."""
    out = bytearray(data)
    at = out.find(b"\x49\x83\x42")
    while at >= 0:
        out[at + 3] = (out[at + 3] & 0x0F) | (color_space << 5) | \
            (color_range << 4)
        at = out.find(b"\x49\x83\x42", at + 1)
    return bytes(out)


def set_vol_bit(data: bytes, field: str, value: int) -> bytes:
    """``data`` (a file or a packet) with ``field`` of :data:`VOL_FIELDS`
    set to ``value`` in every VOL it holds."""
    at, width = VOL_FIELDS[field]
    out, pos = bytearray(data), 0
    while True:
        pos = data.find(b"\x00\x00\x01\x20", pos)
        if pos < 0:
            return bytes(out)
        start = pos + 4
        end = start + (at + width + 7) // 8
        out[start:end] = set_bits(bytes(out[start:end]), at, width, value)
        pos = start


def set_vol_width(data: bytes, width: int) -> bytes:
    """``data`` with the width (13 bits after the start code's 48th) of
    every VOL it holds set to ``width``."""
    out, pos = data, 0
    while True:
        pos = out.find(b"\x00\x00\x01\x20", pos)
        if pos < 0:
            return out
        out = set_bits(out, (pos + 4) * 8 + 48, 13, width)
        pos += 4


def not_coded_vop(time_increment: int, increment_bits: int) -> bytes:
    """A P-VOP with ``vop_coded`` 0, stuffed to a byte."""
    bits = ("01" "0" "1" + format(time_increment, f"0{increment_bits}b")
            + "1" "0")
    bits += "0" + "1" * ((-len(bits) - 1) % 8)
    return b"\x00\x00\x01\xb6" + int(bits, 2).to_bytes(len(bits) // 8,
                                                         "big")


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_frames(path: str):
    """Every frame ``cv2.VideoCapture`` reads from ``path``."""
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def digest(path: str) -> dict:
    frames = cv2_frames(path)
    return {"frames": len(frames),
            "shapes": [list(f.shape) for f in frames],
            "sha256": [sha256(f) for f in frames]}


def jpeg(img: np.ndarray, *params) -> bytes:
    import cv2
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def cut_dht(data: bytes) -> bytes:
    """``data`` without its DHT segments (a Motion JPEG frame as UVC
    cameras send it)."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            return bytes(out + data[pos:])
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out)


def scene(w: int, h: int, seed: int, n: int = 1):
    """``n`` smooth seeded BGR frames (blurred noise over a gradient)."""
    import cv2
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = np.stack([(xx * 255 // max(w - 1, 1) + 40 * i) % 256,
                         yy * 255 // max(h - 1, 1),
                         (xx + yy + 17 * i) % 256], -1).astype(np.float32)
        noise = rng.normal(0, 60, (h, w, 3)).astype(np.float32)
        img = np.clip(base + cv2.GaussianBlur(noise, (5, 5), 0), 0, 255)
        out.append(img.astype(np.uint8))
    return out


def hand_clips():
    """The hand-muxed clips: name -> AVI bytes."""
    import cv2
    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    f420, f422, f444 = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    Q = cv2.IMWRITE_JPEG_QUALITY
    a = scene(64, 48, 1, 3)
    clips = {
        "mjpeg_420.avi": mux_avi([jpeg(f, Q, 80, S, f420) for f in a],
                                 64, 48),
        "mjpeg_422_nodht.avi": mux_avi(
            [cut_dht(jpeg(f, Q, 90, S, f422)) for f in a], 64, 48,
            junk=True),
        "mjpeg_444_rec.avi": mux_avi([jpeg(f, Q, 70, S, f444) for f in a],
                                     64, 48, rec=True),
        "mjpeg_gray.avi": mux_avi(
            [jpeg(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY), Q, 85) for f in a],
            64, 48),
        "mjpeg_restart_progressive.avi": mux_avi(
            [jpeg(a[0], Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
             jpeg(a[1], Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)], 64, 48),
        "mjpeg_odd.avi": mux_avi([jpeg(scene(17, 33, 2)[0], Q, 95),
                                  jpeg(scene(17, 33, 3)[0], Q, 95, S, f422)],
                                 17, 33),
        "mjpeg_odd_height.avi": mux_avi(
            [jpeg(f, Q, 90) for f in scene(64, 47, 4, 2)], 64, 47),
        "mjpeg_1x1.avi": mux_avi([jpeg(np.full((1, 1, 3), (30, 200, 90),
                                               np.uint8), Q, 95)], 1, 1),
        "mjpeg_odml_avix.avi": mux_avi([jpeg(f, Q, 75, S, f422) for f in a],
                                       64, 48, index="odml", split=2),
    }
    return clips


def write_cv2_clip(path: str, frames, fourcc: str, fps: int = 10) -> None:
    """``frames`` through ``cv2.VideoWriter`` (fourcc ``"0"``: 0, the
    uncompressed call), the container by the path's extension."""
    import cv2
    h, w = frames[0].shape[:2]
    code = 0 if fourcc == "0" else cv2.VideoWriter_fourcc(*fourcc)
    vw = cv2.VideoWriter(path, code, fps, (w, h))
    assert vw.isOpened(), fourcc
    for f in frames:
        vw.write(f)
    vw.release()


def write_ffmpeg_clip(path: str, frames, fourcc: str, fps: int = 10) -> None:
    """``frames`` through ``cv2.VideoWriter``'s FFmpeg backend (CAP_FFMPEG),
    the container by the path's extension."""
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.CAP_FFMPEG,
                         cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened(), (path, fourcc)
    for f in frames:
        vw.write(f)
    vw.release()


def y4m(planes, width: int, height: int, colour: str = "C420jpeg",
        extra: str = "", frame_line: bytes = b"FRAME\n") -> bytes:
    """A YUV4MPEG2 stream of raw frames ``planes`` (bytes each): the
    header's ``colour`` token and ``extra`` tokens, each frame behind
    ``frame_line``."""
    head = f"YUV4MPEG2 W{width} H{height} F10:1 Ip A1:1 {colour}{extra}\n"
    return head.encode() + b"".join(frame_line + p for p in planes)


def nv12(img: np.ndarray) -> bytes:
    """:func:`yuv420p`'s frame with U and V interleaved (NV12)."""
    h, w = img.shape[:2]
    n, c = w * h, ((w + 1) // 2) * ((h + 1) // 2)
    raw = np.frombuffer(yuv420p(img), np.uint8)
    uv = np.stack([raw[n:n + c], raw[n + c:]], 1)
    return raw[:n].tobytes() + uv.tobytes()


def padded_rows(data: bytes, planes) -> bytes:
    """Planes back to back in ``data``, given as (rows, width) each, laid
    out again with each row padded to a multiple of 4 bytes."""
    out, at = b"", 0
    for rows, width in planes:
        for _ in range(rows):
            out += data[at:at + width] + bytes(-width % 4)
            at += width
    return out


def yuv420p(img: np.ndarray) -> bytes:
    """A raw yuv420p frame of a BGR image at any size: BT.601 limited
    range, chroma averaged over 2x2 blocks (edge blocks over what they
    hold), planes back to back with no padding, as FFmpeg lays them."""
    f = img.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    h, w = y.shape

    def sub(p):
        p = np.pad(p, ((0, h & 1), (0, w & 1)), mode="edge")
        return p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean((1, 3))
    return b"".join(np.clip(np.rint(p), 0, 255).astype(np.uint8).tobytes()
                    for p in (y, sub(u), sub(v)))


def other_sources(frames) -> None:
    """Write the sources of :func:`main` past the AVIs of Motion JPEG and
    FFV1 (see the module docstring); ``frames`` are the clip's."""
    import cv2
    small = scene(64, 48, 8, 3)
    write_cv2_clip(os.path.join(OUT, "i420.avi"), small, "0")
    with open(os.path.join(OUT, "iyuv_odd.avi"), "wb") as f:
        f.write(mux_avi([yuv420p(x) for x in scene(17, 33, 9, 2)], 17, 33,
                        fourcc=b"IYUV"))
    for ext in ("avi", "mp4", "mkv"):
        write_cv2_clip(os.path.join(OUT, f"mpng.{ext}"), small, "MPNG")
    for ext in ("mp4", "mkv"):
        write_cv2_clip(os.path.join(OUT, f"ffv1.{ext}"), small, "FFV1")
        write_cv2_clip(os.path.join(OUT, f"mjpeg.{ext}"), small, "MJPG")
    write_cv2_clip(os.path.join(OUT, "i420.mkv"), small, "I420")
    write_cv2_clip(os.path.join(OUT, "hfyu.avi"), small, "HFYU")
    write_cv2_clip(os.path.join(OUT, "pan_ffv1.mp4"),
                   [b for b, _ in frames[:RECON_SOURCES["pan_ffv1.mp4"]]],
                   "FFV1")
    for d in SOURCE_DIRS:
        os.makedirs(os.path.join(OUT, d), exist_ok=True)
    odd = scene(63, 47, 10, 1)[0]
    cv2.imwrite(os.path.join(OUT, "images", "one.jpg"), odd)
    cv2.imwrite(os.path.join(OUT, "images", "one.bmp"),
                cv2.cvtColor(small[0], cv2.COLOR_BGR2GRAY))
    cv2.imwrite(os.path.join(OUT, "images", "gray16.png"),
                (np.arange(48 * 64).reshape(48, 64) * 21).astype(np.uint16))
    for i, img in enumerate(small):
        if i == 1:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        cv2.imwrite(os.path.join(OUT, "seq", f"f_{i:03d}.png"), img)
    for i, (b, _) in enumerate(frames):
        cv2.imwrite(os.path.join(OUT, "pan", f"{i}.jpg"), b,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])


def _shifted(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """``img`` moved by (dx, dy), its edge pixels repeated."""
    import cv2
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(img, m, (img.shape[1], img.shape[0]),
                          borderMode=cv2.BORDER_REPLICATE)


def mpeg4_sources(frames) -> None:
    """Write the MPEG-4 Part 2 sources (see the module docstring);
    ``frames`` are the clip's."""
    import cv2
    from fealess_tpu_torch.io.avi import AviFile

    def out(name):
        return os.path.join(OUT, name)
    base = scene(48, 32, 21, 1)[0]
    pan = [_shifted(base, 2 * i, i) for i in range(5)]
    for cc in MPEG4_FOURCCS:
        write_cv2_clip(out(f"m4_{cc}.avi"), pan, cc)
    write_cv2_clip(out("m4_mp4v.mp4"), pan, "mp4v")
    write_cv2_clip(out("m4_mp4v.mkv"), pan, "mp4v")
    write_cv2_clip(out("m4_XVID.mkv"), pan, "XVID")
    odd = scene(63, 47, 22, 1)[0]
    write_cv2_clip(out("m4_size_17x33.avi"),
                   [cv2.resize(_shifted(odd, i, 2 * i), (17, 33))
                    for i in range(4)], "mp4v")
    write_cv2_clip(out("m4_size_63x47.mp4"),
                   [_shifted(odd, -i, i) for i in range(4)], "mp4v")
    a, b = scene(96, 64, 23, 1)[0], scene(96, 64, 24, 1)[0]
    cut = [_shifted(a, i, 0) for i in range(4)]
    for i in range(4):
        f = _shifted(a, 4 + i, 0)
        f[:, 48:] = _shifted(b, 0, i)[:, 48:]
        cut.append(f)
    write_cv2_clip(out("m4_cut.avi"), cut, "mp4v")
    # its VOL's width made odd (95): the same macroblocks, cropped
    avi = AviFile(out("m4_cut.avi"))
    packets = [set_vol_width(p, 95) for p in avi.frames()]
    avi.close()
    with open(out("m4_odd_95x64.avi"), "wb") as f:
        f.write(mux_avi(packets, 95, 64, fourcc=b"FMP4"))
    big = scene(96, 64, 25, 1)[0]
    write_cv2_clip(out("m4_motion.avi"),
                   [_shifted(big, 13 * i, -7 * i) for i in range(7)], "mp4v")
    smooth = [cv2.GaussianBlur(_shifted(big, 2 * i, i), (21, 21), 0)[:32, :48]
              for i in range(5)]
    for f in smooth:
        f[:, :24] = (90, 140, 200)
    write_cv2_clip(out("m4_rate_fps2.avi"), smooth, "mp4v", fps=2)
    rng = np.random.default_rng(26)
    write_cv2_clip(out("m4_rate_fps60.avi"),
                   [rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
                    for _ in range(3)], "mp4v", fps=60)
    # m4_mp4v.avi's packets with a VOP that is not coded after the third
    # (10 fps: 4 time increment bits)
    avi = AviFile(out("m4_mp4v.avi"))
    packets = list(avi.frames())
    avi.close()
    with open(out("m4_notcoded.avi"), "wb") as f:
        f.write(mux_avi(packets[:3] + [not_coded_vop(5, 4)] + packets[3:],
                        48, 32, fourcc=b"FMP4"))
    write_cv2_clip(out("pan_mp4v.avi"), [b for b, _ in frames], "mp4v")


# the edits that make the re-encoded VP8 clips from vp8_pan.avi's packets
# (tests/vp8_edit.rewrite): name -> {frame: {header field: value}}; the
# frame tag's fields ("show", "version") and the number of token
# partitions ("parts") are fields too, and "no_skip" drops the skip flags
VP8_EDITS = {
    "vp8_hidden.avi": {3: {"show": 0}},
    "vp8_version1.avi": {i: {"version": 1} for i in range(14)},
    "vp8_version2.avi": {i: {"version": 2} for i in range(14)},
    "vp8_version3.avi": {i: {"version": 3} for i in range(14)},
    "vp8_color_space.avi": {0: {"color_space": 1}, 12: {"color_space": 1}},
    "vp8_refs.avi": {
        2: {"refresh_golden": 0, "copy_to_golden": 1},
        3: {"refresh_altref": 0, "copy_to_altref": 1},
        4: {"refresh_golden": 0, "copy_to_golden": 2, "refresh_last": 0},
        5: {"refresh_altref": 1, "sign_bias_golden": 1},
        6: {"sign_bias_altref": 1, "sign_bias_golden": 1},
        9: {"refresh_last": 0, "sign_bias_altref": 1}},
    "vp8_probs.avi": {
        2: {"refresh_probs": 0},
        4: {"ymode_probs": [90, 70, 160, 60], "uvmode_probs": [150, 120, 190]},
        5: {"refresh_probs": 0, "ymode_probs": [140, 100, 120, 20]},
        8: {"uvmode_probs": [170, 90, 210]}},
    "vp8_filters.avi": {
        0: {"filter_type": 1, "filter_level": 20},
        1: {"filter_type": 1, "filter_level": 33, "sharpness": 4},
        2: {"sharpness": 1, "filter_level": 12},
        3: {"sharpness": 7, "filter_level": 45},
        4: {"sharpness": 3, "filter_level": 63},
        5: {"filter_type": 1, "filter_level": 0}},
    "vp8_parts.avi": {0: {"parts": 2}, 1: {"parts": 4}, 2: {"parts": 8},
                      3: {"parts": 2}, 5: {"parts": 8}},
    "vp8_noskip.avi": {1: {"no_skip": 1}, 2: {"no_skip": 1},
                       12: {"no_skip": 1}},
}


def _vp8_edit(plan):
    """``tests.vp8_edit.rewrite``'s edit for one of :data:`VP8_EDITS`."""
    def edit(i, f, mbs, toks):
        change = dict(plan.get(i, {}))
        if change.pop("no_skip", 0) and f["skip_flag"]:
            # no skip flags: a skipped MB codes an end of block for each
            # of its blocks instead (25 with Y2, 24 without)
            f["skip_flag"], f["prob_skip"] = 0, None
            for m, mb in enumerate(mbs):
                skipped = mb.pop(0)[1]
                if skipped:
                    toks[m] = [(128, 0)] * (24 if f["modes"][m] in (4, 9)
                                            else 25)
        f.update(change)
    return edit


def set_vp8_size(packet: bytes, width: int, height: int) -> bytes:
    """A key frame's packet with the size in its header set (the scale
    bits kept); other packets as they are."""
    if packet[0] & 1:
        return packet
    b = bytearray(packet)
    b[6:8] = (width | (b[7] >> 6) << 14).to_bytes(2, "little")
    b[8:10] = (height | (b[9] >> 6) << 14).to_bytes(2, "little")
    return bytes(b)


def vp8_sources(frames) -> None:
    """Write the VP8 sources (see the module docstring); ``frames`` are
    the clip's."""
    import cv2
    from fealess_tpu_torch.io.avi import AviFile
    from tests import vp8_edit

    def out(name):
        return os.path.join(VP8_OUT, name)
    base = scene(96, 64, 31, 1)[0]
    pan = [_shifted(base, 3 * i, -2 * i) for i in range(14)]
    for ext in ("avi", "mkv", "webm"):
        write_cv2_clip(out(f"vp8_pan.{ext}"), pan, "VP80")
    # 640x480: two golden refreshes, then a scene cut (a key frame)
    big = cv2.resize(scene(160, 120, 32, 1)[0], (700, 520),
                     interpolation=cv2.INTER_CUBIC)
    other = cv2.flip(big, -1)
    long_pan = [_shifted(big if i < 20 else other, -4 * i, -2 * i)[:480, :640]
                for i in range(24)]
    write_cv2_clip(out("vp8_pan640.webm"), long_pan, "VP80")
    odd = scene(95, 63, 33, 1)[0]
    write_cv2_clip(out("vp8_size_95x63.avi"),
                   [_shifted(odd, 2 * i, i) for i in range(6)], "VP80")
    write_cv2_clip(out("vp8_size_16x16.mkv"),
                   [_shifted(scene(16, 16, 34, 1)[0], i, -i)
                    for i in range(5)], "VP80")
    fast = scene(128, 96, 35, 1)[0]
    write_cv2_clip(out("vp8_motion.mkv"),
                   [_shifted(fast, 37 * i, -11 * i) for i in range(12)],
                   "VP80")
    yy, xx = np.mgrid[0:64, 0:96]
    ramp = np.stack([(2 * xx + 3 * yy) % 256, (3 * xx + yy + 40) % 256,
                     (255 - xx - 2 * yy) % 256], -1).astype(np.uint8)
    smooth = [cv2.GaussianBlur(_shifted(fast, 2 * i, i), (21, 21), 0)
              [:64, :96] for i in range(6)]
    for i, f in enumerate(smooth):
        f[:, :40] = _shifted(ramp, i, 0)[:, :40]
    write_cv2_clip(out("vp8_rate_fps2.webm"), smooth, "VP80", fps=2)
    rng = np.random.default_rng(36)
    write_cv2_clip(out("vp8_rate_fps60.avi"),
                   [rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
                    for _ in range(4)], "VP80", fps=60)
    # hand-edited and re-encoded from vp8_pan.avi's packets
    with AviFile(out("vp8_pan.avi")) as avi:
        packets = list(avi.frames())
    for name, plan in VP8_EDITS.items():
        with open(out(name), "wb") as f:
            f.write(mux_avi(vp8_edit.rewrite(packets, _vp8_edit(plan)), 96,
                            64, fourcc=b"VP80"))
    scaled = [bytes([*p[:7], p[7] | 0x40, p[8], p[9] | 0x80, *p[10:]])
              if not p[0] & 1 else p for p in packets]
    with open(out("vp8_scale_bits.avi"), "wb") as f:
        f.write(mux_avi(scaled, 96, 64, fourcc=b"VP80"))
    with open(out("vp8_odd_93x61.avi"), "wb") as f:
        f.write(mux_avi([set_vp8_size(p, 93, 61) for p in packets], 93, 61,
                        fourcc=b"VP80"))
    write_cv2_clip(out("pan_vp8.webm"), [b for b, _ in frames], "VP80")


# the edits that make the re-encoded VP9 clips from vp9_pan.avi's packets
# (tests/vp9_edit.rewrite): name -> {frame: {header field: value}}; frame
# 12 is a key frame
VP9_EDITS = {
    "vp9_adapt.avi": {i: {"parallel": 0} for i in range(14)},
    "vp9_contexts.avi": {
        0: {"parallel": 0, "ctx_idx": 2}, 1: {"ctx_idx": 1, "parallel": 0},
        2: {"ctx_idx": 2, "refresh_ctx": 0, "parallel": 0,
            "render": (40, 30)},
        3: {"ctx_idx": 3, "reset_ctx": 2}, 4: {"ctx_idx": 1, "reset_ctx": 3},
        5: {"ctx_idx": 3, "parallel": 0}, 6: {"refresh_ctx": 0},
        7: {"ctx_idx": 2, "parallel": 0}, 8: {"reset_ctx": 1},
        13: {"ctx_idx": 3, "parallel": 0}},
    "vp9_error_res.avi": {1: {"error_res": 1}, 2: {"parallel": 0},
                          13: {"error_res": 1}},
    # the golden / altref choice of every block swapped: altref blocks
    "vp9_altref.avi": {i: {"swap_golden_altref": 1} for i in range(14)},
    # the golden / altref choice of every block swapped: altref blocks
    "vp9_altref.avi": {i: {"swap_golden_altref": 1} for i in range(14)},
    "vp9_filters.avi": {
        1: {"filter": 0}, 2: {"filter": 1}, 3: {"filter": 2},
        4: {"filter": 3}, 5: {"filter": 3, "allow_hp": 0},
        11: {"allow_hp": 0}, 13: {"filter": 1}},
    "vp9_loop_filter.avi": {
        0: {"lf_level": 63, "sharpness": 1}, 1: {"lf_level": 0},
        2: {"lf_level": 40, "sharpness": 3},
        3: {"lf_level": 17, "sharpness": 5, "delta_enabled": 0},
        4: {"lf_level": 31, "sharpness": 7, "delta_update": 1,
            "ref_deltas": [3, -2, 5, None], "mode_deltas": [-4, 6]},
        5: {"lf_level": 32, "sharpness": 4},
        6: {"lf_level": 50, "sharpness": 2, "delta_update": 1,
            "ref_deltas": [None, 7, None, -9], "mode_deltas": [None, -3]},
        7: {"lf_level": 9}, 8: {"lf_level": 1, "sharpness": 6},
        12: {"lf_level": 20, "sharpness": 1, "delta_update": 1,
             "ref_deltas": [-1, 2, 0, 1], "mode_deltas": [1, 0]}},
    "vp9_quant.avi": {
        0: {"base_q": 1}, 1: {"base_q": 255}, 2: {"base_q": 128},
        3: {"delta_q": [3, 0, 0]}, 4: {"delta_q": [0, -5, 7]},
        5: {"base_q": 2, "delta_q": [-2, -3, -1]},
        6: {"base_q": 250, "delta_q": [5, 6, -8]}, 12: {"base_q": 60}},
}


def _vp9_edit(plan):
    """``tests.vp9_edit.rewrite``'s edit for one of :data:`VP9_EDITS`."""
    def edit(i, f):
        change = dict(plan.get(i, {}))
        if f.get("key"):                 # fields key frames do not have
            for k in ("filter", "allow_hp", "reset_ctx",
                      "swap_golden_altref"):
                change.pop(k, None)
        if change.get("error_res"):
            f.pop("refresh_ctx", None)
            f.pop("parallel", None)
            f["reset_ctx"] = 0
        f.update(change)
        return f
    return edit


def vp9_sources(frames) -> None:
    """Write the VP9 sources (see the module docstring); ``frames`` are
    the clip's."""
    import cv2
    from fealess_tpu_torch.io.avi import AviFile
    from tests import vp9_edit

    def out(name):
        return os.path.join(VP9_OUT, name)
    base = scene(96, 64, 31, 1)[0]
    pan = [_shifted(base, 3 * i, -2 * i) for i in range(14)]
    for ext in ("avi", "mkv", "webm", "mp4"):
        write_cv2_clip(out(f"vp9_pan.{ext}"), pan, "VP90")
    big = cv2.resize(scene(160, 120, 32, 1)[0], (700, 520),
                     interpolation=cv2.INTER_CUBIC)
    long_pan = [_shifted(big, -4 * i, -2 * i)[:480, :640] for i in range(8)]
    write_cv2_clip(out("vp9_pan640.webm"), long_pan, "VP90")
    wide = cv2.GaussianBlur(cv2.resize(scene(160, 90, 37, 1)[0], (1280, 720),
                                       interpolation=cv2.INTER_CUBIC),
                            (9, 9), 0)
    write_cv2_clip(out("vp9_size_1280x720.webm"),
                   [_shifted(wide, 5 * i, 3 * i) for i in range(3)], "VP90")
    odd = scene(95, 63, 33, 1)[0]
    write_cv2_clip(out("vp9_size_95x63.avi"),
                   [_shifted(odd, 9 * i, -5 * i) for i in range(8)], "VP90")
    write_cv2_clip(out("vp9_size_16x16.mkv"),
                   [_shifted(scene(16, 16, 34, 1)[0], i, -i)
                    for i in range(5)], "VP90")
    fast = scene(128, 96, 35, 1)[0]
    write_cv2_clip(out("vp9_motion.mkv"),
                   [_shifted(fast, 37 * i, -11 * i) for i in range(8)],
                   "VP90")
    yy, xx = np.mgrid[0:64, 0:96]
    ramp = np.stack([(2 * xx + 3 * yy) % 256, (3 * xx + yy + 40) % 256,
                     (255 - xx - 2 * yy) % 256], -1).astype(np.uint8)
    smooth = [cv2.GaussianBlur(_shifted(fast, 2 * i, i), (21, 21), 0)
              [:64, :96] for i in range(6)]
    for i, f in enumerate(smooth):
        f[:, :40] = _shifted(ramp, i, 0)[:, :40]
    write_cv2_clip(out("vp9_rate_fps2.webm"), smooth, "VP90", fps=2)
    rng = np.random.default_rng(36)
    write_cv2_clip(out("vp9_rate_fps60.avi"),
                   [rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
                    for _ in range(4)], "VP90", fps=60)
    # re-encoded, hand-edited and hand-built from vp9_pan.avi's packets
    with AviFile(out("vp9_pan.avi")) as avi:
        packets = list(avi.frames())

    def avi(name, data, w=96, h=64):
        with open(out(name), "wb") as f:
            f.write(mux_avi(data, w, h, fourcc=b"VP90"))
    for name, plan in VP9_EDITS.items():
        avi(name, vp9_edit.rewrite(packets, _vp9_edit(plan)))
    avi("vp9_full_range.avi", [set_vp9_color_space(p, 1, 1) for p in packets])
    avi("vp9_color_space.avi", [set_vp9_color_space(p, 3) for p in packets])
    avi("vp9_superframe.avi", packets[:4] + [
        vp9_edit.superframe(packets[4:6])] + packets[6:])
    hidden = vp9_edit.rewrite(packets, _vp9_edit(
        {5: {"show": 0, "refresh": 5}}))
    avi("vp9_hidden.avi", hidden[:5] + [vp9_edit.superframe(hidden[5:7])] +
        hidden[7:9] + [vp9_edit.show_existing(2)] + hidden[9:])
    # the hidden frame shown right after it: the next frame takes no MV
    # candidates from the frame before (FFmpeg's last_invisible holds)
    avi("vp9_show_hidden.avi", hidden[:6] + [vp9_edit.show_existing(2)] +
        hidden[6:])
    avi("vp9_show_existing.avi", packets[:4] + [vp9_edit.show_existing(0)] +
        packets[4:8] + [vp9_edit.show_existing(1)] + packets[8:])
    from fealess_tpu_torch.io.matroska import MkvFile
    with MkvFile(out("vp9_pan640.webm")) as mkv:
        big_packets = list(mkv.frames())[:4]
    avi("vp9_tile_rows.avi", vp9_edit.rewrite(big_packets, _vp9_edit(
        {0: {"log2_tile_rows": 1}, 1: {"log2_tile_rows": 2},
         3: {"log2_tile_rows": 1, "log2_tile_cols": 0}})), 640, 480)
    write_cv2_clip(out("pan_vp9.webm"), [b for b, _ in frames], "VP90")


def mpeg2_edits(packets):
    """The MPEG-2 clips edited from ``mpeg2_pan96.avi``'s ``packets``
    (see the module docstring): name -> (packets, Matroska CodecPrivate
    or None for an AVI)."""
    from tests import mpeg2_edit as E

    def each(fn, ps=packets):
        return [E.join(fn(E.units(p))) for p in ps]

    def after(units, kind, new):
        """``new`` units after the first unit that ``kind`` picks."""
        out, done = [], False
        for u in units:
            out.append(u)
            if not done and kind(u):
                out += new
                done = True
        return out

    intra = [8] + [8 + (i * 7) % 50 for i in range(1, 64)]
    inter = [10 + (i * 5) % 30 for i in range(64)]
    seq_ext = lambda u: E.ext_id(u) == 1                      # noqa: E731
    coding_ext = lambda u: E.ext_id(u) == 8                   # noqa: E731
    out = {
        "mpeg2_matrices.avi": each(lambda us: [
            E.sequence_header(u, intra, inter) if E.code(u) == E.SEQ else u
            for u in us]),
        "mpeg2_quant_matrix_ext.avi": packets[:1] + each(
            lambda us: after(us, coding_ext, [E.quant_matrix_extension(
                inter, intra, [16] * 64, [20 + i % 9 for i in range(64)])]),
            packets[1:2]) + packets[2:],
        "mpeg2_display_ext.avi": [
            E.join(after(E.units(p), seq_ext, [E.display_extension(
                96, 64, 6 if i == 0 else 5)])) if i in (0, 10) else p
            for i, p in enumerate(packets)],
        "mpeg2_user_data.avi": each(lambda us: after(
            after(us, lambda u: E.code(u) == E.SEQ,
                  [E.user_data(b"fealess MPEG-2 test " * 2)]),
            coding_ext, [E.copyright_extension(),
                         E.picture_display_extension()])),
        "mpeg2_broken_link.avi": each(lambda us: [
            E.set_field(u, *E.GOP_FIELDS["broken_link"], 1)
            if E.code(u) == E.GOP else u for u in us]),
        "mpeg2_seq_end.avi": packets[:-1] + [
            packets[-1] + b"\x00\x00\x01\xb7", b"\x00\x00\x01\xb7"],
        "mpeg2_open_gop_start.avi": packets[10:],
        "mpeg2_closed_gop_start.avi": each(lambda us: [
            E.set_field(u, *E.GOP_FIELDS["closed_gop"], 1)
            if E.code(u) == E.GOP else u for u in us], packets[10:]),
        "mpeg2_low_delay.avi": each(lambda us: [
            E.set_field(u, *E.SEQ_EXT_FIELDS["low_delay"], 1)
            if seq_ext(u) else u for u in us]),
        "mpeg2_q_fine.avi": [E.requantise(p, 1, extra=True)
                             for p in packets],
        "mpeg2_q_coarse.avi": [E.requantise(p, 31) for p in packets],
        "mpeg2_b_intra.avi": packets[:2] + each(lambda us: [
            E.b_intra_slice(0, 6) if E.code(u) == 0x01 else u for u in us],
            packets[2:3]) + packets[3:],
        "mpeg2_width_95.avi": each(lambda us: [
            E.set_field(u, *E.SEQ_FIELDS["width"], 95)
            if E.code(u) == E.SEQ else u for u in us]),
    }
    out = {name: (ps, None) for name, ps in out.items()}
    head = E.units(packets[0])
    seq = [u for u in head if E.code(u) == E.SEQ or seq_ext(u)]
    out["mpeg2_extradata.mkv"] = (packets, E.join(seq))
    return out


def mpeg2_sources(frames) -> None:
    """Write the MPEG-2 sources (see the module docstring); ``frames`` are
    the clip's."""
    import cv2
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.io.avi import AviFile
    from fealess_tpu_torch.io.png import read_png
    from tests.test_torch_containers import mux_mkv

    def out(name):
        return os.path.join(MPEG2_OUT, name)
    bgr = read_png(os.path.join(fixture.FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(fixture.FIXTURE, "scene_depth.png"))
    pan = [b for b, _ in fixture.pan(bgr, depth, 16)]
    for ext in MPEG2_CONTAINERS:
        write_cv2_clip(out(f"mpeg2_pan{ext}"), pan, "MPG2")
    base = scene(96, 64, 51, 1)[0]
    small = [_shifted(base, 3 * i, -2 * i) for i in range(16)]
    write_cv2_clip(out("mpeg2_pan96.avi"), small, "MPG2")
    write_cv2_clip(out("mpeg2_fourcc_MPEG.avi"), small[:5], "MPEG")
    rng = np.random.default_rng(52)
    write_cv2_clip(out("mpeg2_noise.avi"), [
        np.clip(128 + rng.integers(-8, 9, (480, 640, 3)), 0, 255).astype(
            np.uint8) for _ in range(3)], "MPG2")
    fast = scene(128, 96, 53, 1)[0]
    write_cv2_clip(out("mpeg2_motion.mkv"),
                   [_shifted(fast, 37 * i, -11 * i) for i in range(8)],
                   "MPG2")
    wide = cv2.GaussianBlur(cv2.resize(scene(160, 90, 54, 1)[0], (1280, 720),
                                       interpolation=cv2.INTER_CUBIC),
                            (9, 9), 0)
    still = []
    for i in range(4):
        f = np.full_like(wide, 90)
        f[:360] = _shifted(wide, 5 * i, 3 * i)[:360]
        still.append(f)
    write_cv2_clip(out("mpeg2_size_1280x720.avi"), still, "MPG2")
    odd = scene(95, 63, 55, 1)[0]
    write_cv2_clip(out("mpeg2_size_95x63.avi"),
                   [_shifted(odd, 9 * i, -5 * i) for i in range(8)], "MPG2")
    write_cv2_clip(out("mpeg2_size_16x16.mkv"),
                   [_shifted(scene(16, 16, 56, 1)[0], i, -i)
                    for i in range(5)], "MPG2")
    smooth = [cv2.GaussianBlur(_shifted(fast, 2 * i, i), (21, 21), 0)
              [:64, :96] for i in range(6)]
    write_cv2_clip(out("mpeg2_rate_fps2.avi"), smooth, "MPG2", fps=2)
    write_cv2_clip(out("mpeg2_rate_fps60.avi"),
                   [rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
                    for _ in range(4)], "MPG2", fps=60)
    with AviFile(out("mpeg2_pan96.avi")) as avi:
        packets = list(avi.frames())
    for name, (data, private) in mpeg2_edits(packets).items():
        with open(out(name), "wb") as f:
            f.write(mux_avi(data, 96, 64, fourcc=b"mpg2") if private is None
                    else mux_mkv(data, 96, 64, "V_MPEG2", private))
    write_cv2_clip(out("pan_mpeg2.mp4"), [b for b, _ in frames], "MPG2")


def raw_sources(frames) -> None:
    """Write the sources read with no new decoder (see the module
    docstring); ``frames`` are the clip's."""
    import cv2

    def out(name):
        return os.path.join(RAW_OUT, name)

    def write(name, data):
        with open(out(name), "wb") as f:
            f.write(data)
    write_ffmpeg_clip(out("pan_y4m.y4m"),
                      [b for b, _ in frames[:RAW_RECON_SOURCES[
                          "pan_y4m.y4m"]]], "I420")
    small = scene(48, 32, 61, 3)
    for cc in ("I420", "Y800", "YUY2"):
        write_ffmpeg_clip(out(f"y4m_{cc}.y4m"), small, cc)
    for cc in ("jpeg", "LJPG", "GEOX", "Y800", "GREY", "Y8  ", "NV12",
               "RGBA"):
        write_ffmpeg_clip(out(f"avi_{cc.strip()}.avi"), small, cc)
    for cc in ("Y800", "NV12", "RGBA"):
        write_ffmpeg_clip(out(f"mkv_{cc}.mkv"), small, cc)
    for cc in ("RGBA", "xd5b", "mp2v"):
        write_ffmpeg_clip(out(f"mov_{cc}.mov"), small, cc)
    write_ffmpeg_clip(out("raw.mjpeg"), small, "MJPG")
    base = scene(96, 64, 62, 1)[0]
    pan = [_shifted(base, 3 * i, -2 * i) for i in range(12)]
    write_ffmpeg_clip(out("m2v_pan96.m2v"), pan, "MPG2")
    with open(out("m2v_pan96.m2v"), "rb") as f:
        m2v = f.read()
    from fealess_tpu_torch.io.mpegvideo import packets
    last = packets(m2v)[-1]
    # two streams, the first closed by a sequence end code; the last
    # picture cut inside its headers (before its first slice)
    write("m2v_two_streams.m2v", m2v + b"\x00\x00\x01\xb7" + m2v)
    write("m2v_cut_headers.m2v",
          m2v[:len(m2v) - len(last) + last.index(b"\x00\x00\x01\x01")])
    # hand-made YUV4MPEG2: odd sizes, gray, full range, FRAME parameters,
    # MPEG-2 chroma siting at an even height, a last frame cut short
    odd = scene(17, 33, 63, 2)
    write("y4m_17x33.y4m", y4m([yuv420p(x) for x in odd], 17, 33))
    write("y4m_mono_17x33.y4m", y4m(
        [cv2.cvtColor(x, cv2.COLOR_BGR2GRAY).tobytes() for x in odd], 17, 33,
        "Cmono"))
    wide = scene(34, 20, 64, 2)
    write("y4m_full_range.y4m", y4m([yuv420p(x) for x in wide], 34, 20,
                                    extra=" XCOLORRANGE=FULL"))
    write("y4m_frame_params.y4m", y4m([yuv420p(x) for x in wide], 34, 20,
                                      frame_line=b"FRAME Ip XFOO=1\n"))
    write("y4m_420mpeg2.y4m", y4m([yuv420p(x) for x in wide], 34, 20,
                                  "C420mpeg2"))
    write("y4m_cut.y4m", y4m([yuv420p(x) for x in wide], 34, 20)[:-7])
    # hand-muxed raw AVIs at odd widths: gray rows padded to 4 bytes where
    # the packet holds them, NV12 planes padded likewise, RGBA
    write("avi_Y800_17x33.avi", mux_avi(
        [padded_rows(cv2.cvtColor(x, cv2.COLOR_BGR2GRAY).tobytes(),
                     [(33, 17)]) for x in odd], 17, 33, fourcc=b"Y800"))
    write("avi_NV12_17x33.avi", mux_avi([nv12(x) for x in odd], 17, 33,
                                        fourcc=b"NV12"))
    write("avi_NV12_18x9_padded.avi", mux_avi(
        [padded_rows(nv12(x), [(9, 18), (5, 18)])
         for x in scene(18, 9, 65, 2)], 18, 9, fourcc=b"NV12"))
    write("avi_RGBA_17x33.avi", mux_avi(
        [cv2.cvtColor(x, cv2.COLOR_BGR2RGBA).tobytes() for x in odd], 17, 33,
        fourcc=b"RGBA"))
    # PNG images back to back (png_pipe), one of them gray
    pngs = [cv2.imencode(".png", x)[1].tobytes() for x in scene(48, 32, 66,
                                                                  3)]
    pngs[1] = cv2.imencode(".png", cv2.cvtColor(scene(48, 32, 67, 1)[0],
                                                cv2.COLOR_BGR2GRAY))[1]
    write("png_pipe.bin", b"".join(bytes(p) for p in pngs))
    # a PAM image (no TUPLTYPE line): cv2 opens it and reads no frame
    cv2.imwrite(out("image.pam"), small[0])


def raw_committed_sources():
    """Every committed source of RAW_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(RAW_OUT) if not n.endswith(".json"))


def write_raw(frames) -> None:
    """Write RAW_OUT: the sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(RAW_OUT, exist_ok=True)
    for name in os.listdir(RAW_OUT):
        os.remove(os.path.join(RAW_OUT, name))
    raw_sources(frames)
    digests = {name: digest(os.path.join(RAW_OUT, name))
               for name in raw_committed_sources()}
    with open(os.path.join(RAW_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {name: jax_acq_recon(os.path.join(RAW_OUT, name), n)
                         for name, n in RAW_RECON_SOURCES.items()}}
    with open(os.path.join(RAW_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(RAW_OUT, n))
                for n in os.listdir(RAW_OUT))
    print(f"wrote {RAW_OUT}: {total} bytes")


def demux_sources(frames) -> None:
    """Write the demuxed containers' sources (see the module docstring);
    ``frames`` are the clip's."""
    from fealess_tpu_torch.io.asf import AsfFile
    from fealess_tpu_torch.io.isobmff import Mp4File
    from fealess_tpu_torch.io.mpegps import MpegPsFile
    from fealess_tpu_torch.io.mpegvideo import mpeg4_packets, packets
    from fealess_tpu_torch.io.nut import NutFile
    from fealess_tpu_torch.io.ogg import OggFile
    from tests import stream_mux as sm

    def out(name):
        return os.path.join(DEMUX_OUT, name)

    def write(name, data):
        with open(out(name), "wb") as f:
            f.write(data)
    base = scene(96, 64, 71, 1)[0]
    pan = [_shifted(base, 3 * i, -2 * i) for i in range(8)]
    small = scene(48, 32, 72, 3)
    for cc, ext in DEMUX_WRITER:
        write_ffmpeg_clip(out(f"{ext}_{cc}.{ext}"),
                          small if cc in LOSSLESS else pan, cc)
    write_ffmpeg_clip(out("pan_ts.ts"), [b for b, _ in frames[
        :DEMUX_RECON_SOURCES["pan_ts.ts"]]], "MPG2")
    m2 = MpegPsFile(out("mpg_MPG2.mpg"))._payload
    m4 = MpegPsFile(out("mpg_mp4v.mpg"))._payload
    pictures = packets(m2)
    vops = mpeg4_packets(m4)
    # program streams: MPEG-1 packs and PES headers (stuffing, the STD
    # buffer, PTS and DTS), padding, an audio stream and private stream 2;
    # MPEG-2 packs with stuffing, two PES packets a pack; pictures in PES
    # packets of their own, the stream cut after a picture's last pack
    write("ps_mpeg1_packs.mpg", sm.mux_ps([m2], "mpeg1", "mpeg1", 700,
                                          padding=True, foreign=True))
    write("ps_mpeg2_split.vob", sm.mux_ps([m4], "mpeg2", "mpeg2", 900,
                                          pack_every=2, stuffing=3,
                                          padding=True, foreign=True))
    whole = sm.mux_ps(pictures[:5], chunk=600, end_code=False)
    write("ps_cut.mpg", whole)
    # transport streams: adaptation-field stuffing in every packet (a PES
    # over many packets), PES lengths, MPEG-4 Part 2 as private data that
    # FFmpeg probes, BDAV with null packets, a stream cut before a PES
    write("ts_stuffing.ts", sm.mux_ts(pictures, 0x02, stuff_all=True))
    write("ts_pes_length.ts", sm.mux_ts(vops, 0x10, pes_length=True))
    write("ts_private.ts", sm.mux_ts(vops, 0x06))
    write("bdav_null.m2ts", sm.mux_ts(pictures, 0x02, bdav=True,
                                      null_every=3))
    write("ts_cut.ts", sm.mux_ts(pictures[:5], 0x02))
    # fragmented MP4: sizes from trex, tfhd and trun, each base kind; the
    # writer's one-sample fragments cut before the sixth
    ismv = out("ismv_MJPG.ismv")
    with open(ismv, "rb") as f:
        data = f.read()
    head = data[:data.index(b"moof") - 4]
    with Mp4File(ismv) as mp4:
        samples = list(mp4.frames())
    size = max(len(x) for x in samples)
    padded = [x + bytes(size - len(x)) for x in samples]
    write("fmp4_defaults.ismv", sm.mux_fmp4(
        sm.set_trex(head, 1000, size), padded,
        [{"n": 2, "size": "trex", "base": "moof"},
         {"n": 3, "size": "tfhd", "base": "explicit"},
         {"n": 3, "size": "trun", "base": "none"}]))
    moofs = [i - 4 for i in range(len(data)) if data[i:i + 4] == b"moof"]
    write("fmp4_cut.ismv", data[:moofs[5]])
    # Ogg: a packet over pages of three lacing values, a page with a
    # wrong CRC, the stream cut before its last pages
    ogg = OggFile(out("ogv_VP80.ogv"))
    vp8 = list(ogg._packets())
    span = sm.mux_ogg(vp8, max_segments=3)
    write("ogg_span.ogv", span)
    bad = bytearray(sm.mux_ogg(vp8))
    pages = [i for i in range(len(bad)) if bad[i:i + 4] == b"OggS"]
    bad[pages[5] + 22] ^= 0xFF
    write("ogg_bad_crc.ogv", bytes(bad))
    pages = [i for i in range(len(span)) if span[i:i + 4] == b"OggS"]
    write("ogg_cut.ogv", span[:pages[-4]])
    # FLV: a Metadata tag and a script tag after each frame, a
    # SequenceEnd tag, CodedFramesX; cut after its ninth tag
    with open(out("flv_VP90.flv"), "rb") as f:
        tags = sm.flv_tags(f.read())
    meta = next(t for t in tags if t[0] == 9 and t[2][0] == 0xD4)
    more = []
    for k, t in enumerate(tags):
        coded = t[0] == 9 and t[2][0] in (0x91, 0xA1)
        if coded and k % 2:
            t = (9, t[1], bytes([t[2][0] | 2]) + t[2][1:])   # CodedFramesX
        more.append(t)
        if coded:
            more += [(9, t[1], meta[2]), (18, t[1], tags[0][2])]
    more.append((9, 800, b"\x82vp09"))
    write("flv_metadata.flv", sm.mux_flv(more))
    write("flv_cut.flv", sm.mux_flv(more[:9]))
    # ASF: objects in fragments over 500-byte packets, two payloads a
    # packet, the file cut after its twentieth packet
    asf_path = out("asf_MJPG.asf")
    with open(asf_path, "rb") as f:
        data = f.read()
    header = data[:struct.unpack_from("<Q", data, 16)[0]]
    objects = list(AsfFile(asf_path).frames())
    frag = sm.mux_asf(header, objects, 500)
    write("asf_fragments.asf", frag)
    write("asf_multiple.asf", sm.mux_asf(header, objects, 700, True))
    write("asf_cut.asf", frag[:len(header) + 50 + 500 * 20])
    # NUT: a syncpoint every third frame with an elision header and info
    # packets; a syncpoint with a wrong checksum; no elision table; cut
    # before the third syncpoint
    nut = NutFile(out("nut_mp4v.nut"))
    nut_frames = list(nut.frames())
    args = (nut_frames, b"mp4v", 96, 64, nut.stream.extradata)
    synced = sm.mux_nut(*args, sync_every=3, elide=b"\x00\x00\x01\xb6",
                        info=True)
    write("nut_syncpoints.nut", synced)
    bare = bytearray(sm.mux_nut(*args, sync_every=2, elide=b"\x00\x00\x01"))
    syncs = [i for i in range(len(bare))
             if bare[i:i + 8] == sm.NUT_SYNC]
    bare[syncs[1] + 10] ^= 0x40
    write("nut_bad_syncpoint.nut", bytes(bare))
    write("nut_no_elision_table.nut", sm.mux_nut(*args, table=False))
    write("nut_cut.nut", synced[:[i for i in range(len(synced))
                                  if synced[i:i + 8] == sm.NUT_SYNC][2]])


def h263_edits(packets):
    """The Sorenson clips edited from ``flv1_pan.flv``'s first 14
    ``packets`` (96x64; see the module docstring): name -> packets."""
    from tests import h263_edit as E
    return {
        "flv1_version0.avi": [E.to_version0(p) for p in packets],
        "flv1_type2.avi": [E.set_field(p, "type", 2) if i in (3, 7, 8) else p
                           for i, p in enumerate(packets)],
        "flv1_deblock0.avi": [E.set_field(p, "deblocking", 0)
                              for p in packets],
        "flv1_pei.avi": [E.insert_spare(p, b"\x5a\xa5") if i % 2 else p
                         for i, p in enumerate(packets)],
        "flv1_odd_95x63.avi": [E.set_field(E.set_field(p, "width", 95),
                                           "height", 63) for p in packets],
    }


def h263_sources(frames) -> None:
    """Write the H.263 and Sorenson Spark sources (see the module
    docstring); ``frames`` are the clip's."""
    import cv2
    from fealess_tpu_torch.io.avi import AviFile
    from fealess_tpu_torch.io.flv import FlvFile
    from tests import h263_edit as E

    def out(name):
        return os.path.join(H263_OUT, name)

    def pan(w, h, seed, n, dx=3, dy=-2):
        base = scene(w, h, seed, 1)[0]
        return [_shifted(base, dx * i, dy * i) for i in range(n)]

    def smooth(w, h, seed, n):
        big = cv2.GaussianBlur(cv2.resize(scene(w // 8, h // 8, seed, 1)[0],
                                          (w, h),
                                          interpolation=cv2.INTER_CUBIC),
                               (9, 9), 0)
        return [_shifted(big, 5 * i, 3 * i) for i in range(n)]
    # H.263 at its five sizes, a pan long enough for a second I picture,
    # each fourcc and container the writer writes it in
    write_ffmpeg_clip(out("h263_pan.avi"), pan(176, 144, 61, 14), "H263")
    write_ffmpeg_clip(out("h263_128x96.avi"), pan(128, 96, 62, 4), "H263")
    write_ffmpeg_clip(out("h263_352x288.avi"), pan(352, 288, 63, 3), "H263")
    write_ffmpeg_clip(out("h263_704x576.avi"), smooth(704, 576, 64, 2),
                      "H263")
    write_ffmpeg_clip(out("h263_1408x1152.avi"), smooth(1408, 1152, 65, 2),
                      "H263")
    small = pan(128, 96, 66, 3)
    for cc, name in (("U263", "h263_U263.avi"), ("h263", "h263_h263.mov"),
                     ("s263", "h263_s263.3gp"), ("H263", "h263_H263.3g2"),
                     ("H263", "h263.mkv"), ("H263", "h263.asf"),
                     ("H263", "h263.nut")):
        write_ffmpeg_clip(out(name), small, cc)
    with AviFile(out("h263_pan.avi")) as avi:
        h263_packets = list(avi.frames())
    with open(out("h263_pei.avi"), "wb") as f:
        f.write(mux_avi([E.insert_spare(p, b"\x01\x02\x03")
                         for p in h263_packets[:5]], 176, 144,
                        fourcc=b"H263"))
    # Sorenson Spark: a 30-frame pan (I pictures at 0, 12 and 24) in FLV,
    # each container the writer writes it in, any size, checkerboards at
    # its quantiser (11-bit escapes), fast motion (vectors past the edge,
    # intra macroblocks in P pictures)
    write_ffmpeg_clip(out("flv1_pan.flv"), pan(96, 64, 67, 30), "FLV1")
    small = pan(96, 64, 68, 4)
    for cc, name in (("FLV1", "flv1.swf"), ("FLV1", "flv1_FLV1.avi"),
                     ("s263", "flv1_s263.avi"), ("FLV1", "flv1.mov"),
                     ("FLV1", "flv1.asf"), ("FLV1", "flv1.nut")):
        write_ffmpeg_clip(out(name), small, cc)
    write_ffmpeg_clip(out("flv1_128x96.mkv"), pan(128, 96, 69, 4), "FLV1")
    for w, h in ((16, 16), (17, 15), (95, 63)):
        write_ffmpeg_clip(out(f"flv1_{w}x{h}.avi"), pan(w, h, 70, 4, 1, -1),
                          "FLV1")
    write_ffmpeg_clip(out("flv1_1280x720.flv"), smooth(1280, 720, 71, 2),
                      "FLV1")
    yy, xx = np.mgrid[0:64, 0:96]
    checker = (((xx + yy) % 2) * 255).astype(np.uint8)
    write_ffmpeg_clip(out("flv1_checker.avi"),
                      [np.stack([np.roll(checker, i, 1)] * 3, -1)
                       for i in range(3)], "FLV1")
    write_ffmpeg_clip(out("flv1_motion.avi"),
                      pan(128, 96, 72, 8, 37, -11), "FLV1")
    packets = list(FlvFile(out("flv1_pan.flv")).frames())[:14]
    for name, data in h263_edits(packets).items():
        w, h = (95, 63) if "95x63" in name else (96, 64)
        with open(out(name), "wb") as f:
            f.write(mux_avi(data, w, h, fourcc=b"FLV1"))
    write_ffmpeg_clip(out("pan_flv1.flv"), [b for b, _ in frames[
        :H263_RECON_SOURCES["pan_flv1.flv"]]], "FLV1")


def _pan(w, h, seed, n, dx=3, dy=-2):
    """``n`` frames of a seeded scene panned (dx, dy) pixels a frame."""
    base = scene(w, h, seed, 1)[0]
    return [_shifted(base, dx * i, dy * i) for i in range(n)]


def _halves(w, h, v, n):
    """The top half panned right, the bottom half left, ``v`` pixels a
    frame (intra macroblocks in P pictures, MV escapes)."""
    a, b = scene(w, h, 21, 1)[0], scene(w, h, 22, 1)[0]
    frames = []
    for i in range(n):
        f = _shifted(a, v * i, 0)
        f[h // 2:] = _shifted(b, -v * i, 0)[h // 2:]
        frames.append(f)
    return frames


def _appear(w, h, n):
    """A blurred slow pan with a noise square appearing each frame from
    the fifth on (P pictures after P pictures that pick the low motion
    run/level tables, with intra macroblocks)."""
    import cv2
    base = cv2.GaussianBlur(scene(w, h, 23, 1)[0], (7, 7), 0)
    rng, frames = np.random.default_rng(5), []
    for i in range(n):
        f = _shifted(base, i, 0)
        if i >= 4:
            y, x = rng.integers(0, h - 16), rng.integers(0, w - 16)
            f[y:y + 16, x:x + 16] = rng.integers(0, 255, (16, 16, 3))
        frames.append(f)
    return frames


def _split():
    """Black and white halves at 96x64 (DC differences past the DC
    tables' escape), then moved."""
    f = np.zeros((64, 96, 3), np.uint8)
    f[:, 48:] = 255
    return [f, f, np.roll(f, 8, 1)]


def _checker():
    """Three 96x64 checkerboards of one-pixel squares, each moved a pixel
    (third escapes)."""
    yy, xx = np.mgrid[0:64, 0:96]
    checker = (((xx + yy) % 2) * 255).astype(np.uint8)
    return [np.stack([np.roll(checker, i, 1)] * 3, -1) for i in range(3)]


def msmpeg4_sources(frames) -> None:
    """Write the MS MPEG-4 v2 / v3 and WMV7 sources (see
    ``tests/test_torch_msmpeg4.py``); ``frames`` are the clip's."""
    import cv2
    from fealess_tpu_torch.io.avi import AviFile

    def out(name):
        return os.path.join(MSMPEG4_OUT, name)

    pan, halves, appear, split = _pan, _halves, _appear, _split
    checker = _checker()
    # every fourcc alias in AVI at 96x64
    small = pan(96, 64, 81, 4)
    for cc in MSMPEG4_ALIASES:
        write_ffmpeg_clip(out(f"ms_{cc}.avi"), small, cc)
    # the writer puts MP43 in AVI for 3IVD (its MOV tag); FFmpeg's AVI
    # demuxer takes 3IVD too: the DIV3 packets under it
    with AviFile(out("ms_DIV3.avi")) as avi:
        packets = list(avi.frames())
    with open(out("ms_3IVD.avi"), "wb") as f:
        f.write(mux_avi(packets, 96, 64, fourcc=b"3IVD"))
    for cc, tag in (("MP42", "v2"), ("DIV3", "v3"), ("WMV1", "wmv1")):
        # each codec in each container the writer writes it in
        for ext in ("mov", "mkv", "asf", "wmv", "nut"):
            write_ffmpeg_clip(out(f"{tag}.{ext}"), small, cc)
        # 14 frames (a second I picture at 12), 128x96 at 30 fps, 640x480
        write_ffmpeg_clip(out(f"{tag}_pan.avi"), pan(96, 64, 82, 14), cc)
        write_ffmpeg_clip(out(f"{tag}_128x96_30fps.avi"),
                          pan(128, 96, 83, 6), cc, 30)
        write_ffmpeg_clip(out(f"{tag}_640x480.avi"),
                          pan(640, 480, 84, 3, 5, -3), cc)
        # checkerboards (third escapes), halves moving apart, squares
        # appearing, black and white halves
        write_ffmpeg_clip(out(f"{tag}_checker.avi"), checker, cc)
        write_ffmpeg_clip(out(f"{tag}_halves.avi"), halves(96, 64, 8, 6), cc)
        write_ffmpeg_clip(out(f"{tag}_appear.avi"), appear(96, 64, 12), cc)
        write_ffmpeg_clip(out(f"{tag}_split.avi"), split(), cc)
        # the writer writes even sizes only (95x63 as 94x62): its packets
        # under a 95x63 header
        write_ffmpeg_clip(out("odd.avi"), pan(95, 63, 85, 4, 1, -1), cc)
        with AviFile(out("odd.avi")) as avi:
            packets = list(avi.frames())
        os.remove(out("odd.avi"))
        with open(out(f"{tag}_95x63.avi"), "wb") as f:
            f.write(mux_avi(packets, 95, 63, fourcc=cc.encode()))
    # WMV7 P pictures above 320x240 pixels' worth or 128 kbit/s decode
    # intra macroblocks without the inter-intra prediction
    write_ffmpeg_clip(out("wmv1_halves_128x96_30fps.avi"),
                      halves(128, 96, 8, 6), "WMV1", 30)
    write_ffmpeg_clip(out("pan_div3.avi"), [b for b, _ in frames[
        :MSMPEG4_RECON_SOURCES["pan_div3.avi"]]], "DIV3")


def _noise_pan(w, h, n, fresh, seed=1):
    """``n`` frames of uniform noise panned (2, 1) pixels a frame, the top
    ``fresh`` share of each frame's rows new noise: the writer's rate
    control raises the quantiser picture by picture, P pictures crossing
    qscale 10 and 20."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 64, w + 200, 3), dtype=np.uint8)
    frames = []
    for i in range(n):
        f = big[32 + i:32 + i + h, 8 + 2 * i:8 + 2 * i + w].copy()
        rows = int(h * fresh)
        f[:rows] = rng.integers(0, 256, (rows, w, 3), dtype=np.uint8)
        frames.append(f)
    return frames


def wmv2_sources(frames) -> None:
    """Write the WMV8 sources (see ``tests/test_torch_wmv2.py``);
    ``frames`` are the clip's."""
    from fealess_tpu_torch.io.avi import AviFile
    from tests import wmv2_edit

    def out(name):
        return os.path.join(WMV2_OUT, name)

    # the 96x64 pan in every container the writer writes WMV8 in
    for ext in WMV2_CONTAINERS:
        write_ffmpeg_clip(out(f"wmv2.{ext[1:]}"), _pan(96, 64, 81, 4),
                          "WMV2")
    # 14 frames (a second I picture at 12), 128x96 at 30 fps, 640x480
    write_ffmpeg_clip(out("wmv2_pan.avi"), _pan(96, 64, 82, 14), "WMV2")
    write_ffmpeg_clip(out("wmv2_128x96_30fps.avi"), _pan(128, 96, 83, 6),
                      "WMV2", 30)
    write_ffmpeg_clip(out("wmv2_640x480.avi"), _pan(640, 480, 84, 3, 5, -3),
                      "WMV2")
    # checkerboards (third escapes), halves moving apart, squares
    # appearing, black and white halves
    write_ffmpeg_clip(out("wmv2_checker.avi"), _checker(), "WMV2")
    write_ffmpeg_clip(out("wmv2_halves.avi"), _halves(96, 64, 8, 6), "WMV2")
    write_ffmpeg_clip(out("wmv2_appear.avi"), _appear(96, 64, 12), "WMV2")
    write_ffmpeg_clip(out("wmv2_split.avi"), _split(), "WMV2")
    # noise whose P pictures pick each of the three CBP tables by qscale
    # band (up to 10, 11-20, over 20)
    write_ffmpeg_clip(out("wmv2_qscale_bands.avi"),
                      _noise_pan(96, 64, 13, 0.25), "WMV2")
    # that noise re-encoded with run/level tables 1 and 2 and cbp_index 1
    # and 2: the same coefficients, so cv2 gives the same frames
    with AviFile(out("wmv2_qscale_bands.avi")) as avi:
        packets, extradata = list(avi.frames()), avi.stream.extradata
    for rl, rl_chroma, cbp_index in WMV2_RETABLED:
        with open(out(f"wmv2_rl{rl}_rlc{rl_chroma}_cbp{cbp_index}.avi"),
                  "wb") as f:
            f.write(mux_avi(wmv2_edit.retable(packets, 96, 64, rl, rl_chroma,
                                              cbp_index), 96, 64,
                            fourcc=b"WMV2", extradata=extradata))
    # the writer writes even sizes only (95x63 as 94x62): that file, and
    # its packets under a 95x63 header
    write_ffmpeg_clip(out("wmv2_94x62.avi"), _pan(95, 63, 85, 4, 1, -1),
                      "WMV2")
    with AviFile(out("wmv2_94x62.avi")) as avi:
        packets, extradata = list(avi.frames()), avi.stream.extradata
    with open(out("wmv2_95x63.avi"), "wb") as f:
        f.write(mux_avi(packets, 95, 63, fourcc=b"WMV2",
                        extradata=extradata))
    write_ffmpeg_clip(out("pan_wmv2.wmv"), [b for b, _ in frames[
        :WMV2_RECON_SOURCES["pan_wmv2.wmv"]]], "WMV2")


def wmv2_committed_sources():
    """Every committed source of WMV2_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(WMV2_OUT)
                  if n.endswith(WMV2_CONTAINERS))


def write_wmv2(frames) -> None:
    """Write WMV2_OUT: the sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(WMV2_OUT, exist_ok=True)
    for name in os.listdir(WMV2_OUT):
        os.remove(os.path.join(WMV2_OUT, name))
    wmv2_sources(frames)
    digests = {name: digest(os.path.join(WMV2_OUT, name))
               for name in wmv2_committed_sources()}
    with open(os.path.join(WMV2_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {
        name: jax_acq_recon(os.path.join(WMV2_OUT, name), n)
        for name, n in WMV2_RECON_SOURCES.items()}}
    with open(os.path.join(WMV2_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(WMV2_OUT, n))
                for n in os.listdir(WMV2_OUT))
    print(f"wrote {WMV2_OUT}: {total} bytes")


def msmpeg4_committed_sources():
    """Every committed source of MSMPEG4_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(MSMPEG4_OUT)
                  if n.endswith(MSMPEG4_CONTAINERS))


def write_msmpeg4(frames) -> None:
    """Write MSMPEG4_OUT: the sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(MSMPEG4_OUT, exist_ok=True)
    for name in os.listdir(MSMPEG4_OUT):
        os.remove(os.path.join(MSMPEG4_OUT, name))
    msmpeg4_sources(frames)
    digests = {name: digest(os.path.join(MSMPEG4_OUT, name))
               for name in msmpeg4_committed_sources()}
    with open(os.path.join(MSMPEG4_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {
        name: jax_acq_recon(os.path.join(MSMPEG4_OUT, name), n)
        for name, n in MSMPEG4_RECON_SOURCES.items()}}
    with open(os.path.join(MSMPEG4_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(MSMPEG4_OUT, n))
                for n in os.listdir(MSMPEG4_OUT))
    print(f"wrote {MSMPEG4_OUT}: {total} bytes")


def h263_committed_sources():
    """Every committed source of H263_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(H263_OUT)
                  if n.endswith(H263_CONTAINERS))


def write_h263(frames) -> None:
    """Write H263_OUT: the sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(H263_OUT, exist_ok=True)
    for name in os.listdir(H263_OUT):
        os.remove(os.path.join(H263_OUT, name))
    h263_sources(frames)
    digests = {name: digest(os.path.join(H263_OUT, name))
               for name in h263_committed_sources()}
    with open(os.path.join(H263_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {name: jax_acq_recon(os.path.join(H263_OUT, name), n)
                         for name, n in H263_RECON_SOURCES.items()}}
    with open(os.path.join(H263_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(H263_OUT, n))
                for n in os.listdir(H263_OUT))
    print(f"wrote {H263_OUT}: {total} bytes")


def demux_committed_sources():
    """Every committed source of DEMUX_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(DEMUX_OUT)
                  if not n.endswith(".json"))


def write_demux(frames) -> None:
    """Write DEMUX_OUT: the sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(DEMUX_OUT, exist_ok=True)
    for name in os.listdir(DEMUX_OUT):
        os.remove(os.path.join(DEMUX_OUT, name))
    demux_sources(frames)
    digests = {name: digest(os.path.join(DEMUX_OUT, name))
               for name in demux_committed_sources()}
    with open(os.path.join(DEMUX_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {name: jax_acq_recon(os.path.join(DEMUX_OUT, name),
                                             n)
                         for name, n in DEMUX_RECON_SOURCES.items()}}
    with open(os.path.join(DEMUX_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(DEMUX_OUT, n))
                for n in os.listdir(DEMUX_OUT))
    print(f"wrote {DEMUX_OUT}: {total} bytes")


def committed_sources():
    """Every committed source of OUT that ``digests.json`` lists."""
    return sorted([n for n in os.listdir(OUT) if n.endswith(CONTAINERS)]
                  + list(PATH_SOURCES))


def jax_acq_recon(source: str, frames: int) -> dict:
    """The JAX CLI's acq from ``source`` with the committed depth
    directory (the pixel digests of what it wrote), then its recon lines
    on that package (:func:`tests.make_torch_frames.jax_recon`)."""
    from fealess_tpu.apps import cli as jax_cli
    from tests.make_torch_frames import jax_recon
    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "pkg")
        assert jax_cli.main(["acq", source, pkg, "--depth-dir",
                             os.path.join(OUT, "depth")]) == 0
        out = {"acq": {sub: pixel_digests(os.path.join(pkg, sub))
                       for sub in ("gray", "depth")}}
        out.update(jax_recon(pkg, frames))
    return out


def clip_frames():
    """The fixture clip's frames: (bgr, depth x10 as u16) of the fixture's
    first ``CLIP_FRAMES`` pan frames."""
    sys.path.insert(0, REPO)
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.io.png import read_png
    bgr = read_png(os.path.join(fixture.FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(fixture.FIXTURE, "scene_depth.png"))
    return [(b, (d.astype(np.uint32) * 10).astype(np.uint16))
            for b, d in fixture.pan(bgr, depth, CLIP_FRAMES)]


def pixel_digests(directory: str) -> dict:
    """sha256 of each PNG's pixels under ``directory`` (cv2.imread,
    IMREAD_UNCHANGED): the port's PNG writer compresses differently from
    cv2's, so the files are held by what they decode to."""
    import cv2
    return {name: sha256(cv2.imread(os.path.join(directory, name),
                                    cv2.IMREAD_UNCHANGED))
            for name in sorted(os.listdir(directory))}


def main() -> None:
    import cv2
    import shutil
    os.makedirs(os.path.join(OUT, "depth"), exist_ok=True)
    for name in os.listdir(OUT):
        if name.endswith(CONTAINERS):
            os.remove(os.path.join(OUT, name))
    for d in SOURCE_DIRS:
        shutil.rmtree(os.path.join(OUT, d), ignore_errors=True)
    frames = clip_frames()
    write_cv2_clip(os.path.join(OUT, "clip.avi"), [b for b, _ in frames],
                   "MJPG")
    for i, (_, d) in enumerate(frames):
        cv2.imwrite(os.path.join(OUT, "depth", f"{i}.png"), d)
    write_cv2_clip(os.path.join(OUT, "ffv1.avi"), scene(96, 64, 5, 3),
                   "FFV1")
    write_cv2_clip(os.path.join(OUT, "ffv1_640.avi"), [frames[0][0]],
                   "FFV1")
    for name, data in hand_clips().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
    other_sources(frames)
    mpeg4_sources(frames)
    digests = {name: digest(os.path.join(OUT, name))
               for name in committed_sources()}
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    # the JAX CLI on the clip: acq with the depth directory, then recon
    # (a) and (b) on what it wrote
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = jax_acq_recon(os.path.join(OUT, "clip.avi"), CLIP_FRAMES)
    recon["sources"] = {name: jax_acq_recon(os.path.join(OUT, name), n)
                        for name, n in RECON_SOURCES.items()}
    with open(os.path.join(OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(dp, n))
                for dp, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {OUT}: {total} bytes")
    write_vp8(frames)
    write_vp9(frames)
    write_mpeg2(frames)
    write_raw(frames)
    write_demux(frames)
    write_h263(frames)


def vp9_committed_sources():
    """Every committed source of VP9_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(VP9_OUT)
                  if n.endswith(CONTAINERS + (".webm",)))


def write_vp9(frames) -> None:
    """Write VP9_OUT: the VP9 sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(VP9_OUT, exist_ok=True)
    for name in os.listdir(VP9_OUT):
        os.remove(os.path.join(VP9_OUT, name))
    vp9_sources(frames)
    digests = {name: digest(os.path.join(VP9_OUT, name))
               for name in vp9_committed_sources()}
    with open(os.path.join(VP9_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {name: jax_acq_recon(os.path.join(VP9_OUT, name), n)
                         for name, n in VP9_RECON_SOURCES.items()}}
    with open(os.path.join(VP9_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(VP9_OUT, n))
                for n in os.listdir(VP9_OUT))
    print(f"wrote {VP9_OUT}: {total} bytes")


def mpeg2_committed_sources():
    """Every committed source of MPEG2_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(MPEG2_OUT)
                  if n.endswith(MPEG2_CONTAINERS))


def write_mpeg2(frames) -> None:
    """Write MPEG2_OUT: the MPEG-2 sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``)."""
    os.makedirs(MPEG2_OUT, exist_ok=True)
    for name in os.listdir(MPEG2_OUT):
        os.remove(os.path.join(MPEG2_OUT, name))
    mpeg2_sources(frames)
    digests = {name: digest(os.path.join(MPEG2_OUT, name))
               for name in mpeg2_committed_sources()}
    with open(os.path.join(MPEG2_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {name: jax_acq_recon(os.path.join(MPEG2_OUT, name),
                                             n)
                         for name, n in MPEG2_RECON_SOURCES.items()}}
    with open(os.path.join(MPEG2_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(MPEG2_OUT, n))
                for n in os.listdir(MPEG2_OUT))
    print(f"wrote {MPEG2_OUT}: {total} bytes")


def vp8_committed_sources():
    """Every committed source of VP8_OUT (its ``digests.json`` lists
    them)."""
    return sorted(n for n in os.listdir(VP8_OUT)
                  if n.endswith(CONTAINERS + (".webm",)))


def write_vp8(frames) -> None:
    """Write VP8_OUT: the VP8 sources, their ``digests.json`` and
    ``recon.json`` (the JAX CLI's acq and recon under ``"sources"``, as
    OUT's)."""
    os.makedirs(VP8_OUT, exist_ok=True)
    for name in os.listdir(VP8_OUT):
        os.remove(os.path.join(VP8_OUT, name))
    vp8_sources(frames)
    digests = {name: digest(os.path.join(VP8_OUT, name))
               for name in vp8_committed_sources()}
    with open(os.path.join(VP8_OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    import jax
    jax.config.update("jax_platforms", "cpu")
    recon = {"sources": {name: jax_acq_recon(os.path.join(VP8_OUT, name), n)
                         for name, n in VP8_RECON_SOURCES.items()}}
    with open(os.path.join(VP8_OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(VP8_OUT, n))
                for n in os.listdir(VP8_OUT))
    print(f"wrote {VP8_OUT}: {total} bytes")


if __name__ == "__main__":
    if sys.argv[1:] == ["vp8"]:
        write_vp8(clip_frames())
    elif sys.argv[1:] == ["vp9"]:
        write_vp9(clip_frames())
    elif sys.argv[1:] == ["mpeg2"]:
        write_mpeg2(clip_frames())
    elif sys.argv[1:] == ["raw"]:
        write_raw(clip_frames())
    elif sys.argv[1:] == ["demux"]:
        write_demux(clip_frames())
    elif sys.argv[1:] == ["h263"]:
        write_h263(clip_frames())
    elif sys.argv[1:] == ["msmpeg4"]:
        write_msmpeg4(clip_frames())
    elif sys.argv[1:] == ["wmv2"]:
        write_wmv2(clip_frames())
    else:
        main()
