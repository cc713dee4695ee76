"""MPEG-2 in the port (``csrc/mpeg2_decode.c`` through ``io/mpeg2.py`` and
``io/video.VideoReader``) against cv2 5.0.0 and the JAX package: the
committed clips (``tests/data/torch_mpeg2``: ``cv2.VideoWriter``'s MPG2
in AVI, MP4, MOV and Matroska at 1280x720, 640x480, 96x64, 94x62 and
16x16, a closed then an open GOP, noise of I and B pictures only, motion
past f_code 1, 2 and 60 fps, the AVI fourcc MPEG; streams edited by
``tests/mpeg2_edit.py``: loaded matrices, extensions, user data,
broken_link, sequence end codes, cuts before an open GOP, low_delay,
quantisers and extra information on slices, a B picture's intra
macroblock, an odd width, extradata) decode to cv2's frame count and
per-frame sha256; together they reach every syntax path the decoder takes
(its counters); each tool it does not read is refused by name; a packet
cut short ends the reader; mutated packets never crash it; and ``acq``
from the 640x480 MP4 clip writes the JAX CLI's pixels, on which ``recon``
prints the JAX CLI's lines (recorded by ``tests/make_torch_video.py``)."""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import mpeg2
from fealess_tpu_torch.io.avi import AviFile
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.matroska import MkvFile
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import mpeg2_edit as E
from tests.make_torch_video import (MPEG2_OUT, MPEG2_RECON_SOURCES, OUT,
                                    cv2_frames, digest, mpeg2_committed_sources,
                                    mpeg2_edits, mux_avi, sha256)

torch.set_num_threads(1)

CLIPS = mpeg2_committed_sources()
with open(os.path.join(MPEG2_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)
# what cv2.VideoWriter's streams hold: every path but these
EDITED_ONLY = {"SEQ_EXTRADATA", "DISPLAY_EXT", "MATRIX_LOADED",
               "QUANT_MATRIX_EXT", "OTHER_EXT", "BROKEN_LINK", "USER_DATA",
               "SEQ_END", "B_DROPPED", "GREY_FORWARD", "LOW_DELAY",
               "SLICE_EXTRA", "I_MB_QUANT", "P_QUANT", "B_QUANT", "B_INTRA",
               "Q_FINE", "Q_COARSE"}


def _packets(name: str):
    path = os.path.join(MPEG2_OUT, name)
    if name.endswith(".avi"):
        with AviFile(path) as avi:
            return list(avi.frames())
    with MkvFile(path) as mkv:
        return list(mkv.frames())


PAN = _packets("mpeg2_pan96.avi")
WRITTEN = [n for n in CLIPS if n not in mpeg2_edits(PAN)]


def _decode_all(name: str):
    """(frames, path counts) of a committed clip through one Mpeg2Decoder
    over the demuxer's packets, drained at the end."""
    reader = VideoReader(os.path.join(MPEG2_OUT, name))
    try:
        dec = mpeg2.Mpeg2Decoder(reader.extradata, name, reader.container)
        frames = [f for p in reader._packets() for f in dec.decode(p)]
        frames += dec.flush()
        counts = dec.counts()
        dec.close()
    finally:
        reader.close()
    return frames, counts


def _avi(tmp_path, name, packets, w=96, h=64):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(mux_avi(packets, w, h, fourcc=b"mpg2"))
    return path


def test_committed_sources_are_the_digests_and_stay_small():
    assert CLIPS == sorted(DIGESTS)
    assert sum(os.path.getsize(os.path.join(MPEG2_OUT, n))
               for n in os.listdir(MPEG2_OUT)) < 1_000_000


@pytest.mark.parametrize("name", CLIPS)
def test_committed_clip_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them:
    frame count, shapes and each frame's sha256."""
    path = os.path.join(MPEG2_OUT, name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        assert reader.codec == "mpeg2"
        got = list(reader)
    assert {"frames": len(got), "shapes": [list(f.shape) for f in got],
            "sha256": [sha256(f) for f in got]} == DIGESTS[name]


def test_clips_cover_every_container_and_path():
    """The clips cv2.VideoWriter wrote hold AVI, MP4, MOV and Matroska, I,
    P and B pictures, a closed and an open GOP, and every syntax path but
    those only an edited stream shows; with the edited clips every path
    the decoder takes is reached."""
    exts, total, written = set(), dict.fromkeys(mpeg2.PATHS, 0), \
        dict.fromkeys(mpeg2.PATHS, 0)
    for name in CLIPS:
        frames, counts = _decode_all(name)
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
            if name in WRITTEN:
                written[k] += v
        if name in WRITTEN:
            exts.add(os.path.splitext(name)[1])
    assert exts == {".avi", ".mkv", ".mp4", ".mov"}
    assert [k for k, v in total.items() if not v] == []
    assert {k for k, v in written.items() if not v} == EDITED_ONLY
    _, pan = _decode_all("mpeg2_pan.mp4")
    assert pan["GOP_CLOSED"] == pan["GOP_OPEN"] == 1
    assert (pan["I_PIC"], pan["P_PIC"], pan["B_PIC"]) == (2, 4, 10)
    _, noise = _decode_all("mpeg2_noise.avi")
    assert noise["P_PIC"] == 0 and noise["I_PIC"] and noise["B_PIC"]


def test_edited_clips_come_from_their_edits():
    """Each edited clip is mpeg2_pan96.avi's packets through
    make_torch_video.mpeg2_edits (so the committed bytes are what the edit
    makes); the Matroska one carries the sequence header as CodecPrivate."""
    for name, (packets, private) in mpeg2_edits(PAN).items():
        assert _packets(name) == packets, name
        if private is not None:
            with MkvFile(os.path.join(MPEG2_OUT, name)) as mkv:
                assert mkv.track.codec_private == private


def test_b_pictures_leave_in_display_order():
    """An I or P picture leaves one anchor late, a B picture at once, the
    last anchor at the drain; the frames are cv2's in its order."""
    dec = mpeg2.Mpeg2Decoder()
    got, released = [], []
    for p in PAN:
        frames = dec.decode(p)
        released.append(len(frames))
        got += frames
    assert released == [0] + [1] * 15
    last = dec.flush()
    assert len(last) == 1 and dec.flush() == []
    want = cv2_frames(os.path.join(MPEG2_OUT, "mpeg2_pan96.avi"))
    assert len(got + last) == len(want) == 16
    for a, b in zip(got + last, want):
        np.testing.assert_array_equal(a, b)


def test_open_gop_cut_drops_its_b_pictures_as_ffmpeg():
    """The clip cut before its open GOP: cv2 gives 4 frames (FFmpeg drops
    the B pictures that lack their forward reference), and 6 when the GOP
    says it is closed (they are predicted from a grey picture)."""
    for name, n, path in (("mpeg2_open_gop_start.avi", 4, "B_DROPPED"),
                          ("mpeg2_closed_gop_start.avi", 6, "GREY_FORWARD")):
        frames, counts = _decode_all(name)
        assert len(frames) == DIGESTS[name]["frames"] == n
        assert counts[path] > 0


def _units(packet, code):
    return [u for u in E.units(packet) if E.code(u) == code]


def _edit(packets, index, fn):
    """``packets`` with packet ``index``'s units through ``fn``."""
    out = list(packets)
    out[index] = E.join(fn(E.units(out[index])))
    return out


def _field(packets, index, kind, field, value):
    """Set ``field`` in each unit that ``kind`` picks in packet
    ``index``."""
    table = {"seq": E.SEQ_FIELDS, "seq_ext": E.SEQ_EXT_FIELDS,
             "coding_ext": E.CODING_EXT_FIELDS,
             "picture": E.PICTURE_FIELDS}[kind]
    pick = {"seq": lambda u: E.code(u) == E.SEQ,
            "seq_ext": lambda u: E.ext_id(u) == 1,
            "coding_ext": lambda u: E.ext_id(u) == 8,
            "picture": lambda u: E.code(u) == E.PICTURE}[kind]
    return _edit(packets, index, lambda us: [
        E.set_field(u, *table[field], value) if pick(u) else u for u in us])


def _after(packets, index, kind, new):
    def fn(us):
        out = []
        for u in us:
            out.append(u)
            if E.ext_id(u) == kind or (kind == 0 and E.code(u) == E.SEQ):
                out += new
        return out
    return _edit(packets, index, fn)


def _refusals():
    """(case id, packets, the name the refusal gives)."""
    p = PAN
    head = [u for u in E.units(p[0]) if E.code(u) in (E.SEQ, E.GOP)
            or E.ext_id(u) == 1]
    fcode = int(E._bits(_units(p[1], E.EXT)[-1][4:6])[4:8], 2)
    cases = [
        ("field_picture", _field(p, 0, "coding_ext", "picture_structure", 1),
         "field pictures"),
        ("interlaced", _field(p, 0, "seq_ext", "progressive_sequence", 0),
         "interlaced sequence"),
        ("field_motion", _field(p, 0, "coding_ext", "frame_pred_frame_dct",
                                0), "frame_pred_frame_dct 0"),
        ("chroma_422", _field(p, 0, "seq_ext", "chroma_format", 2), "4:2:2"),
        ("chroma_444", _field(p, 0, "seq_ext", "chroma_format", 3), "4:4:4"),
        ("dc_precision", _field(p, 0, "coding_ext", "intra_dc_precision", 1),
         "intra_dc_precision"),
        ("q_scale_type", _field(p, 0, "coding_ext", "q_scale_type", 1),
         "q_scale_type 1"),
        ("intra_vlc", _field(p, 0, "coding_ext", "intra_vlc_format", 1),
         "intra_vlc_format 1"),
        ("alternate_scan", _field(p, 0, "coding_ext", "alternate_scan", 1),
         "alternate scan"),
        ("concealment", _field(p, 0, "coding_ext",
                               "concealment_motion_vectors", 1),
         "concealment motion vectors"),
        ("scalable", _after(p, 0, 1, [b"\x00\x00\x01\xb5\x50\x00\x00"]),
         "scalable extension"),
        ("d_picture", _field(p, 0, "picture", "picture_coding_type", 4),
         "D pictures"),
        ("mpeg1", _edit(p, 0, lambda us: [u for u in us
                                          if E.ext_id(u) != 1]), "MPEG-1"),
        ("resize", _field(p, 10, "seq", "width", 80),
         "changes the frame size"),
        ("odd_height", _field(p, 0, "seq", "height", 63),
         "odd frame height"),
        ("matrix", _after(p, 0, 1, [E.display_extension(96, 64, 1)]),
         "colour matrix"),
        ("tmpgexs", _after(p, 0, 0, [E.user_data(
            b"\x00TMPGEXS\x00" + bytes(24))]), "TMPGEnc"),
        ("mv_outside", p[:1] + [E.push_first_vector(p[1], fcode)] + p[2:],
         "outside the picture"),
        ("two_pictures", p[:2] + [p[2] + p[3]] + p[4:],
         "several pictures in one packet"),
        ("no_reference", [E.join(head + [u for u in E.units(p[1])
                                         if E.code(u) != -1])],
         "without its reference"),
        ("no_coding_ext", _edit(p, 0, lambda us: [u for u in us
                                                  if E.ext_id(u) != 8]),
         "without a picture coding extension"),
        ("no_picture", p[:1] + [E.join(head)] + p[1:],
         "holds no picture"),
    ]
    return cases


REFUSALS = _refusals()


def test_every_refusal_code_has_a_case():
    assert len(REFUSALS) == len(mpeg2.REFUSED)


@pytest.mark.parametrize("case,packets,match", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_each_tool_outside_the_set_is_refused_by_name(tmp_path, case,
                                                      packets, match):
    """A header asking for what the port does not decode: UnsupportedImage
    naming it, at the packet that shows it; through VideoReader,
    UnsupportedVideo naming the container, the codec and the tool."""
    dec = mpeg2.Mpeg2Decoder(what=case)
    with pytest.raises(UnsupportedImage, match=match):
        for p in packets:
            dec.decode(p)
    dec.close()
    path = _avi(tmp_path, f"{case}.avi", packets)
    with pytest.raises(UnsupportedVideo,
                       match=f"AVI with MPEG-2 video using .*{match}"):
        list(VideoReader(path))


@pytest.mark.parametrize("matrix", [2, 5, 6, 1])
def test_colour_matrices_convert_as_cv2_or_are_refused(tmp_path, matrix):
    """A sequence display extension's matrix_coefficients 2, 5 and 6 (BT.601's
    coefficients) give cv2's frames; 1 (BT.709) is refused, as cv2's frame
    is then neither range's BT.601 conversion of the decoded planes."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    packets = _after(PAN[:4], 0, 1, [E.display_extension(96, 64, matrix)])
    path = _avi(tmp_path, "matrix.avi", packets)
    want = cv2_frames(path)
    if matrix != 1:
        got = list(VideoReader(path))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    with pytest.raises(UnsupportedVideo, match="colour matrix"):
        list(VideoReader(path))
    dec = mpeg2.Mpeg2Decoder()
    (first,) = [f for p in PAN[:2] for f in dec.decode(p)]
    planes = dec.planes()
    for full in (False, True):
        assert not np.array_equal(want[0], yuv420p_to_bgr(*planes, full))


def test_a_packet_cut_short_ends_the_reader(tmp_path):
    """The fourth packet (a B picture) cut in half: FFmpeg conceals the
    macroblocks it lacks and cv2 goes on, which no reader can match; the
    reader gives cv2's frames before it and ends.  Cut packets to the
    decoder alone raise DecodeError."""
    packets = PAN[:3] + [PAN[3][:len(PAN[3]) // 2]] + PAN[4:]
    path = _avi(tmp_path, "cut.avi", packets)
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == 2 and len(want) == 16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for cut in (PAN[0][:len(PAN[0]) // 2], PAN[0][:40], b"\x00\x00\x01"):
        dec = mpeg2.Mpeg2Decoder()
        with pytest.raises((DecodeError, UnsupportedImage)):
            dec.decode(cut)
        dec.close()


def test_mp4_object_types_read_as_cv2(tmp_path):
    """MP4's mp4v with object types 0x60-0x65 (the MPEG-2 profiles; the
    writer's 0x61 and MOV's m2v1 entry are committed clips): the frames
    cv2 reads."""
    from tests.test_torch_containers import mux_mp4
    for ot in (0x60, 0x61, 0x65):
        path = str(tmp_path / f"ot{ot:x}.mp4")
        with open(path, "wb") as f:
            f.write(mux_mp4(PAN[:7], 96, 64, object_type=ot))
        want = cv2_frames(path)
        got = list(VideoReader(path))
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_mutated_packets_never_crash():
    """Random byte and bit mutations of the committed clips' packets (and
    truncations): every call returns frames or raises DecodeError /
    UnsupportedImage, and the decoder goes on.  (A longer run of this under
    ASan and UBSan is in CHANGES.md.)"""
    rng = np.random.default_rng(2027)
    sources = [_packets(n) for n in ("mpeg2_pan96.avi", "mpeg2_q_fine.avi",
                                     "mpeg2_matrices.avi", "mpeg2_b_intra.avi",
                                     "mpeg2_rate_fps60.avi",
                                     "mpeg2_size_95x63.avi")]
    outcomes = {"frame": 0, "none": 0, "corrupt": 0, "refused": 0}
    for trial in range(240):
        packets = [bytearray(p) for p in sources[trial % len(sources)]]
        for p in packets:
            for _ in range(int(rng.integers(0, 4))):
                at = int(rng.integers(0, len(p)))
                if rng.random() < 0.5:
                    p[at] ^= 1 << int(rng.integers(0, 8))
                else:
                    p[at] = int(rng.integers(0, 256))
            if rng.random() < 0.1:
                del p[int(rng.integers(0, len(p))):]
        dec = mpeg2.Mpeg2Decoder()
        for p in packets:
            try:
                frames = dec.decode(bytes(p))
                outcomes["frame" if frames else "none"] += 1
            except DecodeError:
                outcomes["corrupt"] += 1
            except UnsupportedImage:
                outcomes["refused"] += 1
        dec.flush()
        dec.close()
    assert all(outcomes.values()), outcomes


def test_planes_crop_and_convert_as_the_raw_path():
    """The decoder's yuv420p planes through rawvideo.yuv420p_to_bgr give
    the frame it returns (one converter for both paths), at 94x62."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    dec = mpeg2.Mpeg2Decoder()
    n = 0
    for p in _packets("mpeg2_size_95x63.avi"):
        for frame in dec.decode(p):
            np.testing.assert_array_equal(
                yuv420p_to_bgr(*dec.planes(), False), frame)
            n += 1
    assert frame.shape[:2] == (62, 94) and n == 7
    dec.close()


def test_the_simple_idct_is_shared():
    """One copy of FFmpeg's simple IDCT (csrc/simple_idct.h) serves the
    Motion JPEG, MPEG-4 Part 2 and MPEG-2 decoders."""
    csrc = os.path.join(os.path.dirname(mpeg2.__file__), "..", "csrc")
    holders = []
    for f in sorted(glob.glob(os.path.join(csrc, "*"))):
        if os.path.isfile(f):
            with open(f, errors="replace") as fh:
                if "22725" in fh.read():
                    holders.append(os.path.basename(f))
    assert holders == ["simple_idct.h"]
    for name in ("mjpeg_decode.c", "mpeg4_decode.c", "mpeg2_decode.c"):
        with open(os.path.join(csrc, name)) as f:
            assert '#include "simple_idct.h"' in f.read()


_SUBPROCESS = r"""
import hashlib, json, os, sys
import numpy as np
from fealess_tpu_torch.io.video import VideoReader

print(json.dumps({name: [hashlib.sha256(np.ascontiguousarray(f).tobytes())
                         .hexdigest() for f in VideoReader(os.path.join(
                             sys.argv[1], name))]
                  for name in sys.argv[2:]}))
print(json.dumps(_loaded()))
"""


def test_decoding_needs_no_cv2_or_jax():
    """A fresh interpreter decodes the MOV, the Matroska clip with
    extradata and the coarse-quantiser AVI to cv2's digests; jax, flax,
    cv2 and the JAX package are never loaded."""
    from tests.test_torch_io import LOADED
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = ["mpeg2_pan.mov", "mpeg2_extradata.mkv", "mpeg2_q_coarse.avi"]
    out = subprocess.run(
        [sys.executable, "-c", LOADED + _SUBPROCESS, MPEG2_OUT, *names],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got, loaded = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert loaded == []
    assert got == {n: DIGESTS[n]["sha256"] for n in names}


def test_matroska_refusal_names_the_container(tmp_path):
    """A Matroska V_MPEG2 track whose sequence is interlaced:
    UnsupportedVideo naming Matroska, MPEG-2 and the tool."""
    from tests.test_torch_containers import mux_mkv
    packets = _field(PAN[:3], 0, "seq_ext", "progressive_sequence", 0)
    path = str(tmp_path / "interlaced.mkv")
    with open(path, "wb") as f:
        f.write(mux_mkv(packets, 96, 64, "V_MPEG2"))
    with pytest.raises(UnsupportedVideo,
                       match="Matroska with MPEG-2 video using an interlaced"):
        list(VideoReader(path))


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def mpeg2_package(tmp_path_factory):
    """acq from the 640x480 MP4 clip with the committed depth
    directory."""
    pkg = str(tmp_path_factory.mktemp("mpeg2") / "pkg")
    rc, _ = _run(["acq", os.path.join(MPEG2_OUT, "pan_mpeg2.mp4"), pkg,
                  "--depth-dir", os.path.join(OUT, "depth"), "--device",
                  "cpu"])
    assert rc == 0
    return pkg


def test_acq_from_the_mp4_clip_writes_the_jax_pixels(mpeg2_package):
    with open(os.path.join(MPEG2_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_mpeg2.mp4"]
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(mpeg2_package, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(mpeg2_package, sub)))}
        assert got == names, sub


def test_recon_on_the_mp4_package_equals_the_jax_cli(mpeg2_package):
    """recon on what acq wrote from the MP4 clip prints the JAX CLI's
    lines in the default ICP setting (a) on every frame.  The forced
    setting (b) changes the engine, not the frames: it is held on the CPU
    for the VP9 package (tests/test_torch_vp9.py) and on every frame of
    this package on the card (chip_smoke phase 7f)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    with open(os.path.join(MPEG2_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_mpeg2.mp4"]
    frames = MPEG2_RECON_SOURCES["pan_mpeg2.mp4"]
    rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                      "--series", mpeg2_package, "--device", "cpu"])
    assert rc == 0 and len(lines) == frames
    _same_lines(lines, want["a"][:frames])
