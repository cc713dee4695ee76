"""VP8 in the port (``csrc/vp8_decode.c`` through ``io/vp8.py`` and
``io/video.VideoReader``) against cv2 5.0.0 and the JAX package: the
committed clips (``tests/data/torch_vp8``: ``cv2.VideoWriter``'s VP80 in
AVI, Matroska and WebM at 640x480, 96x64, 94x62 and 16x16, golden and
altref refreshes, a scene cut, motion past the edge, 2 and 60 fps, and
streams re-encoded with a header field changed or hand-edited) decode to
cv2's frame count and per-frame sha256; together they reach every syntax
path the decoder takes (its counters); each tool it does not read is
refused by name; a hidden frame is dropped as cv2 drops it; a packet it
cannot read ends the reader; mutated packets never crash it; and ``acq``
from the 640x480 WebM clip writes the JAX CLI's pixels, on which ``recon``
prints the JAX CLI's lines (recorded by ``tests/make_torch_video.py``)."""

import contextlib
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
from fealess_tpu_torch.io import vp8
from fealess_tpu_torch.io.avi import AviFile
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import vp8_edit
from tests.make_torch_video import (OUT, VP8_EDITS, VP8_OUT,
                                    VP8_RECON_SOURCES, _vp8_edit, cv2_frames,
                                    digest, mux_avi, set_vp8_size, sha256,
                                    vp8_committed_sources)

torch.set_num_threads(1)

CLIPS = vp8_committed_sources()
with open(os.path.join(VP8_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)
# the clips cv2.VideoWriter wrote (the rest are edited from vp8_pan.avi)
WRITTEN = [n for n in CLIPS if n not in VP8_EDITS and n not in (
    "vp8_scale_bits.avi", "vp8_odd_93x61.avi")]
# what cv2.VideoWriter's streams hold: every path but these
EDITED_ONLY = {"HIDDEN_FRAME", "SCALE_BITS", "COLOR_SPACE", "BILINEAR",
               "FULL_PIXEL", "COPY_LAST_TO_GOLDEN", "COPY_ALTREF_TO_GOLDEN",
               "COPY_LAST_TO_ALTREF", "SIGN_BIAS", "KEEP_LAST", "KEEP_PROBS",
               "YMODE_PROB_UPDATE", "UVMODE_PROB_UPDATE", "NO_SKIP_FLAG",
               "MB_NO_COEFFS", "LF_SIMPLE", "LF_SHARPNESS", "PARTITIONS",
               "REFRESH_ALTREF"}


def _packets(name: str):
    with AviFile(os.path.join(VP8_OUT, name)) as avi:
        return list(avi.frames())


def _decode_all(name: str):
    """(frames, path counts) of a committed clip through one Vp8Decoder
    over the demuxer's packets."""
    reader = VideoReader(os.path.join(VP8_OUT, name))
    try:
        dec = vp8.Vp8Decoder(name, reader.container)
        frames = [f for f in map(dec.decode, reader._packets())
                  if f is not None]
        counts = dec.counts()
        dec.close()
    finally:
        reader.close()
    return frames, counts


def test_committed_sources_are_the_digests_and_stay_small():
    assert CLIPS == sorted(DIGESTS)
    assert sum(os.path.getsize(os.path.join(VP8_OUT, n))
               for n in os.listdir(VP8_OUT)) < 600_000


@pytest.mark.parametrize("name", CLIPS)
def test_committed_clip_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them:
    frame count, shapes and each frame's sha256."""
    path = os.path.join(VP8_OUT, name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        assert reader.codec == "vp8"
        got = list(reader)
    assert {"frames": len(got), "shapes": [list(f.shape) for f in got],
            "sha256": [sha256(f) for f in got]} == DIGESTS[name]


def test_clips_cover_every_container_and_path():
    """The clips cv2.VideoWriter wrote hold AVI, Matroska and WebM and
    every syntax path but those only a changed header shows (B_PRED,
    SPLITMV, each inter mode, golden and altref, loop-filter levels 0 and
    above, skipped MBs, probability updates); with the edited clips every
    path the decoder takes is reached."""
    exts, total, written = set(), dict.fromkeys(vp8.PATHS, 0), \
        dict.fromkeys(vp8.PATHS, 0)
    for name in CLIPS:
        frames, counts = _decode_all(name)
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
            if name in WRITTEN:
                written[k] += v
        if name in WRITTEN:
            exts.add(os.path.splitext(name)[1])
    assert exts == {".avi", ".mkv", ".webm"}
    assert [k for k, v in total.items() if not v] == []
    assert {k for k, v in written.items() if not v} == EDITED_ONLY
    _, pan = _decode_all("vp8_pan640.webm")
    assert pan["KEY_FRAME"] >= 3 and pan["REFRESH_GOLDEN"] >= 2
    assert pan["COPY_GOLDEN_TO_ALTREF"] >= 2


@pytest.mark.parametrize("name", sorted(VP8_EDITS))
def test_edited_clips_come_from_their_edits(name):
    """Each re-encoded clip is vp8_pan.avi's packets through
    tests.vp8_edit.rewrite with its edit (so the committed bytes are what
    the edit makes), and shows the path it was made for."""
    got = vp8_edit.rewrite(_packets("vp8_pan.avi"), _vp8_edit(VP8_EDITS[name]))
    assert got == _packets(name)
    path = {"vp8_hidden.avi": "HIDDEN_FRAME", "vp8_version1.avi": "BILINEAR",
            "vp8_version2.avi": "BILINEAR", "vp8_version3.avi": "FULL_PIXEL",
            "vp8_color_space.avi": "COLOR_SPACE", "vp8_refs.avi": "SIGN_BIAS",
            "vp8_probs.avi": "KEEP_PROBS", "vp8_filters.avi": "LF_SIMPLE",
            "vp8_parts.avi": "PARTITIONS", "vp8_noskip.avi": "NO_SKIP_FLAG"}
    assert _decode_all(name)[1][path[name]] > 0


def test_unedited_rewrite_decodes_as_the_clip():
    """The re-encoder with no edit: packets that cv2 and the port decode
    to the clip's frames."""
    packets = vp8_edit.rewrite(_packets("vp8_pan.avi"), lambda *a: None)
    dec = vp8.Vp8Decoder()
    got = [dec.decode(p) for p in packets]
    want = cv2_frames(os.path.join(VP8_OUT, "vp8_pan.avi"))
    assert len(got) == len(want) == 14
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _rfc_bool_decode(data: bytes, probs):
    """RFC 6386's bool decoder (section 7.3), to hold the encoder to."""
    buf = data + bytes(8)
    value, at, span, count, out = int.from_bytes(buf[:2], "big"), 2, 255, \
        0, []
    for p in probs:
        split = 1 + (((span - 1) * p) >> 8)
        if value >= split << 8:
            out.append(1)
            span -= split
            value -= split << 8
        else:
            out.append(0)
            span = split
        while span < 128:
            value, span, count = value << 1, span << 1, count + 1
            if count == 8:
                value, at, count = value | buf[at], at + 1, 0
    return out


def test_bool_encoder_round_trip():
    """The tests' bool encoder against RFC 6386's decoder: random bools at
    random probabilities (carries included) come back."""
    rng = np.random.default_rng(5)
    probs = rng.integers(1, 256, 20000).tolist()
    bits = [int(b) for b in rng.random(20000) * 256 >= np.array(probs)]
    data = vp8_edit.encode(list(zip(probs, bits)))
    assert _rfc_bool_decode(data, probs) == bits


def _refusals():
    """(case id, packets, the name the refusal gives)."""
    packets = _packets("vp8_pan.avi")
    key, inter = packets[0], packets[1]

    def tag(p, version):
        return bytes([(p[0] & ~0x0E) | (version << 1)]) + p[1:]
    cases = [(f"version{v}", [tag(key, v)], "version") for v in (4, 7)]
    cases.append(("version_inter", [key, tag(inter, 5)], "version"))
    cases.append(("segmentation", [vp8_edit.refusal_frame(
        key, [(128, 0), (128, 0), (128, 1)])], "segmentation"))
    cases.append(("segmentation_inter", [key, vp8_edit.refusal_frame(
        inter, [(128, 1)])], "segmentation"))
    cases.append(("resize", [key, set_vp8_size(key, 80, 64)],
                  "changes the frame size"))
    clamp = vp8_edit.rewrite(packets[:2], _vp8_edit(
        {0: {"clamping_type": 1}}))
    cases.append(("clamping_type", clamp, "clamping_type"))
    return cases


REFUSALS = _refusals()


@pytest.mark.parametrize("case,packets,match", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_each_tool_outside_the_set_is_refused_by_name(tmp_path, case,
                                                      packets, match):
    """A frame tag or header asking for what the port does not decode:
    UnsupportedImage naming it, at the packet that shows it; through
    VideoReader, UnsupportedVideo naming the container, the codec and the
    tool, where cv2 reads a frame from it."""
    dec = vp8.Vp8Decoder(case, "AVI")
    with pytest.raises(UnsupportedImage, match=match):
        for p in packets:
            dec.decode(p)
    dec.close()
    path = str(tmp_path / f"{case}.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets, 96, 64, fourcc=b"VP80"))
    assert len(cv2_frames(path)) >= len(packets) - 1
    with pytest.raises(UnsupportedVideo,
                       match=f"AVI with VP8 video using .*{match}"):
        list(VideoReader(path))


def test_clamping_type_is_refused_because_cv2_converts_by_thread(tmp_path):
    """Why clamping_type 1 is refused: FFmpeg reads it as full range on a
    key frame only, and cv2 converts the key frame at full range; a later
    inter frame comes out at the range of the frame thread that decoded
    it, which the port cannot know."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    packets = _packets("vp8_pan.avi")[:2]
    edited = vp8_edit.rewrite(packets, _vp8_edit({0: {"clamping_type": 1}}))
    dec = vp8.Vp8Decoder()
    dec.decode(packets[0])
    clip = str(tmp_path / "c.avi")
    with open(clip, "wb") as f:
        f.write(mux_avi(edited, 96, 64, fourcc=b"VP80"))
    np.testing.assert_array_equal(cv2_frames(clip)[0],
                                  yuv420p_to_bgr(*dec.planes(96, 64), True))


def test_hidden_frame_is_dropped_as_cv2_drops_it():
    """A frame with show_frame 0 is decoded into the references and gives
    no frame, in cv2 and in the port: the other frames are the clip's."""
    frames, counts = _decode_all("vp8_hidden.avi")
    assert counts["HIDDEN_FRAME"] == 1
    base = cv2_frames(os.path.join(VP8_OUT, "vp8_pan.avi"))
    want = cv2_frames(os.path.join(VP8_OUT, "vp8_hidden.avi"))
    assert len(frames) == len(want) == len(base) - 1 == 13
    for a, b, c in zip(frames, want, base[:3] + base[4:]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_scale_bits_and_odd_sizes_decode_as_cv2():
    """The key frames' scale bits change nothing (FFmpeg does not
    upscale); a size of 93x61 in them crops the same macroblocks, and the
    odd chroma converts as cv2 converts it."""
    a, _ = _decode_all("vp8_scale_bits.avi")
    b, _ = _decode_all("vp8_pan.avi")
    c, _ = _decode_all("vp8_odd_93x61.avi")
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert z.shape == (61, 93, 3)


def test_a_packet_it_cannot_read_ends_the_reader(tmp_path):
    """The third packet cut inside its first partition (FFmpeg: "Header
    size larger than data provided"): cv2's read returns False there, and
    the reader gives the frames before it and ends.  An inter frame
    before any key frame, as FFmpeg discards it, raises DecodeError."""
    packets = _packets("vp8_pan.avi")
    packets[2] = packets[2][:12]
    path = str(tmp_path / "cut.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets, 96, 64, fourcc=b"VP80"))
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dec = vp8.Vp8Decoder()
    with pytest.raises(DecodeError):
        dec.decode(packets[1])
    dec.decode(packets[0])
    for cut in (b"", b"\x10\x02", packets[1][:3], packets[0][:9]):
        with pytest.raises(DecodeError):
            dec.decode(cut)
    path = str(tmp_path / "no_key.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets[1:2] + packets[:1], 96, 64, fourcc=b"VP80"))
    assert cv2_frames(path) == []
    with VideoReader(path) as reader:
        assert list(reader) == []


def test_a_frame_cut_in_its_tokens_ends_the_reader(tmp_path):
    """A packet cut inside its token partition: FFmpeg reads past the end
    until its end-of-data check stops the frame part way (cv2 then returns
    the frame with the macroblocks it did not decode left from an older
    buffer); the port raises DecodeError there, and the reader ends."""
    packets = _packets("vp8_pan.avi")
    packets[3] = packets[3][:len(packets[3]) // 2]
    dec = vp8.Vp8Decoder()
    for p in packets[:3]:
        dec.decode(p)
    with pytest.raises(DecodeError):
        dec.decode(packets[3])
    path = str(tmp_path / "cut.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets, 96, 64, fourcc=b"VP80"))
    with VideoReader(path) as reader:
        got = list(reader)
    want = cv2_frames(os.path.join(VP8_OUT, "vp8_pan.avi"))[:3]
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mutated_packets_never_crash():
    """Random byte and bit mutations of the committed clips' packets (and
    truncations): every call returns a frame, no frame, or raises
    DecodeError / UnsupportedImage, and the decoder goes on."""
    rng = np.random.default_rng(2025)
    sources = [_packets(n) for n in ("vp8_pan.avi", "vp8_parts.avi",
                                     "vp8_refs.avi", "vp8_rate_fps60.avi",
                                     "vp8_version1.avi")]
    outcomes = {"frame": 0, "none": 0, "corrupt": 0, "refused": 0}
    for trial in range(300):
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
        dec = vp8.Vp8Decoder()
        for p in packets:
            try:
                frame = dec.decode(bytes(p))
                outcomes["none" if frame is None else "frame"] += 1
            except DecodeError:
                outcomes["corrupt"] += 1
            except UnsupportedImage:
                outcomes["refused"] += 1
        dec.close()
    assert all(outcomes.values()), outcomes


def test_planes_crop_and_convert_as_the_raw_path():
    """The decoder's yuv420p planes through rawvideo.yuv420p_to_bgr give
    the frame it returns (one converter for both paths), at 93x61."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    dec = vp8.Vp8Decoder()
    for p in _packets("vp8_odd_93x61.avi"):
        frame = dec.decode(p)
        assert frame.shape == (61, 93, 3)
        y, u, v = dec.planes(93, 61)
        np.testing.assert_array_equal(yuv420p_to_bgr(y, u, v), frame)
    dec.close()


def test_mp4_vp8_stays_refused(tmp_path):
    """VP8 in MP4 (vp08), which cv2.VideoWriter does not write, is refused
    by name as before."""
    from tests.test_torch_containers import mux_mp4
    path = str(tmp_path / "vp8.mp4")
    with open(path, "wb") as f:
        f.write(mux_mp4(_packets("vp8_pan.avi")[:2], 96, 64, b"vp08"))
    with pytest.raises(UnsupportedVideo, match="VP8"):
        VideoReader(path)


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
    """A fresh interpreter decodes a WebM, an AVI of two to eight token
    partitions and a version-3 AVI to cv2's digests; jax, flax, cv2 and
    the JAX package are never loaded."""
    from tests.test_torch_io import LOADED
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = ["vp8_pan.webm", "vp8_parts.avi", "vp8_version3.avi"]
    out = subprocess.run(
        [sys.executable, "-c", LOADED + _SUBPROCESS, VP8_OUT, *names],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got, loaded = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert loaded == []
    assert got == {n: DIGESTS[n]["sha256"] for n in names}


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def vp8_package(tmp_path_factory):
    """acq from the 640x480 WebM clip with the committed depth
    directory."""
    pkg = str(tmp_path_factory.mktemp("vp8") / "pkg")
    rc, _ = _run(["acq", os.path.join(VP8_OUT, "pan_vp8.webm"), pkg,
                  "--depth-dir", os.path.join(OUT, "depth"), "--device",
                  "cpu"])
    assert rc == 0
    return pkg


def test_acq_from_the_webm_clip_writes_the_jax_pixels(vp8_package):
    with open(os.path.join(VP8_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_vp8.webm"]
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(vp8_package, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(vp8_package, sub)))}
        assert got == names, sub


@pytest.mark.parametrize("setting", ["a", "b"])
def test_recon_on_the_webm_package_equals_the_jax_cli(vp8_package,
                                                      monkeypatch, setting):
    """recon on what acq wrote from the WebM clip prints the JAX CLI's
    lines, in the default ICP setting (a) and with the iterations forced
    to the cap (b)."""
    from chip_smoke import FORCED
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    with open(os.path.join(VP8_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_vp8.webm"]
    if setting == "b":
        build = cli._engine_for

        def forced(args, width, height):
            eng = build(args, width, height)
            for name, value in FORCED.items():
                eng.set_advanced_param(name, value)
            return eng
        monkeypatch.setattr(cli, "_engine_for", forced)
    # (b) runs 36 brute-force nearest-neighbour searches of 16384 points
    # on the CPU: a few threads for them
    threads = torch.get_num_threads()
    torch.set_num_threads(4 if setting == "b" else threads)
    try:
        rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                          "--series", vp8_package, "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0 and len(lines) == VP8_RECON_SOURCES["pan_vp8.webm"]
    _same_lines(lines, want[setting])


def test_matroska_refusal_names_the_container(tmp_path):
    """A Matroska V_VP8 track whose key frame asks for segmentation:
    UnsupportedVideo naming Matroska, VP8 and the tool, when the reader
    meets it."""
    from tests.test_torch_containers import mux_mkv
    packets = _packets("vp8_pan.avi")[:3]
    packets[0] = vp8_edit.refusal_frame(packets[0],
                                        [(128, 0), (128, 0), (128, 1)])
    path = str(tmp_path / "seg.mkv")
    with open(path, "wb") as f:
        f.write(mux_mkv(packets, 96, 64, "V_VP8"))
    with pytest.raises(UnsupportedVideo,
                       match="Matroska with VP8 video using segmentation"):
        list(VideoReader(path))
