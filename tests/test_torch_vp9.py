"""VP9 in the port (``csrc/vp9_decode.c`` through ``io/vp9.py`` and
``io/video.VideoReader``) against cv2 5.0.0 and the JAX package: the
committed clips (``tests/data/torch_vp9``: ``cv2.VideoWriter``'s VP90 in
AVI, MP4, Matroska and WebM at 1280x720, 640x480, 96x64, 94x62 and
16x16, tiles, a golden refresh, motion past the edge, 2 and 60 fps;
streams re-encoded with header fields changed, hand-edited or hand-built:
backward adaptation, probability contexts, error resilience, fixed
filters, loop-filter and quantiser settings, tile rows, colour range,
superframes, a hidden frame and ``show_existing_frame``) decode to cv2's
frame count and per-frame sha256; together they reach every syntax path
the decoder takes (its counters); each tool it does not read is refused
by name; a packet it cannot read ends the reader; mutated packets never
crash it; and ``acq`` from the 640x480 WebM clip writes the JAX CLI's
pixels, on which ``recon`` prints the JAX CLI's lines (recorded by
``tests/make_torch_video.py``)."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import vp9
from fealess_tpu_torch.io.avi import AviFile
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.matroska import MkvFile
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import vp9_edit
from tests.make_torch_video import (OUT, VP9_EDITS, VP9_OUT,
                                    VP9_RECON_SOURCES, _vp9_edit, cv2_frames,
                                    digest, mux_avi, set_vp9_color_space,
                                    sha256, vp9_committed_sources)

torch.set_num_threads(1)

CLIPS = vp9_committed_sources()
with open(os.path.join(VP9_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)
# the clips built from vp9_pan.avi's or vp9_pan640.webm's packets
BUILT = {"vp9_full_range.avi", "vp9_color_space.avi", "vp9_superframe.avi",
         "vp9_hidden.avi", "vp9_show_hidden.avi", "vp9_show_existing.avi",
         "vp9_tile_rows.avi"}
WRITTEN = [n for n in CLIPS if n not in VP9_EDITS and n not in BUILT]
# what cv2.VideoWriter's streams hold: every path but these
EDITED_ONLY = {"HIDDEN_FRAME", "SHOW_EXISTING", "ERROR_RESILIENT",
               "RESET_CONTEXT", "CONTEXT_IDX", "NO_REFRESH_CONTEXT", "ADAPT",
               "FULL_RANGE", "RENDER_SIZE", "FILTER_BILINEAR", "DELTA_Q",
               "TILE_ROWS", "REF_ALTREF", "LF_SHARPNESS"}


def _packets(name: str):
    path = os.path.join(VP9_OUT, name)
    if name.endswith(".avi"):
        with AviFile(path) as avi:
            return list(avi.frames())
    with MkvFile(path) as mkv:
        return list(mkv.frames())


def _decode_all(name: str):
    """(frames, path counts) of a committed clip through one Vp9Decoder
    over the demuxer's packets."""
    reader = VideoReader(os.path.join(VP9_OUT, name))
    try:
        dec = vp9.Vp9Decoder(name, reader.container)
        frames = [f for p in reader._packets() for f in dec.decode(p)]
        counts = dec.counts()
        dec.close()
    finally:
        reader.close()
    return frames, counts


def test_committed_sources_are_the_digests_and_stay_small():
    assert CLIPS == sorted(DIGESTS)
    assert sum(os.path.getsize(os.path.join(VP9_OUT, n))
               for n in os.listdir(VP9_OUT)) < 1_000_000


@pytest.mark.parametrize("name", CLIPS)
def test_committed_clip_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them:
    frame count, shapes and each frame's sha256."""
    path = os.path.join(VP9_OUT, name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        assert reader.codec == "vp9"
        got = list(reader)
    assert {"frames": len(got), "shapes": [list(f.shape) for f in got],
            "sha256": [sha256(f) for f in got]} == DIGESTS[name]


def test_clips_cover_every_container_and_path():
    """The clips cv2.VideoWriter wrote hold AVI, MP4, Matroska and WebM
    and every syntax path but those only a changed header shows (every
    block size and partition, intra mode, inter mode, transform size and
    token category, the three 8-tap filters, tile columns, the previous
    frame's MVs); with the edited and built clips every path the decoder
    takes is reached."""
    exts, total, written = set(), dict.fromkeys(vp9.PATHS, 0), \
        dict.fromkeys(vp9.PATHS, 0)
    for name in CLIPS:
        frames, counts = _decode_all(name)
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
            if name in WRITTEN:
                written[k] += v
        if name in WRITTEN:
            exts.add(os.path.splitext(name)[1])
    assert exts == {".avi", ".mkv", ".webm", ".mp4"}
    assert [k for k, v in total.items() if not v] == []
    assert {k for k, v in written.items() if not v} == EDITED_ONLY
    _, wide = _decode_all("vp9_size_1280x720.webm")
    assert wide["TILE_COLS"] == 3 and wide["KEY_FRAME"] == 1


@pytest.mark.parametrize("name", sorted(VP9_EDITS))
def test_edited_clips_come_from_their_edits(name):
    """Each re-encoded clip is vp9_pan.avi's packets through
    tests.vp9_edit.rewrite with its edit (so the committed bytes are what
    the edit makes), and shows the path it was made for."""
    got = vp9_edit.rewrite(_packets("vp9_pan.avi"), _vp9_edit(VP9_EDITS[name]))
    assert got == _packets(name)
    path = {"vp9_adapt.avi": "ADAPT", "vp9_contexts.avi": "CONTEXT_IDX",
            "vp9_error_res.avi": "ERROR_RESILIENT",
            "vp9_filters.avi": "FILTER_BILINEAR",
            "vp9_loop_filter.avi": "LF_SHARPNESS", "vp9_quant.avi": "DELTA_Q",
            "vp9_altref.avi": "REF_ALTREF"}
    assert _decode_all(name)[1][path[name]] > 0


def test_built_clips_come_from_their_packets():
    """The hand-edited and hand-built clips are what tests/vp9_edit.py and
    set_vp9_color_space make of vp9_pan.avi's packets (and the tile rows
    of vp9_pan640.webm's)."""
    packets = _packets("vp9_pan.avi")
    assert _packets("vp9_full_range.avi") == [
        set_vp9_color_space(p, 1, 1) for p in packets]
    assert _packets("vp9_superframe.avi") == packets[:4] + [
        vp9_edit.superframe(packets[4:6])] + packets[6:]
    hidden = vp9_edit.rewrite(packets, _vp9_edit(
        {5: {"show": 0, "refresh": 5}}))
    assert _packets("vp9_show_hidden.avi") == hidden[:6] + [
        vp9_edit.show_existing(2)] + hidden[6:]
    big = _packets("vp9_pan640.webm")[:4]
    assert _packets("vp9_tile_rows.avi") == vp9_edit.rewrite(
        big, _vp9_edit({0: {"log2_tile_rows": 1}, 1: {"log2_tile_rows": 2},
                        3: {"log2_tile_rows": 1, "log2_tile_cols": 0}}))


def test_superframes_and_show_existing_give_cv2s_frames():
    """A superframe of two shown frames gives both; one with a hidden
    frame gives the shown one; show_existing_frame gives its slot's frame
    again: in cv2 and in the port, the other frames are the clip's."""
    base = cv2_frames(os.path.join(VP9_OUT, "vp9_pan.avi"))
    frames, _ = _decode_all("vp9_superframe.avi")
    assert len(frames) == 14
    for a, b in zip(frames, base):
        np.testing.assert_array_equal(a, b)
    frames, counts = _decode_all("vp9_show_existing.avi")
    assert counts["SHOW_EXISTING"] == 2 and len(frames) == 16
    np.testing.assert_array_equal(frames[4], base[3])
    want = cv2_frames(os.path.join(VP9_OUT, "vp9_hidden.avi"))
    frames, counts = _decode_all("vp9_hidden.avi")
    assert counts["HIDDEN_FRAME"] == 1 and len(frames) == len(want) == 14
    assert vp9.superframe(_packets("vp9_hidden.avi")[5])[1] == \
        _packets("vp9_show_hidden.avi")[7]


def test_superframe_index_as_ffmpeg_splits_it():
    """Annex B: sizes in 1-4 little-endian bytes between two markers; a
    last byte that only looks like a marker leaves the packet whole; a
    size past the data fails the packet."""
    a, b = b"\x82\x49\x83\x42" + bytes(9), b"\x86\x00" + bytes(5)
    for mag in (1, 2, 3, 4):
        marker = 0xC0 | ((mag - 1) << 3) | 1
        index = bytes([marker]) + len(a).to_bytes(mag, "little") + \
            len(b).to_bytes(mag, "little") + bytes([marker])
        assert vp9.superframe(a + b + index) == [a, b]
    assert vp9.superframe(a + b"\xc1") == [a + b"\xc1"]
    with pytest.raises(DecodeError):
        vp9.superframe(a + b"\xc0\x7f\xc0")
    with pytest.raises(DecodeError):
        vp9.superframe(a + b"\xc0\x00\xc0")


def _header(packet, **change):
    f = vp9_edit.read_header(packet)
    f.update(change)
    return vp9_edit.write_header(f) + packet[f["bytes"]:]


def _refusals():
    """(case id, packets, the name the refusal gives)."""
    packets = _packets("vp9_pan.avi")
    key, inter = packets[0], packets[1]
    # the first byte: frame marker, the profile's low then high bit (then
    # a reserved 0 for profile 3), show_existing_frame, frame_type ...
    cases = [(f"profile{p}", [bytes([b]) + key[1:]], "profile 1-3")
             for p, b in ((1, 0xA2), (2, 0x92), (3, 0xB1))]
    cases.append(("segmentation", [_header(key, segmentation=[1, 0, 0])],
                  "segmentation"))
    cases.append(("intra_only", [key, b"\x84\x80" + bytes(8)],
                  "intra-only"))
    sizes = {k: (96, 64) for k in range(8)}
    f = vp9_edit.read_header(inter, sizes)
    f["refs"] = [(0, 0), (1, 0), (2, 1)]
    cases.append(("compound", [key, vp9_edit.write_header(f) +
                               inter[f["bytes"]:]], "compound"))
    f = vp9_edit.read_header(inter, sizes)
    f.update(size_from=None, width=80, height=64)
    cases.append(("scaled", [key, vp9_edit.write_header(f) +
                             inter[f["bytes"]:]], "another size"))
    cases.append(("resize", [key, _header(packets[12], width=80)],
                  "changes the frame size"))
    cases.append(("lossless", [_header(key, base_q=0)], "lossless"))
    cases.append(("large", [_header(key, width=8193)], "wider or taller"))
    for cs in (2, 4, 5, 6):
        cases.append((f"color_space{cs}", [set_vp9_color_space(key, cs)],
                      "color_space"))
    return cases


REFUSALS = _refusals()


@pytest.mark.parametrize("case,packets,match", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_each_tool_outside_the_set_is_refused_by_name(tmp_path, case,
                                                      packets, match):
    """A header asking for what the port does not decode: UnsupportedImage
    naming it, at the packet that shows it; through VideoReader,
    UnsupportedVideo naming the container, the codec and the tool."""
    dec = vp9.Vp9Decoder(case, "AVI")
    with pytest.raises(UnsupportedImage, match=match):
        for p in packets:
            dec.decode(p)
    dec.close()
    path = str(tmp_path / f"{case}.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets, 96, 64, fourcc=b"VP90"))
    with pytest.raises(UnsupportedVideo,
                       match=f"AVI with VP9 video using .*{match}"):
        list(VideoReader(path))
    if case.startswith("color_space"):    # cv2 reads it, with its matrix
        assert len(cv2_frames(path)) == 1


def test_bt709_is_refused_because_cv2_converts_with_its_matrix(tmp_path):
    """Why color_space 2 is refused: cv2's frame is neither the limited
    nor the full range BT.601 conversion of the decoded planes, while
    color_space 1 and 3 (vp9_color_space.avi) convert as 0 does."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    key = _packets("vp9_pan.avi")[0]
    dec = vp9.Vp9Decoder()
    dec.decode(key)
    planes = dec.planes()
    path = str(tmp_path / "709.avi")
    with open(path, "wb") as f:
        f.write(mux_avi([set_vp9_color_space(key, 2)], 96, 64,
                        fourcc=b"VP90"))
    got = cv2_frames(path)[0]
    for full in (False, True):
        assert not np.array_equal(got, yuv420p_to_bgr(*planes, full))


def test_a_packet_it_cannot_read_ends_the_reader(tmp_path):
    """The fourth packet cut short, an RGB key frame (profile 0 has no
    RGB: FFmpeg fails the packet) and an inter frame before any key frame:
    cv2's read returns False there, and the reader gives the frames before
    it and ends."""
    packets = _packets("vp9_pan.avi")
    cases = {"cut": packets[:3] + [packets[3][:len(packets[3]) // 2]] +
             packets[4:],
             "rgb": packets[:12] + [set_vp9_color_space(packets[12], 7)] +
             packets[13:],
             "no_key": packets[1:2] + packets}
    for name, data in cases.items():
        path = str(tmp_path / f"{name}.avi")
        with open(path, "wb") as f:
            f.write(mux_avi(data, 96, 64, fourcc=b"VP90"))
        want = cv2_frames(path)
        with VideoReader(path) as reader:
            got = list(reader)
        assert len(got) == len(want) == {"cut": 3, "rgb": 12,
                                         "no_key": 0}[name], name
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    dec = vp9.Vp9Decoder()
    for cut in (b"", b"\x10\x02", packets[0][:9], packets[0][:20]):
        with pytest.raises(DecodeError):
            dec.decode(cut)


def test_mutated_packets_never_crash():
    """Random byte and bit mutations of the committed clips' packets (and
    truncations): every call returns frames or raises DecodeError /
    UnsupportedImage, and the decoder goes on.  (A longer run of this under
    ASan and UBSan is in CHANGES.md.)"""
    rng = np.random.default_rng(2026)
    sources = [_packets(n) for n in ("vp9_pan.avi", "vp9_adapt.avi",
                                     "vp9_filters.avi", "vp9_rate_fps60.avi",
                                     "vp9_hidden.avi", "vp9_size_95x63.avi")]
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
        dec = vp9.Vp9Decoder()
        for p in packets:
            try:
                frames = dec.decode(bytes(p))
                outcomes["frame" if frames else "none"] += 1
            except DecodeError:
                outcomes["corrupt"] += 1
            except UnsupportedImage:
                outcomes["refused"] += 1
        dec.close()
    assert all(outcomes.values()), outcomes


def test_planes_crop_and_convert_as_the_raw_path():
    """The decoder's yuv420p planes through rawvideo.yuv420p_to_bgr give
    the frame it returns (one converter for both paths), at 94x62 and at
    full range."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    for name, full in (("vp9_size_95x63.avi", False),
                       ("vp9_full_range.avi", True)):
        dec = vp9.Vp9Decoder()
        for p in _packets(name):
            (frame,) = dec.decode(p)
            np.testing.assert_array_equal(
                yuv420p_to_bgr(*dec.planes(), full), frame)
        assert frame.shape[:2] == ((62, 94) if not full else (64, 96))
        dec.close()


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
    """A fresh interpreter decodes an MP4, a superframe AVI and the
    backward-adapted AVI to cv2's digests; jax, flax, cv2 and the JAX
    package are never loaded."""
    from tests.test_torch_io import LOADED
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = ["vp9_pan.mp4", "vp9_hidden.avi", "vp9_adapt.avi"]
    out = subprocess.run(
        [sys.executable, "-c", LOADED + _SUBPROCESS, VP9_OUT, *names],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got, loaded = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert loaded == []
    assert got == {n: DIGESTS[n]["sha256"] for n in names}


def test_matroska_refusal_names_the_container(tmp_path):
    """A Matroska V_VP9 track whose key frame says BT.709:
    UnsupportedVideo naming Matroska, VP9 and the tool."""
    from tests.test_torch_containers import mux_mkv
    packets = _packets("vp9_pan.avi")[:3]
    packets[0] = set_vp9_color_space(packets[0], 2)
    path = str(tmp_path / "709.mkv")
    with open(path, "wb") as f:
        f.write(mux_mkv(packets, 96, 64, "V_VP9"))
    with pytest.raises(UnsupportedVideo,
                       match="Matroska with VP9 video using a color_space"):
        list(VideoReader(path))


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def vp9_package(tmp_path_factory):
    """acq from the 640x480 WebM clip with the committed depth
    directory."""
    pkg = str(tmp_path_factory.mktemp("vp9") / "pkg")
    rc, _ = _run(["acq", os.path.join(VP9_OUT, "pan_vp9.webm"), pkg,
                  "--depth-dir", os.path.join(OUT, "depth"), "--device",
                  "cpu"])
    assert rc == 0
    return pkg


def test_acq_from_the_webm_clip_writes_the_jax_pixels(vp9_package):
    with open(os.path.join(VP9_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_vp9.webm"]
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(vp9_package, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(vp9_package, sub)))}
        assert got == names, sub


@pytest.mark.parametrize("setting", ["a", "b"])
def test_recon_on_the_webm_package_equals_the_jax_cli(vp9_package, tmp_path,
                                                      monkeypatch, setting):
    """recon on what acq wrote from the WebM clip prints the JAX CLI's
    lines: in the default ICP setting (a) on every frame, and with the
    iterations forced to the cap (b) on the first frame (the CPU twins'
    forced ICP is slow; chip_smoke holds (b) on every frame on the
    card)."""
    from chip_smoke import FORCED
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    with open(os.path.join(VP9_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_vp9.webm"]
    series, frames = vp9_package, VP9_RECON_SOURCES["pan_vp9.webm"]
    if setting == "b":
        build = cli._engine_for

        def forced(args, width, height):
            eng = build(args, width, height)
            for name, value in FORCED.items():
                eng.set_advanced_param(name, value)
            return eng
        monkeypatch.setattr(cli, "_engine_for", forced)
        series, frames = str(tmp_path / "first"), 1
        shutil.copytree(vp9_package, series, ignore=lambda d, names: [
            n for n in names if os.path.isfile(os.path.join(d, n)) and
            os.path.splitext(n)[0] != "0"])
    threads = torch.get_num_threads()
    torch.set_num_threads(4 if setting == "b" else threads)
    try:
        rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                          "--series", series, "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0 and len(lines) == frames
    _same_lines(lines, want[setting][:frames])
