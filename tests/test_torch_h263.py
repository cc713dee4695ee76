"""H.263 and Sorenson Spark in the port (``csrc/h263_decode.c`` and its
macroblock layer ``csrc/h263_mb.h`` through ``io/h263.py``, the SWF
demuxer ``io/swf.py`` and ``io/video.VideoReader``) against cv2 5.0.0 and
the JAX package: the committed sources of ``tests/data/torch_h263``
(``python -m tests.make_torch_video h263``: the writer's H.263 at its five
sizes and its Sorenson Spark at any size, in every container it writes
them in, and Sorenson headers edited by ``tests/h263_edit.py``) decode to
cv2's frame count and per-frame sha256 and together reach every syntax
path the decoder counts; what the writer never writes is refused by name
on hand-edited or hand-built pictures; a packet cut short ends the
reader; the FLV and SWF demuxers give FFmpeg's packets (cv2's raw mode);
the MPEG-4 clips keep their digests now that the two decoders share the
macroblock layer; and ``acq`` from the 640x480 Sorenson FLV writes the
JAX CLI's pixels, on which ``recon`` prints the JAX CLI's lines."""

from __future__ import annotations

import contextlib
import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import h263
from fealess_tpu_torch.io.flv import FlvFile
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.swf import SwfFile
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import h263_edit as E
from tests.make_torch_video import (H263_OUT, H263_RECON_SOURCES, OUT,
                                    cv2_frames, digest,
                                    h263_committed_sources, mux_avi, sha256)

torch.set_num_threads(1)

with open(os.path.join(H263_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)
with open(os.path.join(OUT, "digests.json")) as _f:
    MPEG4_DIGESTS = {n: d for n, d in json.load(_f).items()
                     if n.startswith("m4_") or n == "pan_mp4v.avi"}


def _src(name: str) -> str:
    return os.path.join(H263_OUT, name)


def _write(tmp_path, data: bytes, name: str) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _packets(name: str):
    with VideoReader(_src(name)) as reader:
        return list(reader._packets())


def _frames_digest(frames) -> dict:
    return {"frames": len(frames), "shapes": [list(f.shape) for f in frames],
            "sha256": [sha256(f) for f in frames]}


def test_the_digests_list_every_committed_source():
    assert sorted(DIGESTS) == h263_committed_sources()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_source_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them."""
    path = _src(name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        assert _frames_digest(list(reader)) == DIGESTS[name]


def test_sources_cover_every_size_container_and_path():
    """The sources hold H.263 at its five sizes and both codecs in every
    container the writer puts them in, and every syntax path the decoder
    counts occurs in at least one of them."""
    total = dict.fromkeys(h263.PATHS, 0)
    kinds, sizes = set(), set()
    for name in DIGESTS:
        with VideoReader(_src(name)) as reader:
            kinds.add((reader.codec, reader.container))
            flavour = "h263" if reader.codec == "h263" else "sorenson"
            dec = h263.H263Decoder(b"", reader.fourcc, name,
                                   reader.container, flavour)
            frames = [dec.decode(p) for p in reader._packets()]
        if flavour == "h263":
            sizes.add(frames[0].shape[:2])
        counts = dec.counts()
        dec.close()
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
            if v and k in h263.H263_PATHS:
                assert flavour == "h263", (name, k)
            if v and k in h263.SORENSON_PATHS:
                assert flavour == "sorenson", (name, k)
    assert kinds == {("h263", c) for c in ("AVI", "MP4", "Matroska", "ASF",
                                           "NUT")} | \
        {("flv1", c) for c in ("AVI", "MP4", "Matroska", "ASF", "NUT", "FLV",
                               "SWF")}
    assert sizes == {(96, 128), (144, 176), (288, 352), (576, 704),
                     (1152, 1408)}
    assert [k for k, v in total.items() if not v] == []


@pytest.mark.parametrize("name", sorted(MPEG4_DIGESTS))
def test_mpeg4_clips_keep_their_digests_after_the_table_move(name):
    """The MPEG-4 Part 2 clips, whose decoder now takes its tables, motion
    and reconstruction from ``csrc/h263_mb.h``, decode to the digests
    recorded before the move."""
    with VideoReader(os.path.join(OUT, name)) as reader:
        assert _frames_digest(list(reader)) == MPEG4_DIGESTS[name]


def _pan14():
    return _packets("flv1_pan.flv")[:14]


@pytest.mark.parametrize("name", ["flv1_version0.avi", "flv1_deblock0.avi",
                                  "flv1_pei.avi"])
def test_header_edits_cv2_ignores_give_the_unedited_frames(tmp_path, name):
    """Version 0 (each escape re-coded with an 8-bit level), deblocking 0
    (FFmpeg reads the flag and filters nothing) and PSPARE bytes: cv2
    gives the frames of the unedited packets, and so does the port."""
    plain = _write(tmp_path, mux_avi(_pan14(), 96, 64, fourcc=b"FLV1"),
                   "plain.avi")
    want = cv2_frames(plain)
    assert len(want) == 14
    assert [sha256(f) for f in want] == DIGESTS[name]["sha256"]
    with VideoReader(_src(name)) as reader:
        got = list(reader)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_disposable_p_pictures_leave_the_reference():
    """Picture type 2 on pictures 3, 7 and 8: each is predicted from the
    reference and does not replace it, so every other picture decodes as
    in the stream without them (FFmpeg's droppable pictures)."""
    packets = _packets("flv1_type2.avi")
    kept = [p for i, p in enumerate(packets) if i not in (3, 7, 8)]
    dec = h263.H263Decoder(flavour="sorenson")
    with_them = [dec.decode(p) for p in packets]
    assert dec.counts()["DISPOSABLE_P"] == 3
    dec = h263.H263Decoder(flavour="sorenson")
    without = [dec.decode(p) for p in kept]
    rest = [f for i, f in enumerate(with_them) if i not in (3, 7, 8)]
    for a, b in zip(rest, without):
        np.testing.assert_array_equal(a, b)
    dec = h263.H263Decoder(flavour="sorenson")
    plain = [dec.decode(p) for p in _pan14()]
    assert not np.array_equal(plain[4], with_them[4])


def _skips(n: int) -> list:
    return ["1"] * n


_DC = [100, 90, 80, 70, 128, 128]
_I = E.h263_header(1, False, 5)
_P = E.h263_header(1, True, 5, tr=1)
_INTRA = [E.intra_mb(_DC)] * 48
# a P picture's inter macroblock with four vectors (MCBPC 16, CBPY of no
# coded block, eight zero vector codes)
_INTER4V = "0" + E.CODES["inter_mcbpc"][16] + E.CODES["cbpy"][15] + "1" * 8
REFUSALS = {
    "umv": ("h263_pan.avi", lambda ps: [E.set_field(p, "umv", 1)
                                        for p in ps], "Annex D"),
    "sac": ("h263_pan.avi", lambda ps: ps[:2] + [E.set_field(p, "sac", 1)
                                                for p in ps[2:]], "Annex E"),
    "ap": ("h263_pan.avi", lambda ps: ps[:2] + [E.set_field(p, "ap", 1)
                                               for p in ps[2:]], "Annex F"),
    "pb": ("h263_pan.avi", lambda ps: ps[:1] + [E.set_field(p, "pb", 1)
                                               for p in ps[1:]], "Annex G"),
    "cpm": ("h263_pan.avi", lambda ps: [E.set_field(p, "cpm", 1)
                                        for p in ps], "multipoint"),
    "plusptype": ("h263_pan.avi", lambda ps: ps[:2] + [
        E.set_field(ps[2], "format", 7)], "PLUSPTYPE"),
    "format6": ("h263_pan.avi", lambda ps: ps[:2] + [
        E.set_field(ps[2], "format", 6)], "PLUSPTYPE"),
    "gob": ("h263_pan.avi", lambda ps: ps[:1] + [E.insert_gob(ps[1], 3)] +
            ps[2:], "GOB headers"),
    "dquant_i": ("h263_128x96.avi", lambda ps: [E.picture(
        _I, _INTRA[:5] + [E.intra_mb(_DC, dquant=2)] + _INTRA[6:])],
        "DQUANT"),
    "dquant_p": ("h263_128x96.avi", lambda ps: [E.picture(_I, _INTRA),
                 E.picture(_P, _skips(7) + [E.intra_mb(_DC, 1, True)] +
                           _skips(40))], "DQUANT"),
    "4mv": ("h263_128x96.avi", lambda ps: [E.picture(_I, _INTRA),
            E.picture(_P, _skips(9) + [_INTER4V] + _skips(38))],
            "INTER4V"),
    "stuffing_i": ("h263_128x96.avi", lambda ps: [E.picture(
        _I, [E.CODES["intra_mcbpc"][8]] + _INTRA)], "stuffing"),
    "stuffing_p": ("h263_128x96.avi", lambda ps: [E.picture(_I, _INTRA),
                   E.picture(_P, ["0" + E.CODES["inter_mcbpc"][20]] +
                             _skips(48))], "stuffing"),
    "resize": ("h263_pan.avi", lambda ps: ps[:2] + [E.picture(_I, _INTRA)],
               "changes the frame size"),
    "p_first": ("h263_pan.avi", lambda ps: ps[1:], "P picture before"),
    "sorenson_p_first": ("flv1_FLV1.avi", lambda ps: ps[1:],
                         "P picture before"),
}


@pytest.mark.parametrize("edit", sorted(REFUSALS))
def test_what_the_writer_never_writes_is_refused_by_name(tmp_path, edit):
    """Annex bits, PLUSPTYPE, CPM, a GOB header, DQUANT, INTER4V,
    macroblock stuffing, a size change and a stream opening with a P
    picture, each in an otherwise valid stream: cv2 reads a frame of it,
    the port names what it does not read."""
    source, fn, match = REFUSALS[edit]
    packets = _packets(source)
    fourcc = b"FLV1" if source.startswith("flv1") else b"H263"
    with VideoReader(_src(source)) as reader:
        w, h = reader.width, reader.height
    path = _write(tmp_path, mux_avi(fn(packets), w, h, fourcc=fourcc),
                  "x.avi")
    assert len(cv2_frames(path)) >= 1
    with pytest.raises(UnsupportedVideo, match=match):
        with VideoReader(path) as reader:
            list(reader)


def test_hand_built_pictures_decode_as_cv2_decodes_them(tmp_path):
    """An I picture of DC-only intra macroblocks (INTRADC 255 among them)
    and a P picture of skipped macroblocks around an intra one."""
    mbs = [E.intra_mb([255 if k % 3 == 0 else 1 + 5 * k, 254, 2, 128, 255,
                       64]) for k in range(48)]
    pictures = [E.picture(_I, mbs), E.picture(_P, _skips(10) + [
        E.intra_mb([200, 10, 255, 1, 1, 254], pframe=True)] + _skips(37))]
    path = _write(tmp_path, mux_avi(pictures, 128, 96, fourcc=b"H263"),
                  "x.avi")
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_a_packet_cut_short_ends_the_reader(tmp_path):
    """The fifth picture cut to half its bytes: cv2 conceals the rest of
    it (FFmpeg's error resilience) and goes on; the port gives the four
    frames before it and ends there, as the JAX reader's loop does at
    the first frame cv2 does not serve as written."""
    packets = _pan14()
    cut = packets[:4] + [packets[4][:len(packets[4]) // 2]] + packets[5:]
    path = _write(tmp_path, mux_avi(cut, 96, 64, fourcc=b"FLV1"), "cut.avi")
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == 4 and len(want) == 14
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dec = h263.H263Decoder(flavour="sorenson")
    dec.decode(packets[0])
    with pytest.raises(DecodeError):
        dec.decode(packets[1][:len(packets[1]) // 2])


@pytest.mark.parametrize("level", [0, -128])
def test_an_escape_level_h263_forbids_is_corrupt(level):
    """An 8-bit escape level of 0 or -128 (H.263 forbids both; the
    writer's levels stay within -127..127) raises DecodeError."""
    packets = _packets("h263_pan.avi")
    k, at = next((k, w["escapes"][0][0]) for k, w in
                 enumerate(map(E.walk, packets)) if w["escapes"])
    b = E.bits(packets[k])
    edited = E.unbits(b[:at + 7] + format(level & 0xFF, "08b") +
                      b[at + 15:])
    dec = h263.H263Decoder(flavour="h263")
    for p in packets[:k]:
        dec.decode(p)
    with pytest.raises(DecodeError):
        dec.decode(edited)


def test_mutated_packets_never_crash():
    """Random byte and bit mutations and truncations of the committed
    packets: every call returns a frame or raises DecodeError /
    UnsupportedImage, and the decoder goes on."""
    rng = np.random.default_rng(2028)
    sources = [(_packets(n), f) for n, f in (
        ("h263_pan.avi", "h263"), ("flv1_motion.avi", "sorenson"),
        ("flv1_checker.avi", "sorenson"), ("flv1_version0.avi",
                                           "sorenson"))]
    outcomes = {"frame": 0, "corrupt": 0, "refused": 0}
    for trial in range(240):
        packets, flavour = sources[trial % len(sources)]
        packets = [bytearray(p) for p in packets]
        for p in packets:
            for _ in range(int(rng.integers(0, 4))):
                at = int(rng.integers(0, len(p)))
                if rng.random() < 0.5:
                    p[at] ^= 1 << int(rng.integers(0, 8))
                else:
                    p[at] = int(rng.integers(0, 256))
            if rng.random() < 0.1:
                del p[int(rng.integers(0, len(p))):]
        dec = h263.H263Decoder(flavour=flavour)
        for p in packets:
            try:
                frame = dec.decode(bytes(p))
                assert frame.ndim == 3
                outcomes["frame"] += 1
            except DecodeError:
                outcomes["corrupt"] += 1
            except UnsupportedImage:
                outcomes["refused"] += 1
        dec.close()
    assert all(outcomes.values()), outcomes


def test_planes_crop_and_convert_as_the_raw_path():
    """The decoder's yuv420p planes through rawvideo.yuv420p_to_bgr give
    the frame it returns, at the odd size 95x63."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    dec = h263.H263Decoder(flavour="sorenson")
    for p in _packets("flv1_odd_95x63.avi"):
        frame = dec.decode(p)
        assert frame.shape == (63, 95, 3)
        y, u, v = dec.planes(95, 63)
        np.testing.assert_array_equal(yuv420p_to_bgr(y, u, v), frame)
    dec.close()


def _ffmpeg_packets(path: str):
    """The packets FFmpeg's demuxer hands the decoder (cv2's raw mode)."""
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, data = cap.read()
        if not ok:
            break
        out.append(data.tobytes())
    cap.release()
    return out


@pytest.mark.parametrize("name,cls", [
    ("flv1_pan.flv", FlvFile), ("flv1_1280x720.flv", FlvFile),
    ("pan_flv1.flv", FlvFile), ("flv1.swf", SwfFile)])
def test_flv_and_swf_demuxers_give_ffmpegs_packets(name, cls):
    want = _ffmpeg_packets(_src(name))
    d = cls(_src(name))
    assert d.codec == "flv1" and list(d.frames()) == want


def _swf_tags(data: bytes):
    """(header, [(code, body)]) of an uncompressed SWF."""
    at = 8 + (5 + 4 * (data[8] >> 3) + 7) // 8 + 4
    head, tags = data[:at], []
    while at < len(data):
        code = struct.unpack_from("<H", data, at)[0]
        kind, size = code >> 6, code & 0x3F
        at += 2
        if size == 0x3F:
            size = struct.unpack_from("<I", data, at)[0]
            at += 4
        tags.append((kind, data[at:at + size]))
        at += size
    return head, tags


def _swf(head: bytes, tags) -> bytes:
    body = b"".join(struct.pack("<HI", (k << 6) | 0x3F, len(b)) + b
                    for k, b in tags)
    data = head + body
    return data[:4] + struct.pack("<I", len(data)) + data[8:]


def _swf_edit(edit: str, data: bytes) -> bytes:
    head, tags = _swf_tags(data)
    if edit == "cws":
        return b"CWS" + data[3:8] + zlib.compress(data[8:])
    if edit == "zws":
        return b"ZWS" + data[3:8] + bytes(9) + data[8:]
    if edit == "long_tags_and_skipped":
        return _swf(head, [(9, b"\x10\x20\x30")] + tags + [(77, b"x" * 70)])
    if edit == "codec_vp6":
        return _swf(head, [(k, b[:9] + b"\x04" if k == 60 else b)
                           for k, b in tags])
    if edit == "second_stream":
        define = next(b for k, b in tags if k == 60)
        return _swf(head, tags[:1] + [(60, b"\x07\x00" + define[2:])] +
                    tags[1:])
    if edit == "bitmap":
        return _swf(head, [(20, b"\x01\x00" + bytes(8))] + tags)
    if edit == "frames_before_stream":
        frames = [(k, b) for k, b in tags if k == 61]
        return _swf(head, frames[:2] + tags)
    raise ValueError(edit)


@pytest.mark.parametrize("edit,outcome", [
    ("long_tags_and_skipped", "read"), ("frames_before_stream", "read"),
    ("cws", "compressed SWF"), ("zws", "OSError"),
    ("codec_vp6", "VP6"), ("second_stream", "several video streams"),
    ("bitmap", "bitmap tags")])
def test_swf_kinds_are_read_refused_or_not_opened_as_in_cv2(tmp_path, edit,
                                                            outcome):
    """Long tag headers and tags FFmpeg skips, VideoFrame tags before
    their DefineVideoStream (skipped): read to cv2's frames.  CWS (cv2
    reads damaged frames or none, FFmpeg's inflate losing bytes), VP6, a
    second video stream and bitmap tags: named.  ZWS: cv2 does not open
    it, and the port raises OSError."""
    with open(_src("flv1.swf"), "rb") as f:
        path = _write(tmp_path, _swf_edit(edit, f.read()), "x.swf")
    want = cv2_frames(path)
    if outcome == "read":
        with VideoReader(path) as reader:
            got = list(reader)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    elif outcome == "OSError":
        assert want == []
        with pytest.raises(OSError, match="cannot open video source"):
            VideoReader(path)
    else:
        with pytest.raises(UnsupportedVideo, match=outcome):
            VideoReader(path)
    if edit == "cws":
        plain = cv2_frames(_src("flv1.swf"))
        assert len(want) < len(plain) or any(
            not np.array_equal(a, b) for a, b in zip(want, plain))


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


def test_acq_then_recon_on_the_sorenson_flv_equals_the_jax_cli(tmp_path):
    """acq from the 640x480 Sorenson FLV with the committed depth
    directory writes the pixels the JAX CLI wrote, and recon on that
    package prints the JAX CLI's lines in the default ICP setting
    (recon.json; the forced setting is held on the card)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    name = "pan_flv1.flv"
    with open(os.path.join(H263_OUT, "recon.json")) as f:
        want = json.load(f)["sources"][name]
    pkg = str(tmp_path / "pkg")
    rc, _ = _run(["acq", _src(name), pkg, "--depth-dir",
                  os.path.join(OUT, "depth"), "--device", "cpu"])
    assert rc == 0
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(pkg, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(pkg, sub)))}
        assert got == names, sub
    rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                      "--series", pkg, "--device", "cpu"])
    assert rc == 0 and len(lines) == H263_RECON_SOURCES[name]
    _same_lines(lines, want["a"])


def test_chip_smoke_h263_part_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 7f part for H.263 and Sorenson Spark, its acq
    and recon set aside: every committed source to its digests, the host
    times printed."""
    import chip_smoke
    calls, failed = [], []
    monkeypatch.setattr(chip_smoke, "acq_recon_source",
                        lambda *a, **k: calls.append(a[4:6]))
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, msg: ok or failed.append(msg))
    monkeypatch.setattr(chip_smoke, "DECODE_TIMED", 1)
    chip_smoke.h263_sources(None, "cpu rehearsal", None, None)
    assert not failed, failed
    assert calls == [("pan_flv1.flv", H263_RECON_SOURCES["pan_flv1.flv"])]
    out = capsys.readouterr().out
    assert f"{len(DIGESTS)} committed sources" in out
    for kind in ("640x480 Sorenson I", "640x480 Sorenson P",
                 "704x576 H.263 I", "704x576 H.263 P",
                 "time phase 7f H.263 part"):
        assert kind in out
