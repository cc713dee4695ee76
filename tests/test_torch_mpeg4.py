"""MPEG-4 Part 2 in the port (``csrc/mpeg4_decode.c`` through
``io/mpeg4.py`` and ``io/video.VideoReader``) against cv2 5.0.0 and the
JAX package: the committed clips (``m4_*`` and ``pan_mp4v.avi`` in
``tests/data/torch_video``: every fourcc ``cv2.VideoWriter`` writes
MPEG-4 for, AVI, MP4 and Matroska, odd sizes, a scene cut, motion past
the edge, QP from 3 to 31, a VOP that is not coded) decode to cv2's frame
count and per-frame sha256; together they reach every syntax path the
decoder accepts (its counters); each tool it does not read is refused by
name on a hand-edited header bit or macroblock code; a packet it cannot
read ends the reader; mutated packets never crash it; and ``acq`` from
the 640x480 ``mp4v`` clip writes the JAX CLI's pixels, on which ``recon``
prints the JAX CLI's lines (recorded by ``tests/make_torch_video.py``)."""

import contextlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import mpeg4
from fealess_tpu_torch.io.avi import AviFile
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests.make_torch_video import (OUT, RECON_SOURCES, VOL_FIELDS,
                                    cv2_frames, digest, mux_avi, scene,
                                    set_bits, set_vol_bit, sha256,
                                    write_cv2_clip)

torch.set_num_threads(1)

CLIPS = sorted(n for n in os.listdir(OUT)
               if n.startswith("m4_") or n == "pan_mp4v.avi")
with open(os.path.join(OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def _decode_all(name: str):
    """(frames, summed path counts) of a committed clip through one
    Mpeg4Decoder over the demuxer's packets."""
    reader = VideoReader(os.path.join(OUT, name))
    try:
        dec = mpeg4.Mpeg4Decoder(reader.extradata, reader.fourcc, name,
                                 reader.container)
        frames = [f for f in map(dec.decode, reader._packets())
                  if f is not None]
        counts = dec.counts()
        dec.close()
    finally:
        reader.close()
    return frames, counts


@pytest.mark.parametrize("name", CLIPS)
def test_committed_clip_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them:
    frame count, shapes and each frame's sha256."""
    path = os.path.join(OUT, name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        got = list(reader)
    assert {"frames": len(got), "shapes": [list(f.shape) for f in got],
            "sha256": [sha256(f) for f in got]} == DIGESTS[name]


def test_clips_cover_every_fourcc_container_and_path():
    """The committed clips hold each fourcc cv2.VideoWriter writes MPEG-4
    for, AVI, MP4 and Matroska, and every syntax path the decoder
    accepts occurs in at least one of them."""
    fourccs, containers = set(), set()
    total = dict.fromkeys(mpeg4.PATHS, 0)
    for name in CLIPS:
        with VideoReader(os.path.join(OUT, name)) as reader:
            fourccs.add(reader.fourcc)
            containers.add(reader.container)
        frames, counts = _decode_all(name)
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
    assert {f for f in fourccs if f in mpeg4.FOURCCS} >= {
        b"mp4v", b"XVID", b"FMP4", b"DIVX", b"DX50"}
    with AviFile(os.path.join(OUT, "m4_MP4V.avi")) as avi:   # cv2's fallback
        assert avi.stream.compression == b"FMP4"
    assert containers == {"AVI", "MP4", "Matroska"}
    assert [k for k, v in total.items() if not v] == []


def test_not_coded_vop_is_dropped_as_cv2_drops_it():
    """A VOP with vop_coded 0 between two coded ones gives no frame in
    cv2, and none in the port."""
    frames, counts = _decode_all("m4_notcoded.avi")
    assert counts["NOT_CODED_VOP"] == 1
    base = cv2_frames(os.path.join(OUT, "m4_mp4v.avi"))
    want = cv2_frames(os.path.join(OUT, "m4_notcoded.avi"))
    assert len(want) == len(base) == len(frames) == 5
    for a, b, c in zip(frames, want, base):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def _packets(name: str):
    with AviFile(os.path.join(OUT, name)) as avi:
        return list(avi.frames())


def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def _vop_at(packet: bytes) -> int:
    """The bit just past the VOP start code."""
    return (packet.index(b"\x00\x00\x01\xb6") + 4) * 8


def _first_mb(packet: bytes, increment_bits: int = 4) -> int:
    """The bit of the first macroblock (after the VOP header FFmpeg's
    encoder writes: no modulo_time_base, intra_dc_vlc_thr 0)."""
    bits = _bits(packet)
    at = _vop_at(packet)
    kind = int(bits[at:at + 2], 2)
    at += 2
    while bits[at] == "1":
        at += 1
    at += 1 + 1 + increment_bits + 1 + 1
    return at + (1 if kind else 0) + 3 + 5 + (3 if kind else 0)


def _with_mb_bits(packet: bytes, mb_bits: str) -> bytes:
    """``packet`` cut at its first macroblock, which becomes ``mb_bits``
    followed by zeros."""
    at = _first_mb(packet)
    return _bytes(_bits(packet)[:at] + mb_bits + "0" * 64)


def _vol_edit(packet: bytes, edits) -> bytes:
    at = (packet.index(b"\x00\x00\x01\x20") + 4) * 8
    bits = list(_bits(packet))
    for bit, value in edits:
        bits[at + bit] = value
    return _bytes("".join(bits))


def _field(name: str, value: int):
    at, width = VOL_FIELDS[name]
    return [(at + k, b) for k, b in enumerate(format(value, f"0{width}b"))]


def _lavc(packet: bytes, text: bytes) -> bytes:
    """``packet`` with its user data string replaced (same length)."""
    old = b"Lavc62.28.101"
    assert len(text) == len(old) and old in packet
    return packet.replace(old, text)


def _refusals():
    """(case id, packets, fourcc, the name the refusal gives)."""
    i0, p1 = _packets("m4_mp4v.avi")[:2]
    vop = _vop_at(i0)
    no_user_data = i0.replace(b"\x00\x00\x01\xb2Lavc62.28.101", b"")
    cases = [
        ("bvop", [_bytes(_bits(i0)[:vop] + "10" + _bits(i0)[vop + 2:])],
         "B-VOP"),
        ("svop", [_bytes(_bits(i0)[:vop] + "11" + _bits(i0)[vop + 2:])],
         "S-VOP"),
        ("qpel", [_vol_edit(i0, _field("verid", 2) + [(81, "0"),
                                                       (82, "1")])],
         "quarter-pel"),
        ("verid", [_vol_edit(i0, _field("verid", 2) + [
            (81, "0"), (82, "0"), (83, "1"), (84, "1")])], "verid"),
        ("interlaced", [set_vol_bit(i0, "interlaced", 1)], "interlaced"),
        ("mpeg_quant", [set_vol_bit(i0, "quant_type", 1)],
         "MPEG quantisation"),
        ("sprite", [set_vol_bit(i0, "sprite_enable", 1)], "S-VOP"),
        ("resync", [set_vol_bit(i0, "resync_marker_disable", 0)],
         "resync markers"),
        ("partition", [set_vol_bit(i0, "data_partitioned", 1)],
         "data partitioning and RVLC"),
        ("shape", [set_vol_bit(i0, "shape", 1)], "non-rectangular"),
        ("not_8_bit", [set_vol_bit(i0, "not_8_bit", 1)], "not_8_bit"),
        ("scalability", [set_vol_bit(i0, "scalability", 1)],
         "scalability"),
        ("complexity", [set_vol_bit(i0, "complexity_estimation_disable",
                                    0)], "complexity estimation"),
        ("obmc", [set_vol_bit(i0, "obmc_disable", 0)], "OBMC"),
        ("vbv", [set_vol_bit(i0, "vbv_parameters", 1)], "VBV"),
        ("aspect", [set_vol_bit(i0, "aspect_ratio_info", 15)],
         "aspect ratio"),
        ("fixed_rate", [set_vol_bit(i0, "fixed_vop_rate", 1)],
         "fixed VOP rate"),
        ("studio", [set_vol_bit(i0, "vo_type", 14)], "studio"),
        ("resize", [i0, set_bits(i0, (i0.index(b"\x00\x00\x01\x20") + 4)
                                 * 8 + 48, 13, 64)], "changes the frame"),
        ("odd_height", [set_bits(i0, (i0.index(b"\x00\x00\x01\x20") + 4)
                                 * 8 + 62, 13, 31)], "odd frame height"),
        ("short_header", [b"\x00\x00\x80\x02" + i0[4:]],
         "short video header"),
        ("signal_type", [_bytes(_bits(i0).replace(
            _bits(b"\x00\x00\x01\xb5\x89\x13"),
            _bits(b"\x00\x00\x01\xb5\x89\x1b"), 1))], "video signal"),
        ("xvid_user_data", [_lavc(i0, b"XviD005500000")], "Xvid"),
        ("divx_user_data", [_lavc(i0, b"DivX503b1393p")], "DivX"),
        ("old_lavc", [_lavc(i0, b"Lavc0.0.4712x")], "old libavcodec"),
        ("dc_threshold", [set_bits(i0, _vop_at(i0) + 2 + 1 + 1 + 4 + 1 + 1,
                                   3, 1)], "intra_dc_vlc_thr"),
        ("dquant", [_with_mb_bits(i0, "0001")], "DQUANT"),
        ("stuffing", [_with_mb_bits(i0, "000000001")], "stuffing"),
        ("ac_pred", [_with_mb_bits(i0, "1" "1")], "AC prediction"),
        ("dc_size", [_with_mb_bits(i0, "1" "0" "11" "00000001")],
         "dct_dc_size 9"),
        ("4mv", [i0, _with_mb_bits(p1, "0" "010")], "4MV"),
        ("no_reference", [i0[:i0.index(b"\x00\x00\x01\xb6")] + p1],
         "before any I-VOP"),
    ]
    out = [(c, p, b"FMP4", m) for c, p, m in cases]
    out += [("xvid_fourcc", [no_user_data], b"XVID", "Xvid"),
            ("xvid_fourcc_lower", [no_user_data], b"xvid", "Xvid"),
            ("divx_fourcc", [_vol_edit(no_user_data, _field("vo_type", 0)
                                       + [(21, "0")])], b"DIVX", "DivX")]
    return out


REFUSALS = _refusals()


@pytest.mark.parametrize("case,packets,fourcc,match", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_each_tool_outside_the_set_is_refused_by_name(case, packets, fourcc,
                                                      match):
    """A hand-edited header bit (or a first macroblock's code) asking for
    a tool cv2.VideoWriter's streams never hold: UnsupportedImage naming
    it, at the packet that shows it."""
    if case == "divx_fourcc":
        # vol_control_parameters 0: the 4 bits it guarded go, and 4 bits
        # of stuffing keep the next start code on its byte
        p = packets[0]
        vol = p.index(b"\x00\x00\x01\x20")
        end = p.index(b"\x00\x00\x01", vol + 4) * 8
        bits = _bits(p)
        at = (vol + 4) * 8
        packets = [_bytes(bits[:at + 22] + bits[at + 26:end] + "1111"
                          + bits[end:])]
    dec = mpeg4.Mpeg4Decoder(b"", fourcc, case, "AVI")
    with pytest.raises(UnsupportedImage, match=match):
        for p in packets:
            dec.decode(p)
    dec.close()


def test_extradata_refusal_is_raised_at_open(tmp_path):
    """An MP4 whose VOL (in the esds) asks for OBMC, which FFmpeg ignores:
    VideoReader refuses it when it opens, naming the container, the codec
    and the tool, while cv2 reads it."""
    path = str(tmp_path / "obmc.mp4")
    write_cv2_clip(path, scene(32, 16, 1, 2), "mp4v")
    with open(path, "rb") as f:
        data = set_vol_bit(f.read(), "obmc_disable", 0)
    with open(path, "wb") as f:
        f.write(data)
    assert len(cv2_frames(path)) == 2
    with pytest.raises(UnsupportedVideo,
                       match="MP4 with MPEG-4 Part 2 video \\(mp4v\\) using "
                             "OBMC"):
        VideoReader(path)


@pytest.mark.parametrize("fourcc", [b"FMP4", b"mp4v", b"DX50"])
def test_stream_without_user_data_decodes_as_cv2(tmp_path, fourcc):
    """The clip with its "Lavc" user data cut out, under fourccs FFmpeg
    takes for no particular encoder: cv2's frames (no workaround, the
    simple IDCT), in the port too; under XVID or DIVX it is refused
    (test_each_tool_outside_the_set_is_refused_by_name)."""
    packets = [p.replace(b"\x00\x00\x01\xb2Lavc62.28.101", b"")
               for p in _packets("m4_cut.avi")]
    assert b"Lavc" not in b"".join(packets)
    path = str(tmp_path / "plain.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets, 96, 64, fourcc=fourcc))
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_a_packet_it_cannot_read_ends_the_reader(tmp_path):
    """The third packet cut to its header: the frames before it, then the
    reader ends (where cv2's read first returns False in JAX's loop)."""
    packets = _packets("m4_mp4v.avi")
    packets[2] = packets[2][:12]
    path = str(tmp_path / "cut.avi")
    with open(path, "wb") as f:
        f.write(mux_avi(packets, 48, 32, fourcc=b"FMP4"))
    with VideoReader(path) as reader:
        got = list(reader)
    want = cv2_frames(os.path.join(OUT, "m4_mp4v.avi"))[:2]
    assert len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dec = mpeg4.Mpeg4Decoder(b"", b"FMP4")
    dec.decode(packets[0])
    with pytest.raises(DecodeError):
        dec.decode(b"\x00\x00\x01\xb6")


def test_mutated_packets_never_crash():
    """Random byte and bit mutations of the committed clips' packets (and
    truncations): every call returns a frame, no frame, or raises
    DecodeError / UnsupportedImage, and the decoder goes on."""
    rng = np.random.default_rng(2024)
    sources = [_packets(n) for n in ("m4_mp4v.avi", "m4_motion.avi",
                                     "m4_cut.avi", "m4_rate_fps60.avi")]
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
        dec = mpeg4.Mpeg4Decoder(b"", b"FMP4")
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


def test_planes_crop_and_convert_as_the_raw_path(tmp_path):
    """The decoder's yuv420p planes through rawvideo.yuv420p_to_bgr give
    the frame it returns (one converter for both paths), at an odd
    width."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    packets = _packets("m4_odd_95x64.avi")
    dec = mpeg4.Mpeg4Decoder(b"", b"FMP4")
    for p in packets:
        frame = dec.decode(p)
        assert frame.shape == (64, 95, 3)
        y, u, v = dec.planes(95, 64)
        np.testing.assert_array_equal(yuv420p_to_bgr(y, u, v), frame)
    dec.close()


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


def test_acq_then_recon_on_the_mp4v_clip_equals_the_jax_cli(tmp_path):
    """acq from the 640x480 mp4v clip with the committed depth directory
    writes the pixels the JAX CLI wrote, and recon on that package prints
    the JAX CLI's lines in the default ICP setting (recon.json)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    name = "pan_mp4v.avi"
    with open(os.path.join(OUT, "recon.json")) as f:
        want = json.load(f)["sources"][name]
    pkg = str(tmp_path / "pkg")
    rc, _ = _run(["acq", os.path.join(OUT, name), pkg, "--depth-dir",
                  os.path.join(OUT, "depth"), "--device", "cpu"])
    assert rc == 0
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(pkg, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(pkg, sub)))}
        assert got == names, sub
    rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                      "--series", pkg, "--device", "cpu"])
    assert rc == 0 and len(lines) == RECON_SOURCES[name]
    _same_lines(lines, want["a"])
