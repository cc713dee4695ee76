"""The containers demuxed for codecs the port already decodes, held to
``cv2.VideoCapture`` on the CPU: MPEG program streams (``io/mpegps``),
transport streams and BDAV's (``io/mpegts``), fragmented MP4
(``io/isobmff``), Ogg (``io/ogg``), FLV (``io/flv``), ASF (``io/asf``)
and NUT (``io/nut``).  The committed sources of ``tests/data/torch_demux``
(``python -m tests.make_torch_video demux``: the writer's files and
hand-muxed ones from ``tests/stream_mux.py``) are held bit for bit to
cv2 and to the digests chip_smoke.py holds the card to; files cv2 does
not open raise OSError, codecs cv2 reads and the port does not are
named; one transport stream also goes through both packages'
``ImageSeriesReader``, and ``acq`` from the 640x480 MPEG-TS, then
``recon``, is held to the JAX CLI's recorded output.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import struct

import cv2
import numpy as np
import pytest

from fealess_tpu.io.series import ImageSeriesReader as JaxReader
from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import crc, mpegvideo
from fealess_tpu_torch.io.series import ImageSeriesReader
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import stream_mux as sm
from tests.make_torch_video import (DEMUX_OUT, DEMUX_RECON_SOURCES, OUT,
                                    cv2_frames, digest, scene, sha256,
                                    write_ffmpeg_clip)

with open(os.path.join(DEMUX_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def _write(tmp_path, data: bytes, name: str) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _opens(path: str) -> bool:
    cap = cv2.VideoCapture(path)
    try:
        return cap.isOpened()
    finally:
        cap.release()


def _src(name: str) -> str:
    return os.path.join(DEMUX_OUT, name)


def test_the_digests_list_every_committed_source():
    names = sorted(n for n in os.listdir(DEMUX_OUT)
                   if not n.endswith(".json"))
    assert names == sorted(DIGESTS)
    assert sum(os.path.getsize(_src(n)) for n in names) < 700_000


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_source_matches_cv2_and_the_digest(name):
    """cv2 still gives the recorded digest (which chip_smoke.py holds the
    port to on the card), and the port gives cv2's frames bit for bit."""
    path = _src(name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        got = list(reader)
    assert {"frames": len(got), "shapes": [list(f.shape) for f in got],
            "sha256": [sha256(f) for f in got]} == DIGESTS[name]


@pytest.mark.parametrize("name,kind", [
    ("mpg_MPG2.mpg", "MPEG program stream"),
    ("vob_XVID.vob", "MPEG program stream"),
    ("ts_mp4v.ts", "MPEG transport stream"),
    ("m2ts_MPG2.m2ts", "MPEG transport stream"),
    ("ismv_MPG2.ismv", "MP4"), ("ogv_VP80.ogv", "Ogg"),
    ("flv_VP90.flv", "FLV"), ("wmv_MPG2.wmv", "ASF"),
    ("nut_I420.nut", "NUT")])
def test_each_container_picks_its_demuxer(name, kind):
    """The first bytes pick the demuxer; MPEG-2 in fragmented MP4 sits
    under the tag mp4v, its object type 0x61 sending it to io/mpeg2."""
    with VideoReader(_src(name)) as reader:
        assert reader.container == kind
        if name.startswith("ismv_MPG2"):
            assert (reader.codec, reader.fourcc) == ("mpeg2", b"mp4v")


@pytest.mark.parametrize("fourcc,ext", [
    (f, e) for f in ("MJPG", "FFV1", "I420", "VP80") for e in ("ts", "m2ts")]
    + [("MJPG", "mpg"), ("VP90", "vob")])
def test_mpeg_streams_of_no_codec_ffmpeg_finds_do_not_open(tmp_path, fourcc,
                                                           ext):
    """What the writer writes for these codecs in program and transport
    streams (private data in the PMT, a payload no probe takes): cv2 does
    not open it, and the port raises OSError as the JAX reader does."""
    path = str(tmp_path / f"x.{ext}")
    write_ffmpeg_clip(path, scene(48, 32, 80, 2), fourcc)
    assert not _opens(path)
    with pytest.raises(OSError, match="cannot open video source"):
        VideoReader(path)
    with pytest.raises(OSError, match="cannot open video source"):
        JaxReader(path)


@pytest.mark.parametrize("packet", ["main", "stream"])
def test_nut_header_checksum_fails_as_in_cv2(tmp_path, packet):
    """A main or stream header whose checksum fails, with none after it:
    cv2 does not open the file, nor does the port."""
    with open(_src("nut_syncpoints.nut"), "rb") as f:
        data = bytearray(f.read())
    code = sm.NUT_MAIN if packet == "main" else sm.NUT_STREAM
    data[data.index(code) + 12] ^= 1
    path = _write(tmp_path, bytes(data), "bad.nut")
    assert not _opens(path)
    with pytest.raises(OSError, match="cannot open video source"):
        VideoReader(path)


def test_flv_sorenson_spark_is_refused_by_its_queued_name(tmp_path):
    """Legacy FLV video of codec id 2 (what the writer writes for FLV1):
    cv2 reads it, and so does the port now that Sorenson Spark has left
    QUEUED_FOURCCS (io/h263): cv2's frames, and no refusal naming it."""
    path = str(tmp_path / "x.flv")
    write_ffmpeg_clip(path, scene(48, 32, 81, 3), "FLV1")
    with open(path, "rb") as f:
        assert f.read()[13 + 11 + 184 + 4 + 11] & 0x0F == 2
    want = cv2_frames(path)
    assert len(want) == 3
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_program_stream_map_is_refused_by_name(tmp_path):
    """A program stream map (which the writer never writes): cv2 reads the
    stream, the port names the map."""
    with open(_src("ps_mpeg1_packs.mpg"), "rb") as f:
        data = f.read()
    psm_body = b"\xe0\xff\x00\x00\x00\x04\x02\xe0\x00\x00"
    psm = b"\x00\x00\x01\xbc" + struct.pack(">H", len(psm_body) + 4) + \
        psm_body
    psm += struct.pack(">I", crc.crc32(psm, 0xFFFFFFFF))
    at = data.index(b"\x00\x00\x01\xe0")
    path = _write(tmp_path, data[:at] + psm + data[at:], "psm.mpg")
    assert len(cv2_frames(path)) == DIGESTS["ps_mpeg1_packs.mpg"]["frames"]
    with pytest.raises(UnsupportedVideo, match="program stream map"):
        VideoReader(path)


@pytest.mark.parametrize("stream_type,name", [
    (0x1B, "H.264"), (0x24, "HEVC"), (0xEA, "VC-1")])
def test_transport_stream_codecs_the_port_does_not_decode_are_named(
        tmp_path, stream_type, name):
    pictures = mpegvideo.packets(_payload("ts_MPG2.ts"))
    path = _write(tmp_path, sm.mux_ts(pictures, stream_type), "x.ts")
    with pytest.raises(UnsupportedVideo, match=f"{name} video"):
        VideoReader(path)


def _payload(name: str) -> bytes:
    from fealess_tpu_torch.io.mpegts import MpegTsFile
    return MpegTsFile(_src(name)).payload()


@pytest.mark.parametrize("edit,match", [
    ("theora", "Theora"), ("asf_compressed", "compressed payloads"),
    ("nut_side_data", "side data"), ("moof_description", "description 2"),
    ("flv_av1", "AV1")])
def test_kinds_the_writer_never_writes_are_named(tmp_path, edit, match):
    """Hand-edited kinds no writer here writes, each refused by name:
    Theora in Ogg, ASF's compressed payloads, NUT frames with side data,
    MP4 fragments of a second sample description (by trex's default), AV1
    in enhanced FLV."""
    if edit == "theora":
        data = sm.mux_ogg([b"\x80theora" + bytes(40), b"x" * 9], headers=1)
        name = "x.ogv"
    elif edit == "asf_compressed":
        with open(_src("asf_fragments.asf"), "rb") as f:
            data = bytearray(f.read())
        first = struct.unpack_from("<Q", data, 16)[0] + 50
        data[first + 3 + 2 + 2 + 6 + 1 + 1 + 4] = 1   # replicated length
        data, name = bytes(data), "x.asf"
    elif edit == "nut_side_data":
        with open(_src("nut_syncpoints.nut"), "rb") as f:
            data = bytearray(f.read())
        at = data.index(sm.NUT_SYNC)
        at += 8 + 1 + data[at + 8]               # past the syncpoint
        at = data.index(sm.NUT_INFO, at)
        at += 8 + 1 + data[at + 8]               # past the info packet
        assert data[at] == 0 and data[at + 1] & 0x80 == 0x80
        coded = ((data[at + 1] & 0x7F) << 7 | data[at + 2]) ^ 256
        data[at + 1:at + 3] = bytes([0x80 | coded >> 7, coded & 0x7F])
        data, name = bytes(data), "x.nut"
    elif edit == "moof_description":
        with open(_src("fmp4_defaults.ismv"), "rb") as f:
            data = bytearray(f.read())
        at = data.index(b"trex") + 4 + 8          # the default description
        data[at:at + 4] = struct.pack(">I", 2)
        data, name = bytes(data), "x.ismv"
    else:
        with open(_src("flv_VP90.flv"), "rb") as f:
            data = f.read().replace(b"vp09", b"av01")
        name = "x.flv"
    path = _write(tmp_path, data, name)
    with pytest.raises(UnsupportedVideo, match=match):
        with VideoReader(path) as reader:
            list(reader)


def test_crc_is_the_msb_first_polynomial_of_ffmpeg():
    """io/crc against a bitwise reference on random data, from 0 and
    from 0xFFFFFFFF; CRC-32/MPEG-2's check value; a checksum stored after
    its bytes brings the CRC to 0; Ogg's stored page CRC."""
    def reference(data, c):
        for b in data:
            c ^= b << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7 if c & 0x80000000 else c << 1) \
                    & 0xFFFFFFFF
        return c
    rng = random.Random(5)
    for n in (0, 1, 7, 300):
        data = bytes(rng.randrange(256) for _ in range(n))
        for start in (0, 0xFFFFFFFF):
            assert crc.crc32(data, start) == reference(data, start)
    assert crc.crc32(b"123456789", 0xFFFFFFFF) == 0x0376E6E7
    data = b"nut packet body"
    assert crc.crc32(data + struct.pack(">I", crc.crc32(data))) == 0
    with open(_src("ogv_VP80.ogv"), "rb") as f:
        page = bytearray(f.read(200))
    stored = struct.unpack_from("<I", page, 22)[0]
    page[22:26] = bytes(4)
    end = 27 + page[26] + sum(page[27:27 + page[26]])
    assert crc.crc32(bytes(page[:end])) == stored


def test_mpeg4_packets_cut_after_each_vop():
    """FFmpeg's mpeg4video parser: the headers before a VOP go with it;
    the cut falls at the first start code after the VOP's."""
    vos, vol, vop = (b"\x00\x00\x01\xb0\x01", b"\x00\x00\x01\x20\x08\x80",
                     b"\x00\x00\x01\xb6\x10\x20")
    gov = b"\x00\x00\x01\xb3\x00"
    stream = vos + vol + vop + vop + gov + vop + b"\x00\x00\x01\xb1"
    assert mpegvideo.mpeg4_packets(stream) == [
        vos + vol + vop, vop, gov + vop, b"\x00\x00\x01\xb1"]
    assert mpegvideo.payload_codec(stream) == "mpeg4"
    assert mpegvideo.payload_codec(b"\x00\x00\x01\x00" + vol) == "mpeg4"
    assert mpegvideo.payload_codec(b"\x00\x00\x01\xb3\x06") == "mpeg2"
    assert mpegvideo.payload_codec(b"\x00\x00\x00\x01\x67") == "H.264"
    assert mpegvideo.payload_codec(b"\xff\xd8\xff\xe0") is None


def test_transport_stream_through_both_series_readers():
    """A committed MPEG-TS through the port's ImageSeriesReader and the
    JAX package's (which reads through cv2), with and without
    target_wh: the same stems and frames."""
    path = _src("ts_MPG2.ts")
    for target in (None, (48, 40)):
        got = list(ImageSeriesReader(path, target).iter_named())
        want = list(JaxReader(path, target).iter_named())
        assert [s for s, _ in got] == [s for s, _ in want] == [None] * 8
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- acq and recon from the committed 640x480 MPEG-TS ----

def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def ts_package(tmp_path_factory):
    """acq from the 640x480 MPEG-TS with the committed depth directory
    (its first two frames, paired by position)."""
    pkg = str(tmp_path_factory.mktemp("ts") / "pkg")
    rc, _ = _run(["acq", _src("pan_ts.ts"), pkg, "--depth-dir",
                  os.path.join(OUT, "depth"), "--device", "cpu"])
    assert rc == 0
    return pkg


def test_acq_from_the_transport_stream_writes_the_jax_pixels(ts_package):
    with open(os.path.join(DEMUX_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_ts.ts"]
    for sub, names in want["acq"].items():
        got = {n: sha256(cv2.imread(os.path.join(ts_package, sub, n),
                                    cv2.IMREAD_UNCHANGED))
               for n in sorted(os.listdir(os.path.join(ts_package, sub)))}
        assert got == names, sub


def test_recon_on_the_transport_stream_package_equals_the_jax_cli(
        ts_package):
    """recon on what acq wrote from the MPEG-TS prints the JAX CLI's lines
    in the default ICP setting (a); the forced setting (b) is held on the
    card (chip_smoke phase 7f)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    with open(os.path.join(DEMUX_OUT, "recon.json")) as f:
        want = json.load(f)["sources"]["pan_ts.ts"]
    frames = DEMUX_RECON_SOURCES["pan_ts.ts"]
    rc, lines = _run(["recon", os.path.join(fixture.FIXTURE, "features"),
                      "--series", ts_package, "--device", "cpu"])
    assert rc == 0 and len(lines) == frames
    _same_lines(lines, want["a"][:frames])


def test_chip_smoke_demux_part_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 7f part for the demuxers, its acq and recon
    set aside: every committed source to its digests, each container's
    640x480 mux decoded to the same packets' frames in AVI, the host
    times printed."""
    import chip_smoke
    calls, failed = [], []
    monkeypatch.setattr(chip_smoke, "acq_recon_source",
                        lambda *a, **k: calls.append(a[4:6]))
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, msg: ok or failed.append(msg))
    monkeypatch.setattr(chip_smoke, "DECODE_TIMED", 1)
    chip_smoke.demux_sources(None, "cpu rehearsal", None, None)
    assert not failed, failed
    assert calls == [("pan_ts.ts", DEMUX_RECON_SOURCES["pan_ts.ts"])]
    out = capsys.readouterr().out
    assert f"{len(DIGESTS)} committed sources" in out
    for kind in ("MPEG program stream (MPEG-2)", "Ogg (VP8)", "FLV (VP9)",
                 "ASF (Motion JPEG)", "NUT (MPEG-4 Part 2)",
                 "fragmented MP4 (Motion JPEG)",
                 "BDAV MPEG transport stream (MPEG-2)"):
        assert kind in out
