"""WMV8 in the port (``csrc/msmpeg4_decode.c``'s version 5 on the
macroblock layer ``csrc/h263_mb.h`` with its own inverse transform, the
tables of ``csrc/msmpeg4_tables.h``, through ``io/wmv2.py`` and
``io/video.VideoReader``) against cv2 5.0.0 and the JAX package: the
committed sources of ``tests/data/torch_wmv2`` (``python -m
tests.make_torch_video wmv2``: the writer's WMV2 in AVI, MOV, Matroska,
ASF, WMV and NUT, at 640x480 down to 94x62, P pictures in each qscale
band, that noise re-encoded by ``tests/wmv2_edit.py`` with the run/level
tables and cbp_index values the writer never picks, and the writer's
packets under a 95x63 header) decode to cv2's frame count and per-frame
sha256 and together reach every syntax path the decoder counts; the
header's tables are what cv2's libavcodec holds; what the writer never
writes is refused by name on edited bits; a packet cut short ends the
reader; and ``acq`` from the 640x480 ``.wmv`` writes the JAX CLI's
pixels, on which ``recon`` prints the JAX CLI's lines."""

from __future__ import annotations

import contextlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import wmv2
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import msmpeg4_tables, wmv2_edit
from tests.make_torch_video import (OUT, WMV2_OUT, WMV2_RECON_SOURCES,
                                    WMV2_RETABLED, cv2_frames, digest,
                                    mux_avi, sha256, wmv2_committed_sources)
from tests.test_torch_msmpeg4 import (_bits, _decode012, _read_vlc, _set,
                                      _vlc)

torch.set_num_threads(1)

with open(os.path.join(WMV2_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)

# the noise source re-encoded with each (rl, rl_chroma, cbp_index)
RETABLED = {f"wmv2_rl{rl}_rlc{rlc}_cbp{cbp}.avi": (rl, rlc, cbp)
            for rl, rlc, cbp in WMV2_RETABLED}


def _src(name: str) -> str:
    return os.path.join(WMV2_OUT, name)


def _write(tmp_path, data: bytes, name: str) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _stream(name: str):
    """(packets, extradata) of a committed source."""
    with VideoReader(_src(name)) as reader:
        return list(reader._packets()), reader.extradata


def _frames_digest(frames) -> dict:
    return {"frames": len(frames), "shapes": [list(f.shape) for f in frames],
            "sha256": [sha256(f) for f in frames]}


def _qscale(packet: bytes) -> int:
    """A picture's quantiser: after the type bit, and an I picture's
    7-bit code."""
    bits = _bits(packet[:2])
    return int(bits[1:6], 2) if bits[0] == "1" else int(bits[8:13], 2)


def test_the_digests_list_every_committed_source():
    assert sorted(DIGESTS) == wmv2_committed_sources()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_source_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them."""
    path = _src(name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        assert _frames_digest(list(reader)) == DIGESTS[name]


def _decode_counting(name: str):
    """((container, fourcc, extradata), frames, path counts)."""
    with VideoReader(_src(name)) as reader:
        dec = wmv2.WMV2Decoder(reader.extradata, reader.width, reader.height)
        frames = [dec.decode(p) for p in reader._packets()]
        kind = (reader.container, reader.fourcc, reader.extradata)
    counts = dec.counts()
    dec.close()
    return kind, frames, counts


def test_sources_cover_every_container_size_and_path():
    """The sources hold WMV8 in every container the writer puts it in,
    each with the writer's 4-byte extension header, at 640x480, 128x96,
    96x64, 95x63 and 94x62, and every syntax path the decoder counts
    occurs in at least one of them."""
    total = dict.fromkeys(wmv2.PATHS, 0)
    containers, sizes = set(), set()
    for name in DIGESTS:
        (container, fourcc, extradata), frames, counts = \
            _decode_counting(name)
        containers.add(container)
        sizes.add(frames[0].shape[:2])
        assert fourcc == b"WMV2" and len(extradata) == 4, name
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
    assert containers == {"AVI", "MP4", "Matroska", "ASF", "NUT"}
    assert sizes == {(480, 640), (96, 128), (64, 96), (63, 95), (62, 94)}
    assert [k for k, v in total.items() if not v] == []


@pytest.mark.parametrize("name, cbp_index", [
    ("wmv2_qscale_bands.avi", 0)] + [(n, v[2]) for n, v in RETABLED.items()])
def test_p_pictures_take_the_cbp_table_of_their_qscale_band(name,
                                                            cbp_index):
    """The noise source's P pictures run from qscale 3 to over 20: each
    decodes its macroblock types with the CBP table
    wmv2_get_cbp_table_index gives for its cbp_index and qscale band (up
    to 10, 11-20, above), every band occurring; the writer writes
    cbp_index 0, the re-encoded sources 1 and 2."""
    packets, extradata = _stream(name)
    dec = wmv2.WMV2Decoder(extradata, 96, 64)
    tables = ("CBP_TABLE0", "CBP_TABLE1", "CBP_TABLE2")
    seen = set()
    for p in packets:
        before = dec.counts()
        dec.decode(p)
        after = dec.counts()
        moved = [k for k in tables if after[k] != before[k]]
        if _bits(p[:1])[0] == "1":
            q = _qscale(p)
            band = (q > 10) + (q > 20)
            table = tables[wmv2_edit.CBP_MAP[band][cbp_index]]
            assert moved == [table] and after[table] == before[table] + 1, q
            seen.add(band)
        else:
            assert moved == []
    assert seen == {0, 1, 2}
    dec.close()


@pytest.mark.parametrize("name", sorted(RETABLED))
def test_retabled_sources_are_the_noise_with_other_tables(name):
    """Each re-encoded source is ``tests/wmv2_edit.retable`` of the
    writer's noise source, packet for packet; its headers carry the
    run/level and CBP table indices asked for; cv2 decodes it to the noise
    source's very frames (the coefficients did not change); and the
    decoder reads its blocks with those run/level tables alone."""
    rl, rl_chroma, cbp_index = RETABLED[name]
    packets, extradata = _stream("wmv2_qscale_bands.avi")
    edited, edited_extradata = _stream(name)
    assert edited_extradata == extradata
    assert edited == wmv2_edit.retable(packets, 96, 64, rl, rl_chroma,
                                       cbp_index)
    for p in edited:
        pic = wmv2_edit.walk(p, 6, 4)
        assert (pic["rl"], pic["rl_chroma"]) == \
            ((rl, rl) if pic["p"] else (rl, rl_chroma))
        assert pic.get("cbp_index", cbp_index) == cbp_index
    assert DIGESTS[name]["sha256"] == \
        DIGESTS["wmv2_qscale_bands.avi"]["sha256"]
    _, _, counts = _decode_counting(name)
    used = {f"RL{k}" for k in (rl, 3 + rl, 3 + rl_chroma)}
    assert {k for k in ("RL0", "RL1", "RL2", "RL3", "RL4", "RL5")
            if counts[k]} == used


def test_the_tables_check_and_hold_three_wmv8_cbp_tables():
    """``python -m tests.msmpeg4_tables --check`` passes on the committed
    header, whose WMV8 CBP tables are the three ff_wmv2_inter_table
    entries before ff_table_mb_non_intra, each a complete prefix code of
    128 macroblock types and none equal to another."""
    assert msmpeg4_tables.main(["--check"]) == 0
    tables = msmpeg4_tables.extract(msmpeg4_tables.libavcodec())
    inter = tables["wmv2_inter"] + [tables["mb_non_intra"]]
    assert len(inter) == 4 and all(len(t) == 128 for t in inter)
    for k, table in enumerate(inter):
        msmpeg4_tables.check_prefix_code(*zip(*table), f"inter {k}")
    assert len({tuple(t) for t in inter}) == 4


# ---- edits of the writer's stream ----

def _i_fields(packet: bytes) -> dict:
    """Bit offsets of an I picture's header fields and of its first
    macroblock's AC prediction flag."""
    bits = _bits(packet)
    dc = _decode012(bits, _decode012(bits, 15))
    return {"j_type": 13, "per_mb_rl": 14, "dc": dc,
            "ac_pred": _read_vlc(bits, dc + 1, _vlc("msmp4_mb_i"))}


def _p_fields(packet: bytes) -> dict:
    """Bit offsets of a P picture's header fields."""
    bits = _bits(packet)
    mspel = _decode012(bits, 8)                    # after cbp_index
    per_mb_rl = _decode012(bits, mspel + 2)        # after abt_type
    dc = _decode012(bits, per_mb_rl + 1)           # after the rl index
    return {"skip": 6, "mspel": mspel, "per_mb_abt": mspel + 1,
            "abt_type": mspel + 2, "per_mb_rl": per_mb_rl, "dc": dc,
            "mv": dc + 1}


# extension header bits (FFmpeg's decode_ext_header)
EXT_FIELDS = {"loop_filter": 17, "top_left_mv": 20, "slice_code": 22}


def _i(field: str, value: str):
    def edit(ps, ext):
        return [_set(ps[0], _i_fields(ps[0])[field], value)] + ps[1:], ext
    return edit


def _p(field: str, value: str):
    def edit(ps, ext):
        return [p if _bits(p[:1])[0] == "0" else
                _set(p, _p_fields(p)[field], value) for p in ps], ext
    return edit


def _ext(field: str, value: str):
    return lambda ps, ext: (ps, _set(ext, EXT_FIELDS[field], value))


REFUSALS = {
    "intrax8": (_i("j_type", "1"), "IntraX8"),
    "per_mb_rl_i": (_i("per_mb_rl", "1"), "per macroblock"),
    "dc_table0_i": (_i("dc", "0"), "DC table 0"),
    "ac_pred": (_i("ac_pred", "1"), "AC prediction"),
    "skip_mpeg": (_p("skip", "01"), "skipped macroblocks"),
    "skip_rows": (_p("skip", "10"), "skipped macroblocks"),
    "mspel": (_p("mspel", "1"), "mspel"),
    "abt_per_mb": (_p("per_mb_abt", "0"), "ABT"),
    "abt_8x4": (_p("abt_type", "1"), "ABT"),
    "per_mb_rl_p": (_p("per_mb_rl", "1"), "per macroblock"),
    "dc_table0_p": (_p("dc", "0"), "DC table 0"),
    "mv_table0": (_p("mv", "0"), "MV table 0"),
    "loop_filter": (_ext("loop_filter", "1"), "loop filter"),
    "top_left_mv": (_ext("top_left_mv", "1"), "top-left MV"),
    "two_slices": (_ext("slice_code", "010"), "slice code"),
    "slice_code0": (_ext("slice_code", "000"), "slice code"),
    "no_ext_header": (lambda ps, ext: (ps, b""), "extension header"),
    "no_reference": (lambda ps, ext: (ps[1:], ext), "before any I"),
}


@pytest.mark.parametrize("edit", sorted(REFUSALS))
def test_what_the_writer_never_writes_is_refused_by_name(tmp_path, edit):
    """Each edit turns on a tool the writer never writes (a bit of a
    picture header, of the first macroblock or of the extension header;
    or drops the header or the first I picture): cv2 reads the file, the
    port names the tool."""
    fn, match = REFUSALS[edit]
    packets, extradata = fn(*_stream("wmv2_pan.avi"))
    path = _write(tmp_path, mux_avi(packets, 96, 64, fourcc=b"WMV2",
                                    extradata=extradata), "x.avi")
    assert len(cv2_frames(path)) >= 1
    with pytest.raises(UnsupportedVideo, match=match):
        with VideoReader(path) as reader:
            list(reader)


def test_the_unedited_bits_read_back():
    """The edit helpers find the fields the decoder reads: setting each
    to the value the writer wrote changes no packet and no extradata."""
    packets, extradata = _stream("wmv2_pan.avi")
    for p in packets:
        if _bits(p[:1])[0] == "0":
            f = _i_fields(p)
            for field, value in (("j_type", "0"), ("per_mb_rl", "0"),
                                 ("dc", "1"), ("ac_pred", "0")):
                assert _set(p, f[field], value) == p, field
        else:
            f = _p_fields(p)
            for field, value in (("skip", "00"), ("mspel", "0"),
                                 ("per_mb_abt", "1"), ("abt_type", "0"),
                                 ("per_mb_rl", "0"), ("dc", "1"),
                                 ("mv", "1")):
                assert _set(p, f[field], value) == p, field
    for field, value in (("loop_filter", "0"), ("top_left_mv", "0"),
                         ("slice_code", "001")):
        assert _set(extradata, EXT_FIELDS[field], value) == extradata


def test_a_packet_cut_short_ends_the_reader(tmp_path):
    """The fifth picture cut to half its bytes: cv2 conceals the rest of
    it and goes on; the port gives the four frames before it and ends
    there, as the JAX reader's loop does at the first frame cv2 does not
    serve as written."""
    packets, extradata = _stream("wmv2_pan.avi")
    cut = packets[:4] + [packets[4][:len(packets[4]) // 2]] + packets[5:]
    path = _write(tmp_path, mux_avi(cut, 96, 64, fourcc=b"WMV2",
                                    extradata=extradata), "cut.avi")
    want = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    assert len(got) == 4 and len(want) > 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mutated_packets_never_crash():
    """Bits flipped at random in the writer's packets and extension
    headers: each open and decode gives a decoder, a frame, a refusal or
    DecodeError, never a crash."""
    rng = np.random.default_rng(30)
    for name in ("wmv2_pan.avi", "wmv2_qscale_bands.avi"):
        packets, extradata = _stream(name)
        for trial in range(40):
            ext = bytearray(extradata)
            if trial % 4 == 0:
                ext[int(rng.integers(0, 4))] ^= 1 << int(rng.integers(0, 8))
            try:
                dec = wmv2.WMV2Decoder(bytes(ext), 96, 64)
            except UnsupportedImage:
                continue
            for p in packets[:8]:
                b = bytearray(p)
                for _ in range(int(rng.integers(1, 4))):
                    b[int(rng.integers(0, len(b)))] ^= 1 << int(
                        rng.integers(0, 8))
                if trial % 3 == 0:
                    b = b[:int(rng.integers(0, len(b) + 1))]
                try:
                    frame = dec.decode(bytes(b))
                    assert frame.shape == (64, 96, 3)
                except (DecodeError, UnsupportedImage):
                    pass
            dec.close()


def test_planes_crop_and_convert_as_the_raw_path():
    """The decoder's planes, cropped to 95x63, give its BGR frame through
    the raw yuv420p converter."""
    from fealess_tpu_torch.io.rawvideo import yuv420p_to_bgr
    packets, extradata = _stream("wmv2_95x63.avi")
    dec = wmv2.WMV2Decoder(extradata, 95, 63)
    for p in packets[:2]:
        frame = dec.decode(p)
    y, u, v = dec.planes()
    assert y.shape == (63, 95) and u.shape == v.shape == (32, 48)
    np.testing.assert_array_equal(yuv420p_to_bgr(y, u, v), frame)
    dec.close()


def test_decoder_arguments_are_checked():
    _, extradata = _stream("wmv2.avi")
    with pytest.raises(DecodeError, match="size"):
        wmv2.WMV2Decoder(extradata, 0, 64)
    with pytest.raises(UnsupportedImage, match="extension header"):
        wmv2.WMV2Decoder(extradata[:3], 96, 64)
    assert wmv2.codec_of(b"WMV2") == "wmv2"
    assert wmv2.codec_of(b"WMV1") == wmv2.codec_of(b"ASV1") == ""


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


def test_acq_then_recon_on_the_wmv_equals_the_jax_cli(tmp_path):
    """acq from the 640x480 WMV8 ``.wmv`` with the committed depth
    directory writes the pixels the JAX CLI wrote, and recon on that
    package prints the JAX CLI's lines in the default ICP setting
    (recon.json; the forced setting is held on the card)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    name = "pan_wmv2.wmv"
    with open(os.path.join(WMV2_OUT, "recon.json")) as f:
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
    assert rc == 0 and len(lines) == WMV2_RECON_SOURCES[name]
    _same_lines(lines, want["a"])


def test_chip_smoke_wmv2_part_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 7f part for WMV8, its acq and recon set
    aside: every committed source to its digests, the host times
    printed."""
    import chip_smoke
    calls, failed = [], []
    monkeypatch.setattr(chip_smoke, "acq_recon_source",
                        lambda *a, **k: calls.append(a[4:6]))
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, msg: ok or failed.append(msg))
    monkeypatch.setattr(chip_smoke, "DECODE_TIMED", 1)
    chip_smoke.wmv2_sources(None, "cpu rehearsal", None, None)
    assert not failed, failed
    assert calls == [("pan_wmv2.wmv", WMV2_RECON_SOURCES["pan_wmv2.wmv"])]
    out = capsys.readouterr().out
    assert f"{len(DIGESTS)} committed sources" in out
    for kind in ("640x480 WMV8 I", "640x480 WMV8 P",
                 "VideoReader a 640x480 WMV8 frame",
                 "time phase 7f WMV8 part"):
        assert kind in out
