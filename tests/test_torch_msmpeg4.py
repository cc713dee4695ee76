"""MS MPEG-4 v2, MS MPEG-4 v3 and WMV7 in the port
(``csrc/msmpeg4_decode.c`` on the macroblock layer ``csrc/h263_mb.h``,
with the tables of ``csrc/msmpeg4_tables.h``, through ``io/msmpeg4.py`` and
``io/video.VideoReader``) against cv2 5.0.0 and the JAX package: the
committed sources of ``tests/data/torch_msmpeg4`` (``python -m
tests.make_torch_video msmpeg4``: the writer's three codecs under every
fourcc it takes in AVI, each in MOV, Matroska, ASF, WMV and NUT, at
640x480 down to 96x64, WMV7 on both sides of its inter-intra switch, and
the writer's packets under a 95x63 header) decode to cv2's frame count and
per-frame sha256 and together reach every syntax path the decoder counts;
the header's tables are what cv2's libavcodec holds; what the writer never
writes is refused by name on edited bits; a packet cut short ends the
reader; and ``acq`` from the 640x480 DIV3 AVI writes the JAX CLI's pixels,
on which ``recon`` prints the JAX CLI's lines."""

from __future__ import annotations

import contextlib
import io
import json
import os
import re

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import cli
from fealess_tpu_torch.io import msmpeg4, wmv2
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.video import UnsupportedVideo, VideoReader
from tests import msmpeg4_tables
from tests.make_torch_video import (MSMPEG4_ALIASES, MSMPEG4_OUT,
                                    MSMPEG4_RECON_SOURCES, OUT, cv2_frames,
                                    digest, msmpeg4_committed_sources,
                                    mux_avi, sha256)

torch.set_num_threads(1)

with open(os.path.join(MSMPEG4_OUT, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def _src(name: str) -> str:
    return os.path.join(MSMPEG4_OUT, name)


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
    assert sorted(DIGESTS) == msmpeg4_committed_sources()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_source_decodes_to_cv2_digests(name):
    """cv2 still gives the recorded digests, and VideoReader gives them."""
    path = _src(name)
    assert digest(path) == DIGESTS[name]
    with VideoReader(path) as reader:
        assert _frames_digest(list(reader)) == DIGESTS[name]


def _decode_counting(name: str):
    """((codec, container, fourcc), frames, path counts)."""
    with VideoReader(_src(name)) as reader:
        dec = msmpeg4.MSMPEG4Decoder(reader.codec, reader.width,
                                     reader.height)
        frames = [dec.decode(p) for p in reader._packets()]
        kind = (reader.codec, reader.container, reader.fourcc)
    counts = dec.counts()
    dec.close()
    return kind, frames, counts


# the paths only some codecs take
_V3_WMV1 = ("msmpeg4v3", "wmv1")
ONLY_IN = {"ROUND1": _V3_WMV1, "RL0": _V3_WMV1, "RL1": _V3_WMV1,
           "RL3": _V3_WMV1, "RL4": _V3_WMV1, "CBP_PRED": _V3_WMV1,
           "DC_ESCAPE": _V3_WMV1, "MV_ESCAPE": _V3_WMV1,
           "INTER_INTRA": ("wmv1",), "ESC3_LENGTHS": ("wmv1",)}


def test_sources_cover_every_alias_container_size_and_path():
    """The sources hold every fourcc alias in AVI, each codec in every
    container the writer puts it in, 640x480, 128x96, 96x64 and 95x63,
    and every syntax path the decoder counts occurs in at least one of
    them (the codec-bound ones only in their codecs)."""
    total = dict.fromkeys(msmpeg4.PATHS, 0)
    kinds, fourccs, sizes = set(), set(), set()
    for name in DIGESTS:
        (codec, container, fourcc), frames, counts = _decode_counting(name)
        kinds.add((codec, container))
        if container == "AVI":
            fourccs.add(fourcc)
        sizes.add(frames[0].shape[:2])
        assert len(frames) == DIGESTS[name]["frames"], name
        for k, v in counts.items():
            total[k] += v
            if v and k in ONLY_IN:
                assert codec in ONLY_IN[k], (name, k)
    assert kinds == {(c, k) for c in msmpeg4.FOURCCS
                     for k in ("AVI", "MP4", "Matroska", "ASF", "NUT")}
    assert fourccs == {cc.encode() for cc in MSMPEG4_ALIASES}
    assert sizes == {(480, 640), (96, 128), (64, 96), (63, 95)}
    assert [k for k, v in total.items() if not v] == []


def test_wmv7_inter_intra_prediction_follows_size_and_bit_rate():
    """WMV7 P pictures of under 320x240 pixels at up to 128 kbit/s
    predict an intra macroblock's DC from its neighbours' pixels (96x64
    at 10 fps); at 128x96 and 30 fps the writer's rate is over that and
    they do not."""
    _, _, low = _decode_counting("wmv1_halves.avi")
    _, _, high = _decode_counting("wmv1_halves_128x96_30fps.avi")
    assert low["P_INTRA_MB"] and low["INTER_INTRA"]
    assert high["P_INTRA_MB"] and not high["INTER_INTRA"]


def test_the_header_holds_cv2s_libavcodec_tables():
    """The committed ``msmpeg4_tables.h`` is what ``tests/msmpeg4_tables.py``
    finds in cv2's libavcodec now, every VLC in it a prefix code (complete
    but for the two MPEG-4 / H.263 TCOEF tables), every scan a
    permutation."""
    tables = msmpeg4_tables.extract(msmpeg4_tables.libavcodec())
    with open(msmpeg4_tables.HEADER) as f:
        assert f.read() == msmpeg4_tables.header(tables)
    msmpeg4_tables.check(tables)
    # the MPEG-4 intra and H.263 inter TCOEF tables are the ones the MPEG-4
    # and H.263 decoders carry
    csrc = os.path.dirname(msmpeg4_tables.HEADER)

    def array(path, name):
        with open(os.path.join(csrc, path)) as f:
            body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}",
                             f.read()).group(1)
        return [int(v) for v in body.replace("\n", " ").split(",")
                if v.strip()]
    for k, path, prefix in ((2, "mpeg4_decode.c", "intra"),
                            (5, "h263_mb.h", "inter")):
        rl = tables["rl"][k]
        assert [c for c, _ in rl["vlc"]] == array(path, f"{prefix}_code")
        assert [n for _, n in rl["vlc"]] == array(path, f"{prefix}_len")
        assert rl["run"] == array(path, f"{prefix}_run")
        assert rl["level"] == array(path, f"{prefix}_level")


@pytest.mark.parametrize("lens, codes", [([1, 2, 3, 3], [0, 2, 6, 7]),
                                         ([2, 2, 1], [0, 1, 1]),
                                         ([1, 2, 1], None), ([1, 2], None)])
def test_codes_from_lengths_walk_the_tree_left_to_right(lens, codes):
    """The MV tables' codes from their lengths, as
    ff_vlc_init_from_lengths assigns them; lengths out of the tree's order
    or short of a complete code are refused."""
    if codes is None:
        with pytest.raises(ValueError):
            msmpeg4_tables.codes_from_lengths(lens)
    else:
        assert msmpeg4_tables.codes_from_lengths(lens) == codes


# ---- edits of the writer's pictures ----

def _bits(data: bytes) -> str:
    return "".join(format(b, "08b") for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _vlc(name: str) -> dict:
    with open(msmpeg4_tables.HEADER) as f:
        text = f.read()

    def array(n):
        body = re.search(rf"{n}\[\d+\] =\s*\{{([^}}]*)\}}", text).group(1)
        return [int(v) for v in body.replace("\n", " ").split(",")
                if v.strip()]
    return {format(c, f"0{n}b"): s for s, (c, n) in
            enumerate(zip(array(f"{name}_code"), array(f"{name}_len")))}


def _read_vlc(bits: str, at: int, table: dict) -> int:
    for n in range(1, 33):
        if bits[at:at + n] in table:
            return at + n
    raise ValueError("no code")


def _decode012(bits: str, at: int) -> int:
    return at + (2 if bits[at] == "1" else 1)


def _i_mb0(bits: str, version: str) -> int:
    """The bit after an I picture's first macroblock's MB code (where its
    ac_pred flag is)."""
    if version == "v2":
        return _read_vlc(bits, 12, _vlc("v2_intra_cbpc"))
    at = 12 if version == "v3" else 12 + 17 + 1
    at = _decode012(bits, _decode012(bits, at)) + 1
    return _read_vlc(bits, at, _vlc("msmp4_mb_i"))


def _set(data: bytes, at: int, value: str) -> bytes:
    bits = _bits(data)
    return _bytes(bits[:at] + value + bits[at + len(value):])


def _i_dc_bit(data: bytes, version: str) -> int:
    bits = _bits(data)
    at = 12 if version == "v3" else 12 + 17 + 1
    return _decode012(bits, _decode012(bits, at))


def _p_bits(data: bytes, version: str):
    """(dc table bit, mv table bit) of a v3 / WMV7 P picture."""
    at = _decode012(_bits(data), 8 if version == "v3" else 9)
    return at, at + 1


def _each(ps, fn, first=0):
    return ps[:first] + [fn(p) for p in ps[first:]]


REFUSALS = {
    "ac_pred_v2": ("v2_pan.avi", lambda ps: [_set(
        ps[0], _i_mb0(_bits(ps[0]), "v2"), "1")] + ps[1:], "AC prediction"),
    "ac_pred_v3": ("v3_pan.avi", lambda ps: [_set(
        ps[0], _i_mb0(_bits(ps[0]), "v3"), "1")] + ps[1:], "AC prediction"),
    "ac_pred_wmv1": ("wmv1_pan.avi", lambda ps: [_set(
        ps[0], _i_mb0(_bits(ps[0]), "wmv1"), "1")] + ps[1:],
        "AC prediction"),
    "per_mb_rl_i": ("wmv1_pan.avi", lambda ps: [_set(ps[0], 29, "1")] +
                    ps[1:], "per macroblock"),
    "per_mb_rl_p": ("wmv1_pan.avi", lambda ps: _each(
        ps, lambda p: _set(p, 8, "1"), 1), "per macroblock"),
    "slices_v2": ("v2_pan.avi", lambda ps: [_set(ps[0], 7, "11000")] +
                  ps[1:], "more than one slice"),
    "slices_v3": ("v3_pan.avi", lambda ps: [_set(ps[0], 7, "11000")] +
                  ps[1:], "more than one slice"),
    "dc_table0_i": ("v3_pan.avi", lambda ps: [_set(
        ps[0], _i_dc_bit(ps[0], "v3"), "0")] + ps[1:], "DC table 0"),
    "dc_table0_wmv1": ("wmv1_pan.avi", lambda ps: [_set(
        ps[0], _i_dc_bit(ps[0], "wmv1"), "0")] + ps[1:], "DC table 0"),
    "dc_table0_p": ("v3_pan.avi", lambda ps: _each(
        ps, lambda p: _set(p, _p_bits(p, "v3")[0], "0"), 1), "DC table 0"),
    "mv_table0": ("v3_pan.avi", lambda ps: _each(
        ps, lambda p: _set(p, _p_bits(p, "v3")[1], "0"), 1), "MV table 0"),
    "mv_table0_wmv1": ("wmv1_pan.avi", lambda ps: _each(
        ps, lambda p: _set(p, _p_bits(p, "wmv1")[1], "0"), 1),
        "MV table 0"),
    "no_skip_v2": ("v2_pan.avi", lambda ps: _each(
        ps, lambda p: _set(p, 7, "0"), 1), "without skip flags"),
    "no_skip_v3": ("v3_pan.avi", lambda ps: _each(
        ps, lambda p: _set(p, 7, "0"), 1), "without skip flags"),
    "no_reference": ("v3_pan.avi", lambda ps: ps[1:], "before any I"),
}


@pytest.mark.parametrize("edit", sorted(REFUSALS))
def test_what_the_writer_never_writes_is_refused_by_name(tmp_path, edit):
    """Each edited bit turns on a tool the writer never writes: cv2 reads
    the file, the port names the tool."""
    name, fn, match = REFUSALS[edit]
    with VideoReader(_src(name)) as reader:
        fourcc = reader.fourcc
    path = _write(tmp_path, mux_avi(fn(_packets(name)), 96, 64,
                                    fourcc=fourcc), "x.avi")
    assert len(cv2_frames(path)) >= 1
    with pytest.raises(UnsupportedVideo, match=match):
        with VideoReader(path) as reader:
            list(reader)


def test_the_unedited_bits_read_back():
    """The edit helpers find the fields the decoder reads: setting each
    to the value it holds changes no packet."""
    for version in ("v2", "v3", "wmv1"):
        ps = _packets(f"{version}_pan.avi")
        at = _i_mb0(_bits(ps[0]), version)
        assert _set(ps[0], at, "0") == ps[0]
        if version != "v2":
            assert _set(ps[0], _i_dc_bit(ps[0], version), "1") == ps[0]
            for p in ps[1:12]:
                dc, mv = _p_bits(p, version)
                assert _set(p, dc, "11") == p and mv == dc + 1
        assert _set(ps[1], 7, "1") == ps[1]


def test_a_packet_cut_short_ends_the_reader(tmp_path):
    """The fifth picture cut to half its bytes: cv2 conceals the rest of
    it and goes on; the port gives the four frames before it and ends
    there, as the JAX reader's loop does at the first frame cv2 does not
    serve as written."""
    for name in ("v2_pan.avi", "v3_pan.avi", "wmv1_pan.avi"):
        packets = _packets(name)
        cut = packets[:4] + [packets[4][:len(packets[4]) // 2]] + packets[5:]
        with VideoReader(_src(name)) as reader:
            fourcc = reader.fourcc
        path = _write(tmp_path, mux_avi(cut, 96, 64, fourcc=fourcc),
                      "cut.avi")
        want = cv2_frames(path)
        with VideoReader(path) as reader:
            got = list(reader)
        assert len(got) == 4 and len(want) > 4, name
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_mutated_packets_never_crash():
    """Bits flipped at random in the writer's packets: each decode gives a
    frame, a refusal or DecodeError, never a crash."""
    rng = np.random.default_rng(29)
    for name, codec in (("v2_pan.avi", "msmpeg4v2"),
                        ("v3_pan.avi", "msmpeg4v3"),
                        ("wmv1_pan.avi", "wmv1")):
        packets = _packets(name)
        for trial in range(40):
            dec = msmpeg4.MSMPEG4Decoder(codec, 96, 64)
            for p in packets[:6]:
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
    dec = msmpeg4.MSMPEG4Decoder("msmpeg4v3", 95, 63)
    for p in _packets("v3_95x63.avi")[:2]:
        frame = dec.decode(p)
    y, u, v = dec.planes()
    assert y.shape == (63, 95) and u.shape == v.shape == (32, 48)
    np.testing.assert_array_equal(yuv420p_to_bgr(y, u, v), frame)
    dec.close()


def test_decoder_arguments_are_checked():
    with pytest.raises(ValueError, match="codec"):
        msmpeg4.MSMPEG4Decoder("msmpeg4v1", 96, 64)
    with pytest.raises(DecodeError, match="size"):
        msmpeg4.MSMPEG4Decoder("msmpeg4v3", 0, 64)
    assert msmpeg4.codec_of(b"DIV5") == "msmpeg4v3"
    # WMV8 is io/wmv2's; ASUS V1 waits on ROADMAP's decoding queue
    assert msmpeg4.codec_of(b"ASV1") == ""
    assert msmpeg4.codec_of(b"WMV2") == "" and wmv2.codec_of(b"WMV2") == \
        "wmv2"


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


def test_acq_then_recon_on_the_div3_avi_equals_the_jax_cli(tmp_path):
    """acq from the 640x480 DIV3 AVI with the committed depth directory
    writes the pixels the JAX CLI wrote, and recon on that package prints
    the JAX CLI's lines in the default ICP setting (recon.json; the forced
    setting is held on the card)."""
    from fealess_tpu_torch.apps import fixture
    from tests.test_torch_cli import _same_lines
    name = "pan_div3.avi"
    with open(os.path.join(MSMPEG4_OUT, "recon.json")) as f:
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
    assert rc == 0 and len(lines) == MSMPEG4_RECON_SOURCES[name]
    _same_lines(lines, want["a"])


def test_chip_smoke_msmpeg4_part_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 7f part for MS MPEG-4 and WMV7, its acq and
    recon set aside: every committed source to its digests, the host
    times printed."""
    import chip_smoke
    calls, failed = [], []
    monkeypatch.setattr(chip_smoke, "acq_recon_source",
                        lambda *a, **k: calls.append(a[4:6]))
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, msg: ok or failed.append(msg))
    monkeypatch.setattr(chip_smoke, "DECODE_TIMED", 1)
    chip_smoke.msmpeg4_sources(None, "cpu rehearsal", None, None)
    assert not failed, failed
    assert calls == [("pan_div3.avi", MSMPEG4_RECON_SOURCES["pan_div3.avi"])]
    out = capsys.readouterr().out
    assert f"{len(DIGESTS)} committed sources" in out
    for kind in ("640x480 MS MPEG-4 v3 I", "640x480 MS MPEG-4 v3 P",
                 "640x480 WMV7 P", "VideoReader a 640x480 DIV3 frame",
                 "time phase 7f MS MPEG-4 part"):
        assert kind in out
