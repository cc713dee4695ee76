"""The port's zstd decoder (``io/zstd``, ``csrc/zstd_decode.c``) held to
tensorstore's encoder: the frames tensorstore's zarr driver writes as
chunk files, over compression levels 1, 3, 9, 19 and 22 x data (zeros,
random bytes, repeated int32 rows, the fixture bank's leaves) x sizes (0
and 1 byte, 128 KiB - 1, 128 KiB, 128 KiB + 1, 5 MB), decode to the
bytes written.  Hand-made frames add the forms tensorstore does not
write: empty content under a window descriptor, RLE, skippable,
concatenated and checksummed frames and every frame-header size.  XXH64
and CRC-32C are held to published values.  Truncated frames raise
``DecodeError``; corrupted ones raise it or, where only bits the format
leaves unused changed, give the frame's own content; nothing brings the
process down (hypothesis)."""

import os
import struct

import numpy as np
import pytest
import tensorstore as ts
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fealess_tpu_torch.io import zstd
from fealess_tpu_torch.io.png import DecodeError

LEVELS = [1, 3, 9, 19, 22]
SIZES = [0, 1, 128 * 1024 - 1, 128 * 1024, 128 * 1024 + 1, 5_000_000]
HYPOTHESIS = settings(derandomize=True, database=None, deadline=None,
                      max_examples=300,
                      suppress_health_check=[HealthCheck.too_slow])


def _data(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "zeros":
        return bytes(n)
    if kind == "random":
        return rng.integers(0, 256, n, np.uint8).tobytes()
    rows = rng.integers(-3000, 3000, (7, 63), np.int32)
    reps = -(-n // rows.nbytes)
    return np.tile(rows, (reps, 1)).tobytes()[:n]


def ts_frame(path: str, data: bytes, level: int) -> bytes:
    """The chunk file tensorstore's zarr driver writes for ``data`` (one
    u8 chunk; no data: one element of the empty dtype ``|V0``) under zstd
    at ``level``: a bare zstd frame."""
    arr = np.frombuffer(data, np.uint8)
    n, dtype = (arr.size, "|u1") if arr.size else (1, "|V0")
    store = ts.open({"driver": "zarr",
                     "kvstore": {"driver": "file", "path": path},
                     "metadata": {"shape": [n], "chunks": [n],
                                  "dtype": dtype,
                                  "compressor": {"id": "zstd",
                                                 "level": level}}},
                    create=True, delete_existing=True).result()
    store.write(arr if arr.size else np.zeros((1, 0), np.int8)).result()
    with open(os.path.join(path, "0"), "rb") as f:
        frame = f.read()
    assert struct.unpack("<I", frame[:4])[0] == zstd.MAGIC
    return frame


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["zeros", "random", "rows"])
@pytest.mark.parametrize("level", LEVELS)
def test_decode_equals_tensorstore(tmp_path, level, kind, size):
    data = _data(kind, size)
    frame = ts_frame(str(tmp_path / "z"), data, level)
    assert zstd.decode(frame, len(data)) == data
    assert zstd.decode(frame) == data              # capacity from the header
    if size > 0:
        with pytest.raises(DecodeError, match="capacity"):
            zstd.decode(frame, len(data) - 1)


@pytest.mark.parametrize("level", LEVELS)
def test_decode_fixture_leaves(tmp_path, level):
    """The fixture bank's twelve leaves, each compressed as a whole."""
    from fealess_tpu_torch.io import checkpoint
    yml = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "reference", "out", "features",
                       "linemod_templates.yml")
    bank, _ = checkpoint.import_yaml(yml, device="cpu")
    for name, leaf in checkpoint.bank_arrays(bank).items():
        data = np.ascontiguousarray(leaf).tobytes()
        frame = ts_frame(str(tmp_path / name), data, level)
        assert zstd.decode(frame, len(data)) == data, name


def _frame(body: bytes, fhd: int, extra: bytes = b"") -> bytes:
    return struct.pack("<IB", zstd.MAGIC, fhd) + extra + body


def _block(kind: int, payload: bytes, size: int, last: bool = True) -> bytes:
    return (size << 3 | kind << 1 | last).to_bytes(3, "little") + payload


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 | nibble, len(payload)) + payload


def with_checksum(frame: bytes, data: bytes) -> bytes:
    """``frame`` (one frame of content ``data``) with a content checksum:
    the flag in its header, XXH64's low word after its last block."""
    return (frame[:4] + bytes([frame[4] | 4]) + frame[5:]
            + struct.pack("<I", zstd.xxh64(data) & 0xFFFFFFFF))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792, 200_000])
@pytest.mark.parametrize("checksum", [False, True])
def test_raw_frames_round_trip(n, checksum):
    """encode_raw's frames (every content-size field width) decode, and
    a content checksum is verified."""
    data = _data("random", n)
    frame = zstd.encode_raw(data)
    if checksum:
        frame = with_checksum(frame, data)
    assert zstd.content_size(frame) == n
    assert zstd.decode(frame) == data
    if checksum:
        bad = frame[:-1] + bytes([frame[-1] ^ 1])
        with pytest.raises(DecodeError, match="checksum"):
            zstd.decode(bad)


def test_hand_made_frames():
    # RLE block, window descriptor (no content size)
    wd = bytes([(17 - 10) << 3])
    assert zstd.decode(_frame(_block(1, b"\x07", 5000), 0x00, wd),
                       5000) == b"\x07" * 5000
    assert zstd.content_size(_frame(_block(1, b"\x07", 50), 0x00, wd)) \
        is None
    # empty content: single segment; window descriptor; several empty
    # blocks; an empty RLE block
    assert zstd.decode(_frame(_block(0, b"", 0), 0x20, b"\0"), 0) == b""
    assert zstd.decode(_frame(_block(0, b"", 0, False) + _block(0, b"", 0),
                              0x00, wd), 0) == b""
    assert zstd.decode(_frame(_block(1, b"\x01", 0), 0x20, b"\0")) == b""
    # raw blocks, a dictionary id of 0 (1, 2 and 4 bytes wide)
    for flag, width in ((1, 1), (2, 2), (3, 4)):
        f = _frame(_block(0, b"ab", 2, False) + _block(0, b"cd", 2),
                   0x20 | flag, bytes(width) + b"\4")
        assert zstd.decode(f) == b"abcd"
    # skippable frames before, between and after; frames one after another
    one = zstd.encode_raw(b"first")
    two = with_checksum(zstd.encode_raw(b"second"), b"second")
    stream = (_skippable(b"x" * 9) + one + _skippable(b"", 15) + two
              + _skippable(b"\0" * 3, 3))
    assert zstd.decode(stream) == b"firstsecond"
    assert zstd.content_size(stream) == 11
    # the checksum of an empty frame
    assert zstd.decode(with_checksum(zstd.encode_raw(b""), b"")) == b""


def test_frames_that_fail():
    with pytest.raises(DecodeError, match="dictionary id 4660"):
        zstd.decode(_frame(_block(0, b"", 0), 0x22, b"\x34\x12\0"))
    with pytest.raises(DecodeError, match="reserved bit"):
        zstd.decode(_frame(_block(0, b"", 0), 0x28, b"\0"))
    with pytest.raises(DecodeError, match="reserved block type"):
        zstd.decode(_frame(_block(3, b"", 0), 0x20, b"\0"))
    with pytest.raises(DecodeError, match="not a zstd frame"):
        zstd.decode(b"PK\3\4" + bytes(20))
    with pytest.raises(DecodeError, match="content size differs"):
        zstd.decode(_frame(_block(0, b"abc", 3), 0x20, b"\4"))
    with pytest.raises(DecodeError, match="ends inside a frame"):
        zstd.decode(b"")
    # a block larger than the window allows
    with pytest.raises(DecodeError, match="past its size limit"):
        zstd.decode(_frame(_block(1, b"\0", 2000), 0x00, b"\0"))


@pytest.mark.parametrize("capacity,limit", [
    (None, 4096), (None, 1 << 31), (1 << 45, 1 << 31), (4096, 1 << 45)])
@pytest.mark.parametrize("form", ["declared", "huge", "window"])
def test_content_past_the_bound_raises(form, capacity, limit):
    """``capacity`` and ``limit`` both bound the content: a frame whose
    header declares more raises before a buffer of that size is taken,
    and one that declares nothing stops growing at the bound."""
    if form == "declared":
        frame = zstd.encode_raw(b"x" * 5000)
    elif form == "huge":
        frame = _frame(_block(1, b"\7", 5000), 0xE0,
                       struct.pack("<Q", 1 << 40))
    else:
        frame = _frame(_block(1, b"\7", 5000), 0x00, bytes([7 << 3]))
    if form != "huge" and min(capacity or limit, limit) > 5000:
        assert len(zstd.decode(frame, capacity, limit=limit)) == 5000
        return
    with pytest.raises(DecodeError, match="capacity"):
        zstd.decode(frame, capacity, limit=limit)


@pytest.mark.parametrize("data,seed,want", [
    (b"", 0, 0xEF46DB3751D8E999),
    (b"Nobody inspects the spammish repetition", 0, 0xFBCEA83C8A378BF1),
    (1, 0, 0x4FCE394CC88952D8), (1, 2654435761, 0x739840CB819FA723),
    (14, 0, 0xCFFA8DB881BC3A3D), (14, 2654435761, 0x5B9611585EFCC9CB),
    (101, 0, 0x0EAB543384F878AD), (101, 2654435761, 0xCAA65939306F1E21)])
def test_xxh64_published_values(data, seed, want):
    """xxHash's own sanity vectors (its buffer of 101 bytes made from
    2654435761 squared, and lengths 1 and 14 of it) and the python
    xxhash example."""
    if isinstance(data, int):
        buf, gen = bytearray(), 2654435761
        for _ in range(101):
            buf.append(gen >> 24)
            gen = gen * gen & 0xFFFFFFFF
        data = bytes(buf[:data])
    assert zstd.xxh64(data, seed) == want


def test_crc32c_published_values():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA
    assert zstd.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert zstd.crc32c(bytes(range(32))) == 0x46DD794E
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283


_SEEDS = {}


def _corpus(tmp_path_factory) -> list:
    """Compressed tensorstore frames (Huffman and FSE tables, repeat
    offsets), each given a content checksum: the flag in its header and
    XXH64's low word after its last block."""
    if not _SEEDS:
        path = str(tmp_path_factory.mktemp("corpus"))
        for kind, n, level in (("rows", 3000, 3), ("random", 300, 1),
                               ("rows", 140_000, 19)):
            data = _data(kind, n)
            data = data[:n // 2] + bytes(np.frombuffer(
                data[n // 2:], np.uint8) % 7)
            f = with_checksum(ts_frame(path, data, level), data)
            assert zstd.decode(f, n) == data
            _SEEDS[kind + str(n)] = (f, n)
    return list(_SEEDS.values())


def test_every_truncation_raises(tmp_path_factory):
    for frame, n in _corpus(tmp_path_factory)[:2]:
        for cut in range(len(frame)):
            with pytest.raises(DecodeError):
                zstd.decode(frame[:cut], n)


@HYPOTHESIS
@given(which=st.integers(0, 2), bit=st.integers(0, 1 << 40),
       extra=st.lists(st.tuples(st.integers(0, 1 << 40), st.integers(1, 255)),
                      max_size=3))
def test_corrupted_frames_raise(tmp_path_factory, which, bit, extra):
    """A flipped bit, and up to three more bytes changed, in a checksummed
    frame: DecodeError (the checksum catches content that decodes), or the
    frame's own content where the change hit bits the format leaves
    unused (the last nibble of an odd count of Huffman weights, the
    padding of an FSE table description)."""
    frame, n = _corpus(tmp_path_factory)[which]
    want = zstd.decode(frame, n)
    buf = bytearray(frame)
    buf[bit // 8 % len(buf)] ^= 1 << bit % 8
    for pos, x in extra:
        buf[pos % len(buf)] ^= x
    try:
        got = zstd.decode(bytes(buf), n)
    except DecodeError:
        return
    assert got == want


@HYPOTHESIS
@given(data=st.binary(max_size=300), cap=st.integers(0, 1 << 16))
def test_arbitrary_bytes_never_crash(data, cap):
    """Any input after a zstd magic: bytes or DecodeError, nothing else."""
    try:
        out = zstd.decode(struct.pack("<I", zstd.MAGIC) + data, cap)
    except DecodeError:
        return
    assert len(out) <= cap
