"""OCDBT, the key-value database tensorstore keeps a checkpoint in, read
and written without tensorstore.

The JAX package checkpoints a bank with orbax, which stores the zarr
arrays in an OCDBT database ("optionally-cooperative distributed B+tree")
on plain files.  The card's machine has no tensorstore, so the format is
read and written here; tensorstore is only the oracle of the CPU tests.

A database is a directory: ``manifest.ocdbt`` and data files ``d/<id>``.
Every manifest and node file has the same frame: a 4-byte big-endian
magic (manifest ``0x0cdb3a2a``, B-tree node ``0x0cdb20de``, version-tree
node ``0x0cdb1234``), the file's length (u64 little-endian), the format
version (varint, 0), the compression (varint: 0 none, 1 zstd), the body
(a zstd frame under compression 1), and the CRC-32C of all that
(u32 little-endian).  A node lies inside a data file at an offset and a
length; a value longer than ``max_inline_value_bytes`` lies in a data
file too ("indirect"), shorter ones inside their leaf ("inline").

Bodies store columns, not rows: every field of every entry, then the
next field.  Integers are LEB128 varints unless said otherwise.

- Data-file table (every body that refers to data files): count; for
  files 1.. the length of the path they share with the previous one;
  each path's remaining length; each path's base-path length; the path
  remainders.  A file's path is ``base + relative``; a node reached
  through a file with base ``B`` reads its own table's bases under ``B``
  (tensorstore's transitive path; orbax's merge writes every node into
  the root database, so its checkpoints never need it).
- Manifest: the config (16-byte uuid, manifest kind, max inline value
  bytes, max decoded node bytes, version-tree arity log2 (u8), the
  compression (0 none; 1 zstd, then its level as i32 little-endian));
  the newest versions (a table, a count, then generation, root height
  (u8), file, offset, length, key count, tree bytes, indirect value
  bytes, commit time (u64 ns)); the version-tree nodes holding the older
  ones (a count, then generation, file, offset, length, generation count,
  commit time, height (u8)).  An empty tree's root has offset and length
  2**64 - 1.
- B-tree node: height (u8), a table, an entry count, the keys (for
  entries 1.. the length shared with the previous key; each key's
  remaining length; in an interior node, each child's common key prefix
  length; the remainders); then for a leaf, each value's length, each
  value's kind (0 inline, 1 indirect), the indirect ones' file and
  offset, and the inline values; for an interior node, each child's file,
  offset, length, key count, tree bytes and indirect value bytes.  A
  node's keys lack the prefix its parent's entry strips: the child of
  entry ``k`` (a key under the parent's prefix ``P``) holds its keys
  without ``P + k[:prefix length]``.
- Version-tree node: arity log2 (u8), height (u8), then a leaf lists
  versions as the manifest does, an interior node lists children as the
  manifest lists version-tree nodes, without the height.  The reader
  reads the newest version, which the manifest always holds, so it
  checks the manifest's refs to these nodes but does not walk them.

Everything read is checked: magics, lengths, checksums, varints, table
and value bounds, key order; a fault raises
:class:`~fealess_tpu_torch.io.png.DecodeError`.  :func:`write` writes
what a bank checkpoint needs, one version of one leaf with orbax's
settings, in zstd frames of raw blocks, which tensorstore opens and
lists.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
import uuid
from typing import Dict, List, Optional, Tuple, Union

from fealess_tpu_torch.io import zstd
from fealess_tpu_torch.io.png import DecodeError

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1
MANIFEST = "manifest.ocdbt"


@dataclasses.dataclass(frozen=True)
class Ref:
    """Bytes ``[offset, offset + length)`` of the data file
    ``base + path`` under the database's directory."""
    base: str
    path: str
    offset: int
    length: int

    @property
    def file(self) -> str:
        return self.base + self.path


@dataclasses.dataclass(frozen=True)
class Stats:
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    zstd_level: Optional[int]   # None: nodes are not compressed


@dataclasses.dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Optional[Ref]          # None: the empty tree
    stats: Stats
    commit_time: int


@dataclasses.dataclass(frozen=True)
class VersionNodeRef:
    generation: int
    ref: Ref
    num_generations: int
    commit_time: int
    height: int


@dataclasses.dataclass(frozen=True)
class Manifest:
    config: Config
    versions: Tuple[Version, ...]
    version_tree_nodes: Tuple[VersionNodeRef, ...]


@dataclasses.dataclass(frozen=True)
class LeafEntry:
    key: bytes
    value: Union[bytes, Ref]     # inline bytes, or where they lie


@dataclasses.dataclass(frozen=True)
class InteriorEntry:
    key: bytes
    subtree_common_prefix_length: int
    ref: Ref
    stats: Stats


@dataclasses.dataclass(frozen=True)
class Node:
    height: int
    entries: tuple


# ---- reading


class _Buf:
    """A bounds-checked cursor over a body."""

    def __init__(self, data: bytes, what: str):
        self.d, self.i, self.what = data, 0, what

    def fail(self, msg: str) -> DecodeError:
        return DecodeError(f"{self.what}: {msg} (at byte {self.i})")

    def take(self, n: int) -> bytes:
        if n < 0 or n > len(self.d) - self.i:
            raise self.fail("truncated")
        out = self.d[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def varint(self) -> int:
        v = shift = 0
        for _ in range(10):
            c = self.u8()
            v |= (c & 0x7F) << shift
            if c < 0x80:
                if v > MISSING:
                    break
                return v
            shift += 7
        raise self.fail("bad varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def count(self, limit: int = 1 << 24) -> int:
        n = self.varint()
        if n > min(limit, len(self.d) - self.i + 1):
            raise self.fail(f"count {n} past the body")
        return n

    def end(self) -> None:
        if self.i != len(self.d):
            raise self.fail(f"{len(self.d) - self.i} bytes left over")


def _safe_path(path: str, what: str) -> str:
    parts = path.split("/")
    if path.startswith("/") or ".." in parts or "\\" in path:
        raise DecodeError(f"{what}: data file path {path!r} leaves the "
                          f"database")
    return path


def unframe(raw: bytes, magic: int, what: str,
            limit: int = 1 << 31) -> bytes:
    """The body of a manifest or node file, its frame checked."""
    if len(raw) < 18:
        raise DecodeError(f"{what}: {len(raw)} bytes is too short")
    got = struct.unpack(">I", raw[:4])[0]
    if got != magic:
        raise DecodeError(f"{what}: magic {got:#010x}, expected "
                          f"{magic:#010x}")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise DecodeError(f"{what}: length field {length}, file holds "
                          f"{len(raw)}")
    crc = struct.unpack("<I", raw[-4:])[0]
    if zstd.crc32c(raw[:-4]) != crc:
        raise DecodeError(f"{what}: CRC-32C mismatch")
    b = _Buf(raw[:-4], what)
    b.i = 12
    version, comp = b.varint(), b.varint()
    if version != 0:
        raise DecodeError(f"{what}: format version {version}")
    body = raw[b.i:-4]
    if comp == 0:
        return body
    if comp == 1:
        return zstd.decode(body, limit=limit, what=what)
    raise DecodeError(f"{what}: compression {comp}")


def _table(b: _Buf, transitive: str) -> List[Tuple[str, str]]:
    n = b.count()
    prefix = [0] + b.varints(max(n - 1, 0))
    suffix, base_len = b.varints(n), b.varints(n)
    files, prev = [], ""
    for i in range(n):
        if prefix[i] > len(prev):
            raise b.fail("data file path prefix past the previous path")
        try:
            path = prev[:prefix[i]] + b.take(suffix[i]).decode()
        except UnicodeDecodeError:
            raise b.fail("data file path is not UTF-8") from None
        if base_len[i] > len(path):
            raise b.fail("base path past the path")
        files.append((transitive + path[:base_len[i]], path[base_len[i]:]))
        prev = path
    for base, path in files:
        _safe_path(base + path, b.what)
    return files


def _file(b: _Buf, table, fid: int) -> Tuple[str, str]:
    if fid >= len(table):
        raise b.fail(f"data file {fid} of {len(table)}")
    return table[fid]


def _keys(b: _Buf, n: int, interior: bool):
    """A node's keys, and an interior node's common prefix lengths (a
    column between the key lengths and the key bytes)."""
    prefix = [0] + b.varints(max(n - 1, 0))
    suffix = b.varints(n)
    cpl = b.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise b.fail("key prefix past the previous key")
        key = prev[:prefix[i]] + b.take(suffix[i])
        if i and key <= prev:
            raise b.fail("keys out of order")
        keys.append(key)
        prev = key
    return keys, cpl


def _config(b: _Buf) -> Config:
    uid = b.take(16)
    kind, inline, decoded = b.varint(), b.varint(), b.varint()
    arity = b.u8()
    comp = b.varint()
    if comp == 0:
        level = None
    elif comp == 1:
        level = b.i32()
    else:
        raise b.fail(f"compression {comp}")
    return Config(uid, kind, inline, decoded, arity, level)


def _versions(b: _Buf):
    """A version-tree leaf's columns (the manifest's newest versions):
    (data-file table, versions)."""
    table = _table(b, "")
    n = b.count()
    gen = b.varints(n)
    height = [b.u8() for _ in range(n)]
    fid, off, length = b.varints(n), b.varints(n), b.varints(n)
    nk, tb, ib = b.varints(n), b.varints(n), b.varints(n)
    commit = [b.u64() for _ in range(n)]
    out = []
    for i in range(n):
        if off[i] == MISSING and length[i] == MISSING:
            root = None
        else:
            root = Ref(*_file(b, table, fid[i]), off[i], length[i])
        out.append(Version(gen[i], height[i], root,
                           Stats(nk[i], tb[i], ib[i]), commit[i]))
    return table, out


def _version_refs(b: _Buf, table, n: int) -> List[VersionNodeRef]:
    gen = b.varints(n)
    fid, off, length = b.varints(n), b.varints(n), b.varints(n)
    ngen = b.varints(n)
    commit = [b.u64() for _ in range(n)]
    heights = [b.u8() for _ in range(n)]
    return [VersionNodeRef(gen[i], Ref(*_file(b, table, fid[i]), off[i],
                                       length[i]), ngen[i], commit[i],
                           heights[i]) for i in range(n)]


def decode_manifest(body: bytes, what: str = MANIFEST) -> Manifest:
    b = _Buf(body, what)
    config = _config(b)
    if config.manifest_kind != 0:
        raise b.fail(f"manifest kind {config.manifest_kind} (numbered "
                     f"manifests are not read)")
    # the version-tree nodes share the versions' data-file table
    table, versions = _versions(b)
    nodes = _version_refs(b, table, b.count())
    b.end()
    return Manifest(config, tuple(versions), tuple(nodes))


def decode_node(body: bytes, transitive: str = "",
                what: str = "B-tree node") -> Node:
    b = _Buf(body, what)
    height = b.u8()
    table = _table(b, transitive)
    n = b.count()
    keys, cpl = _keys(b, n, height > 0)
    if height == 0:
        length = b.varints(n)
        kind = b.varints(n)
        if any(k > 1 for k in kind):
            raise b.fail("value kind past 1")
        ind = [i for i in range(n) if kind[i] == 1]
        fid, off = b.varints(len(ind)), b.varints(len(ind))
        refs = {i: Ref(*_file(b, table, f), o, length[i])
                for i, f, o in zip(ind, fid, off)}
        entries = tuple(LeafEntry(keys[i], refs[i] if i in refs
                                  else b.take(length[i])) for i in range(n))
    else:
        fid, off, length = b.varints(n), b.varints(n), b.varints(n)
        nk, tb, ib = b.varints(n), b.varints(n), b.varints(n)
        entries = []
        for i in range(n):
            if cpl[i] > len(keys[i]):
                raise b.fail("common prefix past its key")
            entries.append(InteriorEntry(
                keys[i], cpl[i], Ref(*_file(b, table, fid[i]), off[i],
                                     length[i]),
                Stats(nk[i], tb[i], ib[i])))
        entries = tuple(entries)
    b.end()
    return Node(height, entries)


class Database:
    """An OCDBT database on disk, read-only: the manifest at open, nodes
    and values when asked (each data file read once)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._files: Dict[str, bytes] = {}
        path = os.path.join(directory, MANIFEST)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raise DecodeError(f"{path}: no OCDBT manifest") from None
        self.manifest = decode_manifest(
            unframe(raw, MANIFEST_MAGIC, path), path)
        self.config = self.manifest.config

    def _bytes(self, ref: Ref, what: str) -> bytes:
        name = _safe_path(ref.file, what)
        data = self._files.get(name)
        if data is None:
            path = os.path.join(self.directory, name)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                raise DecodeError(f"{what}: data file {name} is "
                                  f"missing") from None
            self._files[name] = data
        if ref.offset + ref.length > len(data):
            raise DecodeError(f"{what}: bytes [{ref.offset}, "
                              f"{ref.offset + ref.length}) past the "
                              f"{len(data)} of {name}")
        return data[ref.offset:ref.offset + ref.length]

    def node(self, ref: Ref) -> Node:
        what = f"B-tree node {ref.file}:{ref.offset}:{ref.length}"
        body = unframe(self._bytes(ref, what), BTREE_MAGIC, what,
                       self.config.max_decoded_node_bytes)
        return decode_node(body, ref.base, what)

    def value(self, entry: LeafEntry) -> bytes:
        if isinstance(entry.value, bytes):
            return entry.value
        return self._bytes(entry.value, f"value of {entry.key!r}")

    def items(self) -> Dict[bytes, bytes]:
        """Every key and value of the newest version (which the manifest
        always holds; the version tree keeps only older ones)."""
        if not self.manifest.versions:
            raise DecodeError(f"{self.directory}: no version")
        version = self.manifest.versions[-1]
        out: Dict[bytes, bytes] = {}
        if version.root is None:
            return out

        def walk(ref: Ref, height: int, prefix: bytes) -> None:
            node = self.node(ref)
            if node.height != height:
                raise DecodeError(f"B-tree node {ref.file}: height "
                                  f"{node.height}, expected {height}")
            for e in node.entries:
                if height == 0:
                    out[prefix + e.key] = self.value(e)
                else:
                    walk(e.ref, height - 1,
                         prefix + e.key[:e.subtree_common_prefix_length])

        walk(version.root, version.root_height, b"")
        if len(out) != version.stats.num_keys:
            raise DecodeError(f"{self.directory}: {len(out)} keys, the "
                              f"version counts {version.stats.num_keys}")
        return out


def read(directory: str) -> Dict[bytes, bytes]:
    """Every key and value of the newest version under ``directory``."""
    return Database(directory).items()


# ---- writing

# orbax's OCDBT settings (what the JAX package's save_bank writes)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        out.append(c | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _varints(vals) -> bytes:
    return b"".join(_varint(v) for v in vals)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefixed(items: List[bytes]) -> Tuple[List[int], List[int], bytes]:
    """The shared-prefix lengths (for items 1..), the remaining lengths
    and the remainders of sorted byte strings."""
    pre = [0] + [_common(items[i - 1], items[i])
                 for i in range(1, len(items))]
    return (pre[1:], [len(x) - p for x, p in zip(items, pre)],
            b"".join(x[p:] for x, p in zip(items, pre)))


def _enc_table(files: List[Tuple[str, str]]) -> bytes:
    shared, rest, tails = _prefixed([(b + p).encode() for b, p in files])
    return (_varint(len(files)) + _varints(shared) + _varints(rest)
            + _varints(len(base.encode()) for base, _ in files) + tails)


def frame(body: bytes, magic: int) -> bytes:
    """A manifest or node file around ``body``: a zstd frame of raw
    blocks, the file's length and its CRC-32C."""
    payload = zstd.encode_raw(body)
    head = _varint(0) + _varint(1)
    n = 4 + 8 + len(head) + len(payload) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", n) + head + payload
    return raw + struct.pack("<I", zstd.crc32c(raw))


def write(directory: str, items: Dict[bytes, Union[bytes, Ref]]
          ) -> Dict[bytes, Ref]:
    """Write a database of one version (generation 1) under
    ``directory`` with orbax's settings: one leaf node holding ``items``
    (non-empty), in one data file ``d/<random id>`` with every value
    longer than ``MAX_INLINE_VALUE_BYTES``.  A ``Ref`` value (a value in
    another database's data file, by its path from this directory) is
    stored as it is.  Returns where each long value went."""
    if not items:
        raise ValueError("an OCDBT database of no keys is not written")
    path = f"d/{uuid.uuid4().hex}"
    data, size, placed, entries = [], 0, {}, []
    for key in sorted(items):
        v = items[key]
        if not isinstance(v, Ref):
            v = bytes(v)
            if len(v) > MAX_INLINE_VALUE_BYTES:
                data.append(v)
                v = placed[bytes(key)] = Ref("", path, size, len(v))
                size += v.length
        entries.append((bytes(key), v))
    refs = [v for _, v in entries if isinstance(v, Ref)]
    files = sorted({(r.base, r.path) for r in refs})
    fid = {f: i for i, f in enumerate(files)}
    shared, rest, tails = _prefixed([k for k, _ in entries])
    body = (b"\0" + _enc_table(files) + _varint(len(entries))
            + _varints(shared) + _varints(rest) + tails
            + _varints(v.length if isinstance(v, Ref) else len(v)
                       for _, v in entries)
            + _varints(int(isinstance(v, Ref)) for _, v in entries)
            + _varints(fid[(r.base, r.path)] for r in refs)
            + _varints(r.offset for r in refs)
            + b"".join(v for _, v in entries if not isinstance(v, Ref)))
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"an OCDBT leaf of {len(body)} bytes is past "
                         f"{MAX_DECODED_NODE_BYTES}")
    node = frame(body, BTREE_MAGIC)
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    with open(os.path.join(directory, path), "wb") as f:
        f.write(b"".join(data) + node)
    stats = [len(entries), len(node), sum(r.length for r in refs)]
    config = (uuid.uuid4().bytes + _varint(0)
              + _varints([MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES])
              + bytes([VERSION_TREE_ARITY_LOG2]) + b"\1"
              + struct.pack("<i", 0))                       # zstd, level 0
    body = (config + _enc_table([("", path)]) + _varint(1) + _varint(1)
            + b"\0" + _varints([0, size, len(node)] + stats)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(directory, MANIFEST), "wb") as f:
        f.write(frame(body, MANIFEST_MAGIC))
    return placed
