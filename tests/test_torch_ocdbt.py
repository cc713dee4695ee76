"""The port's OCDBT reader and writer (``io/ocdbt``) held to tensorstore:
every manifest and B-tree node the port decodes, and every version-tree
node (which the port's reader does not walk; decoded here from its
column helpers), equals ``tensorstore.ocdbt.dump``'s, on orbax's two databases of a bank
checkpoint (and on orbax's root database as a tree of height 2, its
nodes made small), on trees of height 0 and 7 (inline and indirect
values), on a database with version-tree nodes, and uncompressed; the
keys and values the port reads equal tensorstore's; what the port writes
(one leaf with orbax's settings, inline and indirect values, values in
another database's data file) opens in tensorstore's ``ocdbt`` kvstore
unchanged, and its nodes dump as the port decodes them.  Corrupt files
raise ``DecodeError``.  The zarr v2 arrays in such a database
(``io/zarr2``) read as tensorstore reads them, chunk grids with edge and
missing chunks included."""

import json
import os
import shutil
import struct

import numpy as np
import pytest
import tensorstore as ts

from fealess_tpu_torch.io import ocdbt, zarr2, zstd
from fealess_tpu_torch.io.png import DecodeError

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_ckpt",
                       "fixture_1024", "arrays")
SMALL = {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 16}


def _keys(n: int):
    return [f"k{i:04d}/{'x' * (i % 7)}".encode() for i in range(n)]


def _ts_database(path: str, commits: int = 1, n: int = 300,
                 config=None, seed: int = 0) -> dict:
    """A tensorstore OCDBT database of ``n`` keys written in ``commits``
    transactions; returns its items."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config or SMALL}).result()
    rng = np.random.default_rng(seed)
    keys, items = _keys(n), {}
    per = -(-n // commits)
    for c in range(commits):
        with ts.Transaction() as txn:
            for k in keys[c * per:(c + 1) * per]:
                v = rng.integers(0, 256, int(rng.integers(0, 40)),
                                 np.uint8).tobytes()
                kv.with_transaction(txn)[k] = v
                items[k] = v
    return items


def _ts_items(path: str) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _loc(kind: str, ref) -> str:
    return f"{kind}:{ref.base}:{ref.path}:{ref.offset}:{ref.length}"


def _stats(s) -> dict:
    return {"num_indirect_value_bytes": s.num_indirect_value_bytes,
            "num_keys": s.num_keys, "num_tree_bytes": s.num_tree_bytes}


def _version(v) -> dict:
    root = {"statistics": _stats(v.stats)}
    if v.root is not None:
        root["location"] = _loc("btreenode", v.root)
    return {"commit_time": v.commit_time, "generation_number": v.generation,
            "root": root, "root_height": v.root_height}


def _vref(r) -> dict:
    return {"commit_time": r.commit_time, "generation_number": r.generation,
            "height": r.height, "location": _loc("versionnode", r.ref),
            "num_generations": r.num_generations}


def _manifest_dump(m) -> dict:
    c = m.config
    comp = None if c.zstd_level is None else (
        {"id": "zstd"} if c.zstd_level == 0
        else {"id": "zstd", "level": c.zstd_level})
    config = {"compression": comp,
              "max_decoded_node_bytes": c.max_decoded_node_bytes,
              "max_inline_value_bytes": c.max_inline_value_bytes,
              "uuid": c.uuid.hex(),
              "version_tree_arity_log2": c.version_tree_arity_log2}
    return {"config": config,
            "version_tree_nodes": [_vref(r) for r in m.version_tree_nodes],
            "versions": [_version(v) for v in m.versions]}


def _node_dump(node) -> dict:
    entries = []
    for e in node.entries:
        if node.height == 0:
            d = {"key": e.key}
            if isinstance(e.value, bytes):
                d["inline_value"] = e.value
            else:
                d["indirect_value"] = _loc("value", e.value)
        else:
            d = {"key": e.key, "location": _loc("btreenode", e.ref),
                 "statistics": _stats(e.stats),
                 "subtree_common_prefix":
                     e.key[:e.subtree_common_prefix_length]}
        entries.append(d)
    return {"entries": entries, "height": node.height}


VERSION_MAGIC = 0x0CDB1234


def _version_node(db, ref):
    """The version-tree node at ``ref`` (the reader takes only the
    newest version, which the manifest holds): (arity log2, height,
    versions in a leaf or child refs, which lack the height column)."""
    what = f"version-tree node {ref.file}"
    # tensorstore bounds these nodes by arity: max_decoded_node_bytes is
    # for B-tree nodes (a version-tree node of the config of 256 bytes
    # holds more)
    body = ocdbt.unframe(db._bytes(ref, what), VERSION_MAGIC, what)
    b = ocdbt._Buf(body, what)
    arity, height = b.u8(), b.u8()
    if height == 0:
        entries = ocdbt._versions(b)[1]
    else:
        table = ocdbt._table(b, "")
        n = b.count()
        gen = b.varints(n)
        fid, off, length = b.varints(n), b.varints(n), b.varints(n)
        ngen = b.varints(n)
        commit = [b.u64() for _ in range(n)]
        entries = [ocdbt.VersionNodeRef(
            gen[i], ocdbt.Ref(*ocdbt._file(b, table, fid[i]), off[i],
                              length[i]), ngen[i], commit[i], height - 1)
            for i in range(n)]
    b.end()
    return arity, height, entries


def _vnode_dump(node) -> dict:
    arity, height, entries = node
    entries = [(_version if height == 0 else _vref)(e) for e in entries]
    return {"entries": entries, "height": height,
            "version_tree_arity_log2": arity}


def _all_versions(db, base=None) -> list:
    """Every version of ``db``, oldest first, the version tree walked;
    each version-tree node checked against the dump where ``base`` (the
    database's file kvstore) is given."""
    out = []

    def walk(ref):
        node = _version_node(db, ref.ref)
        assert node[1] == ref.height
        if base is not None:
            assert _vnode_dump(node) == ts.ocdbt.dump(
                base, _loc("versionnode", ref.ref)).result()
        for e in node[2]:
            if node[1] == 0:
                out.append(e)
            else:
                walk(e)

    for r in db.manifest.version_tree_nodes:
        walk(r)
    return out + list(db.manifest.versions)


def _assert_equals_dump(path: str) -> int:
    """Every manifest and node the port decodes under ``path`` equals
    tensorstore's dump; returns the B-tree nodes seen."""
    base = ts.KvStore.open({"driver": "file", "path": path + "/"}).result()
    db = ocdbt.Database(path)
    want = ts.ocdbt.dump(base).result()
    assert _manifest_dump(db.manifest) == want
    seen = 0
    for v in _all_versions(db, base):
        stack = [] if v.root is None else [v.root]
        while stack:
            ref = stack.pop()
            node = db.node(ref)
            assert _node_dump(node) == ts.ocdbt.dump(
                base, _loc("btreenode", ref)).result(), ref
            seen += 1
            if node.height:
                stack += [e.ref for e in node.entries]
    return seen


@pytest.mark.parametrize("db", ["root", "process_0"])
def test_orbax_fixture_equals_dump(db):
    """The committed checkpoint's two databases: the root one, whose leaf
    points into ``ocdbt.process_0/``'s data file, and the process's own
    (four versions)."""
    path = FIXTURE if db == "root" else os.path.join(FIXTURE,
                                                     "ocdbt.process_0")
    assert _assert_equals_dump(path) >= 1
    got = ocdbt.read(path)
    assert got == _ts_items(path)
    assert len(got) == 24


def test_orbax_small_nodes_equal_dump(tmp_path, monkeypatch):
    """orbax's own writer with nodes of at most 512 bytes: the merged root
    database is a tree of height 2 whose leaves point into the process's
    data files; every node equals the dump, the port's bank JAX's."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from orbax.checkpoint._src.serialization import tensorstore_utils as tu
    from fealess_tpu.io import checkpoint as jax_ckpt
    from fealess_tpu_torch.io import checkpoint
    from tests.make_torch_ckpt import YAML, leaf_digests

    write_options = tu.add_ocdbt_write_options

    def small_nodes(spec, *args, **kw):
        write_options(spec, *args, **kw)
        spec["config"].update(max_decoded_node_bytes=512,
                              max_inline_value_bytes=64)

    monkeypatch.setattr(tu, "add_ocdbt_write_options", small_nodes)
    bank, det = jax_ckpt.import_yaml(YAML)
    d = str(tmp_path / "ckpt")
    jax_ckpt.save_bank(d, bank, det)
    root = ocdbt.Database(os.path.join(d, "arrays"))
    assert root.manifest.versions[-1].root_height >= 1
    assert _assert_equals_dump(os.path.join(d, "arrays")) > 1
    got, _ = checkpoint.load_bank(d, device="cpu")
    assert leaf_digests(got) == leaf_digests(bank)


@pytest.mark.parametrize("commits,config", [
    (1, SMALL), (40, SMALL), (1, {**SMALL, "compression": None}),
    (3, {"max_inline_value_bytes": 16})],
    ids=["height7", "version-tree", "uncompressed", "height0"])
def test_tensorstore_trees_equal_dump(tmp_path, commits, config):
    path = str(tmp_path / "db")
    items = _ts_database(path, commits, config=config)
    db = ocdbt.Database(path)
    height = db.manifest.versions[-1].root_height
    assert (height > 0) == ("max_decoded_node_bytes" in config)
    if commits == 40:
        assert db.manifest.version_tree_nodes
    assert _assert_equals_dump(path) >= 1
    assert db.items() == items == _ts_items(path)
    assert len(_all_versions(db)) == db.manifest.versions[-1].generation


@pytest.mark.parametrize("n", [1, 24, 300])
def test_port_database_opens_in_tensorstore(tmp_path, n):
    """One leaf with orbax's settings: values up to 3000 bytes, those past
    1024 in the data file; tensorstore reads every key back."""
    rng = np.random.default_rng(n)
    items = {k: rng.integers(0, 256, int(rng.integers(0, 3000)),
                             np.uint8).tobytes() for k in _keys(n)}
    path = str(tmp_path / "db")
    placed = ocdbt.write(path, items)
    assert set(placed) == {k for k, v in items.items() if len(v) > 1024}
    assert _ts_items(path) == items == ocdbt.read(path)
    assert _assert_equals_dump(path) == 1
    config = ocdbt.Database(path).config
    assert (config.max_inline_value_bytes, config.max_decoded_node_bytes,
            config.version_tree_arity_log2, config.zstd_level) == (
                1024, 100_000_000, 4, 0)
    with pytest.raises(ValueError, match="no keys"):
        ocdbt.write(str(tmp_path / "empty"), {})


def test_port_writes_values_in_another_database(tmp_path):
    """orbax's layout: the process's database holds the values, the root
    database points at them under ``ocdbt.process_0/``."""
    items = {b"a/.zarray": b"{}", b"a/0": bytes(range(256)) * 8,
             b"b/0": b"\1" * 2000}
    sub = str(tmp_path / "ocdbt.process_0")
    placed = ocdbt.write(sub, items)
    root = {k: ocdbt.Ref("ocdbt.process_0/", r.path, r.offset, r.length)
            for k, r in placed.items()}
    ocdbt.write(str(tmp_path), {**items, **root})
    assert _ts_items(str(tmp_path)) == items == ocdbt.read(str(tmp_path))
    _assert_equals_dump(str(tmp_path))


ZARR_ARRAYS = {   # name: (dtype, shape, chunks, fill, separator, zstd)
    "ints": ("<i4", (50, 7, 3), (16, 4, 3), 7, ".", True),
    "bools": ("|b1", (33,), (10,), None, ".", True),
    "floats": ("<f4", (5, 13), (2, 5), -1.5, "/", False),
    "scalar": ("<f4", (), (), None, ".", True)}


def test_zarr_grids_equal_tensorstore(tmp_path):
    """zarr v2 arrays written by tensorstore's zarr driver into an OCDBT
    database (orbax's stack): chunk grids with edge chunks in two
    dimensions, chunks never written (the fill value, or 0 for null),
    the ``/`` separator, raw chunks, a 0-d array; ``read_array`` equals
    tensorstore's read."""
    path = str(tmp_path / "db")
    rng = np.random.default_rng(3)
    want = {}
    for name, (dt, shape, chunks, fill, sep, z) in ZARR_ARRAYS.items():
        meta = {"shape": list(shape), "chunks": list(chunks), "dtype": dt,
                "fill_value": fill, "dimension_separator": sep,
                "compressor": {"id": "zstd", "level": 3} if z else None}
        store = ts.open({"driver": "zarr", "path": name, "metadata": meta,
                         "kvstore": {"driver": "ocdbt",
                                     "base": f"file://{path}/"}},
                        create=True).result()
        dtype = np.dtype(dt)
        full = (rng.random(shape) < 0.5) if dtype == np.bool_ else \
            rng.integers(-1000, 1000, shape).astype(dtype)
        if shape and shape[0] > chunks[0]:   # leave the first chunks out
            store[chunks[0]:].write(full[chunks[0]:]).result()
        else:
            store.write(full).result()
        want[name] = store.read().result()
    items = ocdbt.read(path)
    assert any(k.startswith(b"floats/1/") for k in items)
    assert b"ints/0.0.0" not in items
    for name, arr in want.items():
        got = zarr2.read_array(items, name)
        assert (got.dtype, got.shape) == (arr.dtype, arr.shape), name
        np.testing.assert_array_equal(got, arr, err_msg=name)


@pytest.mark.parametrize("change,match", [
    ({"dtype": "<i8"}, "dtype '<i8'"), ({"order": "F"}, "order 'F'"),
    ({"compressor": {"id": "zlib", "level": 1}}, "compressor 'zlib'"),
    ({"filters": [{"id": "delta", "dtype": "<i4"}]}, "filters"),
    ({"zarr_format": 3}, "zarr_format 3")])
def test_zarr_kinds_not_read_raise(change, match):
    items = zarr2.array_items("a", np.arange(6, dtype=np.int32))
    meta = json.loads(items[b"a/.zarray"])
    meta.update(change)
    items[b"a/.zarray"] = json.dumps(meta).encode()
    with pytest.raises(DecodeError, match=match):
        zarr2.read_array(items, "a")


def test_zarr_chunks_that_fail():
    items = zarr2.array_items("a", np.arange(6, dtype=np.int32))
    with pytest.raises(DecodeError, match="no .zarray"):
        zarr2.read_array(items, "b")
    short = {**items, b"a/0": zstd.encode_raw(bytes(20))}
    with pytest.raises(DecodeError, match="capacity|holds 20"):
        zarr2.read_array(short, "a")
    bools = zarr2.array_items("v", np.ones(4, bool))
    bools[b"v/0"] = zstd.encode_raw(b"\1\2\0\1")
    with pytest.raises(DecodeError, match="bool"):
        zarr2.read_array(bools, "v")


def _files(path: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


@pytest.mark.parametrize("which", ["manifest", "node"])
def test_flipped_bytes_raise(tmp_path, which):
    """Any one byte changed in the manifest or in the root node fails the
    CRC-32C (or an earlier check): DecodeError, never another error."""
    src = str(tmp_path / "src")
    ocdbt.write(src, {k: b"v" * 20 for k in _keys(30)})
    db = ocdbt.Database(src)
    if which == "manifest":
        name, lo, n = ocdbt.MANIFEST, 0, os.path.getsize(
            os.path.join(src, ocdbt.MANIFEST))
    else:
        root = db.manifest.versions[-1].root
        name, lo, n = root.file, root.offset, root.length
    for pos in range(lo, lo + n, max(1, n // 40)):
        dst = str(tmp_path / f"x{pos}")
        shutil.copytree(src, dst)
        with open(os.path.join(dst, name), "r+b") as f:
            f.seek(pos)
            b = f.read(1)[0]
            f.seek(pos)
            f.write(bytes([b ^ 0x10]))
        with pytest.raises(DecodeError):
            ocdbt.read(dst)
        shutil.rmtree(dst)


def test_bad_databases_raise(tmp_path):
    src = str(tmp_path / "src")
    placed = ocdbt.write(src, {b"k": b"x" * 5000})
    data = os.path.join(src, placed[b"k"].path)
    # a data file cut short
    with open(data, "r+b") as f:
        f.truncate(100)
    with pytest.raises(DecodeError, match="past"):
        ocdbt.read(src)
    os.remove(data)
    with pytest.raises(DecodeError):
        ocdbt.read(src)
    with pytest.raises(DecodeError, match="no OCDBT manifest"):
        ocdbt.read(str(tmp_path))
    # a body that names a data file outside the database
    bad = ocdbt._enc_table([("../", "d/x")])
    with pytest.raises(DecodeError, match="leaves the database"):
        ocdbt._table(ocdbt._Buf(bad, "t"), "")
    # wrong magic, length field, format version
    raw = ocdbt.frame(b"\0\0\0", ocdbt.BTREE_MAGIC)
    with pytest.raises(DecodeError, match="magic"):
        ocdbt.unframe(raw, ocdbt.MANIFEST_MAGIC, "m")
    with pytest.raises(DecodeError, match="length"):
        ocdbt.unframe(raw + b"\0", ocdbt.BTREE_MAGIC, "n")
    head = struct.pack(">I", ocdbt.BTREE_MAGIC) + struct.pack(
        "<Q", 4 + 8 + 2 + 3 + 4) + b"\1\0" + b"abc"
    raw = head + struct.pack("<I", ocdbt.zstd.crc32c(head))
    with pytest.raises(DecodeError, match="format version"):
        ocdbt.unframe(raw, ocdbt.BTREE_MAGIC, "n")


@pytest.mark.parametrize("declared", [257, 1 << 40, (1 << 62) - 1])
def test_node_declaring_past_max_decoded_bytes_raises(declared):
    """A node whose zstd frame declares more than the config's
    ``max_decoded_node_bytes`` (its CRC-32C right) raises before any
    buffer of that size is taken."""
    body = (struct.pack("<IBQ", zstd.MAGIC, 0xE0, declared)
            + (1 << 3 | 1 << 1 | 1).to_bytes(3, "little") + b"\0")
    head = struct.pack(">I", ocdbt.BTREE_MAGIC) + struct.pack(
        "<Q", 4 + 8 + 2 + len(body) + 4) + b"\0\1" + body
    raw = head + struct.pack("<I", zstd.crc32c(head))
    with pytest.raises(DecodeError, match="capacity"):
        ocdbt.unframe(raw, ocdbt.BTREE_MAGIC, "n", 256)
