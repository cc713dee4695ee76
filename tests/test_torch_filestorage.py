"""cv::FileStorage's XML and JSON forms in the port
(``fealess_tpu_torch/io/filestorage.py``, through ``io/linemod_yaml``)
against cv2 and the JAX package: the emitters write cv2's text byte for
byte on random trees of the node kinds a bank holds, the parsers read
cv2's text to its values and take the comments, whitespace and attribute
forms cv2's parsers take, anything else is refused by name; the form is
chosen as cv2 chooses it (by content when reading, by extension when
writing, gzip by ``.gz``); ``save_linemod`` / ``save_classes`` write the
JAX writer's text in every form and each package reads the other's,
also under a ``.yml`` name; ``export_yaml`` / ``import_yaml``,
``train_package(out_yml=...)`` and ``ObjReco.add_obj`` on a feature
directory whose ``linemod_templates.yml`` is XML or JSON give JAX's."""

import gzip
import os
import random
import shutil

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu.apps import scan_package as jax_scan
from fealess_tpu.engine import CamIntrinsics as JaxCam
from fealess_tpu.engine import ObjReco as JaxReco
from fealess_tpu.io import checkpoint as jax_ckpt
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch.apps import scan_package
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from fealess_tpu_torch.io import checkpoint, filestorage, linemod_yaml
from tests.test_torch_config import to_port
from tests.test_torch_engine import _LEAVES
from tests.test_torch_io import _assert_same_classes
from tests.test_torch_match import FIXTURE, N_SLOTS
from tests.test_torch_persist import DETS, _random_classes

torch.set_num_threads(1)

FORMS = [".xml", ".json", ".xml.gz", ".json.gz"]
EMITTERS = {"xml": filestorage.XmlEmitter, "json": filestorage.JsonEmitter}
PARSERS = {"xml": filestorage.parse_xml, "json": filestorage.parse_json}


# ---- random trees: maps, block and flow sequences, ints, reals, strings

_KEYS = ("a", "b_c", "x-1", "key", "T", "_k", "pose")
_CHARS = "abcXYZ019 _-+.<>&'\"\\/\t\n:;,[]{}#\x01\x7fé"


def _tree(r: random.Random, depth: int, is_map: bool):
    items = []
    for i in range(r.randint(0, 5)):
        key = r.choice(_KEYS) + str(i) if is_map else None
        u = r.random()
        if depth and u < 0.25:
            items.append((key, "map", _tree(r, depth - 1, True)))
        elif depth and u < 0.45:
            items.append((key, "seq", _tree(r, depth - 1, False)))
        elif u < 0.6:
            items.append((key, "flow", [
                ("int", r.randint(-10 ** 6, 10 ** 6)) if r.random() < 0.5
                else ("real", r.uniform(-1e4, 1e4))
                for _ in range(r.randint(0, 40))]))
        elif u < 0.75:
            items.append((key, "int", r.randint(-2 ** 31, 2 ** 31 - 1)))
        elif u < 0.9:
            items.append((key, "real", r.choice(
                [r.uniform(-1e6, 1e6), float(r.randint(-100, 100)), 1e300,
                 -1e-300, 0.1, np.float32(r.uniform(-9, 9)).item()])))
        else:
            items.append((key, "str", "".join(
                r.choice(_CHARS) for _ in range(r.randint(0, 12)))))
    return items


def _emit_cv2(fs, items) -> None:
    for key, kind, v in items:
        k = key or ""
        if kind in ("map", "seq"):
            fs.startWriteStruct(k, cv2.FILE_NODE_MAP if kind == "map"
                                else cv2.FILE_NODE_SEQ)
            _emit_cv2(fs, v)
            fs.endWriteStruct()
        elif kind == "flow":
            fs.startWriteStruct(k, cv2.FILE_NODE_SEQ | cv2.FILE_NODE_FLOW)
            for t, x in v:
                fs.write("", int(x) if t == "int" else float(x))
            fs.endWriteStruct()
        else:
            fs.write(k, {"int": int, "real": float, "str": str}[kind](v))


def _emit_port(em, items) -> None:
    for key, kind, v in items:
        if kind in ("map", "seq"):
            em.start(key, kind == "map")
            _emit_port(em, v)
            em.end()
        elif kind == "flow":
            em.start(key, False, flow=True)
            for t, x in v:
                (em.int if t == "int" else em.real)(None, x)
            em.end()
        else:
            {"int": em.int, "real": em.real, "str": em.string}[kind](key, v)


def _same_value(got, kind, v, form) -> bool:
    """Whether the parser's node ``got`` holds the written value: numbers
    by value; in XML an empty struct reads as [] and a sequence of one
    value as that value (cv::FileStorage's nodes, as its FileNode API
    sees them)."""
    if kind in ("int", "real"):
        try:
            return float(got) == float(v)
        except (TypeError, ValueError):
            return False
    if kind == "str":
        return got == v
    if kind == "map":
        if form == "xml" and not v:
            return got == []
        return isinstance(got, dict) and list(got) == [k for k, _, _ in v] \
            and all(_same_value(got[k], kk, vv, form) for k, kk, vv in v)
    kids = [(t, x) for t, x in v] if kind == "flow" else \
        [(kk, vv) for _, kk, vv in v]
    if form == "xml" and len(kids) == 1 and \
            kids[0][0] in ("int", "real", "str"):
        return _same_value(got, *kids[0], form)
    return isinstance(got, list) and len(got) == len(kids) and \
        all(_same_value(g, k, x, form) for g, (k, x) in zip(got, kids))


@pytest.mark.parametrize("seeds", [range(0, 60), range(60, 120),
                                   range(120, 180)])
@pytest.mark.parametrize("form", ["xml", "json"])
def test_emitter_writes_cv2_text_and_parser_reads_it(tmp_path, form, seeds):
    """On random trees (nested maps and block sequences, flow sequences
    that wrap, ints, %.17g reals, strings with characters to escape) the
    emitter's text equals cv2.FileStorage's byte for byte, and the parser
    reads cv2's text to the written values wherever cv2 reads it back."""
    path = str(tmp_path / f"t.{form}")
    read_back = 0
    for seed in seeds:
        items = _tree(random.Random(seed), 3, True)
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        _emit_cv2(fs, items)
        fs.release()
        with open(path, encoding="utf-8") as f:
            want = f.read()
        em = EMITTERS[form]()
        _emit_port(em, items)
        assert em.text() == want, seed
        try:      # JSON strings cv2 leaves in single quotes do not read
            cv2.FileStorage(path, cv2.FILE_STORAGE_READ).release()
        except (cv2.error, SystemError):
            continue
        root = PARSERS[form](want)
        assert _same_value(root, "map", items, form) if items else \
            root == {}, seed
        read_back += 1
    assert read_back >= len(seeds) // 2


@pytest.mark.parametrize("s", ["ColorGradient", "", "123", "-x", ".5",
                               "a b", "<&>'\"", '"quoted"', "'single'",
                               "tab\there", "\x01\x1f\x7f", "é ü", "obj_1"])
def test_strings_escape_and_read_back_as_cv2(tmp_path, s):
    """Quoting and escaping of one string value in both forms, and the
    value cv2 reads back from cv2's file is the port's."""
    for form in ("xml", "json"):
        path = str(tmp_path / f"s.{form}")
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        fs.write("k", s)
        fs.release()
        with open(path, encoding="utf-8") as f:
            want = f.read()
        em = EMITTERS[form]()
        em.string("k", s)
        assert em.text() == want
        try:
            fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        except (cv2.error, SystemError):
            with pytest.raises(ValueError):
                PARSERS[form](want)
            continue
        assert PARSERS[form](want)["k"] == fs.getNode("k").string()
        fs.release()


@pytest.mark.parametrize("name,form,gz", [
    ("a.xml", "xml", False), ("a.XML", "xml", False),
    ("a.Json", "json", False), ("a.xml.gz", "xml", True),
    ("a.json.gz", "json", True), ("a.xml.GZ", "xml", False),
    ("a.yml", "yaml", False), ("a.txt", "yaml", False),
    ("a.yml.gz", "yaml", True), ("noext", "yaml", False)])
def test_form_chosen_by_extension_and_content_as_cv2(tmp_path, name, form,
                                                     gz):
    """cv2 picks the written form by extension (any case, past a .gz in
    any case) and gzips only a lower-case .gz; the port does the same, and
    reads any form by content."""
    det, classes = DETS[1], _random_classes(DETS[1],
                                            np.random.default_rng(2))
    jax_path = str(tmp_path / ("jax_" + name))
    port_path = str(tmp_path / ("port_" + name))
    jax_yaml.save_linemod(jax_path, det, classes)
    linemod_yaml.save_linemod(port_path, to_port(det), classes)
    for path in (jax_path, port_path):
        with open(path, "rb") as f:
            raw = f.read()
        assert raw.startswith(b"\x1f\x8b") == gz
        text = gzip.decompress(raw) if gz else raw
        assert filestorage.read_format(text[:8]) == form
    assert filestorage.write_format(name) == form
    opener = gzip.open if gz else open
    with opener(jax_path, "rb") as a, opener(port_path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("det", DETS, ids=["linemod3", "line"])
@pytest.mark.parametrize("form", FORMS)
def test_save_classes_in_every_form_equals_jax(tmp_path, det, form):
    """Per-class files through a %s pattern in each form: the JAX
    writer's text, and each package reads the other's."""
    classes = _random_classes(det, np.random.default_rng(8),
                              names=("a_cls", "a.b", "3x"))
    fmt = {k: str(tmp_path / f"{k}_%s{form}") for k in ("port", "jax")}
    linemod_yaml.save_classes(fmt["port"], to_port(det), classes)
    jax_yaml.save_classes(fmt["jax"], det, classes)
    opener = gzip.open if form.endswith(".gz") else open
    for cid in classes:
        with opener(fmt["port"] % cid, "rb") as a, \
                opener(fmt["jax"] % cid, "rb") as b:
            assert a.read() == b.read(), cid
    ids = sorted(classes)
    args = (ids, det.pyramid_levels, len(det.modalities))
    for reader in (jax_yaml.load_classes, linemod_yaml.load_classes):
        _assert_same_classes(reader(fmt["port"], *args), classes)
    _assert_same_classes(linemod_yaml.load_classes(fmt["jax"], *args),
                         classes)


@pytest.mark.parametrize("form", ["xml", "json"])
@pytest.mark.parametrize("name", ["bank.yml", "bank.yml.gz", "bank.txt"])
def test_content_decides_under_a_yml_name(tmp_path, form, name):
    """An XML or JSON bank under a YAML name (gzip by .gz) reads, in cv2
    and in the port, as the XML or JSON it holds."""
    det = DETS[0]
    classes = _random_classes(det, np.random.default_rng(11))
    src = str(tmp_path / f"src.{form}")
    jax_yaml.save_linemod(src, det, classes)
    dst = str(tmp_path / name)
    with open(src, "rb") as f:
        data = f.read()
    with (gzip.open if name.endswith(".gz") else open)(dst, "wb") as f:
        f.write(data)
    det_w, cls_w = jax_yaml.load_linemod(dst)
    det_g, cls_g = linemod_yaml.load_linemod(dst)
    assert det_w == det and det_g == to_port(det)
    _assert_same_classes(cls_w, classes)
    _assert_same_classes(cls_g, classes)


def _fixture_prefix_dir(root, form: str) -> str:
    """A feature directory of the fixture's first N_SLOTS templates whose
    linemod_templates.yml is the JAX writer's XML or JSON."""
    det, classes = jax_yaml.load_linemod(
        os.path.join(FIXTURE, "features", "linemod_templates.yml"))
    d = os.path.join(str(root), form)
    os.makedirs(os.path.join(d, "depth"))
    tmp = os.path.join(str(root), f"bank.{form}")
    jax_yaml.save_linemod(tmp, det, {"obj": classes["obj"][:N_SLOTS]})
    shutil.move(tmp, os.path.join(d, "linemod_templates.yml"))
    for t in range(N_SLOTS):
        shutil.copy(os.path.join(FIXTURE, "features", "depth", f"{t}.png"),
                    os.path.join(d, "depth", f"{t}.png"))
    return d


@pytest.mark.parametrize("form", ["xml", "json"])
def test_add_obj_serves_xml_and_json_banks_as_jax(tmp_path, form):
    """ObjReco.add_obj on a feature directory whose linemod_templates.yml
    holds XML or JSON (the 128-slot fixture prefix): the bank JAX's
    add_obj builds, and JAX's top-1 on the fixture scene."""
    d = _fixture_prefix_dir(tmp_path, form)
    ref = JaxReco.create("LmICP")
    ref.add_obj(d)
    port = ObjReco.create("LmICP", device="cpu")
    port.add_obj(d)
    for k in _LEAVES:
        np.testing.assert_array_equal(getattr(port.bank, k).numpy(),
                                      np.asarray(getattr(ref.bank, k)),
                                      err_msg=k)
    bgr = cv2.imread(os.path.join(FIXTURE, "scene_bgr.png"))
    depth = cv2.imread(os.path.join(FIXTURE, "scene_depth.png"),
                       cv2.IMREAD_UNCHANGED)
    with open(os.path.join(FIXTURE, "cam.txt")) as f:
        k = [float(v) for v in f.read().split()] + [640, 480]
    want = ref.recognition(bgr, depth, JaxCam(*k))
    got = port.recognition(bgr, depth, CamIntrinsics(*k))
    assert want and len(got) == len(want)
    g, w = got[0], want[0]
    assert (g.obj_tag, g.match_rect, g.similarity) == \
        (w.obj_tag, w.match_rect, w.similarity)
    np.testing.assert_allclose(g.world2cam, w.world2cam, atol=0.05)


@pytest.mark.parametrize("form", FORMS)
def test_export_and_import_yaml_in_every_form(tmp_path, form):
    """export_yaml writes the JAX export's text in each form (gzip
    members compared), and import_yaml of JAX's file gives JAX's
    leaves."""
    det = DETS[0]
    classes = _random_classes(det, np.random.default_rng(13))
    src = str(tmp_path / ("src" + form))
    jax_yaml.save_linemod(src, det, classes)
    got, det_g = checkpoint.import_yaml(src, capacity=12, device="cpu")
    want, det_w = jax_ckpt.import_yaml(src, capacity=12)
    assert det_w == det and det_g == to_port(det)
    assert got.class_names == want.class_names
    for k in _LEAVES:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    out = {"port": str(tmp_path / ("port" + form)),
           "jax": str(tmp_path / ("jax" + form))}
    checkpoint.export_yaml(out["port"], got, det_g)
    jax_ckpt.export_yaml(out["jax"], want, det_w)
    opener = gzip.open if form.endswith(".gz") else open
    with opener(out["port"], "rb") as a, opener(out["jax"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("form", [".xml", ".json.gz"])
def test_train_package_writes_any_form(tmp_path, form):
    """train_package(out_yml=...) in XML and gzipped JSON: JAX's bytes."""
    from tests.test_torch_scan_package import write_package
    pkg = str(tmp_path / "pkg")
    write_package(pkg)
    out = {k: str(tmp_path / (k + form)) for k in ("port", "jax")}
    got = scan_package.train_package(pkg, class_id="box",
                                     out_yml=out["port"], device="cpu")
    want = jax_scan.train_package(pkg, class_id="box", out_yml=out["jax"])
    assert got == want == (3, 3)
    opener = gzip.open if form.endswith(".gz") else open
    with opener(out["port"], "rb") as a, opener(out["jax"], "rb") as b:
        assert a.read() == b.read()


_XML_FORMS = '''<?xml version='1.0' encoding="UTF-8" ?>
<!-- a comment before the root -->
<opencv_storage>
  <pyramid_levels type_id="int">2</pyramid_levels>  <!-- note -->
  <T note='a "b"'>
     5
     8 </T>
  <modalities><_ >
      <type>"ColorGradient"</type>
      <weak_threshold>10.</weak_threshold></_></modalities>
  <name type_id="opencv-matrix"><a>1</a></name>
  <text>&quot;a&#x20;b&#65;&lt;</text>
  <one type_id="seq">7</one>
  <mixed>1 <_>2</_> 3</mixed>
  <empty></empty>
</opencv_storage>
<opencv_storage><pyramid_levels>9</pyramid_levels></opencv_storage>
'''
_JSON_FORMS = '''{
    // a line comment
    "pyramid_levels": 2, /* a block
    comment */
    "T": [ 5, 8, ],
    "modalities": [ { "type": "ColorGradient", "weak_threshold": 10.0 } ],
    "flags": [ true, false ],
    ,
    "text": "a\\"b\\'c\\\\d\\n",
    "e": 1.5e3,
    "neg": -.25
}
'''


@pytest.mark.parametrize("form", ["xml", "json"])
def test_parsers_take_cv2_parser_forms(tmp_path, form):
    """Comments, spacing, attributes in either quote,
    type_id seq and others, entities, values mixed with _ elements, a second
    root (XML); comments, trailing and stray commas, true / false, escapes
    (JSON): cv2 reads each file, and the port reads it to the same
    values."""
    text = _XML_FORMS if form == "xml" else _JSON_FORMS
    path = str(tmp_path / f"f.{form}")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    root = linemod_yaml._read_root(path)

    def same(node, value):
        if node.isMap():
            assert isinstance(value, dict) and sorted(value) == \
                sorted(node.keys())
            for k in node.keys():
                same(node.getNode(k), value[k])
        elif node.isSeq():
            assert isinstance(value, list) and len(value) == node.size()
            for i in range(node.size()):
                same(node.at(i), value[i])
        elif node.isString():
            assert value == node.string()
        elif node.isNone():
            assert value == []
        else:
            assert float(value) == node.real()
    same(fs.root(), root)
    fs.release()


@pytest.mark.parametrize("form,text,match", [
    ("xml", "<opencv_storage></opencv_storage>", "<\\?xml"),
    ("xml", '<?xml version="1.0"?><root></root>', "opencv_storage"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a/></opencv_storage>',
     "empty tag"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>1</b>'
            '</opencv_storage>', "closing tag"),
    ("xml", '<?xml version="1.0"?><opencv_storage><!DOCTYPE x>'
            '</opencv_storage>', "unexpected"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>"x""y"</a>'
            '</opencv_storage>', "no space"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>12ab</a>'
            '</opencv_storage>', "number"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>010</a>'
            '</opencv_storage>', "octal or hex"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>x&foo;</a>'
            '</opencv_storage>', "unexpected"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>1</a><a>2</a>'
            '</opencv_storage>', "duplicate key"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>1 <b>2</b></a>'
            '</opencv_storage>', "mixed"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a>1</a>',
     "not closed"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a type_id="str">1</a>'
            '</opencv_storage>', "type_id"),
    ("xml", '<?xml version="1.0"?><opencv_storage><a type_id="binary">'
            'AAAA</a></opencv_storage>', "base64"),
    ("json", '[1, 2]', "top level"),
    ("json", '{"a": null}', "null"),
    ("json", '{"a": "\\u0041"}', "value"),
    ("json", '\ufeff{"a": 1}', "top level"),
    ("xml", '\ufeff<?xml version="1.0"?><opencv_storage></opencv_storage>',
     "<\\?xml"),
    ("json", '{"a": 1, "a": 2}', "duplicate key"),
    ("json", '{"a": [1,,2]}', "value"),
    ("json", '{"a": 0x1F}', "octal or hex"),
    ("json", '{"a": "$base64$AAAA"}', "base64"),
    ("json", '{"a" 1}', "':'"),
    ("json", '{"a": 1} x', "after the top-level map"),
    ("json", '{"a": [1, 2}', "unexpected"),
    ("json", '{a: 1}', "key"),
    ("json", '{"a": 1', "ends inside"),
])
def test_parsers_refuse_other_constructs_by_name(form, text, match):
    with pytest.raises(ValueError, match=match):
        PARSERS[form](text)


def test_committed_bank_digests_are_the_writers_text():
    """tests/data/torch_ckpt/filestorage.json (chip_smoke.py phase 7e
    holds the port's writer on the card to it) is the sha256 of the JAX
    writer's XML and JSON of the fixture bank, and of the port's."""
    import hashlib
    import json
    from tests.make_torch_ckpt import FILESTORAGE, filestorage_digests
    with open(FILESTORAGE) as f:
        want = json.load(f)
    assert filestorage_digests() == want
    det, classes = linemod_yaml.load_linemod(
        os.path.join(FIXTURE, "features", "linemod_templates.yml"))
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for form in ("xml", "json"):
            path = os.path.join(tmp, f"bank.{form}")
            linemod_yaml.save_linemod(path, det, classes)
            with open(path, "rb") as f:
                assert hashlib.sha256(f.read()).hexdigest() == want[form]
