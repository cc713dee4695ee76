"""The port's persistence against the JAX package's: ``write_png`` round
trips through cv2 and ``read_png``; ``save_linemod`` / ``save_classes``
files read back identically through JAX's cv2 reader and the port's (and
equal cv2's bytes); bank checkpoints round-trip and ``import_yaml`` gives
JAX's leaves; the JAX package's orbax checkpoints load in the port and
the port's in the JAX package, bitwise, and ``recognize_top1`` serves
such a bank as ``ObjReco.recognition`` does; the serving artifact's
``recognition`` equals the port's ``ObjReco.recognition`` and JAX's
(match and similarity exactly, pose within 0.05 mm and 0.01 deg), and so
does an artifact that the JAX package wrote."""

import gzip
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu import bank as jax_bank
from fealess_tpu import config as cfg
from fealess_tpu.engine import CamIntrinsics as JaxCam
from fealess_tpu.io import checkpoint as jax_ckpt
from fealess_tpu.io import linemod_yaml as jax_yaml
from fealess_tpu_torch import bank, detector, pipeline
from fealess_tpu_torch import config as cfg_port
from fealess_tpu_torch.engine import CamIntrinsics
from fealess_tpu_torch.io import checkpoint, linemod_yaml, ocdbt, zstd
from fealess_tpu_torch.io.export import ServingArtifact
from fealess_tpu_torch.io.png import DecodeError, read_png, write_png
from tests.test_match_e2e import H, W
from tests.test_torch_engine import (CX, CY, FX, FY, _LEAVES, _engines,
                                     _frames, _same_results,
                                     feature_dir)  # noqa: F401
from tests.test_torch_config import to_port
from tests.test_torch_io import _assert_same_classes, _encode_png
from tests.make_torch_ckpt import OUT as CKPT, YAML as FIXTURE_YAML
from tests.make_torch_ckpt import leaf_digests

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,dtype", [((7, 9), np.uint8),
                                         ((5, 8), np.uint16),
                                         ((6, 5, 3), np.uint8),
                                         ((1, 1), np.uint16),
                                         ((160, 240, 3), np.uint8)])
def test_write_png_roundtrip(tmp_path, shape, dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    for got in (read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)):
        assert got.dtype == img.dtype and got.shape == img.shape
        np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(read_png(path, color=True),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_read_png_color_matches_cv2(tmp_path):
    """read_png(color=True) is cv2.IMREAD_COLOR on 8/16-bit gray and RGB
    (16-bit samples cut to their high byte, gray to three channels)."""
    rng = np.random.default_rng(3)
    for i, img in enumerate([
            rng.integers(0, 256, (5, 7), dtype=np.uint8),
            rng.integers(0, 65536, (6, 4), dtype=np.uint16),
            rng.integers(0, 256, (3, 5, 3), dtype=np.uint8),
            rng.integers(0, 65536, (4, 6, 3), dtype=np.uint16)]):
        path = str(tmp_path / f"{i}.png")
        with open(path, "wb") as f:
            f.write(_encode_png(img, [0, 4]))
        got = read_png(path, color=True)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_write_png_refuses_other_images(tmp_path):
    for img in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.float32),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError):
            write_png(str(tmp_path / "x.png"), img)


def _random_classes(det, rng, names=("b_cls", "a_cls", "c-3")):
    n_mod = len(det.modalities)
    classes = {}
    for cname in names:
        views = []
        for _ in range(int(rng.integers(1, 4))):
            levels = det.pyramid_levels
            feats = [[rng.integers(0, 200, (int(rng.integers(1, 20)), 3))
                      .astype(np.int32) for _ in range(n_mod)]
                     for _ in range(levels)]
            views.append(jax_bank.TemplateView(
                features=feats,
                width=[int(v) for v in rng.integers(10, 200, levels)],
                height=[int(v) for v in rng.integers(10, 200, levels)],
                offset_x=[int(v) for v in rng.integers(0, 400, levels)],
                offset_y=[int(v) for v in rng.integers(0, 300, levels)],
                pose=(rng.normal(size=13) * 100).astype(np.float32)))
        classes[cname] = views
    return dict(sorted(classes.items()))      # the readers' order


DETS = [cfg.DetectorConfig(t_at_level=(5, 8, 4),
                           depth_normal=cfg.DepthNormalConfig(
                               distance_threshold=1500)),
        cfg.default_line()]


@pytest.mark.parametrize("det", DETS, ids=["linemod3", "line"])
@pytest.mark.parametrize("suffix", [".yml", ".yml.gz", ".xml", ".json",
                                    ".xml.gz", ".json.gz"])
def test_save_linemod_roundtrips_through_both_readers(tmp_path, det, suffix):
    """Several classes, odd pose values (f32 round-trip), LINE-MOD and LINE
    modality sets, YAML, XML and JSON, plain and gzip: the port's file
    reads back through both readers to what was written, and equals the
    JAX writer's text (inside the gzip member for .gz)."""
    classes = _random_classes(det, np.random.default_rng(5))
    port_path = str(tmp_path / ("port" + suffix))
    jax_path = str(tmp_path / ("jax" + suffix))
    linemod_yaml.save_linemod(port_path, to_port(det), classes)
    jax_yaml.save_linemod(jax_path, det, classes)
    for reader, want in ((jax_yaml.load_linemod, det),
                         (linemod_yaml.load_linemod, to_port(det))):
        det_r, cls_r = reader(port_path)
        assert det_r == want
        _assert_same_classes(cls_r, classes)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(port_path, "rb") as a, opener(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_save_classes_load_classes(tmp_path):
    det = DETS[0]
    classes = _random_classes(det, np.random.default_rng(8),
                              names=("a_cls", "a.b", "3x"))
    fmt = {k: str(tmp_path / f"{k}_%s.yml.gz") for k in ("port", "jax")}
    linemod_yaml.save_classes(fmt["port"], to_port(det), classes)
    jax_yaml.save_classes(fmt["jax"], det, classes)
    ids = sorted(classes)
    args = (ids, det.pyramid_levels, len(det.modalities))
    for reader in (jax_yaml.load_classes, linemod_yaml.load_classes):
        _assert_same_classes(reader(fmt["port"], *args), classes)
    _assert_same_classes(linemod_yaml.load_classes(fmt["jax"], *args),
                         classes)


@pytest.fixture(scope="module")
def yaml_banks(tmp_path_factory):
    """A multi-class database imported by both packages."""
    det = DETS[0]
    classes = _random_classes(det, np.random.default_rng(13))
    path = str(tmp_path_factory.mktemp("yml") / "bank.yml")
    jax_yaml.save_linemod(path, det, classes)
    return path, det, classes


def test_import_yaml_equals_jax_leaves(yaml_banks):
    path, det, _ = yaml_banks
    got, det_g = checkpoint.import_yaml(path, capacity=12, device="cpu")
    want, det_w = jax_ckpt.import_yaml(path, capacity=12)
    assert det_w == det and det_g == to_port(det)
    assert got.class_names == want.class_names
    assert got.max_span == want.max_span
    for k in _LEAVES:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


def test_bank_checkpoint_and_yaml_roundtrip(tmp_path, yaml_banks):
    """save_bank/load_bank restore every leaf, the static fields and the
    detector config; export_yaml writes the JAX writer's text and
    unpack_bank inverts pack_bank."""
    path, det, classes = yaml_banks
    packed, _ = checkpoint.import_yaml(path, capacity=12, device="cpu")
    d = str(tmp_path / "ckpt")
    checkpoint.save_bank(d, packed, to_port(det))
    restored, det_r = checkpoint.load_bank(d, device="cpu")
    assert det_r == to_port(det)
    assert (restored.class_names, restored.max_span) == \
        (packed.class_names, packed.max_span)
    for k in _LEAVES:
        a, b = getattr(restored, k), getattr(packed, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    _assert_same_classes(bank.unpack_bank(restored), classes)
    out = str(tmp_path / "out.yml")
    checkpoint.export_yaml(out, restored, to_port(det))
    with open(out) as a, open(path) as b:
        assert a.read() == b.read()
    checkpoint.save_bank(str(tmp_path / "nodet"), packed)
    assert checkpoint.load_bank(str(tmp_path / "nodet"),
                               device="cpu")[1] is None


def _jax_bank(case: str, yaml_banks):
    """(JAX bank, JAX detector config or None, the YAML it came from or
    None) for each checkpoint case."""
    path, det, _ = yaml_banks
    if case in ("yaml12", "nodet"):
        b, _ = jax_ckpt.import_yaml(path, capacity=12)
        return b, (det if case == "yaml12" else None), path
    if case == "fixture1024":
        return jax_ckpt.import_yaml(FIXTURE_YAML) + (FIXTURE_YAML,)
    if case == "sharded8":      # over 8 devices: a grid of 8 chunks a leaf
        from fealess_tpu.parallel import mesh
        b, det = jax_ckpt.import_yaml(FIXTURE_YAML)
        return mesh.shard_bank(b, mesh.template_mesh(8)), det, FIXTURE_YAML
    # 16384 random slots: each feature leaf is one 5 MB chunk, many zstd
    # blocks
    rng = np.random.default_rng(16384)
    n, shape = 16384, (16384, 2, 2, 63)
    arrays = {"feat_x": rng.integers(0, 640, shape, np.int32),
              "feat_y": rng.integers(0, 480, shape, np.int32),
              "feat_label": rng.integers(0, 8, shape, np.int32),
              "feat_valid": rng.random(shape) < 0.9,
              "width": rng.integers(1, 200, (n, 2), np.int32),
              "height": rng.integers(1, 200, (n, 2), np.int32),
              "offset_x": rng.integers(0, 640, (n, 2), np.int32),
              "offset_y": rng.integers(0, 480, (n, 2), np.int32),
              "pose": rng.standard_normal((n, 13)).astype(np.float32),
              "class_idx": rng.integers(0, 3, n, np.int32),
              "template_idx": np.arange(n, dtype=np.int32),
              "valid": rng.random(n) < 0.95}
    import jax.numpy as jnp
    b = jax_bank.TemplateBank(class_names=("a", "b", "c"), max_span=240,
                              **{k: jnp.asarray(v) for k, v in arrays.items()})
    return b, det, None


def _same_bank(port_bank, jax_bank_, det_port, det_jax) -> None:
    """Every leaf bitwise equal, with the JAX bank's dtype and shape; the
    static fields and the detector config equal."""
    assert port_bank.class_names == tuple(jax_bank_.class_names)
    assert port_bank.max_span == jax_bank_.max_span
    assert det_port == (None if det_jax is None else to_port(det_jax))
    for k in _LEAVES:
        got = getattr(port_bank, k).cpu().numpy()
        want = np.asarray(getattr(jax_bank_, k))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), k
        assert got.tobytes() == want.tobytes(), k


CKPT_CASES = ["yaml12", "nodet", "fixture1024", "sharded8", "random16384"]


@pytest.mark.parametrize("case", CKPT_CASES)
def test_load_bank_reads_jax_checkpoint(tmp_path, yaml_banks, case):
    """The port's load_bank of JAX's save_bank equals JAX's load_bank and,
    where the bank came from a YAML, the port's import_yaml; a bank
    sharded over 8 devices is saved as 8 chunks a leaf."""
    jb, det, yml = _jax_bank(case, yaml_banks)
    d = str(tmp_path / "jax")
    jax_ckpt.save_bank(d, jb, det)
    want, det_w = jax_ckpt.load_bank(d)
    got, det_g = checkpoint.load_bank(d, device="cpu")
    _same_bank(got, want, det_g, det_w)
    _same_bank(got, jb, det_g, det)
    if yml is not None:
        imported, _ = checkpoint.import_yaml(
            yml, capacity=jb.feat_x.shape[0], device="cpu")
        for k in _LEAVES:
            assert torch.equal(getattr(got, k), getattr(imported, k)), k


@pytest.mark.parametrize("case", CKPT_CASES)
def test_jax_load_bank_reads_port_checkpoint(tmp_path, yaml_banks, case):
    """JAX's load_bank restores the port's save_bank, leaf for leaf and
    bitwise, with the same detector config and class names; each leaf's
    ``.zarray`` is orbax's (its chunks a shard's where JAX's bank was
    sharded)."""
    jb, det, _ = _jax_bank(case, yaml_banks)
    names = ("feat_x", "feat_y", "feat_label", "feat_valid", "width",
             "height", "offset_x", "offset_y", "pose", "class_idx",
             "template_idx", "valid")
    pb = bank.bank_from_numpy({k: np.asarray(getattr(jb, k)) for k in names},
                              jb.class_names, jb.max_span, "cpu")
    d = str(tmp_path / "port")
    checkpoint.save_bank(d, pb, None if det is None else to_port(det))
    got, det_g = jax_ckpt.load_bank(d)
    assert det_g == det
    _same_bank(pb, got, None if det is None else to_port(det), det_g)
    again, _ = checkpoint.load_bank(d, device="cpu")
    _same_bank(again, got, None if det is None else to_port(det), det_g)
    jax_ckpt.save_bank(str(tmp_path / "jax"), jb, det)
    ours, orbax = (ocdbt.read(os.path.join(p, "arrays"))
                   for p in (d, str(tmp_path / "jax")))
    zarrays = sorted(k for k in orbax if k.endswith(b"/.zarray"))
    assert zarrays == sorted(k for k in ours if k.endswith(b"/.zarray"))
    for k in zarrays:           # orbax's chunks are a shard's
        a, b = json.loads(ours[k]), json.loads(orbax[k])
        assert (a.pop("chunks") == b.pop("chunks")) == (case != "sharded8")
        assert a == b, k


def test_load_bank_reads_old_arrays_npz(tmp_path, yaml_banks):
    """The ``arrays.npz`` earlier versions of the port wrote still loads;
    a save over it writes JAX's format and takes the stale file away."""
    path, det, _ = yaml_banks
    packed, _ = checkpoint.import_yaml(path, capacity=12, device="cpu")
    d = str(tmp_path / "old")
    os.makedirs(d)
    np.savez(os.path.join(d, "arrays.npz"), **bank.bank_arrays(packed))
    with open(os.path.join(d, "bank_meta.json"), "w") as f:
        json.dump({"class_names": list(packed.class_names),
                   "max_span": packed.max_span,
                   "detector": cfg_port.detector_to_dict(to_port(det)),
                   "format_version": 1}, f)
    got, det_g = checkpoint.load_bank(d, device="cpu")
    assert det_g == to_port(det)
    for k in _LEAVES:
        assert torch.equal(getattr(got, k), getattr(packed, k)), k
    checkpoint.save_bank(d, packed, to_port(det))
    assert not os.path.exists(os.path.join(d, "arrays.npz"))
    assert jax_ckpt.load_bank(d)[1] == det


def test_committed_checkpoint_equals_jax_and_digests():
    """The committed JAX checkpoint (``tests/make_torch_ckpt.py``, which
    ``chip_smoke.py`` loads on the card): JAX's load_bank, the port's and
    the recorded digests agree, and so does the fixture YAML's bank."""
    want, det_w = jax_ckpt.load_bank(CKPT)
    got, det_g = checkpoint.load_bank(CKPT, device="cpu")
    _same_bank(got, want, det_g, det_w)
    with open(os.path.join(CKPT, "digests.json")) as f:
        digests = json.load(f)
    assert leaf_digests(got) == leaf_digests(want) == digests
    imported, det_y = checkpoint.import_yaml(FIXTURE_YAML, device="cpu")
    assert det_y == det_g
    assert leaf_digests(imported) == digests


def _orbax_variant(tmp_path, kind: str) -> str:
    """A port checkpoint changed into an orbax form the port refuses."""
    packed = bank.bank_from_numpy(
        {k: np.zeros((2, 2, 2, 3) if k.startswith("feat") else (2, 13)
                     if k == "pose" else (2, 2) if k in (
                         "width", "height", "offset_x", "offset_y") else (2,),
                     np.bool_ if k in ("feat_valid", "valid") else np.float32
                     if k == "pose" else np.int32) for k in _LEAVES},
        ("obj",), 10, "cpu")
    d = str(tmp_path / kind)
    checkpoint.save_bank(d, packed)
    arrays = os.path.join(d, "arrays")
    meta_path = os.path.join(arrays, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    if kind in ("zarr3", "no-ocdbt"):
        meta["use_zarr3" if kind == "zarr3" else "use_ocdbt"] = \
            kind == "zarr3"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        return d
    items = ocdbt.read(arrays)
    zarray = json.loads(items[b"pose/.zarray"])
    if kind == "float64":
        zarray["dtype"] = "<f8"
        items[b"pose/0.0"] = zstd.encode_raw(bytes(2 * 13 * 8))
    else:
        zarray["compressor"] = {"id": "blosc", "cname": "lz4"}
    items[b"pose/.zarray"] = json.dumps(zarray).encode()
    shutil.rmtree(arrays)
    ocdbt.write(arrays, items)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return d


@pytest.mark.parametrize("kind,match", [
    ("zarr3", "zarr v3"), ("no-ocdbt", "without OCDBT"),
    ("float64", "dtype '<f8'"), ("blosc", "compressor 'blosc'")])
def test_load_bank_refuses_orbax_checkpoint(tmp_path, kind, match):
    """The orbax forms the port does not read (zarr v3, no OCDBT, a dtype
    a bank does not have, a compressor other than zstd) raise
    DecodeError naming what they are."""
    d = _orbax_variant(tmp_path, kind)
    with pytest.raises(DecodeError, match=match):
        checkpoint.load_bank(d, device="cpu")


@pytest.mark.parametrize("mode", ["point_to_plane", "point_to_point"])
def test_recognize_top1_from_jax_checkpoint(tmp_path, feature_dir, mode):
    """pipeline.recognize_top1 from the bank of a JAX checkpoint, with the
    model depths of ObjReco.add_obj on the same features, equals
    ObjReco.recognition (every field) and JAX's recognition."""
    ref, port = _engines(feature_dir, mode)
    d = str(tmp_path / "ckpt")
    jax_ckpt.save_bank(d, ref.bank, ref.cfg.detector)
    served, det = checkpoint.load_bank(d, device="cpu")
    assert det == port.cfg.detector
    for k in _LEAVES:
        assert torch.equal(getattr(served, k), getattr(port.bank, k)), k
    tables = detector.build_match_tables(served, det)
    pcam = CamIntrinsics(FX, FY, CX, CY, W, H)
    for bgr, depth in _frames(feature_dir[1]):
        frame = port._prepare_frame(bgr, depth, pcam)
        step = pipeline.recognize_top1(
            served, port._model_depth_dev, port._origins_dev, *frame,
            port.cfg, kernels=tables)
        got = port._fetch_top1(step)[0]
        same = port.recognition(bgr, depth, pcam)
        assert len(got) == len(same) == 1
        for g, s in zip(got, same):
            np.testing.assert_array_equal(g.world2cam, s.world2cam)
            assert (g.obj_tag, g.similarity, g.icp_dist, g.inlier_ratio,
                    g.match_rect) == (s.obj_tag, s.similarity, s.icp_dist,
                                      s.inlier_ratio, s.match_rect)
        _same_results(got, ref.recognition(bgr, depth,
                                           JaxCam(FX, FY, CX, CY, W, H)))


def test_view_from_features_matches_jax():
    feats = [[np.array([[0, 1, 2], [5, 6, 7]]), np.array([[3, 3, 0]])],
             [np.array([[1, 1, 1]]), np.zeros((0, 3), int)]]
    args = (feats, [10, 5], [8, 4], [100, 50], [40, 20],
            np.arange(13, dtype=np.float64))
    got = bank.view_from_features(*args)
    want = jax_bank.view_from_features(*args)
    _assert_same_classes({"o": [got]}, {"o": [want]})
    bad_label = [[np.array([[0, 1, 8]]), feats[0][1]], feats[1]]
    outside = [[np.array([[11, 1, 2]]), feats[0][1]], feats[1]]
    for f in (bad_label, outside):
        with pytest.raises(ValueError):
            bank.view_from_features(f, *args[1:])
    with pytest.raises(ValueError):
        bank.view_from_features(feats, [10], [8, 4], [100, 50], [40, 20],
                                args[5])


@pytest.mark.parametrize("mode", ["point_to_plane", "point_to_point"])
def test_serving_artifact_equals_engine_and_jax(tmp_path, feature_dir, mode):
    """An exported artifact holds the engine's state and serves the same
    results as the port's ObjReco and the JAX package's."""
    ref, port = _engines(feature_dir, mode)
    art = str(tmp_path / "artifact")
    port.export_artifact(art)
    served = ServingArtifact(art, device="cpu")
    assert served.cfg == port.cfg
    for k in _LEAVES:
        assert torch.equal(getattr(served.bank, k), getattr(port.bank, k)), k
    assert torch.equal(served._model_depth_dev, port._model_depth_dev)
    assert torch.equal(served._origins_dev, port._origins_dev)
    for tab_s, tab_p in zip(served._kernels, port._kernels):
        assert tab_s.keys() == tab_p.keys()
        for key in tab_p:
            assert torch.equal(tab_s[key], tab_p[key]), key
    pcam = CamIntrinsics(FX, FY, CX, CY, W, H)
    for bgr, depth in _frames(feature_dir[1]):
        got = served.recognition(bgr, depth, pcam)
        same = port.recognition(bgr, depth, pcam)
        assert len(got) == len(same) == 1
        for g, s in zip(got, same):
            np.testing.assert_array_equal(g.world2cam, s.world2cam)
            assert (g.obj_tag, g.similarity, g.icp_dist, g.inlier_ratio,
                    g.match_rect) == (s.obj_tag, s.similarity, s.icp_dist,
                                      s.inlier_ratio, s.match_rect)
        _same_results(got, ref.recognition(bgr, depth,
                                           JaxCam(FX, FY, CX, CY, W, H)))


@pytest.mark.parametrize("mode", ["point_to_plane", "point_to_point"])
def test_serving_artifact_serves_jax_artifact(tmp_path, feature_dir, mode):
    """An artifact written by the JAX package's ``export_artifact`` is
    served by the port: the bank, model depths and origins are JAX's, the
    score tables are the port's own (built from that bank), and the
    results equal the JAX engine's (match and similarity exactly, pose
    within 0.05 mm and 0.01 deg)."""
    ref, port = _engines(feature_dir, mode)
    art = str(tmp_path / "jax_artifact")
    ref.export_artifact(art)
    with open(os.path.join(art, "meta.json")) as f:
        assert json.load(f)["version"] == "fealess-artifact-1"
    served = ServingArtifact(art, device="cpu")
    assert served.cfg == port.cfg
    for k in _LEAVES:
        assert torch.equal(getattr(served.bank, k), getattr(port.bank, k)), k
    assert served._model_depth_dev.dtype == torch.int32
    assert torch.equal(served._model_depth_dev, port._model_depth_dev)
    assert torch.equal(served._origins_dev, port._origins_dev)
    for tab_s, tab_p in zip(served._kernels, port._kernels):
        assert tab_s.keys() == tab_p.keys()
        for key in tab_p:
            assert torch.equal(tab_s[key], tab_p[key]), key
    pcam = CamIntrinsics(FX, FY, CX, CY, W, H)
    for bgr, depth in _frames(feature_dir[1]):
        _same_results(served.recognition(bgr, depth, pcam),
                      ref.recognition(bgr, depth,
                                      JaxCam(FX, FY, CX, CY, W, H)))


def test_serving_artifact_refuses_unknown_version(tmp_path, feature_dir):
    _, port = _engines(feature_dir, "point_to_plane")
    art = str(tmp_path / "artifact")
    port.export_artifact(art)
    meta_path = os.path.join(art, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    for version in ("v9", "fealess-artifact-2", None):
        with open(meta_path, "w") as f:
            json.dump(dict(meta, version=version), f)
        with pytest.raises(IOError, match="unknown"):
            ServingArtifact(art, device="cpu")
