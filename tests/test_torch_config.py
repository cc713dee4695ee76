"""The port's own configuration (``fealess_tpu_torch.config``) against the
JAX package's ``fealess_tpu.config``: every dataclass has the same fields,
in the same order, with the same defaults, so the copy cannot drift; the
one JSON codec reads back a ``bank_meta.json`` and an artifact
``meta.json`` written by either package, one of them without
``modalities``.

``to_port`` turns a JAX config into the port's (class by class, field by
field); the other port tests build their configs with the JAX package and
hand the port ``to_port`` of them, so both sides run one operating point.
"""

import dataclasses
import json

import numpy as np
import pytest

from fealess_tpu import config as jax_cfg
from fealess_tpu.io import checkpoint as jax_checkpoint
from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.bank import TemplateView, pack_bank
from fealess_tpu_torch.io import checkpoint

CLASSES = ["ColorGradientConfig", "DepthNormalConfig", "DetectorConfig",
           "IcpConfig", "EngineConfig", "KcfConfig"]


def to_port(c):
    """The port's config equal to the JAX config ``c`` (recursively)."""
    if dataclasses.is_dataclass(c):
        return getattr(cfg, type(c).__name__)(**{
            f.name: to_port(getattr(c, f.name))
            for f in dataclasses.fields(c)})
    return c


def _same(port, jax):
    """Equal class names and field values, recursively."""
    assert type(port).__name__ == type(jax).__name__
    if dataclasses.is_dataclass(jax):
        assert type(port).__module__ == "fealess_tpu_torch.config"
        for f in dataclasses.fields(jax):
            _same(getattr(port, f.name), getattr(jax, f.name))
    else:
        assert port == jax


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_matches_jax(name):
    """Field names, order, annotations, defaults and frozenness."""
    port, jax = getattr(cfg, name), getattr(jax_cfg, name)
    pf, jf = dataclasses.fields(port), dataclasses.fields(jax)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert [str(f.type) for f in pf] == [str(f.type) for f in jf]
    assert port.__dataclass_params__.frozen and jax.__dataclass_params__.frozen
    default_p, default_j = port(), jax()
    for f in jf:
        p, j = getattr(default_p, f.name), getattr(default_j, f.name)
        if dataclasses.is_dataclass(j):
            _same(p, j)
        else:
            assert type(p) is type(j) and p == j, f.name


@pytest.mark.parametrize("det", [
    jax_cfg.DetectorConfig(), jax_cfg.default_line(),
    jax_cfg.default_linemod(),
    jax_cfg.DetectorConfig(t_at_level=(5, 8, 4), image_width=240)],
    ids=["default", "line", "linemod", "three_levels"])
def test_detector_helpers_match_jax(det):
    """``to_port`` keeps every field; the two properties and the two
    factories agree."""
    port = to_port(det)
    _same(port, det)
    assert port.pyramid_levels == det.pyramid_levels
    assert port.pyramid_alignment == det.pyramid_alignment
    _same(cfg.default_line(), jax_cfg.default_line())
    _same(cfg.default_linemod(), jax_cfg.default_linemod())
    _same(to_port(jax_cfg.EngineConfig(detector=det)),
          jax_cfg.EngineConfig(detector=det))
    assert cfg.EngineConfig().valid_depth_max_mm == \
        jax_cfg.EngineConfig().valid_depth_max_mm


ENGINES = [jax_cfg.EngineConfig(),
           jax_cfg.EngineConfig(
               detector=jax_cfg.DetectorConfig(
                   t_at_level=(5, 8, 4), image_width=240, image_height=160,
                   depth_normal=jax_cfg.DepthNormalConfig(
                       distance_threshold=1500), max_candidates=16),
               icp=jax_cfg.IcpConfig(mode="point_to_point", max_points=4096,
                                     centered_covariance=True),
               refine_crop=128, template_cx=120.0),
           jax_cfg.EngineConfig(detector=jax_cfg.default_line())]


@pytest.mark.parametrize("drop_modalities", [False, True],
                         ids=["modalities", "no_modalities"])
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("k", range(len(ENGINES)))
def test_config_json_round_trips(tmp_path, k, writer, drop_modalities):
    """The ``detector`` of a ``bank_meta.json`` and the ``engine_config``
    of an artifact ``meta.json``, written as each package writes them, read
    back through the port's codec.  Without ``modalities`` (files from
    before that field), the decoder gives the default LINE-MOD set."""
    want = ENGINES[k]
    if writer == "port":
        det_d = cfg.detector_to_dict(to_port(want.detector))
        eng_d = dataclasses.asdict(to_port(want))
    else:
        det_d = jax_checkpoint._det_to_dict(want.detector)
        eng_d = dataclasses.asdict(want)
    if drop_modalities:
        del det_d["modalities"], eng_d["detector"]["modalities"]
        want = dataclasses.replace(want, detector=dataclasses.replace(
            want.detector, modalities=jax_cfg.DetectorConfig().modalities))
    path = tmp_path / "meta.json"
    path.write_text(json.dumps({"detector": det_d, "engine_config": eng_d}))
    meta = json.loads(path.read_text())
    _same(cfg.detector_from_dict(meta["detector"]), want.detector)
    _same(cfg.engine_from_dict(meta["engine_config"]), want)
    assert cfg.engine_from_dict(meta["engine_config"]) == to_port(want)


def test_bank_meta_json_round_trips(tmp_path):
    """save_bank writes the detector into bank_meta.json and load_bank
    returns it (a three-level detector, one class, one view)."""
    det = to_port(ENGINES[1].detector)
    rng = np.random.default_rng(3)
    feats = [[rng.integers(0, 30, (8, 3)).astype(np.int32) % [30, 30, 8]
              for _ in det.modalities] for _ in range(det.pyramid_levels)]
    view = TemplateView(features=feats, width=[30, 15, 7],
                        height=[30, 15, 7], offset_x=[4, 2, 1],
                        offset_y=[6, 3, 1],
                        pose=np.arange(13, dtype=np.float32))
    bank = pack_bank({"obj": [view]}, levels=det.pyramid_levels, capacity=2,
                     device="cpu")
    checkpoint.save_bank(str(tmp_path), bank, det)
    meta = json.loads((tmp_path / "bank_meta.json").read_text())
    assert meta["detector"] == json.loads(json.dumps(
        jax_checkpoint._det_to_dict(ENGINES[1].detector)))
    _, got = checkpoint.load_bank(str(tmp_path), device="cpu")
    assert got == det
