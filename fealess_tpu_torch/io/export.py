"""The serving artifact (counterpart of ``fealess_tpu.io.export``).

Deployment loads one directory instead of the YAML bank and the model
depth PNGs (the reference ships ``libObjRecoLmICP.so``,
android/Android.mk:1-37).  It holds everything ``ObjReco.add_obj``
computes:

- ``state.npz``: the packed bank's leaves (``bank_*``), the pre-cropped
  model depth stack in mm (``model_depth``, u16), the crop origins
  (``origins``) and the per-level score tables (``table_{l}_{key}``);
- ``meta.json``: the engine config and the bank's static fields, in the
  JAX package's schema, with this package's own version string.

There is no serialized program: the port runs its Python pipeline, so a
cold start saves the YAML parse, the PNG decodes and the table build.

:class:`ServingArtifact` also serves the JAX package's artifacts
(``fealess-artifact-1``): their ``state.npz`` holds the same bank leaves,
model depths and origins and their ``meta.json`` the same fields, but
their score tables have another layout and ``recognition.jaxexport`` is a
JAX program, so both are ignored and the port builds its own tables from
the bank (``detector.build_match_tables``, as ``ObjReco.add_obj`` does).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch import detector as det_mod
from fealess_tpu_torch.bank import bank_arrays, bank_from_numpy
from fealess_tpu_torch.engine import ObjReco

_STATE_FILE = "state.npz"
_META_FILE = "meta.json"
VERSION = "fealess-torch-artifact-1"
_JAX_VERSION = "fealess-artifact-1"


def export_artifact(eng: ObjReco, path: str) -> None:
    """Write the engine's state to the directory ``path``."""
    if eng.bank is None:
        raise RuntimeError("add_obj not called; nothing to export")
    os.makedirs(path, exist_ok=True)
    state = {f"bank_{k}": v for k, v in bank_arrays(eng.bank).items()}
    state["model_depth"] = eng._model_depth_dev.cpu().numpy().astype(
        np.uint16)
    state["origins"] = eng._origins_dev.cpu().numpy()
    for l, tab in enumerate(eng._kernels):
        if tab is None:
            continue
        for key, arr in tab.items():
            state[f"table_{l}_{key}"] = arr.cpu().numpy()
    np.savez_compressed(os.path.join(path, _STATE_FILE), **state)
    meta = {
        "engine_config": dataclasses.asdict(eng.cfg),
        "class_names": list(eng.bank.class_names),
        "max_span": int(eng.bank.max_span),
        "levels": int(eng.bank.levels),
        "version": VERSION,
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)


class ServingArtifact(ObjReco):
    """An engine restored from an artifact on ``device``: the same
    ``recognition`` (and frame preparation and result fetch) as
    :class:`ObjReco`, without parsing YAML or decoding PNGs.  Reads this
    package's artifacts and the JAX package's (whose score tables are
    rebuilt here); any other version raises ``IOError``."""

    def __init__(self, path: str, device="cuda"):
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        version = meta.get("version")
        if version not in (VERSION, _JAX_VERSION):
            raise IOError(f"unknown artifact version {version!r} in {path}")
        super().__init__(cfg.engine_from_dict(meta["engine_config"]),
                         device)
        dev = self.device
        with np.load(os.path.join(path, _STATE_FILE)) as state:
            self.bank = bank_from_numpy(
                {k[5:]: state[k] for k in state.files
                 if k.startswith("bank_")},
                meta["class_names"], meta["max_span"], dev)
            self._model_depth_dev = torch.from_numpy(
                state["model_depth"].astype(np.int32)).to(dev)
            self._origins_dev = torch.from_numpy(
                state["origins"].astype(np.int32)).to(dev)
            if version == VERSION:
                tables = []
                for l in range(meta["levels"]):
                    prefix = f"table_{l}_"
                    tab = {k[len(prefix):]: torch.from_numpy(state[k]).to(dev)
                           for k in state.files if k.startswith(prefix)}
                    tables.append(tab or None)
                self._kernels = tuple(tables)
            else:
                self._kernels = det_mod.build_match_tables(
                    self.bank, self.cfg.detector)
        self._rect_wh = torch.stack([self.bank.width[:, 0],
                                     self.bank.height[:, 0]], 1).cpu().numpy()
        self._feature_path = path
