"""Template-bank checkpoints and YAML interop (counterpart of
``fealess_tpu.io.checkpoint``).

- :func:`save_bank` / :func:`load_bank`: the packed bank's leaves in one
  ``arrays.npz`` (``np.savez``) plus the JAX package's JSON sidecar
  ``bank_meta.json`` (detector config, class names, ``max_span``).  The
  JAX package stores its leaves as an orbax checkpoint under ``arrays/``;
  the two array formats do not interoperate, and :func:`load_bank` refuses
  an orbax checkpoint.  The YAML form below is the shared format.
- :func:`export_yaml` / :func:`import_yaml`: lossless round-trip to the
  reference's ``linemod_templates.yml`` schema, so banks trained here load
  in the JAX package and the C++ reference and vice versa.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.bank import (TemplateBank, bank_arrays,
                                    bank_from_numpy, pack_bank, unpack_bank)
from fealess_tpu_torch.io import linemod_yaml

_META = "bank_meta.json"
_ARRAYS = "arrays.npz"
_ORBAX_ARRAYS = "arrays"


def save_bank(directory: str, bank: TemplateBank,
              det: Optional[cfg.DetectorConfig] = None) -> None:
    """Checkpoint a packed bank: ``arrays.npz`` + ``bank_meta.json``."""
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, _ARRAYS), **bank_arrays(bank))
    meta = {"class_names": list(bank.class_names),
            "max_span": bank.max_span,
            "detector": cfg.detector_to_dict(det) if det else None,
            "format_version": 1}
    with open(os.path.join(directory, _META), "w") as fh:
        json.dump(meta, fh, indent=1)


def load_bank(directory: str, device="cuda"
              ) -> Tuple[TemplateBank, Optional[cfg.DetectorConfig]]:
    """Restore a :func:`save_bank` checkpoint onto ``device``."""
    path = os.path.join(directory, _ARRAYS)
    if not os.path.isfile(path):
        if os.path.isdir(os.path.join(directory, _ORBAX_ARRAYS)):
            raise IOError(f"{directory} is an orbax checkpoint of the JAX "
                          f"package; convert it through export_yaml/"
                          f"import_yaml")
        raise IOError(f"no {_ARRAYS} in {directory}")
    with open(os.path.join(directory, _META)) as fh:
        meta = json.load(fh)
    with np.load(path) as arrays:
        bank = bank_from_numpy(arrays, meta["class_names"],
                               int(meta.get("max_span", 0)), device)
    det = (cfg.detector_from_dict(meta["detector"]) if meta["detector"]
           else None)
    return bank, det


def export_yaml(path: str, bank: TemplateBank,
                det: cfg.DetectorConfig) -> None:
    """Write the bank in the reference ``linemod_templates.yml`` schema."""
    linemod_yaml.save_linemod(path, det, unpack_bank(bank))


def import_yaml(path: str, capacity: Optional[int] = None,
                max_features: int = 63, device="cuda"
                ) -> Tuple[TemplateBank, cfg.DetectorConfig]:
    """Load a reference YAML database into a packed bank on ``device``."""
    det, classes = linemod_yaml.load_linemod(path)
    n = sum(len(v) for v in classes.values())
    bank = pack_bank(classes, levels=det.pyramid_levels,
                     capacity=capacity or max(n, 1),
                     max_features=max_features, device=device)
    return bank, det
