"""Template-bank checkpoints and YAML interop (counterpart of
``fealess_tpu.io.checkpoint``).

- :func:`save_bank` / :func:`load_bank`: the JAX package's checkpoint
  format, both ways, without orbax or tensorstore.  ``arrays/`` is what
  orbax's ``StandardCheckpointer`` writes for the bank's leaves (OCDBT
  databases holding zarr v2 arrays: ``io/ocdbt``, ``io/zarr2``, zstd in
  ``io/zstd``), beside the JSON sidecar ``bank_meta.json`` (detector
  config, class names, ``max_span``).  The JAX package's ``load_bank``
  restores what :func:`save_bank` writes, and :func:`load_bank` restores
  what it writes, leaf for leaf and bit for bit.  :func:`load_bank` also
  reads the ``arrays.npz`` that earlier versions of the port wrote.
- :func:`export_yaml` / :func:`import_yaml`: lossless round-trip to the
  reference's ``linemod_templates.yml`` schema, so banks trained here load
  in the JAX package and the C++ reference and vice versa.

orbax's layout under ``arrays/``: ``_METADATA`` (the tree: each leaf's
name and written shape, one shard's where it was sharded; ``use_ocdbt``,
``use_zarr3``), ``_CHECKPOINT_METADATA``, ``_sharding``,
``array_metadatas/process_0`` (each leaf's chunk shape), the database
``ocdbt.process_0/`` (the values), and the root database, whose leaf
points into the process's data file.  orbax's restore reads
``_METADATA`` and the root database only; the others are written as
orbax writes them.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.bank import (_ARRAYS as _LEAVES, TemplateBank,
                                    bank_arrays, bank_from_numpy, pack_bank,
                                    unpack_bank)
from fealess_tpu_torch.io import linemod_yaml, ocdbt, zarr2
from fealess_tpu_torch.io.png import DecodeError

_META = "bank_meta.json"
_NPZ = "arrays.npz"
_ARRAYS = "arrays"
_PROCESS = "ocdbt.process_0"
# each leaf's dtype in the JAX package's TemplateBank
_DTYPES = {k: np.dtype(np.bool_ if k in ("feat_valid", "valid") else
                       np.float32 if k == "pose" else np.int32)
           for k in _LEAVES}
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def _dump(path: str, obj, **kw) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, **kw)


def _write_orbax(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``arrays`` (name -> array) as orbax's ``StandardCheckpointer``
    writes a flat dict of single-device arrays, into ``path`` (replaced
    whole, as orbax's ``force=True`` replaces it)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    start = time.time_ns()
    items = {}
    for name in sorted(arrays):
        items.update(zarr2.array_items(name, arrays[name]))
    placed = ocdbt.write(os.path.join(tmp, _PROCESS), items)
    ocdbt.write(tmp, {**items, **{
        k: ocdbt.Ref(_PROCESS + "/", r.path, r.offset, r.length)
        for k, r in placed.items()}})
    names = sorted(arrays)
    shapes = {k: [int(s) for s in arrays[k].shape] for k in names}
    _dump(os.path.join(tmp, "_METADATA"), {
        "tree_metadata": {f"('{k}',)": {
            "key_metadata": [{"key": k, "key_type": 2}],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": shapes[k]}} for k in names},
        "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None})
    _dump(os.path.join(tmp, "array_metadatas", "process_0"), {
        "array_metadatas": [{"array_metadata": {
            "param_name": k, "write_shape": shapes[k],
            "chunk_shape": shapes[k],
            "ext_metadata": None}} for k in names]})
    sharding = json.dumps({"sharding_type": "SingleDeviceSharding",
                           "device_str": "TFRT_CPU_0"})
    _dump(os.path.join(tmp, "_sharding"),
          {base64.b64encode(k.encode()).decode(): sharding for k in names},
          separators=(",", ":"))
    _dump(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": start,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _read_orbax(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an orbax checkpoint (OCDBT, zarr v2) at ``path``,
    keyed by their tree path (dict keys joined with ``.``)."""
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
        tree = meta["tree_metadata"]
    except (OSError, ValueError, KeyError) as e:
        raise DecodeError(f"{path}: no orbax _METADATA ({e})") from None
    if not meta.get("use_ocdbt", False):
        raise DecodeError(f"{path}: an orbax checkpoint without OCDBT is "
                          f"not read")
    if meta.get("use_zarr3", False):
        raise DecodeError(f"{path}: an orbax checkpoint in zarr v3 is not "
                          f"read")
    items = ocdbt.read(path)
    out = {}
    for leaf in tree.values():
        try:
            if leaf.get("value_metadata", {}).get("skip_deserialize"):
                continue
            name = ".".join(str(k["key"]) for k in leaf["key_metadata"])
        except (AttributeError, KeyError, TypeError) as e:
            raise DecodeError(f"{path}: bad _METADATA leaf ({e})") from None
        # the shape is the .zarray's: _METADATA's write_shape is one
        # shard's where the array was sharded
        out[name] = zarr2.read_array(items, name)
    return out


def save_bank(directory: str, bank: TemplateBank,
              det: Optional[cfg.DetectorConfig] = None) -> None:
    """Checkpoint a packed bank as the JAX package's ``save_bank`` does:
    ``arrays/`` (orbax's layout) + ``bank_meta.json``."""
    os.makedirs(directory, exist_ok=True)
    _write_orbax(os.path.join(directory, _ARRAYS), bank_arrays(bank))
    npz = os.path.join(directory, _NPZ)
    if os.path.exists(npz):          # an earlier port's arrays, now stale
        os.remove(npz)
    meta = {"class_names": list(bank.class_names),
            "max_span": bank.max_span,
            "detector": cfg.detector_to_dict(det) if det else None,
            "format_version": 1}
    with open(os.path.join(directory, _META), "w") as fh:
        json.dump(meta, fh, indent=1)


def load_bank(directory: str, device="cuda"
              ) -> Tuple[TemplateBank, Optional[cfg.DetectorConfig]]:
    """Restore a checkpoint of the JAX package's ``save_bank`` or of
    :func:`save_bank` (or an earlier port's ``arrays.npz``) onto
    ``device``, each leaf in the JAX bank's dtype and shape."""
    with open(os.path.join(directory, _META)) as fh:
        meta = json.load(fh)
    orbax_dir = os.path.join(directory, _ARRAYS)
    npz = os.path.join(directory, _NPZ)
    if os.path.isdir(orbax_dir):
        arrays = _read_orbax(orbax_dir)
    elif os.path.isfile(npz):
        with np.load(npz) as f:
            arrays = {k: f[k] for k in f.files}
    else:
        raise IOError(f"no {_ARRAYS}/ or {_NPZ} in {directory}")
    for k in _LEAVES:
        if k not in arrays:
            raise DecodeError(f"{directory}: no leaf {k}")
        if arrays[k].dtype != _DTYPES[k]:
            raise DecodeError(f"{directory}: leaf {k} is "
                              f"{arrays[k].dtype}, a bank's is {_DTYPES[k]}")
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
