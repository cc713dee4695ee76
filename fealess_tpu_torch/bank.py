"""The packed template bank (counterpart of ``fealess_tpu.bank``).

Same array layout as the JAX bank (N = template capacity, L = pyramid
levels, M = modalities, F = max features per modality):

- ``feat_x/feat_y/feat_label``: (N, L, M, F) int32 post-crop coordinates
  and orientation labels; ``feat_valid``: (N, L, M, F) bool padding gate.
- ``width/height/offset_x/offset_y``: (N, L) int32 per-level bbox.
- ``pose``: (N, 13) float32 — 3x4 world2cam row-major + view distance.
- ``class_idx``/``template_idx``: (N,) int32; ``valid``: (N,) bool.

Tensors live on one device; ``bank.to(device)`` moves them all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

_ARRAYS = ("feat_x", "feat_y", "feat_label", "feat_valid", "width", "height",
           "offset_x", "offset_y", "pose", "class_idx", "template_idx",
           "valid")


@dataclasses.dataclass
class TemplateBank:
    feat_x: torch.Tensor
    feat_y: torch.Tensor
    feat_label: torch.Tensor
    feat_valid: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    offset_x: torch.Tensor
    offset_y: torch.Tensor
    pose: torch.Tensor
    class_idx: torch.Tensor
    template_idx: torch.Tensor
    valid: torch.Tensor
    class_names: Tuple[str, ...] = ()
    # Max level-0 template bbox side + 1 (px); bounds the score tables'
    # decimated offsets (fealess_tpu_torch.detector._kernel_hw).  0 means
    # unknown: the full decimated grid.
    max_span: int = 0

    @property
    def capacity(self) -> int:
        return self.feat_x.shape[0]

    @property
    def levels(self) -> int:
        return self.feat_x.shape[1]

    @property
    def modalities(self) -> int:
        return self.feat_x.shape[2]

    @property
    def device(self) -> torch.device:
        return self.feat_x.device

    @property
    def num_templates(self) -> int:
        return int(self.valid.sum())

    def num_features(self) -> torch.Tensor:
        """(N, L) int32: valid features across modalities per level."""
        return self.feat_valid.to(torch.int32).sum(dim=(2, 3),
                                                   dtype=torch.int32)

    def to(self, device) -> "TemplateBank":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _ARRAYS})

    def slots(self, start: int, stop: int) -> "TemplateBank":
        """Slots ``start:stop`` as a bank (a template shard); the class
        names and ``max_span`` are the whole bank's."""
        return dataclasses.replace(
            self, **{k: getattr(self, k)[start:stop] for k in _ARRAYS})


@dataclasses.dataclass
class TemplateView:
    """One template pyramid (a single object view), host-side.

    ``features[l][m]`` is an (n_feat, 3) int array of (x, y, label);
    ``width[l]``/... are per-level ints; ``pose`` is 13 floats.
    """
    features: List[List[np.ndarray]]
    width: List[int]
    height: List[int]
    offset_x: List[int]
    offset_y: List[int]
    pose: np.ndarray


def bank_from_numpy(arrays: Mapping[str, np.ndarray],
                    class_names: Sequence[str], max_span: int,
                    device="cuda") -> TemplateBank:
    """A bank from numpy leaves (e.g. ``np.asarray`` of a JAX bank's
    fields), so two engines can be fed the identical bank."""
    dtypes = {"feat_valid": torch.bool, "valid": torch.bool,
              "pose": torch.float32}
    return TemplateBank(
        **{k: torch.tensor(np.asarray(arrays[k]),
                           dtype=dtypes.get(k, torch.int32), device=device)
           for k in _ARRAYS},
        class_names=tuple(class_names), max_span=int(max_span))


def pack_bank(classes: Dict[str, List[TemplateView]], levels: int,
              modalities: int = 2, capacity: int | None = None,
              max_features: int = 63, device="cuda") -> TemplateBank:
    """Pack host-side template views into a TemplateBank on ``device``."""
    views = [(ci, ti, v)
             for ci, (_, vs) in enumerate(sorted(classes.items()))
             for ti, v in enumerate(vs)]
    n_real = len(views)
    n = capacity or max(n_real, 1)
    if n_real > n:
        raise ValueError(f"{n_real} templates exceed capacity {n}")
    f = max_features

    a = {k: np.zeros((n, levels, modalities, f), np.int32)
         for k in ("feat_x", "feat_y", "feat_label")}
    a["feat_valid"] = np.zeros((n, levels, modalities, f), bool)
    for k in ("width", "height", "offset_x", "offset_y"):
        a[k] = np.zeros((n, levels), np.int32)
    a["pose"] = np.zeros((n, 13), np.float32)
    a["class_idx"] = np.zeros((n,), np.int32)
    a["template_idx"] = np.zeros((n,), np.int32)
    a["valid"] = np.zeros((n,), bool)

    for slot, (ci, ti, v) in enumerate(views):
        for l in range(levels):
            for m in range(modalities):
                feats = np.asarray(v.features[l][m], np.int32).reshape(-1, 3)
                k = min(len(feats), f)
                a["feat_x"][slot, l, m, :k] = feats[:k, 0]
                a["feat_y"][slot, l, m, :k] = feats[:k, 1]
                a["feat_label"][slot, l, m, :k] = feats[:k, 2]
                a["feat_valid"][slot, l, m, :k] = True
            a["width"][slot, l] = v.width[l]
            a["height"][slot, l] = v.height[l]
            a["offset_x"][slot, l] = v.offset_x[l]
            a["offset_y"][slot, l] = v.offset_y[l]
        a["pose"][slot] = np.asarray(v.pose, np.float32)
        a["class_idx"][slot] = ci
        a["template_idx"][slot] = ti
        a["valid"][slot] = True

    max_span = max([max(v.width[0], v.height[0]) + 1 for _, _, v in views],
                   default=1)
    return bank_from_numpy(a, sorted(classes.keys()), max_span, device)


def class_slot_mask(bank: TemplateBank,
                    class_ids: Sequence[str]) -> torch.Tensor:
    """(capacity,) bool mask selecting the slots of the given classes (the
    class_ids restriction of ``Detector::match``, linemod.hpp:317-325).
    Unknown names raise."""
    unknown = [c for c in class_ids if c not in bank.class_names]
    if unknown:
        raise KeyError(f"unknown class_ids {unknown}; "
                       f"bank has {list(bank.class_names)}")
    wanted = torch.tensor([bank.class_names.index(c) for c in class_ids],
                          dtype=torch.int32, device=bank.device)
    return torch.isin(bank.class_idx, wanted)


def view_from_features(features: Sequence[Sequence[np.ndarray]],
                       width: Sequence[int], height: Sequence[int],
                       offset_x: Sequence[int], offset_y: Sequence[int],
                       pose: np.ndarray) -> TemplateView:
    """A TemplateView from externally computed features (the
    ``addSyntheticTemplate`` entry point, linemod.hpp:349,
    linemod.cpp:1636-1642).  ``features[l][m]`` is an (n, 3) int array of
    post-crop (x, y, label) with 0 <= label < 8; ranges are validated so a
    malformed template fails here, not as an out-of-range index in the
    scorer."""
    levels = len(features)
    if not (len(width) == len(height) == len(offset_x) == len(offset_y)
            == levels):
        raise ValueError("per-level lists must have equal length")
    feats = [[np.asarray(fm, np.int32).reshape(-1, 3) for fm in fl]
             for fl in features]
    for l, fl in enumerate(feats):
        for m, fm in enumerate(fl):
            if len(fm) == 0:
                continue
            if (fm[:, 2] < 0).any() or (fm[:, 2] >= 8).any():
                raise ValueError(f"label out of [0, 8) at level {l} "
                                 f"modality {m}")
            if ((fm[:, 0] < 0).any() or (fm[:, 0] > width[l]).any()
                    or (fm[:, 1] < 0).any() or (fm[:, 1] > height[l]).any()):
                raise ValueError(f"feature outside bbox at level {l} "
                                 f"modality {m}")
    return TemplateView(features=feats,
                        width=[int(w) for w in width],
                        height=[int(h) for h in height],
                        offset_x=[int(x) for x in offset_x],
                        offset_y=[int(y) for y in offset_y],
                        pose=np.asarray(pose, np.float32).reshape(13))


def bank_arrays(bank: TemplateBank) -> Dict[str, np.ndarray]:
    """The bank's leaves as host numpy arrays, keyed by field name."""
    return {k: getattr(bank, k).cpu().numpy() for k in _ARRAYS}


def unpack_bank(bank: TemplateBank) -> Dict[str, List[TemplateView]]:
    """Inverse of :func:`pack_bank` (for serialization round-trips)."""
    a = bank_arrays(bank)
    out: Dict[str, List[TemplateView]] = {c: [] for c in bank.class_names}
    for slot in np.flatnonzero(a["valid"]):
        fv = a["feat_valid"][slot]
        feats = [[np.stack([a[k][slot, l, m, fv[l, m]]
                            for k in ("feat_x", "feat_y", "feat_label")],
                           axis=-1)
                  for m in range(bank.modalities)]
                 for l in range(bank.levels)]
        out[bank.class_names[int(a["class_idx"][slot])]].append(TemplateView(
            features=feats,
            width=list(a["width"][slot]), height=list(a["height"][slot]),
            offset_x=list(a["offset_x"][slot]),
            offset_y=list(a["offset_y"][slot]),
            pose=a["pose"][slot].copy()))
    return out
