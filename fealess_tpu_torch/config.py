"""Explicit configuration for every runtime parameter of the engine, and its
JSON form (the port's own copy of ``fealess_tpu.config``).

The dataclasses keep the JAX package's names, fields and defaults, so the
two packages read one bank or artifact alike; ``tests/test_torch_config.py``
holds them to it class by class.  The reference scatters its operating
point across compile-time defines and hard-coded literals
(CadReco/obj_reco_lmicp.cpp:6-9,52-55; linemod/linemod.cpp:515-519,827-832,
1820; ICP/common.cpp:264,336-372); here every knob is a field with the
reference default.

:func:`detector_to_dict`, :func:`detector_from_dict` and
:func:`engine_from_dict` are the one JSON codec of these classes: the bank
checkpoint's ``bank_meta.json`` and the serving artifact's ``meta.json``
both go through them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ColorGradientConfig:
    """Quantized colour-gradient modality (reference linemod.cpp:515-519)."""

    weak_threshold: float = 10.0      # gradient magnitude gate at quantization
    strong_threshold: float = 55.0    # gate for template feature candidates
    num_features: int = 63            # features per template at level 0


@dataclasses.dataclass(frozen=True)
class DepthNormalConfig:
    """Quantized depth-normal modality (reference linemod.cpp:827-832)."""

    distance_threshold: int = 2000    # mm; ignore depth beyond this
    difference_threshold: int = 50    # mm; bilateral plane-fit gate
    num_features: int = 63
    extract_threshold: int = 2        # min per-label chessboard distance


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """LINE-MOD detector operating point (reference linemod.cpp:1820-1835)."""

    t_at_level: Tuple[int, ...] = (5, 8)   # spread/sampling step per level
    image_width: int = 640                 # PROC_IMG_WIDTH, obj_reco_lmicp.cpp:6
    image_height: int = 480
    color_gradient: ColorGradientConfig = ColorGradientConfig()
    depth_normal: DepthNormalConfig = DepthNormalConfig()
    # Modality set: ("color_gradient", "depth_normal") = LINE-MOD;
    # ("color_gradient",) = LINE (getDefaultLINE, linemod.cpp:1822-1827).
    modalities: Tuple[str, ...] = ("color_gradient", "depth_normal")
    max_features: int = 63                 # u8 accumulator invariant (linemod.cpp:1137)
    max_templates: int = 1024              # static template-bank capacity
    max_candidates: int = 64               # static top-K carried through refinement

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_at_level)

    @property
    def pyramid_alignment(self) -> int:
        """Smallest dimension multiple for which every pyramid level is
        T-divisible: lcm over levels of ``t_l << l`` (80 for the default
        T={5,8}).  The engine pads frames to this."""
        return math.lcm(*[t << l for l, t in enumerate(self.t_at_level)])


def default_line() -> DetectorConfig:
    """Gradient-only detector (getDefaultLINE, linemod.cpp:1822-1827)."""
    return DetectorConfig(modalities=("color_gradient",))


def default_linemod() -> DetectorConfig:
    """Gradient + normal detector (getDefaultLINEMOD, linemod.cpp:1829-1835)."""
    return DetectorConfig()


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """ICP refinement (reference obj_reco_lmicp.cpp:52-55, ICP/ICP.cpp:617-809)."""

    max_iterations: int = 10          # icp_it_thr
    dist_mean_threshold: float = 0.5  # mm
    dist_diff_threshold: float = 0.01 # mm
    min_points: int = 3               # ptNum_thr, ICP.cpp:633
    max_points: int = 16384           # static padded point-set size
    # The reference gates NN pairs by comparing FLANN's *squared* distance
    # against the unsquared 3*dist_mean (ICP.cpp:268 with L2_Simple metric);
    # True reproduces that, False gates the unsquared distance.
    squared_distance_gate: bool = True
    # "point_to_point" = Kabsch/SVD exactly as the reference (ICP.cpp:
    # 730-744, the parity mode); "point_to_plane" = 6x6 Gauss-Newton normal
    # equations, the default.
    mode: str = "point_to_plane"
    # Relative Tikhonov damping on the 6x6 GN system (point_to_plane only).
    plane_damping: float = 1e-6
    # Weight of the point-to-point anchor blended into the point-to-plane
    # normal equations (H = H_plane + blend*H_point); 0 disables.
    plane_point_blend: float = 0.01
    # Plane-degeneracy gate: below this normal-scatter anisotropy
    # lambda1/lambda2 of eigvals(sum n n^T), every iteration uses the
    # Kabsch (point) update instead of the plane GN step.
    plane_min_normal_anisotropy: float = 0.15
    # False accumulates the covariance without subtracting centroids, as
    # the reference does (ICP.cpp:730-735); True is proper Kabsch.
    centered_covariance: bool = False
    # Point-validity depth cap in mm (is_vec3f_valid, ICP/common.cpp:
    # 261-266): the single source of truth for the z <= 900 gate.
    valid_depth_max_mm: float = 900.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Full recognition pipeline (reference CObjRecoLmICP, obj_reco_lmicp.cpp:47-60)."""

    detector: DetectorConfig = DetectorConfig()
    icp: IcpConfig = IcpConfig()
    matching_threshold: float = 75.0        # percent, obj_reco_lmicp.cpp:53
    # Hard-coded template-rendering intrinsics (ICP/common.cpp:326-372).
    template_fx: float = 608.0
    template_fy: float = 608.0
    template_cx: float = 320.0
    template_cy: float = 240.0
    # Model depth png is stored in 0.1 mm units (obj_reco_lmicp.cpp:188).
    model_depth_scale: float = 0.1
    nms_object_distance: float = 50.0       # mm; th_obj_dist for 3D NMS
    # Candidates refined by the multi-object path (the reference refines
    # top-1 only, obj_reco_lmicp.cpp:111).
    max_objects: int = 8
    # Static refine-window side (must cover the largest template bbox and
    # fit inside the processed image).
    refine_crop: int = 256

    @property
    def valid_depth_max_mm(self) -> float:
        """Alias of ``icp.valid_depth_max_mm`` (the single source of
        truth); configure the cap there."""
        return self.icp.valid_depth_max_mm


@dataclasses.dataclass(frozen=True)
class KcfConfig:
    """KCF tracker (reference kcf_tracker/kcftracker.cpp:92-170)."""

    use_hog: bool = True
    use_lab: bool = False
    use_fixed_window: bool = False
    use_multiscale: bool = True
    lambda_reg: float = 1e-4
    padding: float = 2.5
    output_sigma_factor: float = 0.125      # HOG mode (kcftracker.cpp:106)
    interp_factor: float = 0.012            # HOG mode
    kernel_sigma: float = 0.6               # HOG mode
    cell_size: int = 4
    template_size: int = 96
    scale_step: float = 1.05
    scale_weight: float = 0.95


def detector_to_dict(det: DetectorConfig) -> dict:
    """The JSON form of a detector config."""
    d = dataclasses.asdict(det)
    d["t_at_level"] = list(det.t_at_level)
    return d


def detector_from_dict(d: dict) -> DetectorConfig:
    """Inverse of :func:`detector_to_dict`; a dict without ``modalities``
    (written before that field existed) gets the default LINE-MOD set."""
    d = dict(d)
    cg = ColorGradientConfig(**d.pop("color_gradient"))
    dn = DepthNormalConfig(**d.pop("depth_normal"))
    d["t_at_level"] = tuple(d["t_at_level"])
    if "modalities" in d:
        d["modalities"] = tuple(d["modalities"])
    return DetectorConfig(color_gradient=cg, depth_normal=dn, **d)


def engine_from_dict(d: dict) -> EngineConfig:
    """An engine config from ``dataclasses.asdict`` of one, read back from
    JSON (the artifact's ``meta.json``)."""
    d = dict(d)
    return EngineConfig(detector=detector_from_dict(d.pop("detector")),
                        icp=IcpConfig(**d.pop("icp")), **d)
