"""The lookup tables of the reference, regenerated from their formulas
(the port's own copy of ``fealess_tpu.ops.luts``).

``ORIENTATION_SCORES[d]`` is the response of a feature whose orientation
bin lies at circular distance ``d`` (0..4) from the scene's nearest spread
bin: the active table of the reference (linemod/linemod.cpp:968-970; the
two commented alternatives there are [4,1,0,0,0] and [4,3,2,1,0]).
``ops/response.py`` computes the responses from it by bit arithmetic;
:func:`similarity_lut` expands it to the full (8, 256) table of
``SIMILARITY_LUT`` (linemod.cpp:970), and :func:`normal_lut` regenerates
``NORMAL_LUT`` (linemod/normal_lut.i, GRANULARITY 20), whose quantizer the
front-end computes directly from the azimuth (``ops/quantize.py``).
"""

from __future__ import annotations

import functools

import numpy as np

ORIENTATION_SCORES = (4, 2, 1, 0, 0)
MAX_RESPONSE = ORIENTATION_SCORES[0]


@functools.lru_cache(maxsize=None)
def similarity_lut() -> np.ndarray:
    """(8, 256) u8: orientation bin x spread byte -> the best score over
    the byte's set bits, ``max_j score(circular distance(o, j))``."""
    bins = np.arange(8)
    dist = np.abs(bins[:, None] - bins[None, :])
    score = np.asarray(ORIENTATION_SCORES, np.uint8)[np.minimum(dist,
                                                                8 - dist)]
    bits = (np.arange(256)[:, None] >> bins[None, :]) & 1       # (256, 8)
    return (score[:, None, :] * bits[None].astype(np.uint8)).max(axis=2)


def normal_azimuth_bin(nx: np.ndarray, ny: np.ndarray) -> np.ndarray:
    """Azimuth sector of a (projected) normal: 8 bins of 45 deg centred on
    multiples of 45 deg, the generating formula of NORMAL_LUT."""
    ang = np.degrees(np.arctan2(ny, nx)) % 360.0
    return np.floor((ang + 22.5) / 45.0).astype(np.int64) % 8


@functools.lru_cache(maxsize=None)
def normal_lut(granularity: int = 20) -> np.ndarray:
    """The (G, G, G) u8 NORMAL_LUT, indexed as quantizedNormals does
    (linemod.cpp:664-668): ``lut[int(nz*G+G)][int(ny*G/2+G/2)]
    [int(nx*G/2+G/2)]``; it does not depend on nz."""
    g = granularity
    ys, xs = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    plane = (1 << normal_azimuth_bin((xs - g / 2) / (g / 2),
                                     (ys - g / 2) / (g / 2))).astype(np.uint8)
    return np.broadcast_to(plane, (g, g, g)).copy()
