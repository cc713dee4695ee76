"""Minimal OBJ mesh loader (the port's own copy of the part of
``fealess_tpu.apps.model_mesh`` that ``cli eval`` reads; the wireframe
overlay draws with cv2 and belongs to ``--overlay-dir``, which is not
ported).

Reimplements the parsing of ``CModelMesh`` (reference
test/model_mesh.cpp:4-126): ``v``/``vt``/``vn``/``f`` lines, vertices
divided by ``model_scale``, 1-based face indices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    vertices: np.ndarray       # (V, 3) f32
    faces: np.ndarray          # (F, 3) int32 vertex ids (0-based)
    texcoords: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None


def load_obj(path: str, model_scale: float = 1.0) -> ObjMesh:
    """Parse an OBJ file; vertices are divided by ``model_scale``
    (model_mesh.cpp:35)."""
    vs: List[Tuple[float, float, float]] = []
    vts: List[Tuple[float, float]] = []
    vns: List[Tuple[float, float, float]] = []
    fs: List[Tuple[int, int, int]] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                x, y, z = (float(v) for v in parts[1:4])
                vs.append((x / model_scale, y / model_scale,
                           z / model_scale))
            elif tag == "vt":
                vts.append((float(parts[1]), float(parts[2])))
            elif tag == "vn":
                vns.append(tuple(float(v) for v in parts[1:4]))
            elif tag == "f":
                ids = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                fs.append(tuple(ids))
    return ObjMesh(
        vertices=np.asarray(vs, np.float32).reshape(-1, 3),
        faces=np.asarray(fs, np.int32).reshape(-1, 3),
        texcoords=np.asarray(vts, np.float32).reshape(-1, 2)
        if vts else None,
        normals=np.asarray(vns, np.float32).reshape(-1, 3)
        if vns else None)
