"""Minimal OBJ mesh + wireframe reprojection overlay (the port's own copy
of ``fealess_tpu.apps.model_mesh``).

Reimplements ``CModelMesh`` (reference test/model_mesh.cpp:4-126): parse
``v``/``vt``/``vn``/``f`` lines (vertices divided by ``model_scale``,
1-based face indices), project vertices with the pinhole camera and draw
every triangle edge.  The JAX package draws with ``cv2.line``; the card
has no cv2, so :func:`line_pixels` rasterises a line as ``cv2.line`` does
at thickness 1 with LINE_8 (OpenCV's ``clipLine`` to the image, then its
``LineIterator`` from the left end: Bresenham with ``err = dx - 2 dy``,
the minor coordinate of pixel i ``ceil((2 dy i - dx) / (2 dx))``), found
by experiment against cv2 5.0.0 on random lines far outside the image.
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


def project_vertices(mesh: ObjMesh, k: np.ndarray, r: np.ndarray,
                     t: np.ndarray) -> np.ndarray:
    """Pinhole projection of all vertices -> (V, 2) pixel coords
    (cv::projectPoints without distortion, model_mesh.cpp:73/95)."""
    cam = mesh.vertices @ np.asarray(r, np.float32).T \
        + np.asarray(t, np.float32)
    z = np.where(np.abs(cam[:, 2]) < 1e-9, 1e-9, cam[:, 2])
    u = k[0, 0] * cam[:, 0] / z + k[0, 2]
    v = k[1, 1] * cam[:, 1] / z + k[1, 2]
    return np.stack([u, v], axis=-1)


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` (drawing.cpp): (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of the pixels ``cv2.line`` sets in a (h, w) image between
    integer points ``p1`` and ``p2`` (thickness 1, LINE_8)."""
    x1, y1 = (int(v) for v in p1)
    x2, y2 = (int(v) for v in p2)
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:                                # iterate left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    step = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * i) // (2 * major)) if major else i * 0
    if vert:
        return x1 + m, y1 + step * i
    return x1 + i, y1 + step * m


def draw_wireframe(image: np.ndarray, mesh: ObjMesh, k: np.ndarray,
                   pose_4x4: np.ndarray,
                   color=(0, 0, 255)) -> np.ndarray:
    """Overlay the mesh wireframe for a world2cam pose (CModelMesh::Mesh:
    all three edges of every face; model_mesh.cpp:84-90), as the JAX
    package's ``cv2.line`` calls draw it.  Returns the image (drawn in
    place)."""
    r = np.asarray(pose_4x4, np.float64)[:3, :3]
    t = np.asarray(pose_4x4, np.float64)[:3, 3]
    pts = project_vertices(mesh, np.asarray(k, np.float64), r, t)
    pts_i = np.round(pts).astype(np.int64)
    h, w = image.shape[:2]
    ok = ((pts_i[:, 0] > -10 * w) & (pts_i[:, 0] < 10 * w)
          & (pts_i[:, 1] > -10 * h) & (pts_i[:, 1] < 10 * h))
    for f in mesh.faces:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        if not (ok[a] and ok[b] and ok[c]):
            continue
        for p, q in ((a, b), (a, c), (c, b)):
            xs, ys = line_pixels(w, h, pts_i[p], pts_i[q])
            image[ys, xs] = color
    return image
