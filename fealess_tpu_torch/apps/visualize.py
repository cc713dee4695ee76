"""Match visualization: feature circles, the template blit and PLY dumps
(counterpart of ``fealess_tpu.apps.visualize``).

Reimplements the two ``drawResponse`` overloads (linemod/linemod_if.cpp:
65-139) on numpy images, as the JAX package draws them with OpenCV (the
card has no cv2): each template feature becomes a circle of radius T/2 at
the match offset, coloured per modality, and the grayscale template is
blitted into the match rect with a per-pixel max.  ``save_ply`` writes a
cloud for external viewers.

The circle is ``cv2.circle(img, c, r, color, 2)`` (LINE_8, integer centre,
no shift), whose pixels this module computes with OpenCV's own rules
(drawing.cpp, found against cv2 5.0.0): a thickness above 1 draws the
circle as ``ellipse2Poly`` (a polygon of points at every 90, 30, 18 or 5
degrees for radius < 3, < 10, < 15 or more, from OpenCV's sine table of 7
decimals, in 16-bit fixed point) and then a thick polyline: each segment a
filled quadrilateral (``FillConvexPoly``: its edges by the fixed-point
``Line2``, then scanlines) and a filled radius-1 circle at its end (and at
the first segment's start).  Near the border the segments are clipped
first (``clipLine``), which can move their pixels, so each circle is drawn
in the image's own frame.  Thickness 1 takes another algorithm in OpenCV
(Bresenham's circle); only thickness 2, the one ``draw_response`` draws,
is implemented.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from fealess_tpu_torch.apps.model_mesh import clip_line
from fealess_tpu_torch.bank import TemplateBank

# modality colors (BGR) — linemod_if.cpp:68-72 (orange, green, ...)
COLORS = [(0, 140, 255), (0, 255, 0), (0, 255, 255), (0, 140, 255),
          (0, 0, 255)]

_SHIFT = 16                      # OpenCV's XY_SHIFT
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _sin_table(deg: int) -> float:
    """OpenCV's ``SinTable[deg]``: sin(deg) printed to 7 decimals, as a
    float32 literal."""
    return float(np.float32(f"{math.sin(math.radians(deg)):.7f}"))


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _hline(canvas, y: int, x1: int, x2: int) -> None:
    h, w = canvas.shape
    if 0 <= y < h and x2 >= 0 and x1 < w:
        canvas[y, max(x1, 0):min(x2, w - 1) + 1] = True


def _line2(canvas, p1, p2) -> None:
    """``Line2``: a fixed-point 8-connected line between 16.16 points, its
    ends first clipped to the canvas (``clipLine``, which moves the pixels
    of a line that leaves the image)."""
    h, w = canvas.shape
    inside, x1, y1, x2, y2 = clip_line(w << _SHIFT, h << _SHIFT, *p1, *p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            canvas[y, x] = True

    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy * _ONE, ax | 1)
        ecount = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx * _ONE, ay | 1)
        ecount = (y2 - y1) >> _SHIFT
    x1 += _HALF
    y1 += _HALF
    put((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)
    if ax > ay:
        x1 >>= _SHIFT
        while ecount >= 0:
            put(x1, y1 >> _SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= _SHIFT
        while ecount >= 0:
            put(x1 >> _SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(canvas, v) -> None:
    """``FillConvexPoly`` of 16.16 points, LINE_8: the outline by
    :func:`_line2`, then the scanlines between the two edges."""
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line2(canvas, p0, p)
        p0 = p
    imin = min(range(n), key=lambda i: (v[i][1], i))
    ymin = (v[imin][1] + _HALF) >> _SHIFT
    ymax = (max(p[1] for p in v) + _HALF) >> _SHIFT
    edges = n
    ex = [-_ONE, -_ONE]
    edx = [0, 0]
    eidx = [imin, imin]
    eye = [ymin, ymin]
    edi = [1, n - 1]
    y = ymin
    while True:
        for i in range(2):
            if y >= eye[i]:
                idx0 = eidx[i]
                idx = (idx0 + edi[i]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + _HALF) >> _SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        eye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs
                        eidx[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + edi[i]) % n
        if edges < 0:
            break
        left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
        _hline(canvas, y, (ex[left] + _HALF) >> _SHIFT,
               (ex[right] + _HALF) >> _SHIFT)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _filled_circle(canvas, cx: int, cy: int, radius: int) -> None:
    """``Circle(..., fill=1)``: Bresenham's filled circle."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(canvas, cy - dy, cx - dx, cx + dx)
        _hline(canvas, cy + dy, cx - dx, cx + dx)
        _hline(canvas, cy - dx, cx - dy, cx + dy)
        _hline(canvas, cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(canvas, p0, p1, flags: int) -> None:
    """``ThickLine`` at thickness 2, LINE_8: the segment's quadrilateral
    and a radius-1 cap at its start (flags & 1) and end (flags & 2)."""
    thick = 2 << (_SHIFT - 1)
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r = dx * dx + dy * dy
    if abs(r) > np.finfo(np.float64).eps:
        r = thick / math.sqrt(r)
        ddx, ddy = round(dy * r), round(dx * r)
        _fill_convex_poly(canvas, [(p0[0] + ddx, p0[1] + ddy),
                                   (p0[0] - ddx, p0[1] - ddy),
                                   (p1[0] - ddx, p1[1] - ddy),
                                   (p1[0] + ddx, p1[1] + ddy)])
    cap = (thick + _HALF) >> _SHIFT
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _filled_circle(canvas, (p[0] + _HALF) >> _SHIFT,
                           (p[1] + _HALF) >> _SHIFT, cap)


def draw_circle(canvas: np.ndarray, cx: int, cy: int, radius: int,
                thickness: int = 2) -> np.ndarray:
    """Set the pixels of ``canvas`` (an (H, W) bool mask, the image's
    size) that ``cv2.circle(img, (cx, cy), radius, color, thickness)``
    sets (LINE_8, shift 0); thickness 2 only."""
    if thickness != 2:
        raise ValueError(f"draw_circle draws thickness 2 (the one "
                         f"draw_response uses), not {thickness}")
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    cx, cy = cx << _SHIFT, cy << _SHIFT
    axis = radius << _SHIFT
    step = 90 if radius < 3 else 30 if radius < 10 else 18 if radius < 15 \
        else 5
    pts = []
    for i in range(0, 360 + step, step):
        deg = min(i, 360)
        vx = cx + axis * _sin_table(450 - deg)
        vy = cy + axis * _sin_table(deg)
        px = round(vx / _ONE) << _SHIFT
        py = round(vy / _ONE) << _SHIFT
        px += round(vx - px)
        py += round(vy - py)
        if not pts or pts[-1] != (px, py):
            pts.append((px, py))
    if len(pts) == 1:
        pts = [(cx, cy), (cx, cy)]
    flags = 3
    for p0, p1 in zip(pts[:-1], pts[1:]):
        _thick_line(canvas, p0, p1, flags)
        flags = 2
    return canvas


def draw_response(image: np.ndarray, bank: TemplateBank, slot: int,
                  offset_xy: Tuple[int, int], level: int = 0,
                  t: Optional[int] = None) -> np.ndarray:
    """Draw the matched template's features at ``offset_xy`` (in place):
    a circle of radius T/2 (thickness 2) per valid feature, coloured per
    modality (drawResponse #1, linemod_if.cpp:65-92).  ``image`` is
    (H, W, 3) BGR or (H, W), which takes each colour's first channel."""
    t = t or 5
    fx, fy, fv = (getattr(bank, name)[slot, level].cpu().numpy()
                  for name in ("feat_x", "feat_y", "feat_valid"))
    h, w = image.shape[:2]
    ox, oy = offset_xy
    for m in range(fx.shape[0]):
        mask = np.zeros((h, w), bool)
        for x, y in zip(fx[m][fv[m]], fy[m][fv[m]]):
            draw_circle(mask, int(x) + ox, int(y) + oy, t // 2)
        color = COLORS[m % len(COLORS)]
        image[mask] = color if image.ndim == 3 else color[0]
    return image


def blit_template(image: np.ndarray, template_gray: np.ndarray,
                  offset_xy: Tuple[int, int]) -> np.ndarray:
    """Blit a template's grayscale pixels into the match rect with
    per-pixel max (drawResponse #2's overlay, linemod_if.cpp:96-139),
    clipped at the image border (in place)."""
    ox, oy = offset_xy
    h, w = template_gray.shape[:2]
    ih, iw = image.shape[:2]
    x1 = min(ox + w, iw)
    y1 = min(oy + h, ih)
    if ox >= iw or oy >= ih or x1 <= max(ox, 0) or y1 <= max(oy, 0):
        return image
    sub = image[max(oy, 0):y1, max(ox, 0):x1]
    tpl = template_gray[max(oy, 0) - oy:y1 - oy, max(ox, 0) - ox:x1 - ox]
    if sub.ndim == 3 and tpl.ndim == 2:
        tpl = tpl[..., None]
    np.maximum(sub, tpl, out=sub)
    return image


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None,
             valid: Optional[np.ndarray] = None) -> int:
    """Write a point cloud as ASCII PLY for external 3D viewers (the debug
    role of the reference's PCL viewers, ICP/common.cpp:107-259).
    ``points`` is (N, 3) (mm or m; a tensor is fetched); ``colors`` (N, 3)
    u8 BGR, written as RGB; ``valid`` masks rows (default: finite rows).
    Returns the points written."""
    pts = _host(points).astype(np.float32).reshape(-1, 3)
    if valid is not None:
        keep = _host(valid).astype(bool).reshape(-1)
    else:
        keep = np.isfinite(pts).all(axis=1)
    pts = pts[keep]
    cols = None
    if colors is not None:
        cols = _host(colors).astype(np.uint8).reshape(-1, 3)[keep]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n")
        if cols is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if cols is not None:
                c = cols[i]
                line += f" {c[2]} {c[1]} {c[0]}"
            f.write(line + "\n")
    return len(pts)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
