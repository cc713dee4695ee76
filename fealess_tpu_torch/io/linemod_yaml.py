"""Reference-compatible template database reader (counterpart of
``fealess_tpu.io.linemod_yaml.load_linemod``).

Reads the ``linemod_templates.yml`` schema of the reference's
``writeLinemod`` / ``Detector::writeClass`` (linemod/linemod.cpp:
1764-1794) without OpenCV: the file is the subset of YAML that
cv::FileStorage writes — block maps, block sequences whose items are maps
(``-`` on its own line), scalars and flow sequences ``[ a, b, ... ]`` that
may wrap over several lines.  Scalars are kept as strings and converted
where they are read, as ``FileNode::real()`` would.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from fealess_tpu import config as cfg
from fealess_tpu_torch.bank import TemplateView

CG_NAME = "ColorGradient"
DN_NAME = "DepthNormal"


def _logical_lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) per logical line; a flow sequence that wraps is
    joined into the line that opened it."""
    out: List[Tuple[int, str]] = []
    pending = None
    depth = 0
    for line in text.splitlines():
        if pending is not None:
            pending[1] += " " + line.strip()
            depth += line.count("[") - line.count("]")
            if depth == 0:
                out.append((pending[0], pending[1]))
                pending = None
            continue
        content = line.strip()
        if not content or content[0] in "#%" or content == "---":
            continue
        indent = len(line) - len(line.lstrip(" "))
        depth = content.count("[") - content.count("]")
        if depth > 0:
            pending = [indent, content]
        else:
            out.append((indent, content))
    if pending is not None:
        raise ValueError("unterminated flow sequence")
    return out


def _scalar(text: str) -> str:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    return text


def _flow(text: str) -> List[str]:
    inner = text[1:-1].strip()
    if "[" in inner or "{" in inner:
        raise ValueError(f"nested flow collections are not supported: "
                         f"{text[:40]!r}")
    return [_scalar(s.strip()) for s in inner.split(",")] if inner else []


def _value(lines, i: int, indent: int, text: str):
    """Value written after ``key:`` or ``-`` on line ``i``; block values
    follow on deeper lines (a sequence may sit at its key's indent)."""
    if text.startswith("["):
        return _flow(text), i + 1
    if text:
        return _scalar(text), i + 1
    if i + 1 < len(lines):
        nxt_indent, nxt = lines[i + 1]
        if nxt_indent > indent or (nxt_indent == indent
                                   and nxt.startswith("-")):
            return _block(lines, i + 1, nxt_indent)
    return "", i + 1


def _block(lines, i: int, indent: int):
    if lines[i][1].startswith("-"):
        seq = []
        while (i < len(lines) and lines[i][0] == indent
               and lines[i][1].startswith("-")):
            rest = lines[i][1][1:].strip()
            if rest and not rest.startswith("[") and ":" in rest:
                raise ValueError(f"inline map in a sequence is not "
                                 f"supported: {rest[:40]!r}")
            item, i = _value(lines, i, indent, rest)
            seq.append(item)
        return seq, i
    node = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        node[_scalar(key.strip())], i = _value(lines, i, indent, rest.strip())
    return node, i


def parse_filestorage_yaml(text: str) -> dict:
    """Parse cv::FileStorage YAML text into dicts, lists and strings."""
    lines = _logical_lines(text)
    if not lines:
        return {}
    root, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at {lines[end][1]!r}")
    return root


def load_linemod(path: str) -> Tuple[cfg.DetectorConfig,
                                     Dict[str, List[TemplateView]]]:
    """Load a reference template database -> (detector config, classes)."""
    try:
        with open(path, "r") as f:
            root = parse_filestorage_yaml(f.read())
    except OSError as e:
        raise IOError(f"cannot open {path}") from e
    levels = int(float(root["pyramid_levels"]))
    t_at_level = tuple(int(float(t)) for t in root["T"])
    if len(t_at_level) != levels:
        raise ValueError(f"T has {len(t_at_level)} entries for "
                         f"{levels} pyramid levels")

    cg = cfg.ColorGradientConfig()
    dn = cfg.DepthNormalConfig()
    mod_names = []
    for m in root["modalities"]:
        mtype = m["type"]
        mod_names.append(mtype)
        if mtype == CG_NAME:
            cg = cfg.ColorGradientConfig(
                weak_threshold=float(m["weak_threshold"]),
                num_features=int(float(m["num_features"])),
                strong_threshold=float(m["strong_threshold"]))
        elif mtype == DN_NAME:
            dn = cfg.DepthNormalConfig(
                distance_threshold=int(float(m["distance_threshold"])),
                difference_threshold=int(float(m["difference_threshold"])),
                num_features=int(float(m["num_features"])),
                extract_threshold=int(float(m["extract_threshold"])))
        else:
            raise ValueError(f"unknown modality {mtype!r}")
    n_mod = len(mod_names)

    classes: Dict[str, List[TemplateView]] = {}
    for c in root.get("classes", []):
        class_id, views = _read_class_node(c, levels, n_mod)
        classes[class_id] = views

    name_map = {CG_NAME: "color_gradient", DN_NAME: "depth_normal"}
    det = cfg.DetectorConfig(t_at_level=t_at_level, color_gradient=cg,
                             depth_normal=dn,
                             modalities=tuple(name_map[m] for m in mod_names))
    return det, classes


def _read_class_node(c: dict, levels: int, n_mod: int):
    """One class map -> (class_id, views) (Detector::readClass,
    linemod.cpp:1711-1762)."""
    class_id = c["class_id"]
    if int(float(c["pyramid_levels"])) != levels:
        raise ValueError(f"class {class_id!r} has another pyramid depth")
    views: List[TemplateView] = []
    for ti, tp in enumerate(c.get("template_pyramids", [])):
        if int(float(tp["template_id"])) != ti:
            raise ValueError(f"class {class_id!r}: template_id out of order")
        pose = np.asarray([float(p) for p in tp["template_pose"]],
                          np.float32)
        templates = tp["templates"]
        if len(templates) != levels * n_mod:
            raise ValueError(f"class {class_id!r} template {ti}: "
                             f"{len(templates)} templates, expected "
                             f"{levels * n_mod}")
        feats = [[None] * n_mod for _ in range(levels)]
        width = [0] * levels
        height = [0] * levels
        off_x = [0] * levels
        off_y = [0] * levels
        for j, t in enumerate(templates):
            l = int(float(t["pyramid_level"]))
            m = j % n_mod
            if j // n_mod != l:
                raise ValueError("unexpected template order")
            fl = t.get("features") or []
            arr = np.zeros((len(fl), 3), np.int32)
            if fl:
                arr[:] = np.asarray(fl, dtype=np.float64)
            feats[l][m] = arr
            width[l] = int(float(t["width"]))
            height[l] = int(float(t["height"]))
            off_x[l] = int(float(t["offset_x"]))
            off_y[l] = int(float(t["offset_y"]))
        views.append(TemplateView(features=feats, width=width, height=height,
                                  offset_x=off_x, offset_y=off_y, pose=pose))
    return class_id, views
