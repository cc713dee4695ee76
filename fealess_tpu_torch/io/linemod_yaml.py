"""Reference-compatible template database I/O (counterpart of
``fealess_tpu.io.linemod_yaml``).

Reads and writes the ``linemod_templates.yml`` schema of the reference's
``writeLinemod`` / ``Detector::writeClass`` (linemod/linemod.cpp:
1764-1794) without OpenCV: the file is the subset of YAML that
cv::FileStorage writes — block maps, block sequences whose items are maps
(``-`` on its own line), scalars and flow sequences ``[ a, b, ... ]`` that
may wrap over several lines.  Scalars are kept as strings and converted
where they are read, as ``FileNode::real()`` would.  The writer emits the
same text as cv::FileStorage's YAML emitter (3-space indents, flow
sequences wrapped at column 71, integral doubles as ``800.``, others as
``%.17g``, so a float32 round-trips exactly).  A path ending in ``.gz`` is
gzip-compressed, as cv::FileStorage does.

The XML and JSON forms are read and written too
(:mod:`~fealess_tpu_torch.io.filestorage`), chosen as cv::FileStorage
chooses: by content when reading (an XML or JSON file named ``.yml``
reads as XML or JSON), by extension when writing.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

import numpy as np

from fealess_tpu_torch import config as cfg
from fealess_tpu_torch.bank import TemplateView
from fealess_tpu_torch.io import filestorage

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


def _seq(node) -> list:
    """A node as a sequence, as ``FileNode::size`` / ``at`` see it: a
    scalar (an XML element holding one value) is a sequence of one."""
    return node if isinstance(node, list) else [node]


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
        if nxt_indent > indent and nxt in ("[]", "{}"):
            return ([] if nxt == "[]" else {}), i + 2   # empty collection
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
    root = _read_root(path)
    levels = int(float(root["pyramid_levels"]))
    t_at_level = tuple(int(float(t)) for t in _seq(root["T"]))
    if len(t_at_level) != levels:
        raise ValueError(f"T has {len(t_at_level)} entries for "
                         f"{levels} pyramid levels")

    cg = cfg.ColorGradientConfig()
    dn = cfg.DepthNormalConfig()
    mod_names = []
    for m in _seq(root["modalities"]):
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
    for c in _seq(root.get("classes", [])):
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
    for ti, tp in enumerate(_seq(c.get("template_pyramids", []))):
        if int(float(tp["template_id"])) != ti:
            raise ValueError(f"class {class_id!r}: template_id out of order")
        pose = np.asarray([float(p) for p in _seq(tp["template_pose"])],
                          np.float32)
        templates = _seq(tp["templates"])
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
            fl = [_seq(r) for r in _seq(t.get("features") or [])]
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


_PARSERS = {"yaml": parse_filestorage_yaml, "xml": filestorage.parse_xml,
            "json": filestorage.parse_json}


def _read_root(path: str) -> dict:
    """The file's top-level map, parsed in the form its content shows."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise IOError(f"cannot open {path}") from e
    return _PARSERS[filestorage.read_format(data[:8])](data.decode("utf-8"))


def _emitter(path: str):
    """The emitter of the form ``path``'s extension picks."""
    return {"yaml": _Emitter, "xml": filestorage.XmlEmitter,
            "json": filestorage.JsonEmitter}[filestorage.write_format(path)]()


def _write_text(path: str, text: str) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "wt", encoding="utf-8") as f:
            f.write(text)
    except OSError as e:
        raise IOError(f"cannot open {path} for writing") from e


_WRAP_MARGIN = 71      # cv::FileStorage's wrap column for flow sequences
_INDENT = 3            # CV_YML_INDENT


class _Emitter:
    """cv::FileStorage's YAML emitter (persistence_yml.cpp) for what the
    writers below emit: block maps and sequences, flow sequences and
    scalars.  Each stack entry is [indent, is_map, is_flow, empty]."""

    def __init__(self):
        self._lines = ["%YAML 1.2", "---"]
        self._line = ""
        self._stack = [[0, True, False, True]]

    def _flush(self) -> None:
        if self._line.strip():
            self._lines.append(self._line)
        self._line = " " * self._stack[-1][0]

    def scalar(self, key, data) -> None:
        indent, is_map, flow, empty = self._stack[-1]
        if flow:
            if not empty:
                self._line += ","
            offset = len(self._line) + len(key or "") + len(data or "")
            if offset > _WRAP_MARGIN and offset - indent > 10:
                self._flush()
            else:
                self._line += " "
        else:
            self._flush()
            if not is_map:
                self._line += "-" + (" " if data is not None else "")
        if key:
            self._line += key + ":" + (" " if not flow and data is not None
                                       else "")
        if data is not None:
            self._line += data
        self._stack[-1][3] = False

    def int(self, key, v: int) -> None:
        self.scalar(key, "%d" % v)

    def real(self, key, v: float) -> None:
        self.scalar(key, _real(v))

    def string(self, key, s: str) -> None:
        self.scalar(key, _string(s))

    def start(self, key, is_map: bool, flow: bool = False) -> None:
        self.scalar(key, ("{" if is_map else "[") if flow else None)
        indent, _, parent_flow, _ = self._stack[-1]
        if not parent_flow:
            indent += _INDENT + int(flow)
        self._stack.append([indent, is_map, flow, True])

    def end(self) -> None:
        indent, is_map, flow, empty = self._stack[-1]
        if flow:
            if len(self._line) > indent and not empty:
                self._line += " "
            self._line += "}" if is_map else "]"
        elif empty:
            self._flush()
            self._line += "{}" if is_map else "[]"
        self._stack.pop()

    def text(self) -> str:
        self._flush()
        return "\n".join(self._lines) + "\n"


def _real(v) -> str:
    """A double as cv::FileStorage writes it."""
    v = float(v)
    if v != v:
        return ".Nan"
    if v in (float("inf"), float("-inf")):
        return ".Inf" if v > 0 else "-.Inf"
    if -2 ** 31 <= v <= 2 ** 31 - 1 and v == int(v):
        return "%d." % int(v)
    return "%.17g" % v


def _string(s: str) -> str:
    """A string scalar, quoted where cv::FileStorage quotes it; characters
    it would escape are refused (the reader does not unescape)."""
    for c in s:
        if (not (c.isascii() and c.isalnum())
                and (not (c.isascii() and c.isprintable()) or c in "\\'\"")):
            raise ValueError(f"unsupported character {c!r} in {s!r}")
    quote = (not s or s[0] == " " or s[0] in "0123456789+-."
             or any(not c.isalnum() and c not in "_ -()/+;" for c in s))
    return f'"{s}"' if quote else s


def save_linemod(path: str, det: cfg.DetectorConfig,
                 classes: Dict[str, List[TemplateView]]) -> None:
    """Write a template database in the reference schema."""
    em = _emitter(path)
    em.int("pyramid_levels", det.pyramid_levels)
    em.start("T", False, flow=True)
    for t in det.t_at_level:
        em.int(None, int(t))
    em.end()

    em.start("modalities", False)
    if "color_gradient" in det.modalities:
        c = det.color_gradient
        em.start(None, True)
        em.string("type", CG_NAME)
        em.real("weak_threshold", c.weak_threshold)
        em.int("num_features", int(c.num_features))
        em.real("strong_threshold", c.strong_threshold)
        em.end()
    if "depth_normal" in det.modalities:
        d = det.depth_normal
        em.start(None, True)
        em.string("type", DN_NAME)
        for name in ("distance_threshold", "difference_threshold",
                     "num_features", "extract_threshold"):
            em.int(name, int(getattr(d, name)))
        em.end()
    em.end()

    em.start("classes", False)
    for class_id in sorted(classes.keys()):
        em.start(None, True)
        _write_class_fields(em, class_id, det, classes[class_id])
        em.end()
    em.end()
    _write_text(path, em.text())


def _write_class_fields(em, class_id: str, det: cfg.DetectorConfig,
                        views: List[TemplateView]) -> None:
    """Class fields (Detector::writeClass, linemod.cpp:1764-1794), written
    into the currently open map/root of any form's emitter."""
    em.string("class_id", class_id)
    em.start("modalities", False, flow=True)
    if "color_gradient" in det.modalities:
        em.string(None, CG_NAME)
    if "depth_normal" in det.modalities:
        em.string(None, DN_NAME)
    em.end()
    em.int("pyramid_levels", det.pyramid_levels)
    em.start("template_pyramids", False)
    for ti, v in enumerate(views):
        em.start(None, True)
        em.int("template_id", ti)
        em.start("template_pose", False, flow=True)
        for p in np.asarray(v.pose, np.float64):
            em.real(None, p)
        em.end()
        em.start("templates", False)
        for l in range(det.pyramid_levels):
            for m in range(len(det.modalities)):
                em.start(None, True)
                for name, val in (("width", v.width[l]),
                                  ("height", v.height[l]),
                                  ("offset_x", v.offset_x[l]),
                                  ("offset_y", v.offset_y[l]),
                                  ("pyramid_level", l)):
                    em.int(name, int(val))
                em.start("features", False)
                for row in np.asarray(v.features[l][m], np.int64).tolist():
                    em.start(None, False, flow=True)
                    for val in row:
                        em.int(None, val)
                    em.end()
                em.end()
                em.end()
        em.end()
        em.end()
    em.end()


def save_classes(fmt: str, det: cfg.DetectorConfig,
                 classes: Dict[str, List[TemplateView]]) -> None:
    """Per-class files (Detector::writeClasses, linemod.cpp:1808-1818):
    ``fmt`` is a %s-format path, e.g. ``dir/templates_%s.yml.gz``."""
    for class_id in sorted(classes.keys()):
        em = _emitter(fmt % class_id)
        _write_class_fields(em, class_id, det, classes[class_id])
        _write_text(fmt % class_id, em.text())


def load_classes(fmt: str, class_ids: List[str], levels: int = 2,
                 n_mod: int = 2) -> Dict[str, List[TemplateView]]:
    """Per-class files (Detector::readClasses, linemod.cpp:1796-1806)."""
    out: Dict[str, List[TemplateView]] = {}
    for cid in class_ids:
        class_id, views = _read_class_node(_read_root(fmt % cid), levels,
                                           n_mod)
        out[class_id] = views
    return out
