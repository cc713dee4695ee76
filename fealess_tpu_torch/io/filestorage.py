"""cv::FileStorage's XML and JSON forms, both ways, without OpenCV
(the YAML form lives in :mod:`~fealess_tpu_torch.io.linemod_yaml`).

How cv::FileStorage picks the form (persistence.cpp):

- reading, by content (:func:`read_format`): past a UTF-8 byte order mark,
  ``%YAML`` is YAML, ``{`` is JSON, ``<?xml`` is XML, and anything else
  is YAML (its XML and JSON parsers then refuse the mark, and so do
  these);
- writing, by extension (:func:`write_format`): ``.xml`` or ``.json`` in
  any case, once a trailing ``.gz`` in any case is set aside, else YAML;
- a name ending in ``.gz`` (lower case) is gzip, both ways.

The emitters (:class:`XmlEmitter`, :class:`JsonEmitter`) write the text
cv::FileStorage writes, byte for byte, for maps, block and flow
sequences, ints, doubles and strings: they follow its write buffer (a
line is written when a struct or a value needs a new one, and only if it
holds more than its indent; flow values wrap past column 71) and the
XML / JSON emitters of persistence_xml.cpp and persistence_json.cpp
(their element names, indents, separators, escapes and quoting).

The parsers (:func:`parse_xml`, :func:`parse_json`) return dicts, lists
and strings, as ``parse_filestorage_yaml`` does; scalars stay strings
and are converted where they are read, as ``FileNode::real()`` would.
They take what cv::FileStorage writes plus the whitespace, comments and
attribute forms its parsers take in such files (XML: ``<!-- -->``
comments, attributes in single or double quotes, ``type_id`` ``seq`` /
``map``, character and the five named entities; JSON: ``//``
and ``/* */`` comments, a trailing comma, ``true`` / ``false``).  Any
other construct raises ``ValueError`` naming it.  An XML element with no
content reads as an empty list (cv::FileStorage's empty node, of size
0); one with a single value reads as that value, with several as a list.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional

WRAP_MARGIN = 71        # cv::FileStorage's wrap column for flow values
XML_INDENT = 2          # CV_XML_INDENT
JSON_INDENT = 4
XML_HEAD = '<?xml version="1.0"?>\n<opencv_storage>\n'
XML_TAIL = "</opencv_storage>\n"


def read_format(head: bytes) -> str:
    """"yaml", "json" or "xml" for a file whose first bytes are
    ``head`` (decompressed), as cv::FileStorage decides when it reads."""
    if head.startswith(b"\xef\xbb\xbf"):
        head = head[3:]
    if head.startswith(b"{"):
        return "json"
    if head.startswith(b"<?xml"):
        return "xml"
    return "yaml"


def write_format(path: str) -> str:
    """"yaml", "json" or "xml" for a file written at ``path``."""
    base = path[:-3] if path.lower().endswith(".gz") else path
    ext = base[base.rfind("."):].lower() if "." in base else ""
    return {".xml": "xml", ".json": "json"}.get(ext, "yaml")


def real_text(v: float, explicit_zero: bool) -> str:
    """A double as ``fs::doubleToString`` writes it: an integral value
    in int range as ``%d.`` (``%d.0`` where ``explicit_zero``, the JSON
    form), others as ``%.17g``; NaN and infinities as ``.Nan``, ``.Inf``
    and ``-.Inf``."""
    v = float(v)
    if math.isnan(v):
        return ".Nan"
    if math.isinf(v):
        return ".Inf" if v > 0 else "-.Inf"
    if -2 ** 31 <= v <= 2 ** 31 - 1 and v == int(v):
        return "%d.%s" % (int(v), "0" if explicit_zero else "")
    return "%.17g" % v


class _Struct:
    __slots__ = ("key", "is_map", "flow", "empty", "indent")

    def __init__(self, key, is_map, flow, indent):
        self.key, self.is_map, self.flow = key, is_map, flow
        self.empty, self.indent = True, indent


class _Writer:
    """cv::FileStorage's write buffer: the line being built (``_buf``,
    whose first ``_space`` characters are its indent), what is written
    (``_out``) and the stack of open structs, the root map first."""

    def __init__(self, head: str, root_indent: int):
        self._out: List[str] = [head]
        self._buf, self._space = "", 0
        self._stack = [_Struct("", True, False, root_indent)]

    def _flush(self) -> None:
        """FileStorage::Impl::flush: write the line if it holds more than
        its indent, start the next at the open struct's indent."""
        if len(self._buf) > self._space:
            self._out.append(self._buf + "\n")
        indent = self._stack[-1].indent
        self._buf, self._space = " " * indent, indent

    def int(self, key: Optional[str], v: int) -> None:
        self.scalar(key, "%d" % v)

    def finish(self, tail: str) -> str:
        self._flush()
        return "".join(self._out) + tail


def _check_key(key: str, json: bool) -> None:
    if not (key[0].isascii() and (key[0].isalpha() or key[0] == "_")) or \
            any(not (c.isascii() and (c.isalnum() or c in "_-"
                                      or (json and c == " ")))
                for c in key):
        raise ValueError(f"cv::FileStorage refuses the key {key!r}")


class XmlEmitter(_Writer):
    """persistence_xml.cpp's XMLEmitter: a value is an element named by
    its key (``_`` in a sequence); a sequence's scalars share lines."""

    def __init__(self):
        super().__init__(XML_HEAD, 0)

    def _tag(self, key: Optional[str], closing: bool) -> None:
        cur = self._stack[-1]
        if key == "_":
            raise ValueError("a single _ is a reserved XML tag name")
        if key:
            _check_key(key, False)
        if not closing and not cur.empty:
            self._flush()
        self._buf += ("</" if closing else "<") + (key or "_") + ">"
        cur.empty = False

    def scalar(self, key: Optional[str], data: str) -> None:
        cur = self._stack[-1]
        if cur.is_map:
            self._tag(key, False)
            self._buf += data
            self._tag(key, True)
            return
        if key:
            raise ValueError("elements with keys can not be written to a "
                             "sequence")
        end = len(self._buf) + len(data)
        if (end > WRAP_MARGIN and end - cur.indent > 10) or \
                self._buf.endswith(">"):
            self._flush()
        elif len(self._buf) > cur.indent:
            self._buf += " "
        self._buf += data
        cur.empty = False

    def real(self, key: Optional[str], v: float) -> None:
        self.scalar(key, real_text(v, False))

    def string(self, key: Optional[str], s: str) -> None:
        self.scalar(key, xml_string(s))

    def start(self, key: Optional[str], is_map: bool,
              flow: bool = False) -> None:
        self._tag(key, False)
        parent = self._stack[-1]
        self._stack.append(_Struct(key or "", is_map, flow,
                                   parent.indent + XML_INDENT))
        if not flow:
            self._flush()

    def end(self) -> None:
        self._tag(self._stack[-1].key, True)
        self._stack.pop()
        self._stack[-1].empty = False

    def text(self) -> str:
        return self.finish(XML_TAIL)


def _no_nul(s: str) -> bytes:
    b = s.encode("utf-8")
    if b"\0" in b:
        raise ValueError(f"a NUL character in {s!r}")
    return b


_XML_NAMED = {ord("<"): "lt", ord(">"): "gt", ord("&"): "amp",
              ord("'"): "apos", ord('"'): "quot"}


def xml_string(s: str) -> str:
    """XMLEmitter::write of a string: entities for ``<>&'"`` and control
    characters, quoted where it holds a space, a character past ASCII or
    an entity, or starts like a number; a string already in double quotes
    is written as it is."""
    b = _no_nul(s)
    if b and b[0] == b[-1] == 0x22:
        return s
    out, need = bytearray(), not b
    for c in b:
        if c >= 128 or c == 0x20:
            out.append(c)
            need = True
        elif c < 0x20 or c in _XML_NAMED:
            name = _XML_NAMED.get(c)
            out += ("&%s;" % name if name else "&#x%02x;" % c).encode()
            need = True
        else:
            out.append(c)
    if not need and b[:1] in (b"0", b"1", b"2", b"3", b"4", b"5", b"6",
                              b"7", b"8", b"9", b"+", b"-", b"."):
        need = True
    text = out.decode("utf-8")
    return f'"{text}"' if need else text


class JsonEmitter(_Writer):
    """persistence_json.cpp's JSONEmitter: 4-space indents, ``"key": ``,
    a block value on a line of its own ending in ``,`` where another
    follows, flow values on the struct's line."""

    def __init__(self):
        super().__init__("{\n", JSON_INDENT)

    def scalar(self, key: Optional[str], data: str) -> None:
        cur = self._stack[-1]
        if cur.is_map != bool(key):
            raise ValueError("an element without a key in a map, or with "
                             "one in a sequence")
        if cur.flow:
            if not cur.empty:
                self._buf += ","
            end = len(self._buf) + len(key or "") + len(data)
            if end > WRAP_MARGIN and end - cur.indent > 10:
                self._flush()
            else:
                self._buf += " "
        else:
            if not cur.empty:
                self._out.append(self._buf + ",\n")
                self._buf = ""
            self._flush()
        if key:
            _check_key(key, True)
            self._buf += f'"{key}": '
        self._buf += data
        cur.empty = False

    def real(self, key: Optional[str], v: float) -> None:
        self.scalar(key, real_text(v, True))

    def string(self, key: Optional[str], s: str) -> None:
        self.scalar(key, json_string(s))

    def start(self, key: Optional[str], is_map: bool,
              flow: bool = False) -> None:
        self.scalar(key, "{" if is_map else "[")
        parent = self._stack[-1]
        self._stack.append(_Struct(key or "", is_map, flow,
                                   parent.indent + JSON_INDENT))

    def end(self) -> None:
        st = self._stack[-1]
        if not st.flow:
            st.indent = self._stack[-2].indent
            if len(self._buf) <= self._space:
                self._out.append(self._buf + "\n")
                self._buf = ""
            self._flush()
        if len(self._buf) > st.indent and not st.empty:
            self._buf += " "
        self._buf += "}" if st.is_map else "]"
        self._stack.pop()
        self._stack[-1].empty = False

    def text(self) -> str:
        return self.finish("}\n")


_JSON_ESCAPES = {"\\": "\\\\", '"': '\\"', "'": "\\'", "\n": "\\n",
                 "\r": "\\r", "\t": "\\t", "\b": "\\b", "\f": "\\f"}


def json_string(s: str) -> str:
    """JSONEmitter::write of a string: in double quotes with ``\\``,
    ``"``, ``'`` and ``\\n \\r \\t \\b \\f`` escaped; a string already in
    matching single or double quotes is written as it is."""
    _no_nul(s)
    if s and s[0] == s[-1] and s[0] in "\"'":
        return s
    return '"' + "".join(_JSON_ESCAPES.get(c, c) for c in s) + '"'


# ---- XML parser (persistence_xml.cpp's XMLParser) ----

_XML_ENTITIES = {"lt": "<", "gt": ">", "amp": "&", "apos": "'", "quot": '"'}
_SP = r"[ \t\n\r\v\f]"
_XNAME = r"[A-Za-z_][A-Za-z0-9_-]*"
_ENTITY = r"&(?:lt|gt|amp|apos|quot|#x[0-9A-Fa-f]+|#[0-9]+);"
# what strtod reads where the digits are followed by '.' or 'e', else
# what strtol reads
_NUM = (r"[+-]?(?:[0-9]*\.[0-9]*(?:[eE][+-]?[0-9]+)?|[0-9]+e[+-]?[0-9]+"
        r"|[0-9]+)")
# a token with the whitespace and comments before it; "end" takes what
# trails the last one
_XML_TOKENS = re.compile(
    rf"(?:{_SP}+|<!--.*?-->)*(?:"
    rf"(?P<close></(?P<cname>{_XNAME}){_SP}*>)"
    rf"|(?P<open><(?P<oname>{_XNAME})(?P<attrs>(?:{_SP}+{_XNAME}{_SP}*="
    rf"""{_SP}*(?:"[^"]*"|'[^']*'))*){_SP}*(?P<slash>/?)>)"""
    # values that are all numbers, to the element's end (the common case,
    # split in one go)
    rf"|(?P<nums>{_NUM}(?:{_SP}+{_NUM})*)(?={_SP}*</)"
    rf"|(?P<num>{_NUM})(?=[ \t\n\r\v\f<])"
    rf"""|(?P<q>"(?:[^"&<'>\x00-\x1f]|{_ENTITY})*")"""
    rf"""|(?P<u>(?:[^"&<'>\x00-\x20]|{_ENTITY})+)"""
    r"|(?P<end>\Z)|(?P<bad>.))", re.S)
_XML_HEADER = re.compile(rf"""(?:{_SP}+|<!--.*?-->)*<\?xml(?:{_SP}+"""
                         rf"""{_XNAME}{_SP}*={_SP}*(?:"[^"]*"|'[^']*'))*"""
                         rf"{_SP}*\?>", re.S)
_TYPE_ID = re.compile(rf"""{_SP}type_id{_SP}*={_SP}*(?:"([^"]*)"|'([^']*)')""")
_NUMBER_START = re.compile(r"[0-9]|[+-][0-9.]|\.[A-Za-z0-9]")
_OCTAL_HEX = re.compile(r"[+-]?0[0-9xX]")
# an int of a run that strtol would read as octal
_OCTAL_HEX_IN = re.compile(r"(?:^|\s)[+-]?0[0-9]+(?=\s|$)")


def _xml_error(text: str, at: int, what: str) -> ValueError:
    line = text.count("\n", 0, at) + 1
    return ValueError(f"cv::FileStorage XML, line {line}: {what}")


def _entities(s: str, text: str, at: int) -> str:
    def one(m):
        e = m.group(1)
        if e in _XML_ENTITIES:
            return _XML_ENTITIES[e]
        v = int(e[2:], 16) if e[1:2] == "x" else int(e[1:])
        if v > 255:
            raise _xml_error(text, at, f"the character entity &{e};")
        return chr(v)
    return re.sub(r"&([^;]*);", one, s) if "&" in s else s


def _octal_or_hex(tok: str) -> bool:
    """An int strtol would read as octal or hex (refused: Python reads
    it in decimal)."""
    return bool(_OCTAL_HEX.match(tok)) and not re.search(r"[.e]", tok[:-1])


class _Element:
    __slots__ = ("name", "type_id", "items", "keys", "elements")

    def __init__(self, name, type_id):
        self.name, self.type_id = name, type_id
        self.items, self.keys, self.elements = [], [], 0

    def value(self, text: str, at: int):
        """The element's node: values and ``_`` elements make a sequence
        (one value alone, a scalar), named elements a map."""
        keys = [k for k in self.keys if k is not None]
        if keys:
            if len(keys) != len(self.items) or self.type_id == "seq":
                raise _xml_error(text, at, f"named elements mixed with "
                                           f"values or _ elements in "
                                           f"<{self.name}>")
            node = {}
            for k, v in zip(keys, self.items):
                if k in node:
                    raise _xml_error(text, at, f"the duplicate key {k!r}")
                node[k] = v
            return node
        if self.type_id == "map" and self.items:
            raise _xml_error(text, at, f"values or _ elements in the map "
                                       f"element <{self.name}>")
        if len(self.items) == 1 and not self.elements and \
                self.type_id != "seq":
            return self.items[0]
        return self.items


def parse_xml(text: str) -> dict:
    """Parse cv::FileStorage XML text: the first ``<opencv_storage>``'s
    map."""
    m = _XML_HEADER.match(text)
    if not m:
        raise _xml_error(text, 0, "the file should start with <?xml ...?>")
    stack: List[_Element] = []
    root, value_end = None, -1
    for m in _XML_TOKENS.finditer(text, m.end()):
        kind = m.lastgroup
        at = m.start(kind)
        if kind == "end":
            break
        if kind == "bad":
            raise _xml_error(text, at, f"an unexpected {text[at:at + 12]!r}")
        if kind == "open":
            name = m.group("oname")
            if m.group("slash"):
                raise _xml_error(text, at, f"an empty tag <{name}/>")
            attrs = m.group("attrs")
            t = _TYPE_ID.search(attrs) if attrs else None
            tid = (t.group(1) if t.group(1) is not None else t.group(2)) \
                if t else ""
            if tid in ("str", "binary"):
                raise _xml_error(text, at, f"type_id {tid!r} (cv2 fails on "
                                           f"it)" if tid == "str" else
                                 "a base64 node (type_id 'binary')")
            if not stack and name != "opencv_storage":
                raise _xml_error(text, at, f"<opencv_storage> is expected, "
                                           f"not <{name}>")
            stack.append(_Element(name, tid or ("" if stack else "map")))
            continue
        if kind == "close":
            name = m.group("cname")
            if not stack or stack[-1].name != name:
                raise _xml_error(text, at, f"the closing tag </{name}> "
                                           f"matches no open element")
            value = stack.pop().value(text, at)
            if stack:
                parent = stack[-1]
                parent.items.append(value)
                parent.keys.append(None if name == "_" else name)
                parent.elements += 1
            elif root is None:
                root = value if value != [] else {}
            continue
        # a value
        if not stack:
            raise _xml_error(text, at, f"a value outside <opencv_storage>: "
                                       f"{text[at:at + 12]!r}")
        if value_end == at:
            raise _xml_error(text, at, "no space between two values")
        value = m.group(kind)
        if kind == "nums":
            if _OCTAL_HEX_IN.search(value):
                raise _xml_error(text, at, f"an octal or hex number in "
                                           f"{value[:40]!r}")
            values = value.split()
            stack[-1].items.extend(values)
            stack[-1].keys.extend([None] * len(values))
            value_end = m.end()
            continue
        if kind == "num":
            if _octal_or_hex(text[at:m.end() + 1]):
                raise _xml_error(text, at, f"the octal or hex number "
                                           f"{value!r}")
        if kind == "q":
            value = _entities(value[1:-1], text, at)
        elif kind == "u":
            if _NUMBER_START.match(value):
                raise _xml_error(text, at, f"the number {value!r}")
            value = _entities(value, text, at)
        stack[-1].items.append(value)
        stack[-1].keys.append(None)
        value_end = m.end()
    if stack:
        raise _xml_error(text, len(text), f"<{stack[-1].name}> is not "
                                          f"closed")
    if root is None:
        raise _xml_error(text, len(text), "no <opencv_storage> element")
    return root


# ---- JSON parser (persistence_json.cpp's JSONParser) ----

_JSON_UNESCAPE = {"\\": "\\", '"': '"', "'": "'", "n": "\n", "r": "\r",
                  "t": "\t", "b": "\b", "f": "\f"}
_JSON_TOKENS = re.compile(
    r"(?:[ \t\n\r]+|//[^\n\r]*|/\*.*?\*/)*(?:"
    # a sequence of numbers only (the common case, split in one go)
    rf"(?P<nums>\[[ \t\n\r]*{_NUM}(?:[ \t\n\r]*,[ \t\n\r]*{_NUM})*"
    r"[ \t\n\r]*\])"
    r"|(?P<p>[{}\[\]:,])"
    r"""|(?P<s>"(?:[^"\\\n\r]|\\["\\'nrtbf])*")"""
    rf"|(?P<num>{_NUM})"
    r"|(?P<word>true|false|null)"
    r"|(?P<end>\Z)|(?P<bad>.))", re.S)


def _json_error(text: str, at: int, what: str) -> ValueError:
    line = text.count("\n", 0, at) + 1
    return ValueError(f"cv::FileStorage JSON, line {line}: {what}")


def _unescape(s: str) -> str:
    return re.sub(r"\\(.)", lambda m: _JSON_UNESCAPE[m.group(1)], s) \
        if "\\" in s else s


def parse_json(text: str) -> dict:
    """Parse cv::FileStorage JSON text: its top-level map.  A map takes
    stray commas between its entries, a sequence one after its last
    value, as cv::FileStorage's parser does."""
    # a frame: [node, is_map, state, key]; states: "key" (a key, ',' or
    # '}'), "colon", "value" (a value, or ']' in a sequence), "sep" (','
    # or the closing bracket)
    stack: list = []
    root, done = None, False
    for m in _JSON_TOKENS.finditer(text):
        kind = m.lastgroup
        at, tok = m.start(kind), m.group(kind)
        if kind == "end":
            break
        if done:
            raise _json_error(text, at, f"an unexpected {text[at:at + 12]!r}"
                              f" after the top-level map")
        if not stack:
            if tok != "{":
                raise _json_error(text, at, "the top level should be a map "
                                            "({)")
            root = {}
            stack.append([root, True, "key", None])
            continue
        frame = stack[-1]
        node, is_map, state = frame[0], frame[1], frame[2]
        if kind == "p" and tok in "}]":
            if tok != ("}" if is_map else "]") or \
                    state not in ("sep", "key" if is_map else "value"):
                raise _json_error(text, at, f"an unexpected {tok!r}")
            stack.pop()
            done = not stack
            continue
        if state == "key":
            if tok == ",":
                continue
            if kind != "s" or len(tok) < 3 or "\\" in tok:
                raise _json_error(text, at, f"a malformed key "
                                            f"{text[at:at + 12]!r}")
            frame[3], frame[2] = tok[1:-1], "colon"
            continue
        if state == "colon":
            if tok != ":":
                raise _json_error(text, at, f"no ':' after the key "
                                            f"{frame[3]!r}")
            frame[2] = "value"
            continue
        if state == "sep":
            if tok != "," or kind != "p":
                raise _json_error(text, at, f"an unexpected "
                                            f"{text[at:at + 12]!r}")
            frame[2] = "key" if is_map else "value"
            continue
        child = None
        if kind == "nums":
            value = [v.strip() for v in tok[1:-1].split(",")]
            if any(_octal_or_hex(v + " ") for v in value):
                raise _json_error(text, at, f"an octal or hex number in "
                                            f"{tok[:40]!r}")
        elif kind == "p" and tok in "{[":
            value = {} if tok == "{" else []
            child = [value, tok == "{", "key" if tok == "{" else "value",
                     None]
        elif kind == "s":
            if tok.startswith('"$base64$'):
                raise _json_error(text, at, "a base64 string ($base64$)")
            value = _unescape(tok[1:-1])
        elif kind == "num":
            if _octal_or_hex(text[at:m.end() + 1]):
                raise _json_error(text, at, f"the octal or hex number "
                                            f"{text[at:at + 12]!r}")
            value = tok
        elif kind == "word" and tok != "null":
            value = "1" if tok == "true" else "0"
        else:
            raise _json_error(text, at, f"the value {text[at:at + 12]!r}")
        if is_map:
            if frame[3] in node:
                raise _json_error(text, at, f"the duplicate key "
                                            f"{frame[3]!r}")
            node[frame[3]] = value
        else:
            node.append(value)
        frame[2] = "sep"
        if child:
            stack.append(child)
    if stack or root is None:
        raise _json_error(text, len(text), "the file ends inside the "
                                           "top-level map")
    return root
