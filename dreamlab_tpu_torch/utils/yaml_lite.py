"""A reader for the YAML subset of the port's config files (``styles.yaml``,
``modes.yaml``).

PyYAML is not among the packages the card's machine promises, so the port
reads the documented layouts itself: nested block mappings (indented by
spaces); block sequences (``- item`` lines, indented under their key or at
its column) whose items are scalars, one-line flow mappings or block
mappings that start on the dash's line; one-line flow lists of scalars
(``[0.4, 0.6]``) and flow mappings of scalars (``{ file: a, name: b }``);
and plain or quoted scalars that resolve, as ``yaml.safe_load`` resolves
them, to strings, ints, floats or null. Comments and blank lines are
skipped. It raises ``ValueError`` on anything else (nested flow
collections, sequences of sequences, anchors, tags, multi-line scalars,
documents markers, and the plain scalars PyYAML would read as booleans,
timestamps or non-decimal ints), so a file never silently reads
differently from what PyYAML would give.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

# PyYAML's resolver patterns (yaml/resolver.py), for the types read here
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = ("", "~", "null", "Null", "NULL")
# ... and for the ones that are not: booleans, base-2/8/16 and sexagesimal
# ints and floats, timestamps, merge keys and the value key
_UNSUPPORTED = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF"
    r"|[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_INDICATORS = tuple("&*!|>%@`{[]},#") + ("- ", "? ", "---", "...")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}


class _Line:
    def __init__(self, indent: int, text: str, number: int):
        self.indent, self.text, self.number = indent, text, number


def _fail(line_no: int, what: str):
    raise ValueError(f"yaml_lite: line {line_no}: {what}")


def _quoted(text: str, start: int, line_no: int) -> Tuple[str, int]:
    """The quoted scalar opening at ``text[start]``: (value, index after it)."""
    q, i, out = text[start], start + 1, []
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                _fail(line_no, f"unsupported escape \\{esc}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    _fail(line_no, "quoted scalar not closed on its line")


def _strip_comment(raw: str, line_no: int) -> str:
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch in "'\"" and (i == 0 or raw[i - 1] in " [{,:"):
            i = _quoted(raw, i, line_no)[1]
            continue
        if ch == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
        i += 1
    return raw


def _plain(text: str, line_no: int) -> Any:
    if text.startswith(_INDICATORS) or ": " in text or text.endswith(":") or " #" in text:
        _fail(line_no, f"unsupported construct {text!r}")
    if text in _NULL:
        return None
    if _UNSUPPORTED.match(text):
        _fail(line_no, f"{text!r} is not a string, int, float or null")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        return sign * float("inf") if v == ".inf" else float("nan") if v == ".nan" \
            else sign * float(v)
    return text


def _scalar(text: str, line_no: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0, line_no)
        if text[end:].strip():
            _fail(line_no, f"text after a quoted scalar: {text!r}")
        return value
    return _plain(text, line_no)


def _flow_items(text: str, close: str, line_no: int) -> List[str]:
    """The comma-separated entries of a one-line flow collection."""
    if not text.endswith(close):
        _fail(line_no, "a flow collection must close on its line")
    inner, items, i, start = text[1:-1], [], 0, 0
    while i <= len(inner):
        if i == len(inner) or inner[i] == ",":
            items.append(inner[start:i].strip())
            start = i + 1
        elif inner[i] in "'\"":
            i = _quoted(inner, i, line_no)[1]
            continue
        i += 1
    if items and items[-1] == "" and (len(items) > 1 or not inner.strip()):
        items.pop()  # a trailing comma, or an empty collection
    if any(it == "" for it in items):
        _fail(line_no, f"empty entry in {text!r}")
    return items


def _flow_list(text: str, line_no: int) -> List[Any]:
    return [_scalar(it, line_no) for it in _flow_items(text, "]", line_no)]


def _flow_map(text: str, line_no: int) -> dict:
    out = {}
    for item in _flow_items(text, "}", line_no):
        key, rest = _split_key(item, line_no)
        out[key] = _scalar(rest, line_no) if rest else None
    return out


def _value(text: str, line_no: int) -> Any:
    if text.startswith("["):
        return _flow_list(text, line_no)
    if text.startswith("{"):
        return _flow_map(text, line_no)
    return _scalar(text, line_no)


def _split_key(text: str, line_no: int) -> Tuple[Any, str]:
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0, line_no)
        rest = text[end:]
        if not (rest == ":" or rest.startswith(": ")):
            _fail(line_no, f"not a mapping entry: {text!r}")
        return key, rest[1:].strip()
    for j, ch in enumerate(text):
        if ch == ":" and (j + 1 == len(text) or text[j + 1] == " "):
            return _plain(text[:j].rstrip(), line_no), text[j + 1:].strip()
    _fail(line_no, f"not a mapping entry: {text!r}")


def _is_entry(text: str, line_no: int) -> bool:
    """Whether ``text`` opens a mapping entry (``key: ...`` or ``key:``)."""
    if text[:1] in ("'", '"'):
        end = _quoted(text, 0, line_no)[1]
        return text[end:] == ":" or text[end:].startswith(": ")
    return not text.startswith(_INDICATORS) and re.search(r":( |$)", text) is not None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _node(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose first line is ``lines[i]``, at ``indent``."""
    if _is_item(lines[i].text):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        line = lines[i]
        rest = line.text[1:].lstrip()
        if not rest:  # "-" alone: the item is the block below it, or null
            i += 1
            if i < len(lines) and lines[i].indent > indent:
                item, i = _node(lines, i, lines[i].indent)
            else:
                item = None
        elif _is_item(rest):
            _fail(line.number, "a sequence inside a sequence item")
        elif _is_entry(rest, line.number):
            # a block mapping that starts on the dash's line, at its text's column
            column = indent + len(line.text) - len(rest)
            lines[i] = _Line(column, rest, line.number)
            item, i = _mapping(lines, i, column)
        else:
            item, i = _value(rest, line.number), i + 1
        out.append(item)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].number, "unexpected indentation")
    return out, i


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i].indent == indent and not _is_item(lines[i].text):
        line = lines[i]
        key, rest = _split_key(line.text, line.number)
        i += 1
        if rest:
            out[key] = _value(rest, line.number)
        elif i < len(lines) and lines[i].indent > indent:
            out[key], i = _node(lines, i, lines[i].indent)
        elif i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
            out[key], i = _sequence(lines, i, indent)  # a sequence at its key's column
        else:
            out[key] = None
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].number, "unexpected indentation")
    return out, i


def loads(text: str) -> Any:
    """The mapping (or sequence) a document of the subset holds (None for an
    empty one)."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw, number).rstrip()
        if not body.strip():
            continue
        lead = body[:len(body) - len(body.lstrip())]
        if "\t" in lead:
            _fail(number, "tab in indentation")
        lines.append(_Line(len(lead), body.strip(), number))
    if not lines:
        return None
    value, i = _node(lines, 0, lines[0].indent)
    if i != len(lines):
        _fail(lines[i].number, "indentation below the document's")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
