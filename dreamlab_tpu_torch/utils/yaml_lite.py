"""A reader for the YAML subset of the port's config files (``styles.yaml``).

PyYAML is not among the packages the card's machine promises, so the port
reads the documented layouts itself: nested block mappings (indented by
spaces), one-line flow lists of scalars (``[0.4, 0.6]``), and plain or
quoted scalars that resolve, as ``yaml.safe_load`` resolves them, to
strings, ints, floats or null. Comments and blank lines are skipped. It
raises ``ValueError`` on anything else (block sequences, flow mappings,
anchors, tags, multi-line scalars, documents markers, and the plain scalars
PyYAML would read as booleans, timestamps or non-decimal ints), so a file
never silently reads differently from what PyYAML would give.
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
        if ch in "'\"" and (i == 0 or raw[i - 1] in " [,:"):
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


def _flow_list(text: str, line_no: int) -> List[Any]:
    if not text.endswith("]"):
        _fail(line_no, "a flow list must close on its line")
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
        items.pop()  # a trailing comma, or "[]"
    if any(it == "" for it in items):
        _fail(line_no, f"empty entry in {text!r}")
    return [_scalar(it, line_no) for it in items]


def _value(text: str, line_no: int) -> Any:
    return _flow_list(text, line_no) if text.startswith("[") else _scalar(text, line_no)


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


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        key, rest = _split_key(line.text, line.number)
        i += 1
        if rest:
            out[key] = _value(rest, line.number)
        elif i < len(lines) and lines[i].indent > indent:
            out[key], i = _mapping(lines, i, lines[i].indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].number, "unexpected indentation")
    return out, i


def loads(text: str) -> Any:
    """The mapping a document of the subset holds (None for an empty one)."""
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
    value, i = _mapping(lines, 0, lines[0].indent)
    if i != len(lines):
        _fail(lines[i].number, "indentation below the document's")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
