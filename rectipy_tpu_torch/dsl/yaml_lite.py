"""A small YAML reader for the model-template files.

The port reads its templates without PyYAML.  This reader covers the subset
that the template library uses, and raises :class:`YAMLError` on anything
outside it instead of guessing:

- the ``%YAML`` directive and the ``---`` document marker;
- full-line and trailing ``#`` comments;
- block mappings (plain or quoted keys) and block sequences of scalars,
  with a sequence allowed at its parent key's indentation;
- plain, single-quoted and double-quoted scalars;
- scalar anchors (``&name value``) and aliases (``*name``).

Plain scalars are typed as ``yaml.safe_load`` types them (the YAML 1.1
resolvers of PyYAML): ``null``/``~``, booleans (``true``, ``yes``, ``on``,
...), decimal integers and floats.  As in PyYAML, a float needs a dot and
a signed exponent (``6.0e-3`` is a float, ``1e-3`` and ``1.0e3`` stay
strings).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["YAMLError", "load", "load_file"]


class YAMLError(ValueError):
    """Raised on malformed input or on YAML outside the supported subset."""


_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT_RE = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT_RE = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)")
# integer forms PyYAML also resolves (binary, octal, hex, sexagesimal); the
# templates use none, so they are refused rather than mistyped
_OTHER_NUM_RE = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?")
_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
               "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
               "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def _resolve_plain(text: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.fullmatch(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t == ".nan":
            return float("nan")
        return float(t)
    if _OTHER_NUM_RE.fullmatch(text):
        raise YAMLError(f"Unsupported numeric form {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is outside quotes and starts the line or
    follows whitespace."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t-:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """Parse the quoted scalar starting at ``text[pos]``; return its value
    and the index just past the closing quote."""
    q = text[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                if i + 1 >= len(text):
                    break
                e = text[i + 1]
                if e in _DQ_ESCAPES:
                    out.append(_DQ_ESCAPES[e])
                    i += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(e)
                if width is None:
                    raise YAMLError(f"Unknown escape '\\{e}' in {text!r}")
                out.append(chr(int(text[i + 2:i + 2 + width], 16)))
                i += 2 + width
                continue
            out.append(c)
        i += 1
    raise YAMLError(f"Unterminated quoted scalar in {text!r}")


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str, int]] = []  # (indent, content, lineno)
        self.anchors: Dict[str, object] = {}
        started = False
        for lineno, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError(f"line {lineno}: tabs are not allowed in indentation")
            line = _strip_comment(raw)
            content = line.strip()
            if not content:
                continue
            if not started and content.startswith("%"):
                continue  # directive (%YAML 1.2)
            if content == "---" or content.startswith("--- "):
                if started:
                    raise YAMLError(f"line {lineno}: only one document is supported")
                started = True
                content = content[3:].strip()
                if not content:
                    continue
            if content == "...":
                break
            started = True
            self.lines.append((len(line) - len(line.lstrip()), content, lineno))

    def parse(self):
        if not self.lines:
            return None
        value, i = self._block(0, self.lines[0][0])
        if i != len(self.lines):
            raise YAMLError(f"line {self.lines[i][2]}: unexpected indentation")
        return value

    @staticmethod
    def _is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def _block(self, i: int, indent: int):
        if self._is_item(self.lines[i][1]):
            return self._seq(i, indent)
        return self._map(i, indent)

    def _seq(self, i: int, indent: int):
        out = []
        while i < len(self.lines):
            ind, content, lineno = self.lines[i]
            if ind != indent or not self._is_item(content):
                break
            rest = content[1:].strip()
            i += 1
            if not rest:
                if i < len(self.lines) and self.lines[i][0] > indent:
                    value, i = self._block(i, self.lines[i][0])
                else:
                    value = None
            elif self._split_key(rest) is not None:
                raise YAMLError(f"line {lineno}: mappings inside sequence items are not supported")
            else:
                value = self._scalar(rest, lineno)
            out.append(value)
        return out, i

    def _split_key(self, content: str):
        """``(key, rest)`` when ``content`` is a ``key: value`` entry, else None."""
        if content[0] in "\"'":
            key, end = _quoted(content, 0)
            tail = content[end:].lstrip()
            if not tail.startswith(":"):
                return None
            return key, tail[1:].strip()
        if content[0] in "&*":
            return None
        m = re.search(r":(?:\s|$)", content)
        if m is None:
            return None
        return _resolve_plain(content[:m.start()].rstrip()), content[m.end():].strip()

    def _map(self, i: int, indent: int):
        out: dict = {}
        while i < len(self.lines):
            ind, content, lineno = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"line {lineno}: unexpected indentation")
            if self._is_item(content):
                break
            kv = self._split_key(content)
            if kv is None:
                raise YAMLError(f"line {lineno}: expected 'key: value', got {content!r}")
            key, rest = kv
            i += 1
            if rest:
                out[key] = self._scalar(rest, lineno)
            elif i < len(self.lines) and self.lines[i][0] > indent:
                out[key], i = self._block(i, self.lines[i][0])
            elif (i < len(self.lines) and self.lines[i][0] == indent
                  and self._is_item(self.lines[i][1])):
                out[key], i = self._seq(i, indent)
            else:
                out[key] = None
        return out, i

    def _scalar(self, text: str, lineno: int):
        if text[0] == "&":
            name, _, rest = text[1:].partition(" ")
            if not rest.strip():
                raise YAMLError(f"line {lineno}: anchors on blocks are not supported")
            value = self._scalar(rest.strip(), lineno)
            self.anchors[name] = value
            return value
        if text[0] == "*":
            name = text[1:]
            if name not in self.anchors:
                raise YAMLError(f"line {lineno}: unknown alias {text!r}")
            return self.anchors[name]
        if text[0] in "\"'":
            value, end = _quoted(text, 0)
            if text[end:].strip():
                raise YAMLError(f"line {lineno}: trailing text after quoted scalar {text!r}")
            return value
        if text[0] in "[{|>!%@`":
            raise YAMLError(f"line {lineno}: unsupported YAML syntax {text!r}")
        return _resolve_plain(text)


def load(text: str):
    """Parse one YAML document from a string."""
    return _Reader(text).parse()


def load_file(path: str):
    """Parse the YAML document in the file at ``path``."""
    with open(path, encoding="utf-8") as f:
        return load(f.read())
