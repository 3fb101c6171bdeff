"""A reader and a writer for the block YAML that this package reads and
writes: pipeline ``config.yaml`` files, pyannote.database registries and
the CLI's reports.

The card machine has no PyYAML, so the package carries this subset of
YAML 1.1 as ``yaml.safe_load`` / ``yaml.safe_dump`` read and write it:

- block mappings and block sequences, nested by indentation (a sequence
  may sit at its key's indentation, as PyYAML writes it);
- plain, single-quoted and double-quoted scalars, folded over several
  lines, resolved as PyYAML's SafeLoader resolves them (null, bool, int
  in bases 2, 8, 10 and 16, float with ``.inf`` and ``.nan``, else str);
- the empty flow collections ``{}`` and ``[]``; comments.

Anything else (anchors and aliases, tags, block scalars, flow collections
with items, document markers and directives, complex keys, sexagesimal
numbers, timestamps, merge keys) raises ``ValueError``: it is outside
what this package writes or reads, and silently reading it otherwise
than PyYAML would is worse than refusing it.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, List, Optional, TextIO, Tuple, Union

__all__ = ["safe_load", "safe_dump", "load_file", "dump_file"]

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# what PyYAML resolves to types outside the subset
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}"
                        r"(?:(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}.*)?$")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _resolve(text: str) -> Any:
    """A plain scalar as PyYAML's SafeLoader types it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text) or text in ("<<",
                                                                      "="):
        raise ValueError(f"YAML scalar {text!r} is outside the subset this "
                         f"reader takes (PyYAML would not read it as a "
                         f"string)")
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value != "0" and value.startswith("0"):
            return sign * int(value, 8)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(".inf"):
            return -math.inf if value[0] == "-" else math.inf
        if value == ".nan":
            return math.nan
        return float(value)
    return text


class _Line:
    __slots__ = ("number", "indent", "text", "blanks")

    def __init__(self, number: int, indent: int, text: str, blanks: int):
        self.number, self.indent, self.text = number, indent, text
        self.blanks = blanks      # blank lines just before this one


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a ``#`` at its start or after
    whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t:-[{,"):
            quote = c
        i += 1
    return text.rstrip()


def _lines(source: str) -> List[_Line]:
    out, blanks = [], 0
    for number, raw in enumerate(source.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            raise ValueError(f"line {number}: tabs in YAML indentation")
        text = _strip_comment(raw)
        if not text.strip():
            blanks += 1
            continue
        stripped = text.lstrip(" ")
        if text.startswith("%") or text in ("---", "...") or \
                text.startswith(("--- ", "... ")):
            raise ValueError(f"line {number}: YAML document markers and "
                             f"directives are outside the subset")
        out.append(_Line(number, len(text) - len(stripped), stripped, blanks))
        blanks = 0
    return out


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """(key source, rest) of a mapping entry ``key: rest``, or None."""
    if text[0] in "'\"":
        end = _quoted_end(text, 0)
        if end is None:
            return None
        after = text[end:]
        if after == ":" or after.startswith(": "):
            return text[:end], after[1:].strip()
        return None
    if text.startswith("? "):
        raise ValueError("complex YAML keys are outside the subset")
    for m in re.finditer(r":(?: |$)", text):
        return text[:m.start()].rstrip(), text[m.end():].strip()
    return None


def _quoted_end(text: str, start: int) -> Optional[int]:
    """Index just past the quoted scalar opening at ``start`` on this
    line, or None when it continues on the next line."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                return i + 1
        i += 1
    return None


def _fold(parts: List[Tuple[str, int]]) -> str:
    """Join the lines of a multi-line scalar: a line break folds into a
    space, and each blank line in between keeps one newline."""
    out = parts[0][0]
    for text, blanks in parts[1:]:
        out += ("\n" * blanks if blanks else " ") + text
    return out


def _unescape(body: str, number: int) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1:i + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"line {number}: unknown escape \\{e}")
    return "".join(out)


class _Reader:
    def __init__(self, source: str):
        self.lines = _lines(source)
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0].indent)
        if self.i < len(self.lines):
            line = self.lines[self.i]
            raise ValueError(f"line {line.number}: unexpected indentation")
        return value

    def node(self, indent: int) -> Any:
        line = self.lines[self.i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(line.indent)
        if _split_key(line.text) is not None:
            return self.mapping(line.indent)
        return self.scalar(indent - 1)

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines) and self.lines[self.i].indent == indent:
            line = self.lines[self.i]
            split = _split_key(line.text)
            if split is None:
                raise ValueError(f"line {line.number}: expected 'key: value'")
            key_source, rest = split
            key = self.key(key_source, line.number)
            self.i += 1
            out[key] = self.value(rest, indent, line, in_mapping=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines) and \
                self.lines[self.i].indent == indent and (
                    self.lines[self.i].text == "-"
                    or self.lines[self.i].text.startswith("- ")):
            line = self.lines[self.i]
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.value("", indent, line, in_mapping=False))
                continue
            # the item's content becomes a line of its own, at its column
            column = indent + len(line.text) - len(rest)
            self.lines[self.i] = _Line(line.number, column, rest, 0)
            out.append(self.node(column))
        return out

    def value(self, rest: str, indent: int, line: _Line,
              in_mapping: bool) -> Any:
        """The value after ``key:`` or ``-`` on ``line``."""
        if rest:
            self.lines.insert(self.i, _Line(line.number, indent + 1, rest, 0))
            return self.scalar(indent)
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self.node(nxt.indent)
            # PyYAML writes a mapping's sequence at the key's indentation
            if in_mapping and nxt.indent == indent and (
                    nxt.text == "-" or nxt.text.startswith("- ")):
                return self.sequence(indent)
        return None

    def key(self, source: str, number: int) -> Any:
        if source[:1] in "'\"":
            return self.quoted(source, number)
        self.check_plain(source, number)
        return _resolve(source)

    def check_plain(self, text: str, number: int) -> None:
        if text[:1] in "&*!|>%@`" or text[:1] in "[{":
            raise ValueError(f"line {number}: {text!r} is outside the YAML "
                             f"subset (anchors, aliases, tags, block "
                             f"scalars, flow collections)")

    def quoted(self, text: str, number: int) -> str:
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        return _unescape(body, number)

    def scalar(self, parent_indent: int) -> Any:
        """A scalar starting at the current line, continued on lines
        indented deeper than ``parent_indent``."""
        first = self.lines[self.i]
        self.i += 1
        text = first.text
        if text in ("{}", "[]"):
            return {} if text == "{}" else []
        if text[0] in "'\"":
            parts = [(text, 0)]
            while _quoted_end(_fold(parts), 0) is None:
                if self.i >= len(self.lines):
                    raise ValueError(f"line {first.number}: unterminated "
                                     f"quoted scalar")
                line = self.lines[self.i]
                self.i += 1
                parts.append((line.text, line.blanks))
            joined = _fold(parts)
            end = _quoted_end(joined, 0)
            if joined[end:].strip():
                raise ValueError(f"line {first.number}: text after a quoted "
                                 f"scalar")
            return self.quoted(joined[:end], first.number)
        self.check_plain(text, first.number)
        parts = [(text, 0)]
        while self.i < len(self.lines) and \
                self.lines[self.i].indent > parent_indent and \
                _split_key(self.lines[self.i].text) is None and not (
                    self.lines[self.i].text.startswith("- ")
                    or self.lines[self.i].text == "-"):
            line = self.lines[self.i]
            self.i += 1
            parts.append((line.text, line.blanks))
        if len(parts) > 1:
            return _fold(parts)
        return _resolve(text)


def safe_load(stream: Union[str, TextIO]) -> Any:
    """Read a YAML document of the subset, as ``yaml.safe_load`` does."""
    source = stream if isinstance(stream, str) else stream.read()
    return _Reader(source).parse()


# -- writing ------------------------------------------------------------------

def _float(value: float) -> str:
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        # PyYAML's float needs a dot: 1e-05 would read back as a string
        mantissa, exponent = text.split("e")
        text = f"{mantissa}.0e{exponent}"
    return text


def _plain_ok(text: str) -> bool:
    return (bool(text) and text == text.strip() and text.isprintable()
            and text.isascii() and text[0] not in _INDICATORS
            and ": " not in text and " #" not in text
            and not text.endswith(":") and _safe_resolves_to_str(text))


def _safe_resolves_to_str(text: str) -> bool:
    try:
        return _resolve(text) == text and isinstance(_resolve(text), str)
    except ValueError:
        return False


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float(value)
    if isinstance(value, str):
        if _plain_ok(value):
            return value
        if value.isprintable() and value.isascii():
            return "'" + value.replace("'", "''") + "'"
        return json.dumps(value)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML "
                    f"(the subset takes dict, list, str, int, float, bool "
                    f"and None)")


def _emit(value: Any, indent: int, out: List[str], first_prefix: str) -> None:
    """Write ``value`` as a block node; its first line continues
    ``first_prefix`` (a ``- `` or nothing), the rest start at ``indent``."""
    pad = " " * indent
    if isinstance(value, dict) and value:
        for n, key in enumerate(sorted(value, key=_sort_key)):
            head = (first_prefix if n == 0 else pad) + _scalar(key) + ":"
            _emit_child(value[key], indent, head, out, in_mapping=True)
    elif isinstance(value, (list, tuple)) and value:
        for n, item in enumerate(value):
            head = (first_prefix if n == 0 else pad) + "- "
            if isinstance(item, (dict, list, tuple)) and item:
                _emit(item, indent + 2, out, head)
            else:
                out.append(head + _flow_or_scalar(item))
    else:
        out.append(first_prefix + _flow_or_scalar(value))


def _emit_child(value: Any, indent: int, head: str, out: List[str],
                in_mapping: bool) -> None:
    if isinstance(value, dict) and value:
        out.append(head)
        _emit(value, indent + 2, out, " " * (indent + 2))
    elif isinstance(value, (list, tuple)) and value:
        out.append(head)
        # PyYAML's layout: a mapping's sequence at the key's indentation
        _emit(value, indent, out, " " * indent)
    else:
        out.append(head + " " + _flow_or_scalar(value))


def _flow_or_scalar(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def _sort_key(key: Any):
    return (type(key).__name__, key)


def safe_dump(data: Any, stream: Optional[TextIO] = None) -> Optional[str]:
    """Write ``data`` in block style with sorted keys, as
    ``yaml.safe_dump`` lays it out; returns the text when no ``stream``
    is given."""
    out: List[str] = []
    _emit(data, 0, out, "")
    text = "\n".join(out) + "\n"
    if stream is None:
        return text
    stream.write(text)
    return None


def load_file(path: Union[str, Path]) -> Any:
    with open(path, encoding="utf-8") as f:
        return safe_load(f)


def dump_file(data: Any, path: Union[str, Path]) -> Path:
    path = Path(path)
    with open(path, "w", encoding="utf-8") as f:
        safe_dump(data, f)
    return path
