"""A YAML reader for the subset the repository's configs use, with no PyYAML.

It reads block mappings and block sequences, flow sequences ``[1, 2]`` and
flow mappings ``{a: 1}`` (also across lines), plain, single-quoted and
double-quoted scalars, and comments. Scalars resolve as ``yaml.safe_load``
resolves them (YAML 1.1): ``3.0e-06`` is a float but ``1e-6`` (no dot) and
``1.0e6`` (no exponent sign) stay strings; ``yes``/``no``/``on``/``off`` are
booleans; ``012`` is octal, ``0x1F`` hex, ``0b101`` binary, ``1_000`` is
1000 and ``1:30`` is 90; ``~``, ``null`` and an empty value are None.

Anything outside the subset raises :class:`YAMLSubsetError`: anchors,
aliases, tags, block scalars (``|``, ``>``), complex keys, merge keys,
timestamps, directives, several documents, multi-line plain scalars and
malformed input. It never returns something ``safe_load`` would not.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple


class YAMLSubsetError(ValueError):
    """The text is not YAML, or uses YAML this reader does not implement."""


_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                         (?:[Tt]|[ \t]+)[0-9][0-9]?
                         :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BREAKS = "\r\n\x85  "
_SPACE = " \t"
_FLOW_IND = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(digits: str, cast) -> Any:
    sign = -1 if digits[0] == "-" else 1
    if digits[0] in "+-":
        digits = digits[1:]
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def _int(text: str) -> int:
    """PyYAML's ``construct_yaml_int``."""
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    if v[0] == "0":
        return sign * int(v, 8)
    return sign * int(v)


def resolve_plain(text: str) -> Any:
    """The value ``yaml.safe_load`` gives a plain (unquoted) scalar."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        try:
            return _int(text)
        except ValueError:  # "0x_": PyYAML's constructor fails on it too
            raise YAMLSubsetError(f"not an integer: {text!r}") from None
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamps are not supported: {text!r}")
    if text == "=" or text == "<<":
        raise YAMLSubsetError(f"the {text!r} scalar is not supported")
    return text


class _Scanner:
    """Scalars and flow collections over one logical piece of text."""

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def error(self, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"{msg} at column {self.i + 1} of {self.where}")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def skip_space(self, flow: bool) -> None:
        while True:
            while self.peek() in _SPACE or (flow and self.peek() in _BREAKS and self.peek() != "\0"):
                self.i += 1
            if self.peek() == "#" and (self.i == 0 or self.s[self.i - 1] in _SPACE + _BREAKS):
                while self.peek() not in _BREAKS + "\0":
                    self.i += 1
                if not flow:
                    return
                continue
            return

    def at_end(self) -> bool:
        return self.i >= len(self.s)

    # -- scalars -----------------------------------------------------------
    def single_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "\0" and self.at_end():
                raise self.error("unterminated single-quoted scalar")
            if c == "'":
                if self.peek(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if c in _BREAKS:
                raise self.error("multi-line quoted scalars are not supported")
            out.append(c)
            self.i += 1

    def double_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "\0" and self.at_end():
                raise self.error("unterminated double-quoted scalar")
            if c == '"':
                self.i += 1
                return "".join(out)
            if c in _BREAKS:
                raise self.error("multi-line quoted scalars are not supported")
            if c == "\\":
                e = self.peek(1)
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.error("bad escape in a double-quoted scalar")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"unsupported escape \\{e} in a double-quoted scalar")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar; ends at ``: ``, `` #``, a line break and, in a flow
        collection, at ``,?[]{}``."""
        c, n = self.peek(), self.peek(1)
        stop = _SPACE + _BREAKS + "\0" + (_FLOW_IND if flow else "")
        if c in "&*!|>%@`":
            raise self.error(f"{c!r} (anchors, aliases, tags, block scalars, directives, "
                             f"reserved) is not supported")
        # PyYAML's check_plain: "-" starts a plain scalar unless a space or
        # line end follows; "?" and ":" do so only outside flow collections
        if (c == "-" and n in _SPACE + _BREAKS + "\0") or \
                (c in "?:" and (flow or n in _SPACE + _BREAKS + "\0")):
            raise self.error(f"{c!r} indicator here is not supported")
        if c in "[]{},#'\"":
            raise self.error(f"unexpected {c!r}")
        start = self.i
        end = self.i
        while True:
            c = self.peek()
            if c == "\0" and self.at_end():
                break
            if c in _BREAKS:
                if flow and self._continues_after_break():
                    raise self.error("multi-line plain scalars are not supported")
                break
            if c == ":" and self.peek(1) in stop:
                break
            if flow and c in ",?[]{}":
                break
            if c in _SPACE:
                j = self.i
                while j < len(self.s) and self.s[j] in _SPACE:
                    j += 1
                nxt = self.s[j] if j < len(self.s) else "\0"
                if (nxt == "\0" or nxt in _BREAKS or nxt == "#"
                        or (nxt == ":" and (self.s[j + 1] if j + 1 < len(self.s) else "\0") in stop)
                        or (flow and nxt in ",?[]{}")):
                    self.i = j
                    break
                self.i = j
                continue
            self.i += 1
            end = self.i
        text = self.s[start:end]
        self.i = max(self.i, end)
        return text

    def _continues_after_break(self) -> bool:
        """Whether PyYAML's plain scalar would go on past the line break at
        ``self.i`` (in a flow collection, the next line's text joins it)."""
        j = self.i
        while j < len(self.s) and (self.s[j] in _SPACE or self.s[j] in _BREAKS):
            j += 1
        if j >= len(self.s):
            return False
        c, n = self.s[j], self.s[j + 1] if j + 1 < len(self.s) else "\0"
        if c == "#" or c in ",?[]{}":
            return False
        return not (c == ":" and n in _SPACE + _BREAKS + "\0" + _FLOW_IND)

    # -- nodes -------------------------------------------------------------
    def node(self, flow: bool) -> Any:
        c = self.peek()
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c == "'":
            return self.single_quoted()
        if c == '"':
            return self.double_quoted()
        return resolve_plain(self.plain(flow))

    def key(self, flow: bool) -> Tuple[Any, bool]:
        """A mapping key and whether it was quoted."""
        c = self.peek()
        if c in "[{":
            raise self.error("collection keys are not supported")
        if c == "'":
            return self.single_quoted(), True
        if c == '"':
            return self.double_quoted(), True
        text = self.plain(flow)
        if not text:
            raise self.error("empty keys are not supported")
        if text == "<<":
            raise self.error("merge keys are not supported")
        return resolve_plain(text), False

    def flow_seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_space(True)
            if self.peek() == "]":
                self.i += 1
                return out
            if self.at_end():
                raise self.error("unterminated flow sequence")
            item = self.node(True)
            self.skip_space(True)
            if self.peek() == ":":
                raise self.error("single-pair mappings in a flow sequence are not supported")
            out.append(item)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']'")

    def flow_map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip_space(True)
            if self.peek() == "}":
                self.i += 1
                return out
            if self.at_end():
                raise self.error("unterminated flow mapping")
            k, _ = self.key(True)
            after_key = self.i
            self.skip_space(True)
            if self.peek() == ":" and any(c in _BREAKS for c in self.s[after_key:self.i]):
                raise self.error("a key and its ':' on different lines")
            if self.peek() == ":":
                self.i += 1
                self.skip_space(True)
                v = None if self.peek() in ",}" else self.node(True)
            else:
                v = None
            out[k] = v
            self.skip_space(True)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}'")

    def finish(self) -> None:
        self.skip_space(True)
        if not self.at_end():
            raise self.error(f"unexpected {self.peek()!r}")


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _comment_free(text: str) -> str:
    """``text`` up to a comment, outside quotes (only ``#`` after a space or at
    the start opens one)."""
    quote = None
    for j, c in enumerate(text):
        if quote:
            if c == quote:
                if quote == "'" and j + 1 < len(text) and text[j + 1] == "'":
                    continue
                quote = None
            elif c == "\\" and quote == '"':
                continue
        elif c == "#" and (j == 0 or text[j - 1] in _SPACE):
            return text[:j].rstrip()
        elif c in "'\"" and (j == 0 or text[j - 1] in _SPACE + "[{,:-"):
            quote = c
    return text.rstrip()


def _depth(text: str) -> int:
    """Open flow brackets at the end of ``text`` (quotes skipped)."""
    depth, quote = 0, None
    for j, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or text[j - 1] in _SPACE + "[{,:-"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _flow_start(text: str) -> str:
    """The flow collection a line's value opens (after ``- `` markers and a
    ``key:``), or ""."""
    while text == "-" or text.startswith("- "):
        text = text[1:].lstrip(" ")
    col = _split_key(text) if text else None
    if col is not None:
        text = text[col + 1:].lstrip(" ")
    return text if text[:1] in ("[", "{") else ""


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    raw = text.split("\n")
    seen_doc = False
    k = 0
    while k < len(raw):
        line = raw[k].rstrip("\r")
        k += 1
        if line.startswith("%"):
            raise YAMLSubsetError(f"directives are not supported (line {k})")
        if line.rstrip() in ("---", "...") or line.startswith("--- ") or line.startswith("... "):
            if line.rstrip() == "---" and not seen_doc and not out:
                seen_doc = True
                continue
            raise YAMLSubsetError(f"document markers beyond one leading '---' are not "
                                  f"supported (line {k})")
        stripped = line.lstrip(" ")
        indent = len(line) - len(stripped)
        if stripped.startswith("\t") and stripped.strip():
            raise YAMLSubsetError(f"tabs in indentation (line {k})")
        body = _comment_free(stripped)
        if not body:
            continue
        no = k
        while _depth(_flow_start(body)) > 0 and k < len(raw):  # a flow collection across lines
            body = body + "\n" + _comment_free(raw[k].strip())
            k += 1
        out.append(_Line(indent, body, no))
    return out


def _split_key(text: str) -> Optional[int]:
    """Column of the ``:`` that ends a block mapping key in ``text``, or None
    when the line is not ``key: value`` / ``key:``."""
    if text[0] in "'\"":
        sc = _Scanner(text, "key")
        try:
            sc.single_quoted() if text[0] == "'" else sc.double_quoted()
        except YAMLSubsetError:
            return None
        j = sc.i
        while j < len(text) and text[j] in _SPACE:
            j += 1
        if j < len(text) and text[j] == ":" and (j + 1 == len(text) or text[j + 1] in _SPACE):
            return j
        return None
    if text[0] in "[{":
        return None
    depth = 0
    for j, c in enumerate(text):
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (j + 1 == len(text) or text[j + 1] in _SPACE):
            return j
        elif c == "#" and j and text[j - 1] in _SPACE:
            return None
    return None


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.k = 0

    def error(self, msg: str, line: Optional[_Line] = None) -> YAMLSubsetError:
        line = line or (self.lines[self.k] if self.k < len(self.lines) else None)
        where = f" (line {line.no})" if line else ""
        return YAMLSubsetError(msg + where)

    def inline(self, text: str, line: _Line) -> Any:
        sc = _Scanner(text, f"line {line.no}")
        value = sc.node(False)
        sc.finish()
        return value

    def block(self, indent: int) -> Any:
        line = self.lines[self.k]
        if line.indent != indent:
            raise self.error("bad indentation")
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(indent)
        if _split_key(line.text) is not None:
            return self.mapping(indent)
        self.k += 1
        value = self.inline(line.text, line)
        if self.k < len(self.lines) and self.lines[self.k].indent >= indent:
            raise self.error("multi-line plain scalars are not supported")
        return value

    def after_entry(self, indent: int, compact_seq: bool) -> Any:
        """The value of ``key:`` / ``-`` with nothing after it on its line."""
        if self.k >= len(self.lines):
            return None
        nxt = self.lines[self.k]
        if nxt.indent > indent:
            return self.block(nxt.indent)
        if compact_seq and nxt.indent == indent and (nxt.text == "-" or nxt.text.startswith("- ")):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            line = self.lines[self.k]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error("bad indentation")
            if line.text == "-" or line.text.startswith("- "):
                break
            col = _split_key(line.text)
            if col is None:
                raise self.error("expected 'key: value'")
            if line.text.startswith("? "):
                raise self.error("complex keys are not supported")
            sc = _Scanner(line.text[:col], f"line {line.no}")
            key, _ = sc.key(False)
            sc.finish()
            rest = line.text[col + 1:].strip()
            self.k += 1
            if rest:
                value = self.inline(rest, line)
                if self.k < len(self.lines) and self.lines[self.k].indent > indent:
                    raise self.error("multi-line plain scalars are not supported")
            else:
                value = self.after_entry(indent, compact_seq=True)
            out[key] = value
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            line = self.lines[self.k]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error("bad indentation")
            if not (line.text == "-" or line.text.startswith("- ")):
                break
            rest = line.text[1:]
            if not rest.strip():
                self.k += 1
                out.append(self.after_entry(indent, compact_seq=False))
                continue
            pad = len(rest) - len(rest.lstrip(" "))
            # "- x..." is a node that starts at the column of x
            self.lines[self.k] = _Line(indent + 1 + pad, rest.lstrip(" "), line.no)
            out.append(self.block(indent + 1 + pad))
        return out


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset (see the module doc)."""
    lines = _lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    value = p.block(lines[0].indent)
    if p.k < len(lines):
        raise p.error("unexpected content")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
