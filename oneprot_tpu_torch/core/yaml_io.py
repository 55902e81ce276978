"""A reader and a writer for the YAML that `configs/` uses, in place of
PyYAML (counterpart of the `yaml.safe_load` / `yaml.safe_dump` calls of
oneprot_tpu/core/config.py).

    tree = yaml_io.load(path.read_text(), source=str(path))
    yaml_io.load("1e-3")       # '1e-3': YAML 1.1 has no float without a dot
    yaml_io.load("1.0e-3")     # 0.001
    text = yaml_io.dump(tree)  # yaml.safe_load(text) == tree

The subset read: block mappings and sequences (a sequence may sit at its
key's indentation), flow sequences and mappings, plain, single- and
double-quoted scalars on one line, comments, a leading `---` and empty
documents. Plain scalars resolve as PyYAML's `safe_load` resolves them,
by the YAML 1.1 rules: `yes`/`no`/`on`/`off` are booleans, `~` is null,
`0x10`, the octal `010`, `1_000` and the sexagesimal `12:30` are ints, a
float needs a dot (or is `.inf` / `.nan`), and `2024-01-31` is a
`datetime.date`. Anything else (anchors, aliases, tags, block scalars,
scalars over several lines, complex keys, several documents) raises
`YamlError` naming the source and the line.

`dump` writes block style, `{}` and `[]` for empty collections, a string
plain when it reads back as the same string and double-quoted otherwise.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YamlError", "load", "resolve_plain", "dump"]


class YamlError(ValueError):
    """Input outside the subset, or malformed; names the source and line."""


# ---------------------------------------------------------------------------
# YAML 1.1 scalar resolution (PyYAML's implicit resolvers, in their order)

_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _to_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _to_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _to_timestamp(text: str):
    v = _TIMESTAMP_PARTS.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                   minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tzinfo)


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar, as yaml.safe_load gives it."""
    if _BOOL_RE.match(text):
        return _BOOL[text.lower()]
    if _FLOAT_RE.match(text):
        return _to_float(text)
    if _INT_RE.match(text):
        return _to_int(text)
    if _NULL_RE.match(text):
        return None
    if _TIMESTAMP_RE.match(text):
        return _to_timestamp(text)
    if text in ("<<", "="):
        raise ValueError(f"the YAML 1.1 {'merge' if text == '<<' else 'value'}"
                         " key is outside the subset")
    return text


# ---------------------------------------------------------------------------
# reading

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that cannot start a plain scalar (`-`, `?`, `:` only before a
# space; handled where they are read)
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags",
                      "|": "block scalars", ">": "block scalars",
                      "%": "directives", "@": "reserved indicators",
                      "`": "reserved indicators"}
_FLOW_STOP = ",[]{}"


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: List[_Line] = []
        self.i = 0
        started = False
        for no, raw in enumerate(text.splitlines(), 1):
            stripped = raw.lstrip(" ")
            if not stripped.strip() or stripped.startswith("#"):
                continue
            if stripped[0] == "\t":
                raise self.error(no, "tabs in indentation")
            indent = len(raw) - len(stripped)
            if indent == 0 and stripped.startswith("%"):
                raise self.error(no, "directives are outside the subset")
            if indent == 0 and (stripped == "---"
                                or stripped.startswith(("--- ", "---\t"))):
                if started:
                    raise self.error(no, "several documents are outside the "
                                     "subset")
                rest = stripped[3:].strip()
                if rest and not rest.startswith("#"):
                    raise self.error(no, "content after '---' is outside the "
                                     "subset")
                started = True
                continue
            if indent == 0 and (stripped == "..."
                                or stripped.startswith(("... ", "...\t"))):
                raise self.error(no, "document end markers are outside the "
                                 "subset")
            started = True
            self.lines.append(_Line(no, indent, stripped.rstrip()))

    def error(self, no: int, what: str) -> YamlError:
        return YamlError(f"{self.source}, line {no}: {what}")

    # -- block structure --------------------------------------------------

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0].indent)
        if self.i < len(self.lines):
            line = self.lines[self.i]
            raise self.error(line.no, "unexpected indentation or content")
        return value

    @staticmethod
    def _is_entry(text: str) -> bool:
        return text == "-" or text.startswith(("- ", "-\t"))

    def node(self, indent: int) -> Any:
        line = self.lines[self.i]
        if self._is_entry(line.text):
            return self.sequence(line.indent)
        if self.split_key(line) is not None:
            return self.mapping(line.indent)
        self.i += 1
        return self.inline_to_end(line, 0, indent)

    def inline_to_end(self, line: _Line, p: int, indent: int) -> Any:
        """The inline node at p, which must end its line: a deeper line
        after it would continue a scalar over several lines."""
        value, p = self.inline(line, p, flow=False)
        self.expect_end(line, p)
        if self.i < len(self.lines) and self.lines[self.i].indent > indent:
            raise self.error(self.lines[self.i].no, "a scalar over several "
                             "lines is outside the subset")
        return value

    def value_after(self, indent: int, after_key: bool) -> Any:
        """The block node after an entry or key with no inline value:
        deeper lines or, after a key, a sequence at the key's indentation;
        null when neither follows."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent or (after_key and nxt.indent == indent
                                       and self._is_entry(nxt.text)):
                return self.node(nxt.indent)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent > indent:
                raise self.error(line.no, "expected a '- ' entry at "
                                 f"indentation {indent}")
            if line.indent < indent or not self._is_entry(line.text):
                break  # the end of the sequence (one at its key's level)
            rest = line.text[1:].lstrip(" \t")
            if not rest or rest.startswith("#"):
                self.i += 1
                # a '-' at this indentation is the next entry
                out.append(self.value_after(indent, after_key=False))
                continue
            # the rest of the line is a node at its own column
            col = indent + len(line.text) - len(rest)
            self.lines[self.i] = _Line(line.no, col, rest)
            out.append(self.node(col))
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            split = self.split_key(line) if line.indent == indent else None
            if split is None:
                raise self.error(line.no, f"expected a 'key:' at indentation "
                                 f"{indent}")
            key, p = split
            self.i += 1
            p = self.skip_spaces(line.text, p)
            if p >= len(line.text) or self.at_comment(line.text, p):
                out[key] = self.value_after(indent, after_key=True)
            else:
                out[key] = self.inline_to_end(line, p, indent)
        return out

    def split_key(self, line: _Line) -> Optional[Tuple[Any, int]]:
        """(key, position after its ':') when the line starts a mapping entry."""
        s = line.text
        if s[0] in "'\"":
            key, p = self.quoted(line, 0)
            p = self.skip_spaces(s, p)
            if p < len(s) and s[p] == ":" and (p + 1 == len(s)
                                               or s[p + 1] in " \t"):
                return key, p + 1
            return None
        if s[0] in "[{":
            return None
        if s == "?" or s.startswith(("? ", "?\t")):
            raise self.error(line.no, "complex keys are outside the subset")
        for p, c in enumerate(s):
            if c == "#" and p and s[p - 1] in " \t":
                return None
            if c == ":" and (p + 1 == len(s) or s[p + 1] in " \t"):
                text = s[:p].rstrip()
                if not text:
                    raise self.error(line.no, "an empty key is outside the "
                                     "subset")
                self.check_plain_start(line, text, flow=False)
                return self.plain_value(line, text), p + 1
        return None

    # -- one line ---------------------------------------------------------

    @staticmethod
    def skip_spaces(s: str, p: int) -> int:
        while p < len(s) and s[p] in " \t":
            p += 1
        return p

    @staticmethod
    def at_comment(s: str, p: int) -> bool:
        return s[p] == "#" and (p == 0 or s[p - 1] in " \t")

    def expect_end(self, line: _Line, p: int) -> None:
        p = self.skip_spaces(line.text, p)
        if p < len(line.text) and not self.at_comment(line.text, p):
            raise self.error(line.no, f"unexpected {line.text[p:]!r}")

    def check_plain_start(self, line: _Line, text: str, flow: bool) -> None:
        c = text[0]
        if c in _UNSUPPORTED_START:
            raise self.error(line.no, f"{_UNSUPPORTED_START[c]} are outside the "
                             "subset")
        nxt = text[1:2]
        if c in "-?:" and (nxt in ("", " ", "\t") or (flow and nxt in _FLOW_STOP)):
            raise self.error(line.no, f"a plain scalar cannot start with {c!r} "
                             "here")
        if c in "#" or (flow and c in _FLOW_STOP):
            raise self.error(line.no, f"unexpected {c!r}")

    def plain_value(self, line: _Line, text: str) -> Any:
        try:
            return resolve_plain(text)
        except ValueError as e:
            raise self.error(line.no, str(e)) from None

    def inline(self, line: _Line, p: int, flow: bool) -> Tuple[Any, int]:
        """A node that starts at p on this line: (value, position after it)."""
        s = line.text
        c = s[p]
        if c == "[":
            return self.flow_sequence(line, p)
        if c == "{":
            return self.flow_mapping(line, p)
        if c in "'\"":
            return self.quoted(line, p)
        if not flow and (c == "-" and s[p + 1:p + 2] in ("", " ", "\t")):
            raise self.error(line.no, "a sequence entry is not allowed here")
        end = p
        while end < len(s):
            ch = s[end]
            if ch == "#" and s[end - 1] in " \t":
                break
            if ch == ":" and (end + 1 == len(s) or s[end + 1] in " \t"
                              or (flow and s[end + 1] in _FLOW_STOP)):
                if not flow:
                    raise self.error(line.no, "a mapping value is not allowed "
                                     "here")
                break
            if flow and ch in _FLOW_STOP:
                break
            end += 1
        text = s[p:end].rstrip()
        if not text:
            raise self.error(line.no, f"unexpected {s[p:]!r}")
        self.check_plain_start(line, text, flow)
        return self.plain_value(line, text), end

    def quoted(self, line: _Line, p: int) -> Tuple[str, int]:
        s, q = line.text, line.text[p]
        out = []
        i = p + 1
        while i < len(s):
            ch = s[i]
            if q == "'" and ch == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and ch == '"':
                return "".join(out), i + 1
            if q == '"' and ch == "\\":
                e = s[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = s[i + 2:i + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.error(line.no, f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
                if not e:
                    raise self.error(line.no, "a quoted scalar over several "
                                     "lines is outside the subset")
                raise self.error(line.no, f"unknown escape \\{e}")
            out.append(ch)
            i += 1
        raise self.error(line.no, "a quoted scalar over several lines is "
                         "outside the subset")

    def flow_sequence(self, line: _Line, p: int) -> Tuple[list, int]:
        s = line.text
        out = []
        p = self.skip_spaces(s, p + 1)
        while True:
            if p >= len(s):
                raise self.error(line.no, "a flow sequence over several lines "
                                 "is outside the subset")
            if s[p] == "]":
                return out, p + 1
            value, p = self.inline(line, p, flow=True)
            p = self.skip_spaces(s, p)
            if p < len(s) and s[p] == ":":
                raise self.error(line.no, "a mapping inside a flow sequence "
                                 "is outside the subset")
            out.append(value)
            if p < len(s) and s[p] == ",":
                p = self.skip_spaces(s, p + 1)
            elif p < len(s) and s[p] != "]":
                raise self.error(line.no, f"expected ',' or ']' at "
                                 f"{s[p:]!r}")

    def flow_mapping(self, line: _Line, p: int) -> Tuple[dict, int]:
        s = line.text
        out = {}
        p = self.skip_spaces(s, p + 1)
        while True:
            if p >= len(s):
                raise self.error(line.no, "a flow mapping over several lines "
                                 "is outside the subset")
            if s[p] == "}":
                return out, p + 1
            if s[p] in "[{":
                raise self.error(line.no, "a collection as a key is outside "
                                 "the subset")
            key, p = self.inline(line, p, flow=True)
            p = self.skip_spaces(s, p)
            value = None
            if p < len(s) and s[p] == ":":
                p = self.skip_spaces(s, p + 1)
                if p < len(s) and s[p] not in ",}":
                    value, p = self.inline(line, p, flow=True)
                    p = self.skip_spaces(s, p)
            out[key] = value
            if p < len(s) and s[p] == ",":
                p = self.skip_spaces(s, p + 1)
            elif p < len(s) and s[p] != "}":
                raise self.error(line.no, f"expected ',' or '}}' at "
                                 f"{s[p:]!r}")


def load(text: str, source: str = "<string>") -> Any:
    """Parse one YAML document of the subset, as yaml.safe_load would."""
    return _Reader(text, source).document()


# ---------------------------------------------------------------------------
# writing

_PLAIN_START_BAD = set("-?:,[]{}#&*!|>'\"%@`")


def _plain_ok(s: str) -> bool:
    if (not s or s != s.strip() or s[0] in _PLAIN_START_BAD
            or s.startswith(("---", "...")) or ": " in s or " #" in s
            or s.endswith(":") or not s.isprintable()):
        return False
    try:
        return resolve_plain(s) == s
    except ValueError:
        return False


def _quote(s: str) -> str:
    out = ['"']
    for ch in s:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch.isprintable() and ch not in "\x85\u2028\u2029\ufeff":
            out.append(ch)
        else:
            code = ord(ch)
            out.append(f"\\x{code:02X}" if code < 0x100 else
                       f"\\u{code:04X}" if code < 0x10000 else f"\\U{code:08X}")
    out.append('"')
    return "".join(out)


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        # YAML 1.1 reads an exponent as a float only after a dot
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    raise TypeError(f"cannot write a {type(v).__name__} as YAML: {v!r}")


def _lines(v: Any) -> List[str]:
    """Block lines of a non-empty collection, at indentation 0."""
    out: List[str] = []
    if isinstance(v, dict):
        for key, val in v.items():
            head = f"{_scalar(key)}:"
            if isinstance(val, (dict, list, tuple)) and len(val):
                # a nested mapping goes 2 deeper; a sequence stays at the key's
                pad = "  " if isinstance(val, dict) else ""
                out.append(head)
                out.extend(pad + line for line in _lines(val))
            else:
                out.append(f"{head} {_inline(val)}")
    else:
        for val in v:
            if isinstance(val, (dict, list, tuple)) and len(val):
                sub = _lines(val)
                out.append("- " + sub[0])
                out.extend("  " + line for line in sub[1:])
            else:
                out.append(f"- {_inline(val)}")
    return out


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(obj: Any) -> str:
    """Block-style YAML text that yaml.safe_load (and `load`) read back as
    `obj`; dicts keep their order."""
    if isinstance(obj, (dict, list, tuple)) and len(obj):
        return "\n".join(_lines(obj)) + "\n"
    return _inline(obj) + "\n"
