"""A YAML reader for the subset the config tree and ``yaml.safe_dump`` use
(the port has no PyYAML; counterpart of ``sheeprl_tpu/config/compose.py::
_yaml_load``, :39-59).

It reads block mappings and sequences (the indentless sequences of
``safe_dump`` too), flow collections (``[a, b]``, ``{_target_: x}``),
plain, single- and double-quoted scalars (folded over several lines) and
comments. Plain scalars resolve as PyYAML's ``SafeLoader`` resolves them
under YAML 1.1 (``yes``/``no``/``on``/``off`` are booleans, ``~`` is null,
``0o``-less octal ``0755`` and ``1_000`` are integers, dates are dates), with
the JAX loader's extra YAML-1.2 float resolver tried last, so ``3e-4`` is a
float. Anchors, aliases, tags, block scalars (``|``, ``>``) and several
documents in one text are not read: they raise :class:`YAMLError`.
"""

from __future__ import annotations

import datetime
import re
from typing import Any, List, Optional, Tuple


class YAMLError(ValueError):
    """The text is not in the subset this reader reads."""


# -- scalar resolution (PyYAML resolver.py / constructor.py, YAML 1.1) -------

_BOOL = {
    "yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True, "on": True, "On": True, "ON": True,
    "no": False, "No": False, "NO": False, "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
    "OFF": False,
}  # fmt: skip
_NULL = {"~", "null", "Null", "NULL", ""}
_FLOAT11 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_TIMESTAMP_PARTS = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""",
    re.X,
)
# the JAX loader's YAML-1.2 float resolver (compose.py:43-56)
_FLOAT12 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)


def _sexagesimal(sign: int, text: str, cast) -> Any:
    value = cast(0)
    base = 1
    for digit in reversed([cast(p) for p in text.split(":")]):
        value += digit * base
        base *= 60
    return sign * value


def _to_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return _sexagesimal(sign, value, int)
    return sign * int(value)


def _to_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return _sexagesimal(sign, value, float)
    return sign * float(value)


def _to_timestamp(text: str) -> Any:
    m = _TIMESTAMP_PARTS.match(text)
    if m is None:
        raise YAMLError(f"bad timestamp {text!r}")
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return datetime.date(year, month, day)
    fraction = int((m["fraction"] or "0")[:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    stamp = datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]), int(m["second"]), fraction, tz)
    # PyYAML's SafeLoader returns naive UTC times
    if tz is not None:
        stamp = stamp.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return stamp


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, by PyYAML's resolver order: bool, 1.1
    float, int, null, timestamp, then the 1.2 float."""
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT11.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if text in _NULL:
        return None
    if _TIMESTAMP.match(text):
        return _to_timestamp(text)
    if _FLOAT12.match(text):
        return _to_float(text)
    return text


# -- lines -------------------------------------------------------------------


class _Line:
    __slots__ = ("indent", "text", "number")

    def __init__(self, indent: int, text: str, number: int) -> None:
        self.indent, self.text, self.number = indent, text, number


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote: Optional[str] = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
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
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = c
        i += 1
    return text.rstrip()


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    for number, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YAMLError(f"line {number}: tabs are not allowed in indentation")
        stripped = raw.strip()
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            if out or stripped.startswith("%") or stripped == "...":
                raise YAMLError(f"line {number}: several documents or directives are not read")
            continue
        # keep blank and comment lines as empty: a quoted scalar may fold them
        out.append(_Line(len(raw) - len(raw.lstrip(" ")), raw.strip(" "), number))
    return out


# -- flow scalars and collections --------------------------------------------

_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r",
    "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " ",
}  # fmt: skip


def _fold(chunks: List[str]) -> str:
    """Join the lines of a multi-line scalar: one break is a space, each
    empty line a newline."""
    out = chunks[0]
    pending = 0
    for chunk in chunks[1:]:
        if chunk == "":
            pending += 1
            continue
        out += ("\n" * pending if pending else " ") + chunk
        pending = 0
    return out + "\n" * pending if pending else out


class _Flow:
    """A cursor over one scalar or flow collection's text."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def error(self, what: str) -> YAMLError:
        return YAMLError(f"{what} at column {self.pos} of {self.text!r}")

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def node(self, in_flow: bool) -> Any:
        self.skip_space()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            return self.quoted()
        if c in "&*!|>%@`":
            raise self.error(f"{c!r} (anchors, aliases, tags and block scalars are not read)")
        return resolve_plain(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            nxt = self.text[self.pos + 1] if self.pos + 1 < len(self.text) else ""
            if in_flow and c in ",[]{}":
                break
            if c == ":" and (nxt in " \t\n" or nxt == "" or (in_flow and nxt in ",[]{}")):
                break
            self.pos += 1
        return " ".join(self.text[start : self.pos].split())

    def quoted(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        chunks: List[str] = []
        cur = ""
        while True:
            if self.pos >= len(self.text):
                raise self.error("unterminated quoted scalar")
            c = self.text[self.pos]
            if quote == "'" and c == "'":
                if self.peek_at(1) == "'":
                    cur += "'"
                    self.pos += 2
                    continue
                self.pos += 1
                break
            if quote == '"' and c == '"':
                self.pos += 1
                break
            if quote == '"' and c == "\\":
                esc = self.peek_at(1)
                if esc == "\n":  # an escaped line break joins the lines
                    self.pos += 2
                    while self.peek() in (" ", "\t"):
                        self.pos += 1
                    continue
                if esc in ("x", "u", "U"):
                    width = {"x": 2, "u": 4, "U": 8}[esc]
                    cur += chr(int(self.text[self.pos + 2 : self.pos + 2 + width], 16))
                    self.pos += 2 + width
                    continue
                if esc not in _ESCAPES:
                    raise self.error(f"unknown escape \\{esc}")
                cur += _ESCAPES[esc]
                self.pos += 2
                continue
            if c == "\n":
                chunks.append(cur.rstrip(" \t"))
                cur = ""
                self.pos += 1
                while self.peek() in (" ", "\t"):
                    self.pos += 1
                continue
            cur += c
            self.pos += 1
        chunks.append(cur if not chunks else cur.lstrip(" \t"))
        return _fold(chunks) if len(chunks) > 1 else chunks[0]

    def peek_at(self, offset: int) -> str:
        i = self.pos + offset
        return self.text[i] if i < len(self.text) else ""

    def sequence(self) -> list:
        self.pos += 1
        out: list = []
        while True:
            self.skip_space()
            if self.peek() == "]":
                self.pos += 1
                return out
            if self.peek() == "":
                raise self.error("unterminated flow sequence")
            item = self.node(True)
            self.skip_space()
            if self.peek() == ":":  # a single-pair mapping inside a sequence
                self.pos += 1
                item = {item: self.node(True)}
                self.skip_space()
            out.append(item)
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.pos += 1
        out: dict = {}
        while True:
            self.skip_space()
            if self.peek() == "}":
                self.pos += 1
                return out
            if self.peek() == "":
                raise self.error("unterminated flow mapping")
            key = self.node(True)
            self.skip_space()
            value = None
            if self.peek() == ":":
                self.pos += 1
                self.skip_space()
                value = None if self.peek() in (",", "}") else self.node(True)
                self.skip_space()
            out[_hashable(key, self)] = value
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}'")

    def rest_is_empty(self) -> bool:
        self.skip_space()
        return self.pos >= len(self.text)


def _hashable(key: Any, where: Any) -> Any:
    if isinstance(key, (list, dict)):
        raise where.error("a collection as a mapping key is not read")
    return key


def _flow_value(text: str) -> Any:
    cur = _Flow(text)
    value = cur.node(False)
    if not cur.rest_is_empty():
        raise cur.error("unexpected text after the value")
    return value


# -- block structure ---------------------------------------------------------


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """``(key, rest)`` when ``text`` is a block mapping entry ``key: rest``
    (the ``:`` outside quotes and brackets, followed by a space or the end)."""
    if text.startswith(("'", '"')):
        cur = _Flow(text)
        cur.quoted()
        end = cur.pos
        while end < len(text) and text[end] in " \t":
            end += 1
        if end < len(text) and text[end] == ":" and (end + 1 == len(text) or text[end + 1] in " \t"):
            return text[: cur.pos], text[end + 1 :].strip()
        return None
    if text.startswith(("[", "{")):
        return None
    depth = 0
    for i, c in enumerate(text):
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1 :].strip()
    return None


def _is_seq_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: List[_Line]) -> None:
        self.lines = lines
        self.i = 0

    def error(self, what: str) -> YAMLError:
        line = self.lines[min(self.i, len(self.lines) - 1)].number if self.lines else 0
        return YAMLError(f"line {line}: {what}")

    def next_content(self) -> Optional[_Line]:
        """The next line with content (comments stripped), skipping blank
        and comment lines."""
        while self.i < len(self.lines):
            line = self.lines[self.i]
            text = _strip_comment(line.text)
            if text:
                return _Line(line.indent, text, line.number)
            self.i += 1
        return None

    def node(self, indent: int, seq_ok_at_indent: bool = False) -> Any:
        """The block node whose lines are indented more than ``indent`` (or
        an indentless sequence at ``indent`` after a mapping key); ``None``
        when there is none."""
        line = self.next_content()
        if line is None:
            return None
        if line.indent > indent or (seq_ok_at_indent and line.indent == indent and _is_seq_entry(line.text)):
            if _is_seq_entry(line.text):
                return self.sequence(line.indent)
            if _split_key(line.text) is not None:
                return self.mapping(line.indent)
            return self.scalar(indent)
        return None

    def scalar(self, indent: int) -> Any:
        """A scalar or flow collection that starts on the current line and
        runs over the lines indented more than ``indent``."""
        first = self.next_content()
        self.i += 1
        return self.continued(first.text, indent)

    def continued(self, head: str, indent: int) -> Any:
        """``head`` and the continuation lines after it, as one value: a
        quoted scalar or flow collection runs until it closes, keeping its
        line breaks for the flow parser; a plain scalar takes the lines
        indented more than ``indent`` and folds them."""
        if head[:1] in "'\"[{":
            parts = [head]
            while not _closed(parts):
                if self.i >= len(self.lines):
                    raise self.error(f"unterminated flow value {head!r}")
                parts.append(self.lines[self.i].text)
                self.i += 1
            return _flow_value(_strip_flow_comments("\n".join(parts)))
        parts = [head]
        while self.i < len(self.lines):
            line = self.lines[self.i]
            content = _strip_comment(line.text)
            if content and line.indent <= indent:
                break
            if not content:
                # a blank line inside a plain scalar is a newline, but only
                # when more of the scalar follows
                j = self.i + 1
                while j < len(self.lines) and not _strip_comment(self.lines[j].text):
                    j += 1
                if j >= len(self.lines) or self.lines[j].indent <= indent:
                    break
            elif _split_key(content) is not None or _is_seq_entry(content):
                raise self.error(f"unexpected mapping or sequence entry in a plain scalar: {content!r}")
            parts.append(content)
            self.i += 1
        if len(parts) == 1:
            return _flow_value(head)
        return resolve_plain(_fold([p.strip() for p in parts]))

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.next_content()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise self.error(f"bad indentation of a mapping entry: {line.text!r}")
            if _is_seq_entry(line.text):
                return out
            split = _split_key(line.text)
            if split is None:
                raise self.error(f"expected 'key: value', got {line.text!r}")
            key_text, rest = split
            # a repeated key keeps its last value, as in PyYAML
            key = _hashable(_flow_value(key_text), self)
            self.i += 1
            if rest:
                out[key] = self.continued(rest, indent)
            else:
                out[key] = self.node(indent, seq_ok_at_indent=True)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.next_content()
            if line is None or line.indent < indent or not _is_seq_entry(line.text) or line.indent > indent:
                if line is not None and line.indent > indent:
                    raise self.error(f"bad indentation of a sequence entry: {line.text!r}")
                return out
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.node(indent))
                continue
            # the entry's content starts on this line, at this column: parse
            # it as a block node by rewriting the line in place
            raw = self.lines[self.i]
            raw_rest = raw.text[1:].lstrip(" ")
            column = indent + len(raw.text) - len(raw_rest)
            self.lines[self.i] = _Line(column, raw_rest, raw.number)
            if _is_seq_entry(rest):
                out.append(self.sequence(column))
            elif _split_key(rest) is not None:
                out.append(self.mapping(column))
            else:
                self.i += 1
                out.append(self.continued(rest, indent))


def _closed(parts: List[str]) -> bool:
    """Whether the flow value in ``parts`` is complete (quotes closed and
    brackets balanced)."""
    try:
        _flow_value(_strip_flow_comments("\n".join(parts)))
        return True
    except YAMLError:
        return False


def _strip_flow_comments(text: str) -> str:
    return "\n".join(_strip_comment(line) if line.strip() else "" for line in text.split("\n"))


def load(text: str) -> Any:
    """The value of a YAML document, as ``_yaml_load`` (PyYAML's
    ``SafeLoader`` plus the 1.2 float resolver) reads it; ``None`` for an
    empty one."""
    block = _Block(_lines(text))
    first = block.next_content()
    if first is None:
        return None
    value = block.node(first.indent - 1)
    rest = block.next_content()
    if rest is not None:
        raise YAMLError(f"line {rest.number}: unexpected content {rest.text!r}")
    return value
