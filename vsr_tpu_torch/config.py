"""Attribute-access configuration tree loaded from YAML (port of
``vsr_tpu/config.py``).

``Config`` is the same nested dict with attribute access. ``load_config`` and
``save_config`` read and write the YAML subset the repo's configs use with a
reader of the port's own (the port does not depend on pyyaml): block mappings
and sequences, flow mappings and sequences (also over several lines),
comments, and the YAML 1.1 scalars as ``yaml.safe_load`` resolves them: ints,
floats (``0.0001``, ``1.0e-4``; ``1e-4`` has no dot and stays a string),
booleans, ``null``, quoted and plain strings. Anything else (anchors, tags,
block scalars, multi-line scalars, several documents) raises with the line
number. The same YAML section schema applies (``main / dataset / dataloader /
net / losses / metrics / optimizer / [lr_scheduler] / logger / monitor /
trainer``, each ``{name, kwargs}``).
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path
from typing import Any, Iterator, Mapping


class Config(dict):
    """A dict with attribute access, recursively wrapping nested mappings.

    Attribute reads mirror item reads, missing attributes raise
    ``AttributeError`` (so ``getattr(cfg, 'lr_scheduler', None)`` works), and
    ``get``/``setdefault`` behave like ``dict``.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict[str, Any] = {}
        if data is not None:
            merged.update(data)
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Config has no attribute {key!r}; available: {sorted(self.keys())}"
            ) from None

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key) from None

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        other = dict(*args, **kwargs)
        for key, value in other.items():
            self[key] = value

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self:
            self[key] = default
        return self[key]

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> dict[str, Any]:
        def unwrap(value: Any) -> Any:
            if isinstance(value, Config):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [unwrap(v) for v in value]
            return value

        return {k: unwrap(v) for k, v in self.items()}

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config(copy.deepcopy(self.to_dict(), memo))

    def __iter__(self) -> Iterator[str]:
        return super().__iter__()

    def __repr__(self) -> str:
        return f"Config({dict.__repr__(self)})"


# ------------------------------------------------------------- YAML reader


class YamlError(ValueError):
    """The text is outside the YAML subset this reader takes."""


# YAML 1.1 resolution of a plain scalar, as ``yaml.safe_load`` does it.
_BOOLS = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                               "on", "On", "ON")},
          **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                                "off", "Off", "OFF")}}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# Other YAML 1.1 number forms (binary, octal, hex, sexagesimal): refused.
_EXOTIC_NUMBER = re.compile(
    r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
    r"|[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\"}


def _resolve_plain(text: str, lineno: int) -> Any:
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _EXOTIC_NUMBER.fullmatch(text):
        raise YamlError(f"line {lineno}: number form {text!r} is not supported "
                        "(write it in decimal)")
    if text[0] in "&*!|>%@`":
        raise YamlError(f"line {lineno}: anchors, aliases, tags and block "
                        f"scalars are not supported ({text!r})")
    return text


def _scan_quoted(text: str, pos: int, lineno: int) -> tuple[str, int]:
    """The quoted string that starts at ``text[pos]``; returns (value, index
    after the closing quote)."""
    quote, out, i = text[pos], [], pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
        elif ch == '"':
            return "".join(out), i + 1
        elif ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise YamlError(f"line {lineno}: escape \\{esc} is not supported")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YamlError(f"line {lineno}: a quoted string does not end on its line")


def _strip_comment(line: str, lineno: int) -> str:
    """``line`` without its trailing comment (a ``#`` at the start or after
    white space, outside quotes) and trailing white space."""
    i = 0
    while i < len(line):
        ch = line[i]
        # A quote opens a string only where a scalar may start.
        if ch in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            _, i = _scan_quoted(line, i, lineno)
            continue
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Recursive-descent parser of one flow collection (``{...}``/``[...]``)."""

    def __init__(self, text: str, lineno: int):
        self.text, self.pos, self.lineno = text, 0, lineno

    def _skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def _peek(self) -> str:
        self._skip()
        return self.text[self.pos:self.pos + 1]

    def _expect(self, ch: str) -> None:
        if self._peek() != ch:
            raise YamlError(f"line {self.lineno}: expected {ch!r} in flow "
                            f"collection at {self.text[self.pos:][:20]!r}")
        self.pos += 1

    def parse(self) -> Any:
        value = self.value()
        if self._peek():
            raise YamlError(f"line {self.lineno}: text after the flow "
                            f"collection: {self.text[self.pos:]!r}")
        return value

    def value(self) -> Any:
        ch = self._peek()
        if ch == "{":
            return self.mapping()
        if ch == "[":
            return self.sequence()
        return self.scalar()

    def scalar(self) -> Any:
        ch = self._peek()
        if ch in ("'", '"'):
            value, self.pos = _scan_quoted(self.text, self.pos, self.lineno)
            return value
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in ",]}[{\n" or (c == ":" and self.text[self.pos + 1:self.pos + 2]
                                  in (" ", "", "\n")):
                break
            self.pos += 1
        return _resolve_plain(self.text[start:self.pos].strip(), self.lineno)

    def mapping(self) -> dict:
        self._expect("{")
        out: dict = {}
        while self._peek() != "}":
            key = self.scalar()
            if isinstance(key, (dict, list)) or key is None:
                raise YamlError(f"line {self.lineno}: bad key in flow mapping")
            self._expect(":")
            if self._peek() in (",", "}"):
                out[key] = None
            else:
                out[key] = self.value()
            if self._peek() == ",":
                self.pos += 1
            elif self._peek() != "}":
                raise YamlError(f"line {self.lineno}: expected ',' or '}}' in "
                                "flow mapping")
        self.pos += 1
        return out

    def sequence(self) -> list:
        self._expect("[")
        out: list = []
        while self._peek() != "]":
            out.append(self.value())
            if self._peek() == ",":
                self.pos += 1
            elif self._peek() != "]":
                raise YamlError(f"line {self.lineno}: expected ',' or ']' in "
                                "flow sequence")
        self.pos += 1
        return out


def _flow_depth(text: str, lineno: int) -> int:
    """Open brackets minus closed ones, outside quotes."""
    depth, i = 0, 0
    while i < len(text):
        ch = text[i]
        if ch in "'\"":
            _, i = _scan_quoted(text, i, lineno)
            continue
        depth += ch in "[{"
        depth -= ch in "]}"
        i += 1
    return depth


def _split_key(body: str, lineno: int) -> tuple[Any, str] | None:
    """``key: rest`` -> (key, rest); None where the line is no mapping
    entry."""
    if body[0] in "'\"":
        key, end = _scan_quoted(body, 0, lineno)
        tail = body[end:].lstrip(" ")
        if not tail.startswith(":") or tail[1:2] not in ("", " "):
            return None
        return key, tail[1:].strip()
    if body[0] in "[{":
        return None
    if body.startswith("? "):
        raise YamlError(f"line {lineno}: complex keys are not supported")
    m = re.search(r":(?: |$)", body)
    if not m:
        return None
    return _resolve_plain(body[:m.start()].rstrip(), lineno), body[m.end():].strip()


class _Block:
    """Indentation parser over the file's lines."""

    def __init__(self, text: str):
        self.lines: list[tuple[int, int, str]] = []  # (lineno, indent, text)
        for lineno, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise YamlError(f"line {lineno}: tab in the indentation")
            body = _strip_comment(body, lineno)
            if not body:
                continue
            if body in ("---", "...") or body.startswith(("--- ", "%")):
                raise YamlError(f"line {lineno}: document markers and "
                                "directives are not supported")
            self.lines.append((lineno, len(raw) - len(raw.lstrip(" ")), body))
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0][1])
        if self.i < len(self.lines):
            lineno, _, body = self.lines[self.i]
            raise YamlError(f"line {lineno}: unexpected text {body!r}")
        return value

    def node(self, indent: int) -> Any:
        lineno, ind, body = self.lines[self.i]
        if ind != indent:
            raise YamlError(f"line {lineno}: unexpected indentation")
        if body == "-" or body.startswith("- "):
            return self.sequence(indent)
        if body[0] in "[{":
            self.i += 1
            return self.inline(body, lineno, indent)
        if _split_key(body, lineno) is not None:
            return self.mapping(indent)
        raise YamlError(f"line {lineno}: a top-level scalar or a multi-line "
                        f"scalar is not supported ({body!r})")

    def inline(self, text: str, lineno: int, indent: int) -> Any:
        """The value written on a line after ``key:`` or ``-``: a flow
        collection (continued over the next lines until it closes) or a
        scalar."""
        if text[0] in "[{":
            while _flow_depth(text, lineno) > 0:
                if self.i >= len(self.lines):
                    raise YamlError(f"line {lineno}: flow collection never "
                                    "closes")
                text += "\n" + self.lines[self.i][2]
                self.i += 1
            return _Flow(text, lineno).parse()
        if text[0] in "'\"":
            value, end = _scan_quoted(text, 0, lineno)
            if text[end:].strip():
                raise YamlError(f"line {lineno}: text after a quoted scalar")
        else:
            value = _resolve_plain(text, lineno)
        if self.i < len(self.lines) and self.lines[self.i][1] > indent:
            raise YamlError(f"line {self.lines[self.i][0]}: multi-line "
                            "scalars are not supported")
        return value

    def child(self, parent_indent: int, allow_same_indent_seq: bool) -> Any:
        """The block under a ``key:`` (or ``-``) that has no inline value:
        a deeper block, a sequence at the key's own indent, or null."""
        if self.i >= len(self.lines):
            return None
        _, ind, body = self.lines[self.i]
        if ind > parent_indent:
            return self.node(ind)
        if (allow_same_indent_seq and ind == parent_indent
                and (body == "-" or body.startswith("- "))):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            lineno, ind, body = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(f"line {lineno}: unexpected indentation")
            if body == "-" or body.startswith("- "):
                break
            entry = _split_key(body, lineno)
            if entry is None:
                raise YamlError(f"line {lineno}: expected 'key: value', got "
                                f"{body!r}")
            key, rest = entry
            if key is None or key in out:
                raise YamlError(f"line {lineno}: empty or duplicate key "
                                f"{key!r}")
            self.i += 1
            out[key] = (self.inline(rest, lineno, indent) if rest
                        else self.child(indent, True))
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            lineno, ind, body = self.lines[self.i]
            if ind != indent or not (body == "-" or body.startswith("- ")):
                if ind > indent:
                    raise YamlError(f"line {lineno}: unexpected indentation")
                break
            rest = body[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.child(indent, False))
            elif _split_key(rest, lineno) is not None:
                # "- key: value": a mapping whose keys sit at the column
                # after the dash.
                inner = indent + len(body) - len(rest)
                self.lines[self.i] = (lineno, inner, rest)
                out.append(self.mapping(inner))
            elif rest == "-" or rest.startswith("- "):
                inner = indent + len(body) - len(rest)
                self.lines[self.i] = (lineno, inner, rest)
                out.append(self.sequence(inner))
            else:
                self.i += 1
                out.append(self.inline(rest, lineno, indent))
        return out


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    return _Block(text).parse()


# ------------------------------------------------------------- YAML writer

_PLAIN_SAFE = re.compile(r"[A-Za-z_/][A-Za-z0-9_/.+-]*(?: [A-Za-z0-9_/.+-]+)*")


def _dump_scalar(value: Any) -> str:
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        value = value.item()  # numpy scalars
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text:  # YAML 1.1 floats need a dot and a signed exponent
            mantissa, exponent = text.split("e")
            if "." not in mantissa:
                mantissa += ".0"
            if exponent[0] not in "+-":
                exponent = "+" + exponent
            text = f"{mantissa}e{exponent}"
        return text
    if isinstance(value, Path):
        value = str(value)
    if not isinstance(value, str):
        raise TypeError(f"cannot write {type(value).__name__} to YAML")
    if _PLAIN_SAFE.fullmatch(value) and isinstance(_resolve_plain(value, 0), str):
        return value
    if "\n" in value or "\\" in value or any(ord(c) < 32 for c in value):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        for char, name in (("\n", "n"), ("\t", "t"), ("\r", "r")):
            escaped = escaped.replace(char, "\\" + name)
        if any(ord(c) < 32 for c in escaped):
            raise ValueError(f"cannot write control characters to YAML: {value!r}")
        return f'"{escaped}"'
    return "'" + value.replace("'", "''") + "'"


def _dump(value: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, Mapping):
        for key, item in value.items():
            head = f"{pad}{_dump_scalar(key)}:"
            if isinstance(item, Mapping) and item or (
                    isinstance(item, (list, tuple)) and item):
                out.append(head)
                _dump(item, indent + 2, out)
            else:
                out.append(f"{head} {_dump_leaf(item)}")
    else:
        for item in value:
            if isinstance(item, Mapping) and item:
                lines: list[str] = []
                _dump(item, indent + 2, lines)
                out.append(f"{pad}- {lines[0][indent + 2:]}")
                out.extend(lines[1:])
            elif isinstance(item, (list, tuple)) and item:
                out.append(f"{pad}-")
                _dump(item, indent + 2, out)
            else:
                out.append(f"{pad}- {_dump_leaf(item)}")


def _dump_leaf(item: Any) -> str:
    if isinstance(item, Mapping):
        return "{}"
    if isinstance(item, (list, tuple)):
        return "[]"
    return _dump_scalar(item)


def dumps(data: Mapping[str, Any]) -> str:
    """Block-style YAML of a nested dict / list / scalar tree (key order
    kept), readable by this module's reader and by any YAML 1.1 parser."""
    if not data:
        return "{}\n"
    out: list[str] = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"


def load_config(path: str | Path) -> Config:
    """Load a YAML file into a :class:`Config` tree."""
    with open(path, "r") as f:
        data = loads(f.read())
    if data is None:
        data = {}
    if not isinstance(data, Mapping):
        raise TypeError(f"Top-level YAML in {path} must be a mapping, got {type(data)}")
    return Config(data)


def save_config(config: Config | Mapping[str, Any], path: str | Path) -> None:
    """Persist a config next to experiment results."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = config.to_dict() if isinstance(config, Config) else dict(config)
    with open(path, "w") as f:
        f.write(dumps(data))
