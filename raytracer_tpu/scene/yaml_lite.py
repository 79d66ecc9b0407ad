"""A reader for the subset of YAML that scene files use.

Block sequences and mappings (a sequence may sit at its key's indent),
one-line flow sequences and mappings (``[a, [b, c]]``, ``{k: v}``), plain
and quoted scalars, and ``#`` comments. Scalars resolve as PyYAML's safe
loader resolves them: ints, floats with a dot (``1e5`` stays a string),
booleans, null, everything else a string. Anchors, tags, multi-line
scalars and multi-document streams are not scene syntax and raise.
"""

from __future__ import annotations

import re

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|[-+]?\.(inf|Inf|INF)$|\.(nan|NaN|NAN)$"
)
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}


class YamlError(ValueError):
    pass


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1].replace("''", "'") if t[0] == "'" else t[1:-1]
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "-.", "+."):
        low = t.lower()
        if low.endswith("inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(t.replace("_", ""))
    if t[:1] in "&*!|>%@`":
        raise YamlError(f"unsupported YAML syntax: {t!r}")
    return t


def _split_top(text: str, sep: str) -> list:
    """Split on ``sep`` outside brackets and quotes."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def _key_split(text: str):
    """(key, rest) for a ``key: rest`` line, else None."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (
                i + 1 == len(text) or text[i + 1] == " "):
            return _scalar(text[:i]), text[i + 1:].strip()
    return None


def _value(text: str):
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise YamlError(f"unclosed flow sequence: {t!r}")
        inner = t[1:-1].strip()
        return [_value(p) for p in _split_top(inner, ",")] if inner else []
    if t.startswith("{"):
        if not t.endswith("}"):
            raise YamlError(f"unclosed flow mapping: {t!r}")
        inner = t[1:-1].strip()
        out = {}
        for p in _split_top(inner, ",") if inner else []:
            kv = _key_split(p.strip()) or (_scalar(p), "")
            out[kv[0]] = _value(kv[1])
        return out
    return _scalar(t)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def safe_load(text: str):
    """The scene-file subset of ``yaml.safe_load``."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs in indentation")
        line = _strip_comment(raw).rstrip()
        if line.strip() in ("---", "..."):
            continue
        if line.strip():
            lines.append([len(line) - len(line.lstrip()), line.strip()])
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlError(f"unexpected indentation: {lines[i][1]!r}")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i, indent):
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].lstrip()
        if not rest:
            i += 1
            if i < len(lines) and lines[i][0] > indent:
                item, i = _block(lines, i, lines[i][0])
            else:
                item = None
        elif _is_item(rest) or (_key_split(rest) is not None
                                and rest[0] not in "[{"):
            # an item whose block starts on the dash's line: re-read the
            # line from the column where that block starts
            col = indent + len(lines[i][1]) - len(rest)
            lines[i] = [col, rest]
            item, i = _block(lines, i, col)
        else:
            item, i = _value(rest), i + 1
        out.append(item)
    return out, i


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _key_split(lines[i][1])
        if kv is None:
            raise YamlError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i
