"""Reader and writer for the YAML subset this package uses.

The config tree under ``conf/`` and the MLflow-style ``meta.yaml`` files are
plain YAML: block mappings and sequences (including the indentless
``- item`` form under a key), flow lists and mappings (``[a, b]``, ``{}``),
single- and double-quoted strings, comments, and plain scalars resolved by
the YAML 1.1 rules PyYAML's ``safe_load`` applies (so ``1.0e-6`` is a float
while ``1e-9`` stays a string, exactly as there). Anchors, tags, block
scalars (``|``/``>``) and multi-document streams are not supported and raise
``YamlError``.

``dump`` writes block style that both this reader and PyYAML read back to
the same value.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

__all__ = ["YamlError", "load", "dump", "parse_scalar"]


class YamlError(ValueError):
    pass


_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_BOOL_SPELLINGS = {v for k in _BOOL for v in (k, k.capitalize(), k.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT_RE = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF_RE = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN_RE = re.compile(r"\.(?:nan|NaN|NAN)")


def parse_scalar(text: str) -> Any:
    """Resolve one plain (unquoted) scalar the way PyYAML's safe_load does."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _BOOL_SPELLINGS:
        return _BOOL[s.lower()]
    if _INT_RE.fullmatch(s):
        return int(s.replace("_", ""))
    if _FLOAT_RE.fullmatch(s):
        return float(s.replace("_", ""))
    m = _INF_RE.fullmatch(s)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN_RE.fullmatch(s):
        return math.nan
    return s


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """Drop a trailing ``# ...`` comment that is outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str) -> Tuple[str, str] | None:
    """Split ``key: value`` at the first ``:`` followed by a space or the end
    of the line, outside quotes and flow brackets; None if there is none."""
    quote = None
    depth = 0
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or content[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(content)
                                           or content[i + 1] == " "):
            return content[:i].strip(), content[i + 1:].strip()
    return None


def _value(text: str) -> Any:
    """Parse an inline value: quoted, flow collection or plain scalar."""
    text = text.strip()
    if text[:1] in ("|", ">", "&", "*", "!"):
        raise YamlError(f"unsupported YAML construct: {text!r}")
    if text[:1] in ("[", "{", "'", '"'):
        val, pos = _flow(text, 0)
        if text[pos:].strip():
            raise YamlError(f"trailing text after value: {text!r}")
        return val
    return parse_scalar(text)


def _flow(text: str, pos: int) -> Tuple[Any, int]:
    """Recursive-descent parse of a flow node starting at ``pos``."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos >= len(text):
        return None, pos
    ch = text[pos]
    if ch == '"':
        end = pos + 1
        while end < len(text) and text[end] != '"':
            end += 2 if text[end] == "\\" else 1
        if end >= len(text):
            raise YamlError(f"unterminated string: {text!r}")
        return json.loads(text[pos:end + 1]), end + 1
    if ch == "'":
        out, end = [], pos + 1
        while True:
            nxt = text.find("'", end)
            if nxt < 0:
                raise YamlError(f"unterminated string: {text!r}")
            out.append(text[end:nxt])
            if text[nxt + 1:nxt + 2] == "'":
                out.append("'")
                end = nxt + 2
                continue
            return "".join(out), nxt + 1
    if ch in "[{":
        close = "]" if ch == "[" else "}"
        items: list = []
        mapping: dict = {}
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise YamlError(f"unterminated flow collection: {text!r}")
            if text[pos] == close:
                return (items if ch == "[" else mapping), pos + 1
            key, pos = _flow(text, pos)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if ch == "{":
                if text[pos:pos + 1] != ":":
                    raise YamlError(f"flow mapping needs 'key: value': {text!r}")
                val, pos = _flow(text, pos + 1)
                mapping[key] = val
            else:
                items.append(key)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] != close:
                raise YamlError(f"expected ',' or {close!r}: {text!r}")
    end = pos
    while end < len(text) and text[end] not in ",]}" and not (
            text[end] == ":" and text[end + 1:end + 2] in (" ", "")):
        end += 1
    return parse_scalar(text[pos:end]), end


def _block(lines: List[list], i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block node whose lines start at ``i`` with ``indent``."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:]
            body = rest.lstrip(" ")
            if not body:
                i += 1
                if i < len(lines) and lines[i][0] > indent:
                    val, i = _block(lines, i, lines[i][0])
                else:
                    val = None
            elif _split_key(body) is not None and body[:1] not in "[{'\"":
                # "- key: value" opens a mapping at the item's column
                lines[i] = [indent + 1 + len(rest) - len(body), body]
                val, i = _block(lines, i, lines[i][0])
            else:
                val = _value(body)
                i += 1
            seq.append(val)
        return seq, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        if content == "-" or content.startswith("- "):
            break
        kv = _split_key(content)
        if kv is None:
            raise YamlError(f"expected 'key: value', got {content!r}")
        key_text, val_text = kv
        key = _value(key_text) if key_text[:1] in "'\"" else \
            parse_scalar(key_text)
        i += 1
        if val_text:
            mapping[key] = _value(val_text)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-"
                                           or lines[i][1].startswith("- ")))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    return mapping, i


def load(text: str) -> Any:
    """Parse a YAML document of the supported subset (see module doc)."""
    lines: List[list] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs are not allowed in YAML indentation")
        content = _strip_comment(raw).strip()
        if not content or content == "---":
            continue
        if content.startswith(("%", "...")):
            raise YamlError(f"unsupported YAML construct: {content!r}")
        lines.append([len(raw) - len(raw.lstrip(" ")), content])
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None and \
            not lines[0][1].startswith("- "):
        return _value(lines[0][1])
    val, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlError(f"bad indentation near {lines[i][1]!r}")
    return val


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _scalar_text(v: Any) -> str:
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
        r = repr(v)
        mant, e, exp = r.partition("e")
        if "." not in mant:
            mant += ".0"  # YAML 1.1 floats need a dot
        return mant + (e + exp if e else "")
    s = str(v)
    plain = (s == s.strip() and s != ""
             and parse_scalar(s) == s
             and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
             and not any(c in s for c in ",[]{}\n")
             and ": " not in s and " #" not in s and not s.endswith(":"))
    return s if plain else json.dumps(s)


def _flow_text(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar_text(k)}: {_flow_text(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_text(x) for x in v) + "]"
    return _scalar_text(v)


def _emit(data: dict, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for k in sorted(data, key=str):
        v = data[k]
        key = _scalar_text(k)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{key}:")
            _emit(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and v:
            out.append(f"{pad}{key}:")
            out.extend(f"{pad}- {_flow_text(x)}" for x in v)
        else:
            out.append(f"{pad}{key}: {_flow_text(v)}")


def dump(data: dict) -> str:
    """Block-style YAML for a mapping, keys sorted (like yaml.safe_dump)."""
    if not isinstance(data, dict):
        raise YamlError("dump() takes a mapping")
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"
