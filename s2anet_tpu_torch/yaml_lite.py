"""The YAML the repository's config files use, without pyyaml.

:func:`load` reads block maps nested by indentation (``configs/*.yaml`` use
two levels), ``key: value`` scalars, flow lists ``[a, b]`` and flow maps
``{k: v}`` (nestable), and ``#`` comments. Scalars resolve as
``yaml.safe_load`` (YAML 1.1) resolves them: ``null``/``~``/empty,
booleans (``true``, ``yes``, ``on``, ... in their three spellings),
decimal integers, floats (a dot required; ``1e-4`` stays a string, as
there), ``.inf``/``.nan``, and quoted or plain strings. Block lists
(``- item``), anchors, tags and multi-line strings are not read: a file
that needs them raises.

:func:`dump` writes a tree of maps, lists, tuples and scalars that both
:func:`load` and ``yaml.safe_load`` read back to the same values (tuples
as lists): block maps, flow lists, floats always with a dot or as
``.inf``/``.nan``, and every string single-quoted.
"""

from __future__ import annotations

import math
import re

_BOOL = {v: b for b, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
         for w in words for v in (w, w.capitalize(), w.upper())}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _strip_comment(line: str) -> str:
    """``line`` up to a ``#`` that starts a comment (at the start of the
    line or after white space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return t[1:-1].encode().decode("unicode_escape")
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    m = _INF.match(t)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(t):
        return math.nan
    if t[:1] in "[]{}&*!|>-%@`" and t not in ("-",):
        raise ValueError(f"yaml_lite: unsupported value {t!r}")
    return t


def _split_top(text: str):
    """Split at the commas outside brackets and quotes."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return [p for p in parts if p.strip()]


def _key_value(text: str):
    """``key: value`` -> (key, value text); the colon must be followed by
    white space or end the text."""
    m = re.match(r"\s*('[^']*'|\"[^\"]*\"|[^:'\"]+?)\s*:(?:\s+|$)(.*)$", text, re.S)
    if m is None:
        raise ValueError(f"yaml_lite: not a 'key: value' entry: {text!r}")
    return _scalar(m.group(1)), m.group(2).strip()


def _value(text: str):
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"yaml_lite: unclosed list {t!r}")
        return [_value(p) for p in _split_top(t[1:-1])]
    if t.startswith("{"):
        if not t.endswith("}"):
            raise ValueError(f"yaml_lite: unclosed map {t!r}")
        return {k: _value(v) for k, v in map(_key_value, _split_top(t[1:-1]))}
    return _scalar(t)


def _block(lines, i: int, indent: int):
    """The block map whose keys sit at ``indent``, from line i on."""
    out = {}
    while i < len(lines):
        ind, body = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"yaml_lite: bad indentation at {body!r}")
        key, rest = _key_value(body)
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load(text: str):
    """The document in ``text``: a map (``None`` when it holds nothing)."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lead = line[: len(line) - len(line.lstrip())]
            if "\t" in lead:
                raise ValueError("yaml_lite: tab indentation")
            lines.append((len(lead), line.strip()))
    if not lines:
        return None
    tree, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"yaml_lite: bad indentation at {lines[i][1]!r}")
    return tree


def _dump_scalar(v) -> str:
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
        if "." not in r:  # 1e-05 -> 1.0e-05: safe_load wants the dot
            m, _, e = r.partition("e")
            r = f"{m}.0e{e}" if e else f"{m}.0"
        return r
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    raise TypeError(f"yaml_lite: cannot write {type(v).__name__}")


def dump(tree: dict, indent: int = 0) -> str:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.append(" " * indent + f"{k}:\n" + dump(v, indent + 2))
        else:
            out.append(" " * indent + f"{k}: " + ("{}" if isinstance(v, dict)
                                                   else _dump_scalar(v)) + "\n")
    return "".join(out)
