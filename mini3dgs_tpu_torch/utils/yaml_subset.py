"""The subset of YAML that the training configs use, without PyYAML.

`loads` reads nested block mappings (by indentation), `#` comments, quoted
and plain scalars and inline lists such as `[1.0, 1.0, 1.0]`, and resolves
plain scalars as PyYAML's `safe_load` does (YAML 1.1): an int is decimal, a
float needs a dot (`1e-5` stays a string, `1.0e-5` is a float), `yes` /
`no` / `on` / `off` are bools, `~` / `null` / nothing is None.  Anything
outside the subset (block sequences, flow mappings, anchors, tags, block
scalars, octal or hex ints, several documents) raises ValueError.  `dumps`
writes a flat mapping that `loads` and PyYAML read back to the same dict.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
# Plain scalars PyYAML would read as a type the subset does not carry.
_OUTSIDE = re.compile(r"^(?:[-+]?0[0-7_]+|[-+]?0[xXbB][0-9a-fA-F_]+"
                      r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")
_SPECIAL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On",
                     "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                     "Off", "OFF"), False),
    **dict.fromkeys(("", "~", "null", "Null", "NULL"), None),
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"),
                    math.inf),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), -math.inf),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), math.nan),
}


def _fail(lineno: int, why: str):
    raise ValueError(f"line {lineno}: {why} (outside the YAML subset the "
                     "configs use)")


def _strip_comment(line: str) -> str:
    """The line without a ` #` comment that is not inside quotes."""
    quote, escaped = None, False
    for i, ch in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif ch == "\\" and quote == '"':
                escaped = True
            elif ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str, lineno: int) -> str:
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            _fail(lineno, f"unterminated string {text!r}")
        return text[1:-1].replace("''", "'")
    if len(text) < 2 or text[-1] != '"':
        _fail(lineno, f"unterminated string {text!r}")
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        _fail(lineno, f"escape in {text!r}")


def _scalar(text: str, lineno: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text, lineno)
    if text in _SPECIAL:
        return _SPECIAL[text]
    if (text[0] in "&*!|>{}[]%@`" or text in ("-", "?")
            or text.startswith(("- ", "? ")) or ": " in text
            or text.endswith(":")):
        _fail(lineno, f"value {text!r}")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OUTSIDE.match(text):
        _fail(lineno, f"value {text!r}")
    return text


def _split_items(body: str, lineno: int) -> List[str]:
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            _fail(lineno, "nested flow collection")
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if quote:
        _fail(lineno, "unterminated string")
    items.append(cur)
    if items[-1].strip() == "":
        items.pop()  # a trailing comma
    if any(s.strip() == "" for s in items):
        _fail(lineno, "empty list item")
    return items


def _value(text: str, lineno: int) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            _fail(lineno, "a list continued on the next line")
        return [_scalar(s, lineno) for s in _split_items(text[1:-1], lineno)]
    return _scalar(text, lineno)


def _key_value(text: str, lineno: int) -> Tuple[str, str]:
    """(plain key, the rest of the line after ': ')."""
    m = re.search(r":(?:\s|$)", text)
    if m is None:
        _fail(lineno, f"{text!r} is not 'key: value'")
    key, rest = text[:m.start()].strip(), text[m.end():]
    if key == "" or key[0] in "-?&*!|>[]{}%@`'\"":
        _fail(lineno, f"key {key!r}")
    return key, rest.strip()


def loads(text: str) -> Any:
    """Parse a document of the subset; an empty document gives None."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _fail(lineno, "a tab in the indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.startswith(("---", "...", "%")):
            _fail(lineno, "a document marker or directive")
        lines.append((lineno, len(line) - len(line.lstrip(" ")),
                      line.strip()))
    if not lines:
        return None
    root: dict = {}
    stack = [(-1, root)]          # (indent of the mapping's keys, mapping)
    pending = None                # (indent, mapping, key) awaiting a block
    for lineno, indent, body in lines:
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_map[p_key] = child
                stack.append((indent, child))
            else:
                p_map[p_key] = None
        if stack[0][0] == -1:
            stack[0] = (indent, root)  # the first key sets the root's indent
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            _fail(lineno, "indentation that matches no mapping")
        if body.startswith("- ") or body == "-":
            _fail(lineno, "a block sequence")
        key, rest = _key_value(body, lineno)
        mapping = stack[-1][1]
        if key in mapping:
            _fail(lineno, f"duplicate key {key!r}")
        if rest == "":
            pending = (indent, mapping, key)
        else:
            mapping[key] = _value(rest, lineno)
    if pending is not None:
        pending[1][pending[2]] = None
    return root


def _dump_scalar(v: Any) -> str:
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
        r = repr(v).lower()
        if "." not in r:  # 1e-05 would read back as a string
            r = r.replace("e", ".0e", 1) if "e" in r else r + ".0"
        if "e" in r and r[r.index("e") + 1] not in "+-":
            r = r.replace("e", "e+", 1)
        return r
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r}")


def dumps(data: dict) -> str:
    """A flat mapping of scalars and lists of scalars as `key: value`
    lines."""
    out = []
    for k, v in data.items():
        if isinstance(v, (list, tuple)):
            text = "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
        elif isinstance(v, dict):
            raise TypeError(f"{k}: nested mappings are not written")
        else:
            text = _dump_scalar(v)
        if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", k):
            raise ValueError(f"key {k!r} is not a plain identifier")
        out.append(f"{k}: {text}")
    return "\n".join(out) + "\n"
