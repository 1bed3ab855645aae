"""Scenario configs with attribute access, read without pyyaml.

Counterpart of gym_pybullet_adrp_tpu.utils.config. The machine the port
runs on has no pyyaml, so ``configs/*.yaml`` are read by a small reader
for the YAML subset they use: block maps by indentation, ``- item`` block
lists, flow lists ``[a, b]``, quoted strings, booleans, decimal integers
and floats (``-0.000001``), and ``#`` comments. Scalars resolve as
pyyaml's YAML 1.1 resolver does (a float needs a dot, so ``1e-6`` stays
a string there and here); ``tests/test_torch_config.py`` holds the reader
equal to ``yaml.safe_load`` on every bundled config.
"""

import re
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent.parent / "configs"

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {
    "true": True, "True": True, "TRUE": True, "yes": True, "Yes": True,
    "YES": True, "on": True, "On": True, "ON": True,
    "false": False, "False": False, "FALSE": False, "no": False,
    "No": False, "NO": False, "off": False, "Off": False, "OFF": False,
}
_NULL = {"", "~", "null", "Null", "NULL"}


class AttrDict(dict):
    """dict with attribute-style access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def convert(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.convert(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.convert(v) for v in obj]
        return obj


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is outside quotes and starts a token."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok) and tok not in (".", "-.", "+."):
        return float(tok.replace("_", ""))
    return tok


def _split_flow(body: str):
    """Split the inside of a flow list at top-level commas."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [s for s in items if s.strip()]


def _value(tok: str):
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]"):
            raise ValueError(f"unterminated flow list: {tok!r}")
        return [_value(s) for s in _split_flow(tok[1:-1])]
    return _scalar(tok)


def _split_key(content: str):
    """``key: rest`` -> (key, rest); None when the line is not a map entry."""
    m = re.match(r"^([^\s:\[\]\"'][^:]*?|\"[^\"]*\"|'[^']*'):(\s+|$)(.*)$",
                 content)
    if not m:
        return None
    key = m.group(1).strip()
    if key[0] in "\"'":
        key = key[1:-1]
    return key, m.group(3)


def _parse_block(lines, i, indent):
    """Parse the block starting at ``lines[i]`` (all at ``indent``)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            item = lines[i][1][1:].strip()
            i += 1
            if item:
                out.append(_value(item))
            elif i < len(lines) and lines[i][0] > indent:
                val, i = _parse_block(lines, i, lines[i][0])
                out.append(val)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"not a map entry: {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest.strip():
            out[_scalar(key)] = _value(rest)
        elif i < len(lines) and (
                lines[i][0] > indent
                or (lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[_scalar(key)], i = _parse_block(lines, i, lines[i][0])
        else:
            out[_scalar(key)] = None
    return out, i


def parse_yaml(text: str):
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw.replace("\t", "    "))
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[i][1]!r}")
    return value


def load_config(path) -> AttrDict:
    """Load a scenario config by path or by the bare name of a bundled
    config (e.g. "getting_started" or "level2.yaml")."""
    p = Path(path)
    if not p.exists():
        candidate = CONFIG_DIR / (p.name if p.suffix else p.name + ".yaml")
        if candidate.exists():
            p = candidate
        else:
            raise FileNotFoundError(f"config not found: {path}")
    return AttrDict.convert(parse_yaml(p.read_text()))
