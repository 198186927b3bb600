"""Nested configuration trees with dotted overrides: port of
bilateral_driving_tpu/utils/config.py without PyYAML.

The JAX package loads YAML files; the port starts from a preset tree in
`configs.py`, applies `key=value` overrides whose values are read as YAML
scalars and flow sequences (PyYAML's own resolution rules for null, bool,
int and float, written out here), and saves a run's tree as JSON.
"""
from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List


class ConfigDict(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, path: str, default=None):
        node = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def wrap(x):
    """Dicts become ConfigDicts, recursively through lists."""
    if isinstance(x, dict):
        return ConfigDict({k: wrap(v) for k, v in x.items()})
    if isinstance(x, (list, tuple)):
        return [wrap(v) for v in x]
    return x


def merge(base: Dict, override: Dict) -> ConfigDict:
    """Recursive merge; override wins; dicts merge, everything else replaces."""
    out = ConfigDict(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = wrap(copy.deepcopy(v))
    return out


# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _sexagesimal(body: str, cast):
    value, base = cast(0), 1
    for part in reversed(body.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    body = s[1:] if s[0] in "+-" else s
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body[0] == "0":
        return sign * int(body, 8)
    if ":" in body:
        return sign * _sexagesimal(body, int)
    return sign * int(body)


def _float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    body = s[1:] if s[0] in "+-" else s
    if body == ".inf":
        return sign * math.inf
    if body == ".nan":
        return math.nan
    if ":" in body:
        return sign * _sexagesimal(body, float)
    return sign * float(body)


def _scalar(s: str) -> Any:
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _float(s)
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    return s


def _flow(s: str, i: int):
    """Parse one flow node of s from index i: a [sequence], a {mapping} of
    scalar keys, or a plain scalar. Returns (value, next index)."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i < len(s) and s[i] in "[{":
        close = "]" if s[i] == "[" else "}"
        items, i = [], i + 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i >= len(s):
                raise ValueError(f"unclosed {s[0]!r} in {s!r}")
            if s[i] == close:
                i += 1
                break
            item, i = _flow(s, i)
            items.append(item)
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
        if close == "]":
            return items, i
        out = {}
        for item in items:
            if not (isinstance(item, str) and ":" in item):
                raise ValueError(f"mapping entry {item!r} in {s!r}")
            k, v = item.split(":", 1)
            out[_scalar(k.strip())] = _scalar(v.strip())
        return out, i
    j = i
    while j < len(s) and s[j] not in ",]}":
        j += 1
    return _scalar(s[i:j].strip()), j


def parse_value(s: str) -> Any:
    """A CLI value as yaml.safe_load reads it: null, bool, int, float, a
    quoted or plain string, or a flow sequence or mapping of those."""
    s = s.strip()
    if s[:1] in ("[", "{"):
        try:
            value, end = _flow(s, 0)
        except ValueError:
            return s
        if s[end:].strip():
            return s
        return value
    return _scalar(s)


def apply_dotlist(cfg: ConfigDict, dotlist: List[str]) -> ConfigDict:
    """['a.b.c=1', 'x=foo'] overrides, each value read by parse_value."""
    cfg = merge(cfg, {})
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override must be key=value: {item}")
        key, val = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = ConfigDict()
            node = node[p]
        node[parts[-1]] = wrap(parse_value(val))
    return cfg


def validate_keys(cfg: Dict, schema: Dict, path: str = "") -> List[str]:
    """Dotted paths of keys not covered by `schema`: a nested dict whose
    leaves are True, with "*" allowing any key at its level."""
    unknown = []
    for k, v in cfg.items():
        if k in schema:
            sub = schema[k]
        elif "*" in schema:
            sub = schema["*"]
        else:
            unknown.append(f"{path}{k}")
            continue
        if isinstance(sub, dict) and isinstance(v, dict):
            unknown += validate_keys(v, sub, f"{path}{k}.")
    return unknown


def save_config(cfg: Dict, path: str):
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def load_config(path: str, overrides: List[str] = ()) -> ConfigDict:
    """A saved run's tree (save_config) with overrides applied."""
    with open(path) as f:
        return apply_dotlist(wrap(json.load(f)), list(overrides))
