"""Nested configuration trees with dotted overrides: port of
bilateral_driving_tpu/utils/config.py without PyYAML.

A tree comes from a preset of `configs.py` or from YAML files read by
`load_yaml`, a reader of the block YAML the configuration files are
written in: block mappings and sequences, flow sequences and flow
mappings on one line, plain and quoted scalars and comments, with PyYAML's
resolution rules for null, bool, int and float written out here; anything
else (anchors, aliases, tags, block scalars, documents, multi-line flow
collections) raises naming its line. `load_config` merges a method file,
a dataset file and `key=value` overrides, as the JAX package does; a
run's tree is saved as JSON.
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


class YAMLError(ValueError):
    pass


def _strip_comment(text: str) -> str:
    """The line without its comment: a # at its start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _key_value(text: str):
    """(key, rest) of a `key: value` or `key:` entry, or None."""
    if text[:1] in "'\"":
        end = text.find(text[0], 1)
        if end > 0 and text[end + 1:end + 2] == ":" and (
                text[end + 2:end + 3] in ("", " ")):
            return text[:end + 1], text[end + 2:].strip()
        return None
    for i, ch in enumerate(text):
        if ch == ":" and text[i + 1:i + 2] in ("", " "):
            return text[:i].strip(), text[i + 1:].strip()
        if ch in "[{":
            return None
    return None


class _Lines:
    """The content lines of a YAML text: (line number, indent, text)."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or body.startswith("\t"):
                self.fail(n, "a tab in the indentation")
            if n == 1 and stripped.startswith("%"):
                self.fail(n, "a directive")
            if stripped in ("---", "...") or stripped.startswith(
                    ("--- ", "... ")):
                self.fail(n, "a document marker")
            self.lines.append((n, len(body) - len(stripped), stripped))

    def fail(self, n: int, what: str):
        raise YAMLError(f"{self.name}:{n}: {what} is not supported")


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _inline(lines: _Lines, n: int, text: str):
    """A value written on its line: a one-line flow collection or a
    scalar."""
    if text[:1] in "&*!":
        lines.fail(n, f"an anchor, alias or tag ({text.split()[0]!r})")
    if text[:1] in "|>":
        lines.fail(n, f"a block scalar ({text[:1]!r})")
    if text[:1] in "[{":
        try:
            value, end = _flow(text, 0)
        except ValueError:
            lines.fail(n, f"a flow collection over several lines ({text!r})")
        if text[end:].strip():
            lines.fail(n, f"text after a flow collection ({text!r})")
        return value
    if text[:1] in "'\"" and not (len(text) >= 2 and text[-1] == text[0]):
        lines.fail(n, f"a quoted scalar over several lines ({text!r})")
    if text[:1] == "?":
        lines.fail(n, "a complex key")
    return _scalar(text)


def _node(lines: _Lines, i: int, indent: int):
    """The block node whose first line is lines.lines[i] at `indent`."""
    if _is_item(lines.lines[i][2]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _value_after(lines: _Lines, i: int, indent: int):
    """The value of an entry whose own line ends at its `:` or `-`: the
    deeper block after it (a sequence may also sit at the key's indent),
    or null."""
    L = lines.lines
    if i < len(L) and (L[i][1] > indent or (
            L[i][1] == indent and _is_item(L[i][2]))):
        return _node(lines, i, L[i][1])
    return None, i


def _mapping(lines: _Lines, i: int, indent: int):
    out = {}
    L = lines.lines
    while i < len(L) and L[i][1] == indent and not _is_item(L[i][2]):
        n, _, text = L[i]
        kv = _key_value(text)
        if kv is None:
            lines.fail(n, f"a line that is no `key: value` ({text!r})")
        key = _inline(lines, n, kv[0])
        if isinstance(key, (dict, list)):
            lines.fail(n, "a collection as a key")
        if kv[1]:
            out[key] = _inline(lines, n, kv[1])
            i += 1
        else:
            out[key], i = _value_after(lines, i + 1, indent)
    if i < len(L) and L[i][1] > indent:
        lines.fail(L[i][0], "indentation past its mapping's")
    return out, i


def _sequence(lines: _Lines, i: int, indent: int):
    out = []
    L = lines.lines
    while i < len(L) and L[i][1] == indent and _is_item(L[i][2]):
        n, _, text = L[i]
        rest = text[1:].lstrip(" ")
        if not rest:
            value, i = _value_after(lines, i + 1, indent)
        elif _is_item(rest) or _key_value(rest) is not None:
            # a compact nested node: its first line continues the item
            col = indent + len(text) - len(rest)
            L[i] = (n, col, rest)
            value, i = _node(lines, i, col)
        else:
            value, i = _inline(lines, n, rest), i + 1
        out.append(value)
    if i < len(L) and L[i][1] > indent:
        lines.fail(L[i][0], "indentation past its sequence's")
    return out, i


def parse_yaml(text: str, name: str = "<yaml>"):
    """The tree of a block-YAML text (see the module docstring); an empty
    text gives None, as yaml.safe_load does."""
    lines = _Lines(text, name)
    if not lines.lines:
        return None
    n, indent, first = lines.lines[0]
    if _is_item(first) or _key_value(first) is not None:
        value, i = _node(lines, 0, indent)
    else:
        value, i = _inline(lines, n, first), 1
    if i < len(lines.lines):
        lines.fail(lines.lines[i][0], "text after the document's node")
    return value


def load_yaml(path: str) -> ConfigDict:
    with open(path) as f:
        return wrap(parse_yaml(f.read(), path) or {})


def _read_tree(path: str) -> ConfigDict:
    """A saved run's config.json, or a YAML file."""
    if path.endswith(".json"):
        with open(path) as f:
            return wrap(json.load(f))
    return load_yaml(path)


def save_config(cfg: Dict, path: str):
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def load_config(config_file: str, dataset_file: str | None = None,
                overrides: List[str] = ()) -> ConfigDict:
    """The method file (a YAML or a run's config.json), merged with the
    dataset YAML where one is given, then the `key=value` overrides."""
    cfg = _read_tree(config_file)
    if dataset_file:
        cfg = merge(cfg, load_yaml(dataset_file))
    return apply_dotlist(cfg, list(overrides))
