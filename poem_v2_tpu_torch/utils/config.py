"""Hierarchical configuration tree (counterpart of ``poem_v2_tpu/utils/config.py``).

``Config`` is a dict with attribute access, recursive conversion, freezing,
merge, clone and dump; :func:`get_config` loads an experiment config and
merges the CLI's overrides by the JAX package's rules. PyYAML is optional:
when it imports, a config file is read with it; otherwise with
:func:`parse_yaml`, the port's reader of the YAML subset the repository's
files use, and a path that names no file but whose stem names a
configuration of :mod:`poem_v2_tpu_torch.configs` (the seven
``configs/synthetic_*.yaml``, or ``train_<tier>`` of the released ones) is
taken from there. :func:`dump_yaml` writes that subset.
"""

from __future__ import annotations

import copy
import importlib
import math
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union


def _yaml():
    """The PyYAML module, or None where it is not installed."""
    try:
        return importlib.import_module("yaml")
    except ImportError:
        return None


class Config(dict):
    """A dict with attribute access, recursive conversion and freezing: nested
    dicts become ``Config`` nodes, lists of dicts lists of ``Config`` nodes."""

    __slots__ = ("_frozen",)

    def __init__(self, init: Optional[Mapping[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = _convert(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if self.frozen:
            raise AttributeError(f"Config is frozen; cannot set {key!r}")
        super().__setitem__(key, _convert(value))

    @property
    def frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    def _set_frozen(self, frozen: bool) -> "Config":
        object.__setattr__(self, "_frozen", frozen)
        for v in self.values():
            for item in (v if isinstance(v, list) else [v]):
                if isinstance(item, Config):
                    item._set_frozen(frozen)
        return self

    def freeze(self) -> "Config":
        return self._set_frozen(True)

    def defrost(self) -> "Config":
        return self._set_frozen(False)

    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Recursively merge ``other`` on top of this config."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def clone(self) -> "Config":
        return Config(self.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        return _deconvert(self)

    def dump(self, stream=None) -> str:
        """YAML: PyYAML's where it imports, else :func:`dump_yaml`'s."""
        yaml = _yaml()
        text = (yaml.safe_dump(self.to_dict(), sort_keys=False) if yaml is not None
                else dump_yaml(self.to_dict()))
        if stream is not None:
            stream.write(text)
        return text

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(self.to_dict(), memo))

    def __reduce__(self):
        return (Config, (self.to_dict(),))


def _convert(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return [_convert(x) for x in v]
    return v


def _deconvert(v: Any) -> Any:
    if isinstance(v, Config):
        return {k: _deconvert(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_deconvert(x) for x in v]
    return v


def known_configs() -> Dict[str, dict]:
    """The configurations this package holds as data, by the stem of their file."""
    from ..configs import RELEASE, SYNTHETIC

    return {**SYNTHETIC, **{f"train_{name}": cfg for name, cfg in RELEASE.items()}}


def load_yaml(path: str) -> Any:
    """A YAML file's contents: PyYAML's ``safe_load`` where it imports, else
    :func:`parse_yaml`."""
    with open(path, "r") as f:
        text = f.read()
    yaml = _yaml()
    return yaml.safe_load(text) if yaml is not None else parse_yaml(text, path)


def load_config_file(path: str) -> Dict[str, Any]:
    """The contents of a config file as a dict (see the module docstring)."""
    if os.path.isfile(path):
        return load_yaml(path) or {}
    stem = os.path.splitext(os.path.basename(path))[0]
    known = known_configs()
    if stem in known:
        return copy.deepcopy(known[stem])
    raise FileNotFoundError(f"{path}: no such file, and {stem!r} names no configuration of "
                            f"poem_v2_tpu_torch/configs.py ({sorted(known)})")


# Defaults of the reference TRAIN block (lib/utils/config.py:46-63).
DEFAULT_TRAIN = {
    "MANUAL_SEED": 1,
    "CONV_REPEATABLE": True,
    "BATCH_SIZE": 8,
    "EPOCH": 10,
    "OPTIMIZER": "adam",
    "LR": 1e-4,
    "SCHEDULER": "StepLR",
    "LR_DECAY_GAMMA": 0.1,
    "LR_DECAY_STEP": [7],
    "LOG_INTERVAL": 10,
    "FIND_UNUSED_PARAMETERS": False,
    "GRAD_CLIP_ENABLED": True,
    "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0},
    "WEIGHT_DECAY": 0.0,
}


def get_config(config_file: Union[str, Mapping[str, Any]], arg: Optional[Any] = None,
               merge: bool = True) -> Config:
    """An experiment config from a file (or a dict of one), frozen.

    Over ``DEFAULT_TRAIN``; with ``merge``, ``arg.batch_size`` overrides
    ``TRAIN.BATCH_SIZE``, ``arg.reload`` ``MODEL.PRETRAINED`` and
    ``arg.val_batch_size`` ``TRAIN.VAL_BATCH_SIZE``, as the JAX package does."""
    cfg = Config({"TRAIN": copy.deepcopy(DEFAULT_TRAIN)})
    cfg.merge(config_file if isinstance(config_file, Mapping)
              else load_config_file(config_file))
    if merge and arg is not None:
        batch_size = getattr(arg, "batch_size", None)
        if batch_size:
            cfg.TRAIN.BATCH_SIZE = batch_size
        reload_ckpt = getattr(arg, "reload", None)
        if reload_ckpt:
            if "MODEL" not in cfg:
                cfg.MODEL = {}
            cfg.MODEL.PRETRAINED = reload_ckpt
        val_batch_size = getattr(arg, "val_batch_size", None)
        if val_batch_size:
            cfg.TRAIN.VAL_BATCH_SIZE = val_batch_size
    return cfg.freeze()


# ---------------------------------------------------------------- YAML subset
#
# What the repository's YAML files use (configs/, configs/release/, the
# recorded dump_cfg.yaml files, DexYCB's meta.yml / mano.yml): block mappings
# and lists (a list may sit at its key's indent), flow lists and mappings on
# one line, anchors and aliases, plain / single- / double-quoted scalars and
# comments. Plain scalars resolve as PyYAML's safe loader resolves them
# (YAML 1.1): null, booleans, decimal integers and floats; every other
# construct raises with its line number.

_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# other YAML 1.1 forms PyYAML would turn into numbers or dates: outside the subset
_OTHER = re.compile(r"^[-+]?0b[01_]+$|^[-+]?0[0-7_]+$|^[-+]?0x[0-9a-fA-F_]+$"
                    r"|^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                    r"|^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


class YAMLSubsetError(ValueError):
    """Text outside the YAML subset :func:`parse_yaml` reads."""


def _plain(text: str) -> Any:
    """A plain scalar resolved as PyYAML's safe loader resolves it."""
    if text == "" or _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER.match(text):
        raise ValueError(f"the plain scalar {text!r} (a YAML 1.1 number or date form)")
    if text[0] in "!&*|>%@`" or text.startswith(("- ", "? ")) or ": " in text \
            or text.endswith(":"):
        raise ValueError(f"the plain scalar {text!r}")
    return text


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.anchors: Dict[str, Any] = {}
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                self.fail(no, "a tab in the indentation")
            content = self._strip_comment(raw).rstrip()
            if not content.strip():
                continue
            if content.startswith(("---", "...", "%")):
                self.fail(no, f"the document marker or directive {content!r}")
            indent = len(content) - len(content.lstrip(" "))
            self.lines.append((no, indent, content[indent:]))

    def fail(self, no: int, what: str):
        raise YAMLSubsetError(f"{self.source}:{no}: {what} is outside the YAML subset the port "
                              "reads")

    @staticmethod
    def _strip_comment(line: str) -> str:
        quote = None
        for i, ch in enumerate(line):
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
                quote = ch
            elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
                return line[:i]
        return line

    # -- block structure ------------------------------------------------------
    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        no, ind, content = self.lines[i]
        if ind != indent:
            self.fail(no, "an unexpected indentation")
        if content == "-" or content.startswith("- "):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines):
            no, ind, content = self.lines[i]
            is_item = content == "-" or content.startswith("- ")
            if ind < indent or (ind == indent and not is_item):
                break  # the list's parent goes on
            if ind > indent:
                self.fail(no, "a list item at an unexpected indentation")
            rest = content[1:].lstrip(" ")
            if not rest:
                value, i = self.nested(i + 1, indent, in_list=True)
            elif rest == "-" or rest.startswith("- ") or self._is_key(rest):
                # "- - x" / "- key: value": a list or mapping inside the list, at
                # the column its first item or key starts
                inner = indent + len(content) - len(rest)
                self.lines[i] = (no, inner, rest)
                value, i = self.block(i, inner)
            else:
                value, i = self.value(rest, i, indent, no, in_list=True)
            out.append(value)
        return out, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines):
            no, ind, content = self.lines[i]
            if ind < indent or (ind == indent and (content == "-" or content.startswith("- "))):
                break
            if ind > indent:
                self.fail(no, "a line at an unexpected indentation")
            key, rest = self._split_key(content, no)
            value, i = self.value(rest, i, indent, no, in_list=False)
            out[key] = value
        return out, i

    def nested(self, i: int, indent: int, in_list: bool) -> Tuple[Any, int]:
        """The block under a key or list item whose value is on the lines below:
        deeper lines, or (under a key) a list at the key's own indent."""
        if i < len(self.lines):
            _, ind, content = self.lines[i]
            is_item = content == "-" or content.startswith("- ")
            if ind > indent or (ind == indent and is_item and not in_list):
                return self.block(i, ind)
        return None, i

    def value(self, rest: str, i: int, indent: int, no: int, in_list: bool) -> Tuple[Any, int]:
        anchor = None
        if rest.startswith("&"):
            anchor, _, rest = rest[1:].partition(" ")
            rest = rest.lstrip(" ")
            if not anchor:
                self.fail(no, "an empty anchor")
        if not rest:
            value, i = self.nested(i + 1, indent, in_list)
        else:
            value, i = self.inline(rest, no), i + 1
        if anchor is not None:
            self.anchors[anchor] = value
        return value, i

    def inline(self, text: str, no: int) -> Any:
        if text.startswith("*"):
            name = text[1:]
            if name not in self.anchors:
                self.fail(no, f"the alias {text!r} of no anchor above it")
            return copy.deepcopy(self.anchors[name])
        if text[0] in "[{":
            value, pos = self.flow(text, 0, no)
            if text[pos:].strip():
                self.fail(no, f"text after a flow collection ({text[pos:].strip()!r})")
            return value
        if text[0] in "'\"":
            value, pos = self.quoted(text, 0, no)
            if text[pos:].strip():
                self.fail(no, f"text after a quoted scalar ({text[pos:].strip()!r})")
            return value
        try:
            return _plain(text)
        except ValueError as e:
            self.fail(no, str(e))

    def _is_key(self, text: str) -> bool:
        if text[0] in "'\"":
            try:
                _, pos = self.quoted(text, 0, 0)
            except YAMLSubsetError:
                return False
            return text[pos:].startswith(":")
        m = re.match(r"^[^\[\]{},#&*!|>'\"%@`][^#]*?:(?: |$)", text)
        return m is not None

    def _split_key(self, content: str, no: int) -> Tuple[Any, str]:
        if content[0] in "'\"":
            key, pos = self.quoted(content, 0, no)
        else:
            m = re.match(r"^([^\[\]{},#&*!|>'\"%@`?][^#]*?):(?: |$)", content)
            if m is None:
                self.fail(no, f"the line {content!r} (no 'key: value')")
            key, pos = _plain(m.group(1).rstrip()), m.end(1)
        if not content[pos:].startswith(":"):
            self.fail(no, f"the line {content!r} (no ':' after its key)")
        return key, content[pos + 1:].strip()

    # -- scalars and flow collections ----------------------------------------
    def quoted(self, text: str, pos: int, no: int) -> Tuple[str, int]:
        q, out, i = text[pos], [], pos + 1
        while i < len(text):
            ch = text[i]
            if q == "'" and ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and ch == '"':
                return "".join(out), i + 1
            if q == '"' and ch == "\\":
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 2
                    continue
                n = {"x": 2, "u": 4, "U": 8}.get(esc)
                if n is None or not re.fullmatch(r"[0-9a-fA-F]{%d}" % n, text[i + 2:i + 2 + n]):
                    self.fail(no, f"the escape {text[i:i + 2]!r}")
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            out.append(ch)
            i += 1
        self.fail(no, "a quoted scalar that does not end on its line")

    def flow(self, text: str, pos: int, no: int) -> Tuple[Any, int]:
        close = "]" if text[pos] == "[" else "}"
        out: Any = [] if close == "]" else {}
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                self.fail(no, "a flow collection that does not end on its line")
            if text[pos] == close:
                return out, pos + 1
            if close == "}":
                key, pos = self.flow_item(text, pos, no, ":")
                if text[pos:pos + 1] != ":":
                    self.fail(no, "a flow mapping entry without ':'")
                value, pos = self.flow_item(text, pos + 1, no, ",}")
                out[key] = value
            else:
                value, pos = self.flow_item(text, pos, no, ",]")
                out.append(value)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] != close:
                self.fail(no, f"{text[pos:pos + 1]!r} in a flow collection")

    def flow_item(self, text: str, pos: int, no: int, stops: str) -> Tuple[Any, int]:
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if text[pos:pos + 1] in ("[", "{"):
            return self.flow(text, pos, no)
        if text[pos:pos + 1] in ("'", '"'):
            value, pos = self.quoted(text, pos, no)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            return value, pos
        end = pos
        while end < len(text) and text[end] not in stops and text[end] not in "[]{}":
            end += 1
        try:
            return _plain(text[pos:end].strip()), end
        except ValueError as e:
            self.fail(no, str(e))


def parse_yaml(text: str, source: str = "<string>") -> Any:
    """The document ``text`` holds, as PyYAML's ``safe_load`` gives it, for the
    subset described above; text outside it raises :class:`YAMLSubsetError` with
    the line number."""
    r = _Reader(text, source)
    if not r.lines:
        return None
    no, indent, content = r.lines[0]
    if len(r.lines) == 1 and not (content.startswith("- ") or r._is_key(content)):
        return r.inline(content, no)
    value, i = r.block(0, indent)
    if i < len(r.lines):
        r.fail(r.lines[i][0], "a line at an unexpected indentation")
    return value


# strings written without quotes: no indicator first, no ': ' / ' #' / flow characters
_SAFE_PLAIN = re.compile(r"^[A-Za-z0-9_./(][A-Za-z0-9_./()+ =-]*(?<! )$")


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
        text = repr(v)
        if "." not in text:  # 1e-05 -> 1.0e-05: YAML 1.1 floats need a dot
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        return text
    if isinstance(v, str):
        try:
            plain_ok = bool(_SAFE_PLAIN.match(v)) and _plain(v) == v
        except ValueError:
            plain_ok = False
        return v if plain_ok else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump_yaml(obj: Any, indent: int = 0) -> str:
    """``obj`` (dicts, lists and scalars) as block YAML in PyYAML's default layout
    (a list at its key's indent), which :func:`parse_yaml` and PyYAML read back."""
    pad = " " * indent
    if isinstance(obj, Mapping):
        if not obj:
            return pad + "{}\n"
        out = []
        for k, v in obj.items():
            key = _dump_scalar(k)
            if isinstance(v, Mapping) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(list(v), indent))
            else:
                out.append(f"{pad}{key}: {_inline(v)}\n")
        return "".join(out)
    if isinstance(obj, (list, tuple)):
        if not obj:
            return pad + "[]\n"
        out = []
        for v in obj:
            if isinstance(v, Mapping) and v:
                body = dump_yaml(v, indent + 2)
                out.append(f"{pad}- " + body[indent + 2:])
            elif isinstance(v, (list, tuple)) and v:
                body = dump_yaml(list(v), indent + 2)
                out.append(f"{pad}- " + body[indent + 2:])
            else:
                out.append(f"{pad}- {_inline(v)}\n")
        return "".join(out)
    return pad + _dump_scalar(obj) + "\n"


def _inline(v: Any) -> str:
    if isinstance(v, Mapping):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)
