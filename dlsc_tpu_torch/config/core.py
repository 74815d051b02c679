"""Config tree: attribute access, interpolation, merge, flatten.

A small OmegaConf-style container. Values may contain ``${dotted.path}``
interpolations resolved lazily against the root of the tree, plus the
``${now:FORMAT}`` resolver used by run-dir patterns
(reference: configs/training.yaml:28-31).
"""

from __future__ import annotations

import copy
import datetime
import re
from typing import Any, Iterator

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")

_MISSING = object()


class Config:
    """Nested dict with attribute access and lazy ``${...}`` interpolation."""

    def __init__(self, data: dict | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", _root)
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    # -- construction helpers -------------------------------------------------
    def _wrap(self, v: Any) -> Any:
        if isinstance(v, Config):
            object.__setattr__(v, "_root", self._root_cfg())
            return v
        if isinstance(v, dict):
            return Config(v, _root=self._root_cfg())
        if isinstance(v, list):
            return [self._wrap(x) for x in v]
        return v

    def _root_cfg(self) -> "Config":
        return self._root if self._root is not None else self

    def _rebind_root(self, root: "Config") -> None:
        object.__setattr__(self, "_root", root if root is not self else None)
        for v in self._data.values():
            if isinstance(v, Config):
                v._rebind_root(root)
            elif isinstance(v, list):
                for x in v:
                    if isinstance(x, Config):
                        x._rebind_root(root)

    # -- access ---------------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getitem__(self, key: str) -> Any:
        v = self._data[key]
        return self._resolve(v)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self[k] for k in self._data]

    def items(self):
        return [(k, self[k]) for k in self._data]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def pop(self, key: str, default: Any = _MISSING) -> Any:
        if key in self._data:
            v = self[key]
            del self._data[key]
            return v
        if default is _MISSING:
            raise KeyError(key)
        return default

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self[key] = default
        return self[key]

    # -- dotted-path access ---------------------------------------------------
    def select(self, path: str, default: Any = _MISSING) -> Any:
        """Get ``a.b.c``; returns *default* (or raises KeyError) if absent."""
        node: Any = self
        for part in path.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            else:
                if default is _MISSING:
                    raise KeyError(path)
                return default
        return node

    def update(self, path: str, value: Any, *, force_add: bool = True) -> None:
        """Set ``a.b.c = value``, creating intermediate nodes.

        Mirrors ``OmegaConf.update`` used by the HPO layer to patch
        suggested parameters back onto the tree
        (reference: src/optimization/hyperparameter_space.py:173-199).
        """
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], Config):
                if not force_add and part not in node._data:
                    raise KeyError(path)
                node._data[part] = Config({}, _root=self._root_cfg())
            node = node._data[part]
        node[parts[-1]] = value

    def delete(self, path: str) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            node = node._data[part]
        del node._data[parts[-1]]

    # -- interpolation ----------------------------------------------------------
    def _resolve(self, v: Any) -> Any:
        if isinstance(v, str):
            return self._resolve_str(v)
        if isinstance(v, list):
            return [self._resolve(x) for x in v]
        return v

    def _resolve_str(self, s: str) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation: preserve value type
            return self._lookup_interp(m.group(1))
        # embedded interpolation(s): substitute as strings
        def sub(m: re.Match) -> str:
            return str(self._lookup_interp(m.group(1)))

        out = _INTERP_RE.sub(sub, s)
        return out

    def _lookup_interp(self, expr: str) -> Any:
        if expr.startswith("now:"):
            return datetime.datetime.now().strftime(expr[4:])
        if expr.startswith("env:"):
            import os

            name = expr[4:]
            if "," in name:
                name, default = name.split(",", 1)
                return os.environ.get(name, default)
            return os.environ[name]
        if expr.startswith("oc.env:"):
            return self._lookup_interp("env:" + expr[7:])
        root = self._root_cfg()
        return root.select(expr)

    # -- export -----------------------------------------------------------------
    def to_dict(self, resolve: bool = True) -> dict:
        out = {}
        for k in self._data:
            v = self[k] if resolve else self._data[k]
            out[k] = _export(v, resolve)
        return out

    def copy(self) -> "Config":
        c = Config(copy.deepcopy(self.to_dict(resolve=False)))
        return c


def _export(v: Any, resolve: bool) -> Any:
    if isinstance(v, Config):
        return v.to_dict(resolve)
    if isinstance(v, list):
        return [_export(x, resolve) for x in v]
    return v


def merge(base: Config | dict, *others: Config | dict) -> Config:
    """Deep-merge config trees; later trees win. Lists/scalars are replaced."""
    out = Config(base.to_dict(resolve=False) if isinstance(base, Config) else copy.deepcopy(base))
    for other in others:
        od = other.to_dict(resolve=False) if isinstance(other, Config) else other
        _merge_into(out, od)
    out._rebind_root(out)
    return out


def _merge_into(dst: Config, src: dict) -> None:
    for k, v in src.items():
        if (
            k in dst._data
            and isinstance(dst._data[k], Config)
            and isinstance(v, (dict, Config))
        ):
            _merge_into(dst._data[k], v.to_dict(resolve=False) if isinstance(v, Config) else v)
        else:
            dst[k] = copy.deepcopy(v.to_dict(resolve=False) if isinstance(v, Config) else v)


def flatten(cfg: Config | dict, prefix: str = "", sep: str = ".") -> dict:
    """Flatten to ``{dotted.path: leaf}`` — used for logging every config key
    to the tracker (reference: scripts/train.py:132-167)."""
    items: dict[str, Any] = {}
    obj = cfg.items() if isinstance(cfg, Config) else cfg.items()
    for k, v in obj:
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, (Config, dict)):
            items.update(flatten(v, key, sep))
        else:
            items[key] = v
    return items
