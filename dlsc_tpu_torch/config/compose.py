"""Defaults-list composition + CLI override grammar.

Implements the subset of Hydra composition the reference uses
(reference: configs/training.yaml:22-26, configs/optimization.yaml:1-5):

- a ``defaults:`` list whose entries are sibling files (``base_training``),
  group selections (``dataset: esc50`` → configs/dataset/esc50.yaml merged
  under key ``dataset``), the ``_self_`` marker, and ``override hydra/...``
  entries (ignored — no Hydra runtime here),
- recursive defaults in composed files,
- CLI overrides: ``a.b=v`` (set), ``+a.b=v`` (add), ``~a.b`` (delete),
  and group overrides ``model=envnet_v2`` that re-select a defaults group.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import re

import yaml

from dlsc_tpu_torch.config.core import Config, merge


class _Loader(yaml.SafeLoader):
    """SafeLoader with YAML 1.2 float semantics: pyyaml's 1.1 resolver
    treats ``5e-4`` (no dot) as a string; OmegaConf — and every config in
    this tree — expects a float."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def load_yaml(path: str | Path) -> dict:
    with open(path) as f:
        data = yaml.load(f, Loader=_Loader)
    return data or {}


def _parse_value(raw: str) -> Any:
    """Parse an override value with YAML typing (true/null/1e-4/[a,b]/...)."""
    try:
        return yaml.load(raw, Loader=_Loader)
    except yaml.YAMLError:
        return raw


def parse_overrides(overrides: Sequence[str]) -> tuple[dict, dict, list, list]:
    """Split CLI overrides into (sets, adds, deletes, raw_pairs).

    Group-vs-value disambiguation happens during compose (a key that names a
    defaults-list group is a group override; anything else is a value set).
    """
    sets: dict[str, Any] = {}
    adds: dict[str, Any] = {}
    deletes: list[str] = []
    pairs: list[tuple[str, Any]] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            deletes.append(ov[1:].split("=", 1)[0])
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Malformed override (expected key=value): {ov!r}")
        key, raw = ov.split("=", 1)
        val = _parse_value(raw)
        if add:
            adds[key] = val
        else:
            sets[key] = val
        pairs.append((key, val))
    return sets, adds, deletes, pairs


def _load_with_defaults(
    config_dir: Path,
    rel_name: str,
    group_overrides: dict[str, str],
    _depth: int = 0,
) -> Config:
    """Load a config file, recursively composing its ``defaults:`` list."""
    if _depth > 16:
        raise RecursionError(f"defaults list nesting too deep at {rel_name}")
    path = config_dir / f"{rel_name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"Config not found: {path}")
    body = load_yaml(path)
    defaults = body.pop("defaults", None)
    self_cfg = Config(body)
    if defaults is None:
        return self_cfg

    parent_dir = path.parent
    merged = Config({})
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            merged = merge(merged, self_cfg)
            self_done = True
            continue
        if isinstance(entry, str):
            # plain file: sibling ("base_training") or root-absolute ("/base")
            base = config_dir if entry.startswith("/") else parent_dir
            rel = (base / entry.lstrip("/")).relative_to(config_dir)
            sub = _load_with_defaults(config_dir, str(rel), group_overrides,
                                      _depth + 1)
            merged = merge(merged, sub)
            continue
        if isinstance(entry, dict):
            (key, option), = entry.items()
            if "hydra/" in key:
                continue  # no hydra runtime to configure
            if key.startswith("override "):
                key = key[len("override "):]
            absolute = key.startswith("/")
            group = key.lstrip("/")
            option = group_overrides.get(group, option)
            if option is None:
                continue
            base = config_dir if absolute else parent_dir
            rel = (base / group / str(option)).relative_to(config_dir)
            sub = _load_with_defaults(config_dir, str(rel), group_overrides,
                                      _depth + 1)
            merged = merge(merged, Config({group: sub.to_dict(resolve=False)}))
            continue
        raise ValueError(f"Unsupported defaults entry: {entry!r}")
    if not self_done:
        merged = merge(merged, self_cfg)
    return merged


def _discover_groups(config_dir: Path, config_name: str) -> set[str]:
    """Names of defaults-list groups reachable from the root config."""
    groups: set[str] = set()

    def walk(rel_name: str, depth: int = 0) -> None:
        if depth > 16:
            return
        path = config_dir / f"{rel_name}.yaml"
        if not path.exists():
            return
        defaults = load_yaml(path).get("defaults") or []
        for entry in defaults:
            if isinstance(entry, str) and entry != "_self_":
                base = config_dir if entry.startswith("/") else path.parent
                walk(str((base / entry.lstrip("/")).relative_to(config_dir)),
                     depth + 1)
            elif isinstance(entry, dict):
                (key, option), = entry.items()
                if "hydra/" in key:
                    continue
                key = key.removeprefix("override ")
                absolute = key.startswith("/")
                key = key.lstrip("/")
                groups.add(key)
                if option is not None:
                    base = config_dir if absolute else path.parent
                    walk(str((base / key / str(option)).relative_to(config_dir)),
                         depth + 1)

    walk(config_name)
    return groups


def compose(
    config_dir: str | Path,
    config_name: str,
    overrides: Sequence[str] = (),
) -> Config:
    """Compose a config like ``python scripts/train.py model=envnet_v2 a.b=1``.

    Mirrors the Hydra entry point the reference wraps every script in
    (reference: scripts/train.py:56-61).
    """
    config_dir = Path(config_dir)
    sets, adds, deletes, _ = parse_overrides(overrides)

    groups = _discover_groups(config_dir, config_name)
    group_overrides = {k: str(v) for k, v in sets.items() if k in groups}
    value_sets = {k: v for k, v in sets.items() if k not in groups}

    cfg = _load_with_defaults(config_dir, config_name, group_overrides)
    for key, val in value_sets.items():
        cfg.update(key, val)
    for key, val in adds.items():
        cfg.update(key, val)
    for key in deletes:
        try:
            cfg.delete(key)
        except KeyError:
            pass
    cfg._rebind_root(cfg)
    return cfg
