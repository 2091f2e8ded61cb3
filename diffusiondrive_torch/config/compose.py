"""Layered YAML config composition (hydra-equivalent subset).

Copy of `diffusiondrive_tpu/config/compose.py`: it composes the same
repo-root `configs/` tree, found from this file.

Covers the reference's config workflows (`config/common/default_evaluation.yaml:2-7`,
SURVEY §5.6) without the hydra dependency:

- **defaults lists**: `defaults: [{agent: diffusiondrive_agent}, base, _self_]`
  — `group: name` entries load `<root>/<group>/<name>.yaml` into the `group`
  subtree; bare names merge a sibling file at the root; `_self_` positions the
  file's own keys in the merge order (appended last when omitted).
- **interpolation**: `${oc.env:VAR}` / `${oc.env:VAR,default}` / `${env:VAR}`
  read the environment; `${a.b.c}` references another resolved config key.
  A full-string reference preserves the referenced type.
- **CLI overrides**: dotted `key.sub=value` strings, values YAML-parsed
  (`batch_size=64`, `agent.config.lidar_min_x=-32`).
- **snapshot**: the resolved config is dumped to `<output_dir>/config.yaml`
  (hydra's `output_dir/code/hydra` parity) so a run is reproducible from one
  file: `--config <snapshot>` with no overrides.

Group roots resolve relative to the composing file, falling back to the
vendored `configs/` tree at the repo root.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

import yaml

REPO_CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"

_INTERP = re.compile(r"\$\{([^${}]+)\}")
_FLOAT_LITERAL = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


class ConfigError(ValueError):
    pass


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def _find_config_file(name: Union[str, Path], root: Optional[Path]) -> Path:
    """Resolve a config reference: explicit path, else <root>/, else configs/."""
    p = Path(name)
    candidates = [p if p.suffix in (".yaml", ".yml") else p.with_suffix(".yaml")]
    if root is not None:
        candidates.append(root / candidates[0])
    candidates.append(REPO_CONFIG_ROOT / candidates[0])
    for c in candidates:
        if Path(c).exists():
            return Path(c)
    raise ConfigError(f"config file not found: {name} (searched {[str(c) for c in candidates]})")


def load_config(name: Union[str, Path], config_root: Optional[Path] = None) -> Dict[str, Any]:
    """Load one YAML with its `defaults` list recursively composed (unresolved)."""
    path = _find_config_file(name, config_root)
    with open(path) as fp:
        data = yaml.safe_load(fp) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: top level must be a mapping")
    root = config_root or path.parent

    defaults = data.pop("defaults", [])
    merged: Dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, data)
            self_merged = True
        elif isinstance(entry, dict):
            for group, group_name in entry.items():
                if group_name is None:
                    continue
                sub = load_config(Path(group) / str(group_name), root)
                merged = _deep_merge(merged, {str(group): sub})
        else:
            merged = _deep_merge(merged, load_config(str(entry), root))
    if not self_merged:
        merged = _deep_merge(merged, data)
    return merged


def apply_overrides(config: Dict[str, Any], overrides: Iterable[str]) -> Dict[str, Any]:
    """Apply dotted `key.sub=value` overrides (values YAML-parsed)."""
    out = dict(config)
    for item in overrides:
        if "=" not in item:
            raise ConfigError(f"override must look like key=value, got: {item}")
        key, _, raw = item.partition("=")
        key = key.lstrip("+").strip()
        value = yaml.safe_load(raw) if raw != "" else None
        if isinstance(value, str) and _FLOAT_LITERAL.match(value):
            value = float(value)  # YAML 1.1 misses bare "1e-3"-style floats
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
            node[part] = dict(nxt)
            node = node[part]
        node[parts[-1]] = value
    return out


def _lookup(config: Dict[str, Any], dotted: str) -> Any:
    node: Any = config
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise ConfigError(f"unresolvable interpolation: ${{{dotted}}}")
        node = node[part]
    return node


def _resolve_token(token: str, config: Dict[str, Any]) -> Any:
    if token.startswith(("oc.env:", "env:")):
        body = token.split(":", 1)[1]
        var, _, default = body.partition(",")
        if var in os.environ:
            return os.environ[var]
        if _:  # a default was given (possibly empty)
            return yaml.safe_load(default) if default else ""
        raise ConfigError(f"environment variable not set: {var}")
    return _lookup(config, token)


def resolve_interpolations(config: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve `${...}` references bottom-up; cycles raise."""

    def resolve_value(value: Any, stack: tuple) -> Any:
        if isinstance(value, dict):
            return {k: resolve_value(v, stack) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve_value(v, stack) for v in value]
        if not isinstance(value, str):
            return value
        full = _INTERP.fullmatch(value.strip())
        if full:
            token = full.group(1)
            if token in stack:
                raise ConfigError(f"interpolation cycle via ${{{token}}}")
            return resolve_value(_resolve_token(token, config), stack + (token,))

        def sub(match):
            token = match.group(1)
            if token in stack:
                raise ConfigError(f"interpolation cycle via ${{{token}}}")
            return str(resolve_value(_resolve_token(token, config), stack + (token,)))

        return _INTERP.sub(sub, value)

    return resolve_value(config, ())


def compose(name: Union[str, Path], overrides: Iterable[str] = ()) -> Dict[str, Any]:
    """defaults-composed + overridden + interpolation-resolved config.

    An override `group=name` whose `<root>/<group>/<name>.yaml` exists swaps
    that config group wholesale (hydra group-override semantics); everything
    else is a dotted value override.
    """
    path = _find_config_file(name, None)
    config = load_config(path)
    root = path.parent

    plain: List[str] = []
    for item in overrides:
        key, _, raw = item.partition("=")
        key = key.strip()
        raw_name = raw.strip()
        # group override only for bare names (a path/list/dict value is data,
        # and an absolute path would swallow the group prefix in the join)
        if "." not in key and raw_name and "/" not in raw_name and "\\" not in raw_name \
                and not raw_name.startswith(("{", "[")) and not raw_name.endswith((".yaml", ".yml")):
            try:
                group_file = _find_config_file(Path(key) / raw.strip(), root)
            except ConfigError:
                group_file = None
            if group_file is not None:
                config[key] = load_config(group_file, root)
                continue
        plain.append(item)
    return resolve_interpolations(apply_overrides(config, plain))


def snapshot(config: Dict[str, Any], output_dir: Union[str, Path]) -> Path:
    """Write the resolved config; `compose(<path>)` reproduces the run."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / "config.yaml"
    with open(out, "w") as fp:
        yaml.safe_dump(config, fp, sort_keys=False)
    return out


def config_get(config: Dict[str, Any], dotted: str, default: Any = None) -> Any:
    """`config_get(cfg, "agent.name")` with a default."""
    try:
        return _lookup(config, dotted)
    except ConfigError:
        return default
