"""Layered-YAML config composition (the port's own copy of
gennerf_tpu/utils/config.py's `compose`).

A root yaml's `defaults:` list composes `configs/<group>/<name>.yaml` under
key `<group>`; `experiment=<name>` applies `configs/experiment/<name>.yaml`
as a global overlay, following its own `defaults:` chain (group re-selects
and inherited experiments); dotted `a.b=value` overrides; `${a.b}`,
`${oc.env:VAR,default}` and `${now:fmt}` interpolation.
"""
from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Dict, List, Optional

import yaml


class ConfigError(Exception):
    pass


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _get_dotted(cfg: Dict[str, Any], dotted: str) -> Any:
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            raise ConfigError(f"interpolation target not found: {dotted}")
        node = node[k]
    return node


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _resolve_value(value: Any, root: Dict[str, Any], _depth: int = 0) -> Any:
    if _depth > 16:
        raise ConfigError("interpolation recursion limit")
    if isinstance(value, str):
        full = _INTERP.fullmatch(value.strip())
        if full:
            return _resolve_value(_resolve_ref(full.group(1), root), root, _depth + 1)

        def sub(m):
            return str(_resolve_value(_resolve_ref(m.group(1), root), root, _depth + 1))

        return _INTERP.sub(sub, value)
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, _depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root, _depth) for v in value]
    return value


def _resolve_ref(expr: str, root: Dict[str, Any]) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        parts = expr[len("oc.env:"):].split(",", 1)
        var = parts[0].strip()
        if var in os.environ:
            return os.environ[var]
        if len(parts) > 1:
            return yaml.safe_load(parts[1])
        raise ConfigError(f"environment variable not set: {var}")
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr[len("now:"):])
    return _get_dotted(root, expr)


def _parse_override(token: str):
    if "=" not in token:
        raise ConfigError(f"override must be key=value: {token!r}")
    key, raw = token.split("=", 1)
    try:
        value = yaml.safe_load(raw)
    except yaml.YAMLError:
        value = raw
    return key.strip(), value


def _load_group(config_dir: str, group: str, name: str, _depth: int = 0) -> Dict[str, Any]:
    """configs/<group>/<name>.yaml with its within-group `defaults:`."""
    if _depth > 8:
        raise ConfigError(f"defaults recursion too deep in {group}/{name}")
    path = os.path.join(config_dir, group, f"{name}.yaml")
    if not os.path.exists(path):
        raise ConfigError(f"missing config {path}")
    data = _load_yaml(path)
    base: Dict[str, Any] = {}
    for entry in data.pop("defaults", []):
        if entry == "_self_":
            continue
        if isinstance(entry, str):
            base = _deep_merge(base, _load_group(config_dir, group, entry, _depth + 1))
        elif isinstance(entry, dict):
            for _, n in entry.items():
                base = _deep_merge(base, _load_group(config_dir, group, str(n), _depth + 1))
    return _deep_merge(base, data)


def _load_experiment(config_dir: str, name: str, group_choices: Dict[str, Any],
                     _depth: int = 0) -> Dict[str, Any]:
    """An experiment overlay; its `defaults:` re-select groups
    (`- override /model: gen_nerf`) or inherit another experiment."""
    if _depth > 8:
        raise ConfigError(f"experiment inheritance too deep at {name}")
    exp_path = os.path.join(config_dir, "experiment", f"{name}.yaml")
    if not os.path.exists(exp_path):
        raise ConfigError(f"unknown experiment {name!r} ({exp_path})")
    exp_cfg = _load_yaml(exp_path)
    base: Dict[str, Any] = {}
    for entry in exp_cfg.pop("defaults", []):
        if isinstance(entry, dict):
            for g, n in entry.items():
                g = str(g).removeprefix("override ").removeprefix("/")
                group_choices[g] = n
        elif isinstance(entry, str) and entry != "_self_":
            base = _deep_merge(
                base, _load_experiment(config_dir, entry, group_choices, _depth + 1)
            )
    return _deep_merge(base, exp_cfg)


def compose(
    config_dir: str,
    config_name: str = "train",
    overrides: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Compose the final config dict from `config_dir`/`config_name`.yaml,
    `experiment=<name>`, `group=<name>` and dotted `a.b.c=value` overrides."""
    root_yaml = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    group_choices: Dict[str, Optional[str]] = {}
    for entry in root_yaml.pop("defaults", []):
        if isinstance(entry, dict):
            for g, n in entry.items():
                group_choices[str(g)] = n
        elif isinstance(entry, str) and entry != "_self_":
            group_choices[entry] = entry

    experiment = None
    cli_group_choices = {}
    value_overrides = []
    for token in overrides or []:
        key, value = _parse_override(token)
        if key == "experiment":
            experiment = value
        elif key in group_choices and isinstance(value, str):
            cli_group_choices[key] = value
        else:
            value_overrides.append((key, value))

    exp_cfg: Dict[str, Any] = {}
    if experiment:
        exp_cfg = _load_experiment(config_dir, experiment, group_choices)
    group_choices.update(cli_group_choices)

    cfg: Dict[str, Any] = {}
    global_overlays = []
    for group, choice in group_choices.items():
        if choice is None:
            continue
        loaded = _load_group(config_dir, group, choice)
        if group == "debug":
            global_overlays.append(loaded)
        else:
            cfg[group] = loaded

    cfg = _deep_merge(cfg, root_yaml)
    cfg = _deep_merge(cfg, exp_cfg)
    for overlay in global_overlays:
        cfg = _deep_merge(cfg, overlay)
    for key, value in value_overrides:
        _set_dotted(cfg, key, value)
    return _resolve_value(copy.deepcopy(cfg), cfg)


def load_experiment_config(experiment_yaml: str, config_name: str = "predict",
                           overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """The whole config of `configs/experiment/<name>.yaml` composed under
    the root config `config_name` ('predict' or 'train'), given the yaml's
    path (the configs tree is its grandparent directory), with dotted
    `a.b=value` overrides."""
    path = os.path.abspath(experiment_yaml)
    exp_dir = os.path.dirname(path)
    if os.path.basename(exp_dir) != "experiment":
        raise ConfigError(f"{experiment_yaml} is not under a configs/experiment/ directory")
    name = os.path.splitext(os.path.basename(path))[0]
    return compose(os.path.dirname(exp_dir), config_name,
                   [f"experiment={name}"] + list(overrides or []))


def load_experiment_model_config(experiment_yaml: str) -> Dict[str, Any]:
    """The composed `model` dict of `configs/experiment/<name>.yaml`."""
    return load_experiment_config(experiment_yaml)["model"]
