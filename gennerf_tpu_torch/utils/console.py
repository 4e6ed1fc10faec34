"""Console utilities run before a task, the reference's `extras` (the
port's copy of gennerf_tpu/utils/console.py): the composed config printed
as a plain-text tree (saved to `config_tree.log` under paths.output_dir),
the run's tags (prompted for on an interactive stdin, else the prompt's
default ["dev"]; saved to `tags.log`) and the warnings filter.
"""
from __future__ import annotations

import os
import sys
import warnings
from typing import Any, Dict, List, Optional, Sequence

# the reference's print order of the top-level groups
DEFAULT_PRINT_ORDER: Sequence[str] = (
    "data", "model", "callbacks", "logger", "trainer", "paths", "extras",
)


def format_config_tree(cfg: Dict[str, Any],
                       print_order: Sequence[str] = DEFAULT_PRINT_ORDER) -> str:
    """The config as text: the groups of `print_order` first (absent ones
    skipped), the other keys after, each subtree as YAML."""
    import yaml

    queue: List[str] = [f for f in print_order if f in cfg]
    queue += [f for f in cfg if f not in queue]
    lines: List[str] = ["CONFIG"]
    for field in queue:
        lines.append(f"├── {field}")
        group = cfg[field]
        if isinstance(group, dict):
            body = yaml.safe_dump(group, default_flow_style=False, sort_keys=False)
        else:
            body = str(group)
        for ln in body.rstrip("\n").split("\n"):
            lines.append(f"│   {ln}")
    return "\n".join(lines) + "\n"


def _rank0() -> bool:
    """The rank-zero gate (parallel.platform.is_rank0)."""
    from ..parallel.platform import is_rank0

    return is_rank0()


def _save(cfg: Dict[str, Any], name: str, text: str) -> None:
    out_dir = (cfg.get("paths") or {}).get("output_dir")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)


def print_config_tree(cfg: Dict[str, Any], print_order: Sequence[str] = DEFAULT_PRINT_ORDER,
                      save_to_file: bool = False) -> None:
    """Print the config tree; with `save_to_file` also write it to
    <paths.output_dir>/config_tree.log. Rank 0 only."""
    if not _rank0():
        return
    text = format_config_tree(cfg, print_order)
    print(text, end="")
    if save_to_file:
        _save(cfg, "config_tree.log", text)


def enforce_tags(cfg: Dict[str, Any], save_to_file: bool = False) -> None:
    """Give the run tags when the config has none: asked for on an
    interactive stdin, else the prompt's default ["dev"] with a warning
    (an unattended job must not block). Sets cfg["tags"]; with
    `save_to_file` writes them to <paths.output_dir>/tags.log."""
    from ..train.loggers import get_logger

    log = get_logger()
    if not cfg.get("tags"):
        if _rank0() and sys.stdin is not None and sys.stdin.isatty():
            log.warning("No tags provided in config. Prompting user...")
            raw = input("Enter a list of comma separated tags [dev]: ") or "dev"
        else:
            log.warning("No tags provided in config and stdin is not interactive; "
                        "defaulting tags to ['dev']")
            raw = "dev"
        cfg["tags"] = [t.strip() for t in raw.split(",") if t.strip()]
        log.info(f"Tags: {cfg['tags']}")
    if save_to_file and _rank0():
        _save(cfg, "tags.log", repr(cfg["tags"]) + "\n")


def extras(cfg: Dict[str, Any], print_order: Optional[Sequence[str]] = None) -> None:
    """The config's `extras`, in the reference's order: ignore_warnings,
    enforce_tags, print_config (each saving its file)."""
    from ..train.loggers import get_logger

    log = get_logger()
    ex = cfg.get("extras")
    if not ex:
        log.warning("Extras config not found! <cfg.extras=null>")
        return
    if ex.get("ignore_warnings"):
        log.info("Disabling python warnings <extras.ignore_warnings=True>")
        warnings.filterwarnings("ignore")
    if ex.get("enforce_tags"):
        enforce_tags(cfg, save_to_file=True)
    if ex.get("print_config"):
        print_config_tree(cfg, print_order or DEFAULT_PRINT_ORDER, save_to_file=True)
