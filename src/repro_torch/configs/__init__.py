"""Architecture registry: ``get_config("<id>")`` / ``--arch <id>``.

The port carries the dense ``paper-100m`` family so far; the other
architectures of ``repro.configs`` come with the model families that run
them (ROADMAP.md slice 10)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, active_params, num_params

_MODULES = {
    "paper-100m": "paper_100m",
}


def get_config(name: str) -> ArchConfig:
    smoke = name.endswith("-smoke")
    base = name[:-len("-smoke")] if smoke else name
    if base not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[base]}")
    cfg = mod.CONFIG
    return cfg.reduced() if smoke else cfg


def list_archs():
    return sorted(_MODULES)


__all__ = ["ArchConfig", "get_config", "list_archs", "num_params",
           "active_params"]
