"""Architecture registry: ``get_config("<id>")`` / ``--arch <id>``.

The port carries ``paper-100m`` and the eight decoder-only text
architectures of ``repro.configs`` (dense, sliding-window, MoE, SSM and
the hybrid).  qwen2-vl-72b (M-RoPE, ``qkv_bias``, the vision frontend)
and whisper-small (layer norm, GELU, sinusoids, the encoder and
cross-attention) come with slice 10b (ROADMAP.md item 22b)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, active_params, num_params

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-7b": "zamba2_7b",
    "mamba2-130m": "mamba2_130m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "llama3-8b": "llama3_8b",
    "internlm2-20b": "internlm2_20b",
    "mixtral-8x22b": "mixtral_8x22b",
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
