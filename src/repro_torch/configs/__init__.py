"""Experiment configurations of the port (copies of ``repro/configs``).

``get_config(name)`` / ``get_smoke_config(name)`` cover the two LM
architectures the port's models run (the LM-loss workload's); the
paper's own 8-parameter problem is ``paper_anm``.  The reference's other
eight architectures are not ported yet (ROADMAP.md queue A).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa: F401
                                      ShapeConfig, SSMConfig,
                                      config_from_dict, cut_depth)

_ARCH_MODULES: Dict[str, str] = {
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
