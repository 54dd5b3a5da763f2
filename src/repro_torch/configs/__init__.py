"""Experiment configurations of the port (copies of ``repro/configs``).

``get_config(name)`` / ``get_smoke_config(name)`` cover every LM
architecture of the reference, in its order: the dense families
(qwen2-72b, deepseek-coder-33b, command-r-plus-104b, chameleon-34b, the
hubert-xlarge encoder), MLA + MoE (deepseek-v2-lite-16b), interleaved
MoE (llama4-maverick-400b-a17b), h2o-danube-3-4b's sliding window,
rwkv6-7b and the Mamba2 + shared-attention hybrid zamba2-2.7b.  The
paper's own 8-parameter problem is ``paper_anm``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, cell_is_runnable,
                                      config_from_dict, cut_depth)

_ARCH_MODULES: Dict[str, str] = {
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
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
