"""Architecture config registry of the port: ``get_config("<arch-id>")``.

Only the architectures the port serves are registered: the dense decoders,
the MoE family (``qwen3-moe-235b-a22b`` at its smoke config only: its
full config, 470 GB of bf16 weights, does not fit on one card) and the
recurrent families (``xlstm-125m``, ``recurrentgemma-2b``). The others
arrive with the slices that port their model families."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config"]
