"""Architecture registry: ``--arch <id>`` lookup for launcher/dryrun/tests."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config", "arch_names"]

# arch id -> module (ids keep the assignment spelling; modules are sanitized)
ARCHS: dict[str, str] = {
    "hymba-1.5b":            "repro_torch.configs.hymba_1_5b",
    "mamba2-1.3b":           "repro_torch.configs.mamba2_1_3b",
    "hubert-xlarge":         "repro_torch.configs.hubert_xlarge",
    "phi3.5-moe-42b-a6.6b":  "repro_torch.configs.phi35_moe",
    "mixtral-8x7b":          "repro_torch.configs.mixtral_8x7b",
    "llama3-8b":             "repro_torch.configs.llama3_8b",
    "qwen1.5-4b":            "repro_torch.configs.qwen15_4b",
    "qwen2-1.5b":            "repro_torch.configs.qwen2_1_5b",
    "gemma-7b":              "repro_torch.configs.gemma_7b",
    "internvl2-2b":          "repro_torch.configs.internvl2_2b",
}


def arch_names() -> list[str]:
    return list(ARCHS)


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
