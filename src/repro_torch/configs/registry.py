"""Architecture registry: --arch <id> resolves here.

Port of `src/repro/configs/registry.py` (`ARCH_IDS`, `get_config`,
`all_configs`); `get_config` resolves `repro_torch.configs.<id>`.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "minicpm3-4b",
    "llama-3.2-vision-90b",
    "deepseek-v2-lite-16b",
    "qwen1.5-4b",
    "musicgen-medium",
    "minitron-4b",
    "deepseek-v2-236b",
    "mamba2-2.7b",
    "jamba-1.5-large-398b",
    "yi-34b",
]


def get_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
