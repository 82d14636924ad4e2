"""Architecture registry of the port (twin of ``repro.configs``): the 10
assigned archs, each with its published FULL config and the reduced SMOKE
config the tests and the serving CLI use. ``--arch <id>`` resolves through
here, and the dry-run's input shapes (``shapes.py``) are re-exported."""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        input_specs)

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama4-scout-17b-a16e": "llama4_scout",
    "pixtral-12b": "pixtral_12b",
    "llama3-8b": "llama3_8b",
    "qwen1.5-32b": "qwen15_32b",
    "yi-34b": "yi_34b",
    "qwen2.5-32b": "qwen25_32b",
    "musicgen-large": "musicgen_large",
    "xlstm-125m": "xlstm_125m",
    "zamba2-1.2b": "zamba2_12b",
}

ARCH_IDS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def full_config(arch: str):
    return _mod(arch).FULL


def smoke_config(arch: str):
    return _mod(arch).SMOKE
