"""Config registry: ``--arch <id>`` → ModelConfig.

The 10 assigned architectures (exact published configurations) and the
four input-shape cells of the dry-run (``SHAPES``), the same data as the
JAX package's registry.  The port's transformer runs
all of them (see :mod:`repro_torch.models.transformer`).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    FAMILIES,
    SHAPES,
    SUBQUADRATIC_FAMILIES,
    ModelConfig,
    ShapeCell,
)

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2-7b": "qwen2_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "deepseek-7b": "deepseek_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-large-v3": "whisper_large_v3",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether a (arch × shape) cell runs, and the reason when skipped."""
    if shape == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention (see DESIGN.md §4)")
    return True, ""


def all_cells() -> list[tuple[str, str, bool, str]]:
    """(arch, shape, applicable, skip_reason) for all 40 cells."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_applicable(cfg, shape)
            out.append((arch, shape, ok, why))
    return out


__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "FAMILIES", "ARCH_IDS",
           "get_config", "cell_applicable", "all_cells",
           "SUBQUADRATIC_FAMILIES"]
