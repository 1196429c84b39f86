"""Architecture registry: ``--arch <id>`` resolution and the (arch x shape)
grid, as ``repro.configs.registry``.

The ten assigned architectures plus the paper's own GDM service.  Every
cell of the assigned grid (arch x shape) is enumerated by
:func:`grid_cells`, with the reference's skip rule: ``long_500k`` runs only
for the sub-quadratic archs (jamba, xlstm).
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "yi-6b": "repro_torch.configs.yi_6b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "gdm-dit": "repro_torch.configs.gdm_paper",
}

ASSIGNED_ARCHS: Tuple[str, ...] = tuple(k for k in _ARCH_MODULES
                                        if k != "gdm-dit")
ALL_ARCHS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is runnable; returns (supported, reason)."""
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return False, "full-attention arch: long_500k skipped per assignment"
    return True, ""


def grid_cells(archs: Optional[Iterable[str]] = None,
               shapes: Optional[Iterable[str]] = None,
               include_skipped: bool = False
               ) -> List[Tuple[str, str, bool, str]]:
    """All (arch, shape, supported, reason) cells of the assigned grid."""
    out: List[Tuple[str, str, bool, str]] = []
    for a in (archs or ASSIGNED_ARCHS):
        cfg = get_config(a)
        for s in (shapes or SHAPES):
            ok, why = cell_supported(cfg, SHAPES[s])
            if ok or include_skipped:
                out.append((a, s, ok, why))
    return out
