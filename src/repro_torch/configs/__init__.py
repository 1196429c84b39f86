"""Model configurations the port runs (``--arch <id>`` resolution).

Only the paper's own ``gdm-dit`` service is ported so far; the LM zoo of
``repro.configs.registry`` follows with the LM slice.
"""
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs import gdm_paper

_CONFIGS = {"gdm-dit": gdm_paper.CONFIG}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]
