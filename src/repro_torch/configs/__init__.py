"""Model configurations the port runs (``--arch <id>`` resolution).

The paper's own ``gdm-dit`` service and the dense LMs of the edge
launcher (``yi-6b``, and ``qwen1.5-4b`` for the tests); the rest of the
reference's LM zoo (``repro.configs.registry``) follows family by family.
"""
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs import gdm_paper, qwen1_5_4b, yi_6b

_CONFIGS = {"gdm-dit": gdm_paper.CONFIG, "yi-6b": yi_6b.CONFIG,
            "qwen1.5-4b": qwen1_5_4b.CONFIG}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]
