"""Model configurations the port runs (``--arch <id>`` resolution).

The paper's own ``gdm-dit`` service, the dense LMs of the edge launcher
(``yi-6b``, and ``qwen1.5-4b`` for the tests), the hybrid
``jamba-v0.1-52b`` of the trainer and the MoE LMs
(``granite-moe-1b-a400m``, the reference trainer test's model, and
``qwen3-moe-235b-a22b``); the rest of the reference's LM zoo
(``repro.configs.registry``) follows family by family.
"""
from repro_torch.configs.base import (MambaConfig, ModelConfig,  # noqa: F401
                                      TrainConfig)
from repro_torch.configs import (gdm_paper, granite_moe_1b_a400m,
                                 jamba_v0_1_52b, qwen1_5_4b,
                                 qwen3_moe_235b_a22b, yi_6b)

_CONFIGS = {"gdm-dit": gdm_paper.CONFIG, "yi-6b": yi_6b.CONFIG,
            "qwen1.5-4b": qwen1_5_4b.CONFIG,
            "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
            "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
            "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]
