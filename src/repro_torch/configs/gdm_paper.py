"""The paper's own GDM service: a DiT-style latent denoiser with B blocks.

A "block" in the paper (one scheduling quantum, Table II: B=4) is
``steps_per_block`` denoise steps; quality Omega(k) is measured by the SSIM
proxy in :mod:`repro_torch.models.gdm`.  Same widths as
``repro.configs.gdm_paper.CONFIG``.

The *system-level* side of the paper — which edge network this service is
deployed into — is named here too: :data:`SIM_SCENARIO` is the Table II
regime, and :func:`sim_config` resolves any named scenario from
:mod:`repro_torch.sim.scenarios`.
"""
from repro_torch.configs.base import ModelConfig

SIM_SCENARIO = "paper-fig3"       # Table II environment (U=15, C=2, T=40)


def sim_config(scenario: str = SIM_SCENARIO, **overrides):
    """Named edge-network regime for deploying this service
    (``repro_torch.sim.scenarios`` registry; overrides win over the
    scenario's defaults)."""
    from repro_torch.sim.scenarios import get_scenario
    return get_scenario(scenario, **overrides)

CONFIG = ModelConfig(
    name="gdm-dit",
    family="gdm",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=49_408,        # prompt token vocab (CLIP-style)
    gdm_blocks=4,             # B in the paper (Table II)
    latent_hw=16,             # 16x16 latent patch grid
)
