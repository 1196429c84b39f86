"""The paper's own GDM service: a DiT-style latent denoiser with B blocks.

A "block" in the paper (one scheduling quantum, Table II: B=4) is
``steps_per_block`` denoise steps; quality Omega(k) is measured by the SSIM
proxy in :mod:`repro_torch.models.gdm`.  Same widths as
``repro.configs.gdm_paper.CONFIG``.
"""
from repro_torch.configs.base import ModelConfig

SIM_SCENARIO = "paper-fig3"       # Table II environment (U=15, C=2, T=40)

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
