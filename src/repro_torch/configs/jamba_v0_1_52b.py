"""jamba-v0.1-52b — 32L d4096 32H (GQA kv=8) d_ff=14336, Mamba+attn 1:7, MoE 16e top-2.

[arXiv:2403.19887]  Same widths as ``repro.configs.jamba_v0_1_52b.CONFIG``:
one attention layer per 8 (attn_every=8), the other seven Mamba
selective-SSM blocks (d_state 16, d_conv 4, expand 2: d_in 8192, dt_rank
256); MoE MLP on every second layer (moe_every=2), dense SwiGLU on the
rest.  A full-width period with its experts fits no card, so the card
trains a period without them (``num_experts=0``: a dense SwiGLU in every
slot); the reduced config runs with its experts.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    moe_d_ff=14_336,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
)
