"""qwen3-moe-235b-a22b — 94L d4096 64H (GQA kv=4) MoE 128e top-8, moe_d_ff=1536.

Same widths as ``repro.configs.qwen3_moe_235b_a22b.CONFIG`` (head_dim=128
explicit, as in Qwen3's configs).  At full width it has 16 query heads per
KV head, over ``decode_attention``'s limit of 8 (ROADMAP Queue 2 item 6),
and fits no card; the port runs its reduced config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                # the per-expert hidden width
    moe_d_ff=1536,
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    moe_every=1,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
