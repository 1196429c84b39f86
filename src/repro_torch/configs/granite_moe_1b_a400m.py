"""granite-moe-1b-a400m — 24L d1024 16H (GQA kv=8) MoE 32e top-8, moe_d_ff=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base]  Same widths as
``repro.configs.granite_moe_1b_a400m.CONFIG``: every layer's MLP is a
mixture of 32 SwiGLU experts of width 512, 8 of them per token; tied
embeddings over the vocab padded to 49 408.  About 1.335 B parameters,
5.34 GB in float32, about 0.43 B of them active per token.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49_155,        # padded to 49_408 internally
    num_experts=32,
    experts_per_token=8,
    moe_every=1,
    tie_embeddings=True,
)
