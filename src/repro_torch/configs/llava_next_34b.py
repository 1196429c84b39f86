"""llava-next-34b — 60L d7168 56H (GQA kv=8) d_ff=20480 vocab 64000 (anyres VLM).

[hf:llava-hf/llava-v1.6 family]  Same widths as
``repro.configs.llava_next_34b.CONFIG``: the vision frontend is a stub
(``num_patch_tokens`` precomputed patch embeddings, projected by
``patch_proj``, take the place of the first token embeddings) on a dense
backbone.  About 34.4 B parameters, 137.6 GB in float32: it fits no card,
so the card runs it at its published widths with its depth cut.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    num_patch_tokens=2_880,   # 5 anyres tiles x 576 patches
    frontend="image_patches",
)
