"""minitron-8b — 32L d4096 32H (GQA kv=8) d_ff=16384 vocab 256000 (pruned nemotron).

[arXiv:2407.14679]  Same widths as ``repro.configs.minitron_8b.CONFIG``:
a dense LM of about 9.9 B parameters (39.7 GB in float32).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=256_000,
)
