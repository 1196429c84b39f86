"""yi-6b — 32L d4096 32H (GQA kv=4) d_ff=11008 vocab 64000. [arXiv:2403.04652]

Same widths as ``repro.configs.yi_6b.CONFIG``: about 6.06 B parameters,
24.2 GB in float32, so the whole model fits one 80 GB H100.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
)
