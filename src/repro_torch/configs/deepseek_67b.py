"""deepseek-67b — 95L d8192 64H (GQA kv=8) d_ff=22016 vocab 102400 (llama-arch).

[arXiv:2401.02954]  Same widths as ``repro.configs.deepseek_67b.CONFIG``:
a dense LM of about 67.4 B parameters, which fits no card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=102_400,
)
