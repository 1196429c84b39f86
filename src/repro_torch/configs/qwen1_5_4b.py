"""qwen1.5-4b — 40L d2560 20H (MHA kv=20) d_ff=6912 vocab 151936, QKV bias.

Same widths as ``repro.configs.qwen1_5_4b.CONFIG``.  The port's tests use
it for what yi-6b lacks: QKV bias, multi-head attention (one query head per
kv head) and a vocab that needs padding (151936 -> 152064).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
)
