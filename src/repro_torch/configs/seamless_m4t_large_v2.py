"""seamless-m4t-large-v2 — enc-dec 24L d1024 16H (kv=16) d_ff=8192 vocab 256206.

[arXiv:2308.11596]  Same widths as
``repro.configs.seamless_m4t_large_v2.CONFIG``: the speech frontend is a
stub (``launch.steps.input_specs`` gives ``encoder_seq_len`` precomputed
audio-frame embeddings as the encoder's input), and the backbone is 24
encoder and 24 decoder layers with LayerNorm, GELU MLPs and
cross-attention in every decoder layer.  About 2.04 B parameters, 8.1 GB
in float32, so the whole model fits one 80 GB H100.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,            # decoder stack
    encoder_layers=24,        # encoder stack (audio-frame embeddings stub)
    cross_attention=True,
    encoder_seq_len=1024,     # stub: precomputed speech frame embeddings
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,       # padded to 256_256 internally
    frontend="audio_frames",
    tie_embeddings=False,
)
