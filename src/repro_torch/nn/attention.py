"""Multi-head attention: projections around the attention kernel.

The attention math is :func:`repro_torch.kernels.ops.flash_attention` (the
CUDA kernel on the card, the plain version on the CPU); this module owns
the projections.  Only the full-sequence path without rotary embedding is
ported, which is what the DiT runs; rope, the KV cache and decode come with
the LM slice.
"""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn.linear import Dense, dense_apply


class Attention(nn.Module):
    """``wq``/``wk``/``wv``/``wo`` as in ``repro.nn.attention.attention_init``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.wq = Dense(d, cfg.q_dim, bias=cfg.qkv_bias, device=device)
        self.wk = Dense(d, cfg.kv_dim, bias=cfg.qkv_bias, device=device)
        self.wv = Dense(d, cfg.kv_dim, bias=cfg.qkv_bias, device=device)
        self.wo = Dense(cfg.q_dim, d,
                        stddev=cfg.q_dim ** -0.5
                        / max(1, 2 * cfg.num_layers) ** 0.5,
                        device=device)


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def attention_apply(params: Attention, x, *, cfg: ModelConfig,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    rope: bool = True):
    """Full-sequence self-attention.  x: (B, S, d_model)."""
    if rope:
        raise NotImplementedError(
            "rotary embedding is not ported yet (LM slice, ROADMAP Queue 1 "
            "item 12); the DiT calls attention_apply with rope=False")
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = _split_heads(dense_apply(params.wq, x), cfg.num_heads, hd)
    k = _split_heads(dense_apply(params.wk, x), cfg.num_kv_heads, hd)
    v = _split_heads(dense_apply(params.wv, x), cfg.num_kv_heads, hd)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    return dense_apply(params.wo, out.reshape(b, s, cfg.q_dim))
