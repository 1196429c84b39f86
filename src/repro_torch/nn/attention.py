"""GQA multi-head attention: projections, RoPE and the KV cache around the
attention kernels, as in ``repro.nn.attention``.

The attention math is :func:`repro_torch.kernels.ops.flash_attention` for a
full sequence and :func:`repro_torch.kernels.ops.decode_attention` for one
decode token (the CUDA kernels on the card, their plain versions on the
CPU); this module owns the projections, the rotary embedding and the cache
insert.  Cross-attention (the enc-dec family) takes its keys and values
from the encoder's memory: ``attention_apply(memory=)`` over a full
sequence, :func:`cross_attention_decode` for one decode token.  With
``sharded_decode`` a decode step runs the split-K decode over a mesh's
model axis (:mod:`repro_torch.distributed.flash_decode`), which inserts
the new row on the shard that owns its position.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.flash_decode import sharded_decode_attention
from repro_torch.kernels import ops
from repro_torch.nn.linear import Dense, dense_apply
from repro_torch.nn.rope import apply_rope


class KVCache(NamedTuple):
    """Per-layer KV cache: (B, S_max, KH, D) in the state's dtype
    (bfloat16 by default, as the reference's) + current length (B,)
    int32.  The decode path writes into ``k`` and ``v`` in place."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


class Attention(nn.Module):
    """``wq``/``wk``/``wv``/``wo`` as in ``repro.nn.attention.attention_init``."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        kw = dict(bias=cfg.qkv_bias, device=device, dtype=dtype)
        self.wq = Dense(d, cfg.q_dim, **kw)
        self.wk = Dense(d, cfg.kv_dim, **kw)
        self.wv = Dense(d, cfg.kv_dim, **kw)
        self.wo = Dense(cfg.q_dim, d,
                        stddev=cfg.q_dim ** -0.5
                        / max(1, 2 * cfg.num_layers) ** 0.5,
                        device=device, dtype=dtype)


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def attention_apply(params: Attention, x, *, cfg: ModelConfig,
                    positions=None, causal: bool = True, window: int = 0,
                    q_offset: int = 0, memory=None, rope: bool = True):
    """Full-sequence (train / prefill) attention.  x: (B, S, d_model).

    With ``rope`` the queries rotate by ``positions`` (default ``arange(S)
    + q_offset``) and the keys by ``arange(S)``, as in the reference; the
    DiT calls it with ``rope=False``.  ``memory`` (B, S_mem, d_model)
    switches to cross-attention: keys and values from the memory, no rope
    and no causal mask."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    kv_src = memory if memory is not None else x
    q = _split_heads(dense_apply(params.wq, x), cfg.num_heads, hd)
    k = _split_heads(dense_apply(params.wk, kv_src), cfg.num_kv_heads, hd)
    v = _split_heads(dense_apply(params.wv, kv_src), cfg.num_kv_heads, hd)
    if rope and memory is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :] + q_offset
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, torch.arange(s, device=x.device)[None, :],
                       cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal and memory is None,
                              window=window, q_offset=q_offset)
    return dense_apply(params.wo, out.reshape(b, s, cfg.q_dim))


def attention_decode(params: Attention, x, cache: KVCache, *,
                     cfg: ModelConfig, fused_position: bool = False,
                     sharded_decode=None):
    """One-token decode step.  x: (B, 1, d_model); returns (y, new_cache).

    The new key and value rows are written into ``cache.k`` / ``cache.v``
    in place (the returned cache holds the same tensors and a new length).
    ``fused_position=True`` writes every batch row at ``cache.length[0]``,
    as the reference's ``dynamic_update_slice``, whose start index is
    clamped so the row fits: a length of S or more writes row S - 1.
    ``fused_position=False`` writes row b at ``cache.length[b]``, as the
    reference's one-hot blend does for a finite cache: a row whose length
    is outside ``[0, S)`` is left unwritten.  Neither reads the lengths on
    the host.  The new rows are rounded to the cache's dtype first, as the
    reference's blend computes in it (``cache * (1 - onehot) + onehot *
    row``: the kept rows times one, the written row plus zeros, exact in
    any dtype).  The query stays in the model's dtype: a float32 model
    over a bfloat16 cache hands the kernel a float32 q.

    ``sharded_decode``: (batch_axes, model_axis, mesh) runs the split-K
    decode over ``model_axis`` instead of the ``decode_attention`` kernel,
    the cache split along the sequence; every row inserts at
    ``cache.length[0]`` on the shard that owns it, whatever
    ``fused_position`` says, and nowhere when that is outside ``[0, S)``.
    """
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    s = cache.k.shape[1]
    q = _split_heads(dense_apply(params.wq, x), cfg.num_heads, hd)  # (B,1,H,D)
    k = _split_heads(dense_apply(params.wk, x), cfg.num_kv_heads, hd)
    v = _split_heads(dense_apply(params.wv, x), cfg.num_kv_heads, hd)

    pos = cache.length[:, None]                                      # (B,1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    new_len = cache.length + 1

    if sharded_decode is not None:
        batch_axes, model_axis, mesh = sharded_decode
        out, _, _ = sharded_decode_attention(
            q[:, 0], cache.k, cache.v, new_len, axis=model_axis,
            batch_axes=batch_axes, mesh=mesh, k_new=k[:, 0], v_new=v[:, 0])
        y = dense_apply(params.wo, out.reshape(b, 1, cfg.q_dim))
        return y, KVCache(cache.k, cache.v, new_len)
    if fused_position:
        idx = cache.length[:1].clamp(0, s - 1).long()
        cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
    else:
        rows = torch.arange(b, device=x.device)
        idx = cache.length.clamp(0, s - 1).long()
        inside = ((cache.length >= 0) & (cache.length < s))[:, None, None]
        for buf, new in ((cache.k, k), (cache.v, v)):
            buf[rows, idx] = torch.where(inside, new[:, 0].to(buf.dtype),
                                         buf[rows, idx])
    out = ops.decode_attention(q[:, 0], cache.k, cache.v, new_len)
    y = dense_apply(params.wo, out.reshape(b, 1, cfg.q_dim))
    return y, KVCache(cache.k, cache.v, new_len)


def cross_attention_decode(params: Attention, x, memory, *,
                           cfg: ModelConfig):
    """Decode-time cross-attention of x (B, 1, d_model) against a fixed
    encoder memory (B, S_mem, d_model).  As in the reference, the memory's
    keys and values are projected again at every call (nothing is cached),
    and every row attends to all S_mem of them."""
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    q = _split_heads(dense_apply(params.wq, x), cfg.num_heads, hd)
    k = _split_heads(dense_apply(params.wk, memory), cfg.num_kv_heads, hd)
    v = _split_heads(dense_apply(params.wv, memory), cfg.num_kv_heads, hd)
    lens = torch.full((b,), memory.shape[1], dtype=torch.int32,
                      device=x.device)
    out = ops.decode_attention(q[:, 0], k, v, lens)
    return dense_apply(params.wo, out.reshape(b, 1, cfg.q_dim))


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """An empty cache in ``dtype`` (the reference's default bfloat16)."""
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int32,
                                      device=device))


def prefill_kv_cache(params: Attention, x, *, cfg: ModelConfig,
                     max_seq: int, dtype=torch.bfloat16) -> KVCache:
    """A cache built from a full prompt x (B, S, d_model), rounded to
    ``dtype`` (the reference's default bfloat16) and zero-padded to
    ``max_seq`` positions, with every length S."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    k = _split_heads(dense_apply(params.wk, x), cfg.num_kv_heads, hd)
    k = apply_rope(k, torch.arange(s, device=x.device)[None, :],
                   cfg.rope_theta)
    v = _split_heads(dense_apply(params.wv, x), cfg.num_kv_heads, hd)
    pad = (0, 0, 0, 0, 0, max_seq - s)
    return KVCache(torch.nn.functional.pad(k.to(dtype), pad),
                   torch.nn.functional.pad(v.to(dtype), pad),
                   torch.full((b,), s, dtype=torch.int32, device=x.device))
