"""Sharded flash-decoding: split-K decode attention over the model axis,
as ``repro.distributed.flash_decode``.

When a model axis does not divide the kv heads, the KV cache splits over
the sequence instead: each model shard attends over its local block of
the cache and produces a partial ``(o, m, l)`` (unnormalised output, row
max, row sum), and the exact combine is

    m  = max_i m_i
    l  = sum_i l_i * exp(m_i - m)
    o  = sum_i o_i * exp(m_i - m) / l

so only O(H·D + H) numbers per (batch row, layer) cross between shards,
whatever the cache's length.

The reference runs this under ``shard_map``; the port runs it from one
controller: each shard's block is a view of the global cache on its
device (a copy, written back, on another device), its partial is
computed there, and the partials are gathered to the data shard's first
device for the combine (the reference's ``all_gather``).  The partial is
plain torch ops, as it is plain ``jnp`` in the reference: it is no
kernel, and the ``decode_attention`` kernel does not run here.  A cost
counter (:mod:`repro_torch.distributed.op_cost`) sees each shard's
partial at its mesh position and is charged the combine's three
all-gathers, as ``hlo_cost`` counts the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.op_cost import collective, place, where
from repro_torch.distributed.sharding import _axes, shard_rows

NEG_INF = -1e30


def _local_partial(q, k, v, lengths, start: int, scale: float):
    """Partial attention over a local cache block.

    q: (B, H, D); k, v: (B, S_loc, KH, D); lengths: (B,) GLOBAL valid
    length; start: the block's global offset.  Returns (o, m, l) with o
    (B, H, D) float32 unnormalised, m and l (B, H) float32.  GQA is the
    grouped product, with no repeat of the kv heads."""
    b, h, d = q.shape
    s_loc, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, kh, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    pos = start + torch.arange(s_loc, device=q.device)
    valid = (pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)                                  # (B, KH, G)
    # a fully masked block adds nothing
    e = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", e, v.float())
    return o.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def _insert(cache, new, pos, start: int):
    """The reference's masked local insert into one shard's block: the
    row at ``pos - start`` (clipped into the block) takes ``new`` where
    the shard owns ``pos``, and itself elsewhere."""
    s_loc = cache.shape[1]
    local = (pos - start).clamp(0, s_loc - 1).long().view(1)
    owns = (pos >= start) & (pos < start + s_loc)
    row = torch.where(owns, new[:, None].to(cache.dtype),
                      cache.index_select(1, local))
    cache.index_copy_(1, local, row)


def _combine(parts, home):
    """The exact combine of the shards' partials, on ``home``: each of
    o, m and l all-gathered over the shards."""
    at = [where(p[0]) for p in parts]
    o_all, m_all, l_all = (
        place(torch.stack([p[i].to(home) for p in parts]), at[0])
        for i in range(3))
    for t in (o_all, m_all, l_all):
        collective("all-gather", t.numel() * t.element_size(), len(parts),
                   at)
    m_star = m_all.amax(dim=0)                               # (B, H)
    w = torch.exp(m_all - m_star[None])
    l_star = (l_all * w).sum(dim=0)
    num = (o_all * w[..., None]).sum(dim=0)                  # (B, H, D)
    return num / l_star.clamp_min(1e-30)[..., None]


def sharded_decode_attention(q, k_cache, v_cache, lengths, *,
                             axis: str = "model", batch_axes=(), mesh=None,
                             scale: Optional[float] = None,
                             k_new=None, v_new=None):
    """Split-K decode attention over ``axis`` of ``mesh``.

    q: (B, H, D), the batch split over ``batch_axes``; k_cache, v_cache:
    (B, S, KH, D), the sequence split over ``axis`` (S divisible by its
    size); lengths: (B,) global VALID length (the new token's position +
    1).  Returns (B, H, D) on q's device, or (out, k_cache, v_cache) when
    ``k_new`` / ``v_new`` (B, KH, D) are given: every batch row then
    inserts at ``lengths[0] - 1`` (aligned batching), on the shard that
    owns that position, into the caches in place."""
    b, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    with_insert = k_new is not None
    rows = shard_rows(mesh, _axes(batch_axes), axis)
    if k_cache.shape[1] % len(rows[0]) or b % len(rows):
        raise ValueError(f"a cache of {k_cache.shape[1]} rows and a batch "
                         f"of {b} do not split over {len(rows[0])} model "
                         f"and {len(rows)} data shards")
    s_loc = k_cache.shape[1] // len(rows[0])
    bs = b // len(rows)
    outs = []
    for i, devs in enumerate(rows):
        rs = slice(i * bs, (i + 1) * bs)
        row = i if len(rows) > 1 else where(q)[0]
        parts = []
        for m, dev in enumerate(devs):
            start = m * s_loc
            blocks = [c[rs, start:start + s_loc] for c in (k_cache, v_cache)]
            k_l, v_l = (place(c.to(dev), (row, m)) for c in blocks)
            len_l = place(lengths[rs].to(dev), (row, m))
            if with_insert:
                pos = len_l[0] - 1
                for c, new in ((k_l, k_new), (v_l, v_new)):
                    _insert(c, new[rs].to(dev), pos, start)
                for c, local in zip(blocks, (k_l, v_l)):
                    if local is not c:      # a copy on another device
                        c.copy_(local)
            parts.append(_local_partial(place(q[rs].to(dev), (row, m)),
                                        k_l, v_l, len_l, start, scale))
        outs.append(_combine(parts, devs[0]).to(q.dtype))
    out = torch.cat([o.to(q.device) for o in outs]) if len(outs) > 1 \
        else outs[0].to(q.device)
    if with_insert:
        return out, k_cache, v_cache
    return out
