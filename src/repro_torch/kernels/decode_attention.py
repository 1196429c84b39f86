"""Wrapper of the split-K decode attention CUDA kernel
(``csrc/decode_attention.cu``).

Replaces ``repro.kernels.decode_attention.decode_attention_pallas``: one
query token per batch row against a KV cache, attending to positions
``[0, lengths[b])``, with G = H/KH query heads per kv head read by index,
in float32 or, as the reference's kernel takes a bfloat16 cache, with
bfloat16 caches and q in bfloat16 or float32 (the
``decode_attention_bf16`` launch; the output in q's dtype).  Its plain
version is :func:`repro_torch.kernels.ref.decode_attention`;
:func:`repro_torch.kernels.ops.decode_attention` picks between them by the
tensor's device.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import (BF16, build, check_launch, check_operand,
                                 launched, refuse_grad, variant)

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's compiled head widths
MAX_GROUP = 8                     # query heads per kv head
TILE_KEYS = 32                    # keys a tile on the CUDA cores
TILE_KEYS_MMA = 64                # ... on the tensor cores (bfloat16 q, cache)
MIN_SPLIT_TILES = 2               # tiles a split takes at the least
MAX_SPLITS = 128                  # splits the merge kernel takes
BLOCKS_PER_SM = 2                 # blocks in flight the splits aim for


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def work(q_shape, k_shape, q_bytes: int = 4, kv_bytes: int = 4):
    """(flops, bytes) of one call, from the shapes: every cache row
    counted (the lengths are data; the reference's XLA version computes
    over the whole cache too), 4 D flops per (row, query head), and q
    (``q_bytes`` an element), the caches (``kv_bytes``) and the int32
    lengths read and o (q's type) written once."""
    b, h, d = q_shape
    s, kh = k_shape[1], k_shape[2]
    return 4.0 * b * s * h * d, float(q_bytes * 2 * b * h * d
                                      + kv_bytes * 2 * b * s * kh * d + 4 * b)


def tile_keys(q_dtype, kv_dtype) -> int:
    """Keys a tile of the kernel that takes these dtypes: the tensor cores'
    for bfloat16 q over a bfloat16 cache, else the CUDA cores'."""
    return TILE_KEYS_MMA if q_dtype == kv_dtype == BF16 else TILE_KEYS


def decode_grid(pairs: int, group: int, seq: int, sms: int, tile: int):
    """(splits, head groups) of the launch, from the shapes alone, so the
    lengths never leave the card.  The cache of each (b, kv head), in
    tiles of ``tile`` keys, is split into as many chunks of whole tiles
    as fill ``BLOCKS_PER_SM`` blocks on every SM, but none under
    ``MIN_SPLIT_TILES`` tiles (a short cache takes one split and no
    merge); then, while the blocks are fewer than the SMs, the ``group``
    query heads of a kv head go to as many blocks (a divisor of
    ``group``) as keep one block an SM at most."""
    tiles = -(-seq // tile)
    want = max(1, min(BLOCKS_PER_SM * sms // pairs, tiles // MIN_SPLIT_TILES,
                      MAX_SPLITS))
    per = -(-tiles // want)               # tiles a split takes
    splits = -(-tiles // per)
    head_groups = max([hg for hg in range(1, group + 1)
                       if group % hg == 0 and pairs * splits * hg <= sms],
                      default=1)
    return splits, head_groups


def split_keys(seq: int, splits: int, tile: int) -> int:
    """Keys a split takes, the launch's one statement of it: split s
    covers keys [s * chunk, (s + 1) * chunk), ceil(tiles / splits) whole
    tiles of ``tile`` keys (the kernel refuses any other)."""
    return -(-(-(-seq // tile)) // splits) * tile


def decode_attention_cuda(q, k_cache, v_cache, lengths, *,
                          scale: float | None = None):
    """q: (B, H, D); k_cache, v_cache: (B, S, KH, D), H % KH == 0 and
    H / KH <= 8; contiguous and 16-byte aligned, with lengths (B,) int32,
    on one CUDA device; float32, or bfloat16 caches with q bfloat16 or
    float32.  Returns (B, H, D) in q's dtype."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("decode_attention: q must be (B, H, D) and the "
                         "caches (B, S, KH, D)")
    refuse_grad("decode_attention", q, k_cache, v_cache)
    b, h, d = q.shape
    _, s, kh, _ = k_cache.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda: q is on {dev}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    if kh == 0 or h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h} heads over {kh} kv heads "
                         f"(at most {MAX_GROUP} per kv head)")
    if s == 0:
        raise ValueError("decode_attention: empty cache")
    bf = k_cache.dtype == BF16
    check_operand("k_cache", k_cache, dev, (b, s, kh, d),
                  dtypes=(torch.float32, BF16))
    check_operand("v_cache", v_cache, dev, (b, s, kh, d),
                  dtypes=(k_cache.dtype,))
    check_operand("q", q, dev, (b, h, d),
                  dtypes=(BF16, torch.float32) if bf else (torch.float32,))
    if (lengths.device != dev or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (b,) or not lengths.is_contiguous()):
        raise ValueError(f"decode_attention: lengths must be contiguous "
                         f"int32 ({b},) on {dev}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             "aligned")
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty_like(q)
    if b == 0:
        return o
    g = h // kh
    tile = tile_keys(q.dtype, k_cache.dtype)
    splits, head_groups = decode_grid(b * kh, g, s,
                                      _sm_count(dev.index or 0), tile)
    ws_acc = ws_ml = None
    if splits > 1:
        ws_acc = torch.empty(b * kh * splits * g * d, device=dev)
        ws_ml = torch.empty(b * kh * splits * g * 2, device=dev)
    lib = build.library()
    name = variant("decode_attention", k_cache)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), o.data_ptr(),
            ws_acc.data_ptr() if ws_acc is not None else None,
            ws_ml.data_ptr() if ws_ml is not None else None,
            b, s, h, kh, d, splits, head_groups,
            split_keys(s, splits, tile))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if bf:
            err = lib.decode_attention_bf16(*args, int(q.dtype == BF16),
                                            float(scale), stream)
        else:
            err = lib.decode_attention_f32(*args, float(scale), stream)
    check_launch(name, err)
    launched(name, work(q.shape, k_cache.shape, q.element_size(),
                        k_cache.element_size()))
    return o
