"""Wrapper of the FlashAttention CUDA kernels (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` with its
full semantics: causal and sliding-window masks, ``q_offset``, grouped-query
attention by index (kv is never repeated) and any key length, in float32
(3xTF32 ``mma.sync``) or bfloat16 (the ``flash_attention_bf16`` launch:
bfloat16 products on the tensor cores, float32 softmax, the output rounded
once; at D in {64, 128} a ``wgmma`` kernel fed by TMA, see
:func:`bf16_route`).  Its plain
version is :func:`repro_torch.kernels.ref.attention`;
:func:`repro_torch.kernels.ops.flash_attention` picks between them by the
tensor's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import (BF16, build, check_launch, check_operand,
                                 launched, variant)

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's compiled head widths


def bf16_route(b: int, sq: int, h: int, d: int) -> str:
    """Which kernel a bfloat16 call at these shapes launches, as the
    launcher decides it (``flash_attention_bf16_consumers`` in the
    source): FlashAttention-3's shape on ``wgmma`` and TMA with one or two
    consumer warpgroups a block at D in {64, 128}, else the ``mma.sync``
    kernel that float32 shares (its bfloat16 form).  Builds the kernels."""
    nc = build.library().flash_attention_bf16_consumers(b, sq, h, d)
    if nc < 0:
        raise RuntimeError("flash_attention: the card's SM count is "
                           "unreadable")
    return (f"wgmma, {nc} consumer warpgroup{'s' if nc > 1 else ''}"
            if nc else "mma.sync")


@functools.lru_cache(maxsize=None)
def unmasked_pairs(sq: int, sk: int, causal: bool, window: int,
                   q_offset: int) -> int:
    """The (query, key) pairs of one (batch row, head) that the mask
    keeps: query i at position i + q_offset sees key j where j <= i +
    q_offset (causal) and i + q_offset - j < window (window > 0)."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    hi = np.minimum(pos, sk - 1) if causal else np.full_like(pos, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(q_shape, k_shape, *, causal: bool, window: int, q_offset: int,
         itemsize: int = 4):
    """(flops, bytes) of one call: 4 D flops per unmasked (query, key)
    pair (the two products; the softmax's exponentials not counted), and
    q, k, v read and o written once, ``itemsize`` bytes an element."""
    b, sq, h, d = q_shape
    sk, kh = k_shape[1], k_shape[2]
    pairs = b * h * unmasked_pairs(sq, sk, causal, window, q_offset)
    return 4.0 * pairs * d, float(itemsize * 2 * (b * sq * h * d
                                                  + b * sk * kh * d))


def backward_work(q_shape, k_shape, *, causal: bool, window: int,
                  q_offset: int, itemsize: int = 4):
    """(flops, bytes) of the gradient of q, k and v, FlashAttention-2's
    work: 10 D flops per unmasked pair (P recomputed, then dV, dP, dQ and
    dK), and q, k, v, o, dO read and dQ, dK, dV written once, ``itemsize``
    bytes an element."""
    b, sq, h, d = q_shape
    sk, kh = k_shape[1], k_shape[2]
    pairs = b * h * unmasked_pairs(sq, sk, causal, window, q_offset)
    return 10.0 * pairs * d, float(itemsize * 4 * (b * sq * h * d
                                                   + b * sk * kh * d))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: float | None = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D), H % KH == 0; contiguous,
    all float32 or all bfloat16, on one CUDA device, starting on 16 bytes.
    Returns (B, Sq, H, D) in their dtype, with the products on the tensor
    cores in 3xTF32 (float32 accuracy) or in bfloat16."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, H, D)")
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda: q is on {dev}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} heads over {kh} kv heads")
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    check_operand("q", q, dev, (b, sq, h, d), dtypes=(torch.float32, BF16))
    check_operand("k", k, dev, (b, sk, kh, d), dtypes=(q.dtype,))
    check_operand("v", v, dev, (b, sk, kh, d), dtypes=(q.dtype,))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on 16 bytes "
                         "(the kernel copies 16-byte chunks)")
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = build.library()
    name = variant("flash_attention", q)
    entry = lib.flash_attention_bf16 if q.dtype == BF16 \
        else lib.flash_attention_f32
    with torch.cuda.device(dev):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, sk, h, kh, d, int(causal), int(window), int(q_offset),
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(name, err)
    launched(name, work(q.shape, k.shape, causal=causal, window=window,
                        q_offset=q_offset, itemsize=q.element_size()))
    return o
