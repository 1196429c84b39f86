"""Wrapper of the FlashAttention-2 CUDA kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` with its
full semantics: causal and sliding-window masks, ``q_offset``, grouped-query
attention by index (kv is never repeated) and any key length.  Its plain
version is :func:`repro_torch.kernels.ref.attention`;
:func:`repro_torch.kernels.ops.flash_attention` picks between them by the
tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build, check_launch, check_operand

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's compiled head widths


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: float | None = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D), H % KH == 0; contiguous
    float32 on one CUDA device.  Returns (B, Sq, H, D)."""
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
    check_operand("q", q, dev, (b, sq, h, d))
    check_operand("k", k, dev, (b, sk, kh, d))
    check_operand("v", v, dev, (b, sk, kh, d))
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, sk, h, kh, d, int(causal), int(window), int(q_offset),
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return o
