"""Wrapper of the row RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Replaces ``repro.kernels.rmsnorm.rmsnorm_pallas``: ``x * (mean(x^2) + eps)
** -0.5 * scale`` over the last axis, reduced in float32.  Its plain
version is :func:`repro_torch.kernels.ref.rmsnorm`;
:func:`repro_torch.kernels.ops.rmsnorm` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build, check_launch, check_operand

MAX_D = 8192          # a row lives in one block's registers


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """x: (..., d) contiguous; scale: (d,); float32 on one CUDA device,
    d <= 8192.  Returns x's shape."""
    if x.dim() == 0:
        raise ValueError("rmsnorm: x must have a feature axis")
    d = x.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_cuda: x is on {dev}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} outside 1..{MAX_D}")
    check_operand("x", x, dev, x.shape)
    check_operand("scale", scale, dev, (d,))
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.rmsnorm_f32(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                              rows, d, float(eps),
                              torch.cuda.current_stream(dev).cuda_stream)
    check_launch("rmsnorm", err)
    LAUNCHES["rmsnorm"] += 1
    return y
