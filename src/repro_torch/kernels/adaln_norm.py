"""Wrapper of the fused adaLN CUDA kernel (``csrc/adaln_norm.cu``).

Replaces ``repro.kernels.adaln_norm.adaln_norm_pallas``: LayerNorm plus
adaLN modulation, ``y = (LN(x) * w + b) * (1 + scale) + shift``, and the
gated-residual epilogue that first forms ``r = residual + gate * x`` and
returns ``(y, r)``.  Its plain version is :func:`repro_torch.kernels.ref.
adaln_norm`; :func:`repro_torch.kernels.ops.adaln_norm` picks between them
by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, build, check_launch,
                                 check_operand, refuse_grad)

MAX_D = 4096          # a row lives in one block's registers
MAX_THREADS = 512


def load_width(x, shift, scale, weight, bias, gate=None, residual=None):
    """Floats per load and store: 4 (16 bytes) where d % 4 == 0, every
    tensor starts on a 16-byte boundary and every modulation row stride is
    a multiple of 4 floats, so every row of every operand is aligned (x and
    the residual are contiguous); else 1."""
    if x.shape[-1] % 4:
        return 1
    tensors = [t for t in (x, shift, scale, weight, bias, gate, residual)
               if t is not None]
    if any(t.data_ptr() % 16 for t in tensors):
        return 1
    if any(t.stride(0) % 4 for t in (shift, scale, gate) if t is not None):
        return 1
    return 4


def launch_shape(d: int, width: int):
    """(threads, vectors per thread) of the block that owns one row: two
    vectors a thread while the row has at most 1024, else four or eight; a
    whole number of warps."""
    n = d // width
    vpt = 2
    while -(-n // vpt) > MAX_THREADS:
        vpt *= 2
    threads = -(-(-(-n // vpt)) // 32) * 32
    return threads, vpt


def adaln_norm_cuda(x, shift, scale, weight, bias, gate=None, residual=None,
                    *, eps: float = 1e-5):
    """x/residual: (B, S, d); shift/scale/gate: (B, d) with unit stride in
    d (any row stride); weight/bias: (d,).  All float32 on one CUDA device,
    d <= 4096.
    """
    epilogue = residual is not None
    if epilogue != (gate is not None):
        raise ValueError("adaln_norm: gate and residual go together")
    if x.dim() != 3:
        raise ValueError(f"adaln_norm: x must be (B, S, d), got {tuple(x.shape)}")
    refuse_grad("adaln_norm", x, shift, scale, weight, bias, gate, residual)
    b, s, d = x.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"adaln_norm_cuda: x is on {dev}")
    if d > MAX_D:
        raise ValueError(f"adaln_norm: d={d} > {MAX_D} is not supported")
    check_operand("x", x, dev, (b, s, d))
    check_operand("weight", weight, dev, (d,))
    check_operand("bias", bias, dev, (d,))
    for name, t in (("shift", shift), ("scale", scale)) + (
            (("gate", gate),) if epilogue else ()):
        check_operand(name, t, dev, (b, d), contiguous=False)
    if epilogue:
        check_operand("residual", residual, dev, (b, s, d))
    y = torch.empty_like(x)
    r = torch.empty_like(x) if epilogue else None
    if x.numel() == 0:
        return (y, r) if epilogue else y
    width = load_width(x, shift, scale, weight, bias, gate, residual)
    threads, vpt = launch_shape(d, width)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.adaln_norm_f32(
            x.data_ptr(), residual.data_ptr() if epilogue else None,
            gate.data_ptr() if epilogue else None,
            gate.stride(0) if epilogue else 0,
            shift.data_ptr(), shift.stride(0),
            scale.data_ptr(), scale.stride(0),
            weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), r.data_ptr() if epilogue else None,
            b * s, s, d, width, threads, vpt, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("adaln_norm", err)
    LAUNCHES["adaln_norm_epilogue" if epilogue else "adaln_norm"] += 1
    return (y, r) if epilogue else y
