"""Wrapper of the row RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Replaces ``repro.kernels.rmsnorm.rmsnorm_pallas``: ``x * (mean(x^2) + eps)
** -0.5 * scale`` over the last axis, reduced in float32.  Its plain
version is :func:`repro_torch.kernels.ref.rmsnorm`;
:func:`repro_torch.kernels.ops.rmsnorm` picks between them by the tensor's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, check_launch, check_operand, launched

MAX_D = 8192          # a row lives in one block's registers
MAX_THREADS = 1024
MANY_ROWS = 512       # from here two rows a block (rows_per_block)


def work(x_shape):
    """(flops, bytes) of one call: 4 flops an element (square, sum,
    scale twice), x read, y written and scale read once, float32."""
    d = x_shape[-1]
    rows = int(np.prod(x_shape[:-1], dtype=np.int64))
    return 4.0 * rows * d, 4.0 * (2 * rows * d + d)


def backward_work(x_shape):
    """(flops, bytes) of the gradient of x and scale: 10 flops an
    element, x, dy and scale read, dx and dscale written once."""
    d = x_shape[-1]
    rows = int(np.prod(x_shape[:-1], dtype=np.int64))
    return 10.0 * rows * d, 4.0 * (3 * rows * d + 2 * d)


def load_width(x, scale):
    """Floats per load and store: 4 (16 bytes) where d % 4 == 0 and x and
    scale start on a 16-byte boundary (x is contiguous, so every row then
    does, and y is a fresh allocation); else 1."""
    if x.shape[-1] % 4 or x.data_ptr() % 16 or scale.data_ptr() % 16:
        return 1
    return 4


def launch_shape(d: int, width: int):
    """(threads, vectors per thread) of a block's row: four vectors a
    thread while a row has at most 4096 vectors, else eight; a whole number
    of warps."""
    n = d // width
    vpt = 4
    while -(-n // vpt) > MAX_THREADS:
        vpt *= 2
    threads = -(-(-(-n // vpt)) // 32) * 32
    return threads, vpt


def rows_per_block(rows: int) -> int:
    """Rows a block takes: two where a call has ``MANY_ROWS`` or more (the
    two share each thread's slice of scale, so an SM holds twice the rows
    in the same registers), one below, so that a decode row pays for no
    second row's sums."""
    return 2 if rows >= MANY_ROWS else 1


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
    width = load_width(x, scale)
    threads, vpt = launch_shape(d, width)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.rmsnorm_f32(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                              rows, d, width, threads, vpt,
                              rows_per_block(rows), float(eps),
                              torch.cuda.current_stream(dev).cuda_stream)
    check_launch("rmsnorm", err)
    launched("rmsnorm", work(x.shape))
    return y
