"""Wrapper of the row RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Replaces ``repro.kernels.rmsnorm.rmsnorm_pallas``: ``x * (mean(x^2) + eps)
** -0.5 * scale`` over the last axis, reduced in float32, in float32 or,
as the reference's kernel takes it, bfloat16 (x, scale and y bfloat16;
the ``rmsnorm_bf16`` launch).  Its plain version is
:func:`repro_torch.kernels.ref.rmsnorm`;
:func:`repro_torch.kernels.ops.rmsnorm` picks between them by the tensor's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (BF16, build, check_launch, check_operand,
                                 launched, variant)

MAX_D = 8192          # a row lives in one block's registers
MAX_THREADS = 1024
MANY_ROWS = 512       # from here two rows a block (rows_per_block)


def work(x_shape, x_bytes: int = 4, scale_bytes: int = 4):
    """(flops, bytes) of one call: 4 flops an element (square, sum,
    scale twice), x read, y written and scale read once, at ``x_bytes``
    and ``scale_bytes`` an element."""
    d = x_shape[-1]
    rows = int(np.prod(x_shape[:-1], dtype=np.int64))
    return 4.0 * rows * d, float(x_bytes * 2 * rows * d + scale_bytes * d)


def backward_work(x_shape):
    """(flops, bytes) of the gradient of x and scale: 10 flops an
    element, x, dy and scale read, dx and dscale written once."""
    d = x_shape[-1]
    rows = int(np.prod(x_shape[:-1], dtype=np.int64))
    return 10.0 * rows * d, 4.0 * (3 * rows * d + 2 * d)


def load_width(x, scale):
    """Values per load and store: 16 bytes of x (4 floats, 8 bfloat16)
    where d is a multiple of that and x and scale start on a 16-byte
    boundary (x is contiguous, so every row then does, and y is a fresh
    allocation); else 1."""
    wide = 16 // x.element_size()
    if x.shape[-1] % wide or x.data_ptr() % 16 or scale.data_ptr() % 16:
        return 1
    return wide


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
    """x: (..., d) contiguous; scale: (d,); on one CUDA device, d <= 8192;
    float32 or bfloat16, scale in x's dtype.  Returns x's
    shape and dtype."""
    if x.dim() == 0:
        raise ValueError("rmsnorm: x must have a feature axis")
    d = x.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_cuda: x is on {dev}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} outside 1..{MAX_D}")
    check_operand("x", x, dev, x.shape, dtypes=(torch.float32, BF16))
    check_operand("scale", scale, dev, (d,), dtypes=(x.dtype,))
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    width = load_width(x, scale)
    threads, vpt = launch_shape(d, width)
    lib = build.library()
    name = variant("rmsnorm", x)
    args = (x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, width,
            threads, vpt, rows_per_block(rows))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        fn = lib.rmsnorm_bf16 if x.dtype == BF16 else lib.rmsnorm_f32
        err = fn(*args, float(eps), stream)
    check_launch(name, err)
    launched(name, work(x.shape, x.element_size(), scale.element_size()))
    return y
