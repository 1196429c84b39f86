"""Wrapper of the row RMSNorm CUDA kernels (``csrc/rmsnorm.cu``).

Replaces ``repro.kernels.rmsnorm.rmsnorm_pallas``: ``x * (mean(x^2) + eps)
** -0.5 * scale`` over the last axis, reduced in float32, in float32 or,
as the reference's kernel takes it, bfloat16 (x and y bfloat16, scale
bfloat16 or float32; the ``rmsnorm_bf16`` launch).  Its plain version is
:func:`repro_torch.kernels.ref.rmsnorm`;
:func:`repro_torch.kernels.ops.rmsnorm` picks between them by the tensor's
device.  :func:`launch_plan` picks one of the source's two kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import (BF16, build, check_launch, check_operand,
                                 launched, variant)

MAX_D = 8192          # a row lives in one block's registers
MAX_THREADS = 1024
WARP = 32
MANY_ROWS = 512       # from here two rows a block (rows_per_block)
# the kernels of ``csrc/rmsnorm.cu`` (``Plan.kernel``)
BLOCK, ROW = 0, 1


class Plan(NamedTuple):
    """One call's launch: ``kernel`` (BLOCK or ROW), threads and vectors a
    thread, rows a block (the block kernel's 1 or 2; 1 for the row
    kernel)."""
    kernel: int
    threads: int
    vpt: int
    rows_per_block: int


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _warps(threads: int) -> int:
    """``threads`` rounded up to a whole number of warps, one at least."""
    return max(WARP, _cdiv(threads, WARP) * WARP)


def launch_shape(d: int, width: int):
    """(threads, vectors per thread) of the block kernel's row: four
    vectors a thread while a row has at most 4096 vectors, else eight; a
    whole number of warps."""
    n = d // width
    vpt = 4
    while _cdiv(n, vpt) > MAX_THREADS:
        vpt *= 2
    return _warps(_cdiv(n, vpt)), vpt


def rows_per_block(rows: int) -> int:
    """Rows a block takes: two where a call has ``MANY_ROWS`` or more (the
    two share each thread's slice of scale, so an SM holds twice the rows
    in the same registers), one below, so that a decode row pays for no
    second row's sums."""
    return 2 if rows >= MANY_ROWS else 1


def lane_shape(d: int, width: int):
    """(threads, vectors per thread) of the row kernel: two vectors a lane,
    so a bfloat16 row of 1024 is two warps and one of 4096 is 256 threads;
    a whole number of warps."""
    return _warps(_cdiv(d // width, 2)), 2


def launch_plan(rows: int, d: int, dtype, width=None) -> Plan:
    """The kernel and launch shape of a call on ``rows`` rows of ``d``
    values of ``dtype``, moving ``width`` values a load
    (:func:`load_width`; by default 16 bytes).

    bfloat16 rows that move 16 bytes a load take the row kernel
    (:func:`lane_shape`), at every row count; float32, and bfloat16 values
    that cannot move 16 bytes at a time, take the block kernel
    (:func:`launch_shape`, :func:`rows_per_block`).

    The choice was read from a sweep of launch plans on an NVIDIA H100
    80GB HBM3 at 700 W, at rows in {1, 128, 512, 1024, 2048, 8192} x d in
    {1024, 4096, 7168, 8192}: the row kernel ran ahead of the block
    kernel's 16-byte bfloat16 form at every shape, so no row count moves
    the choice.  A persistent kernel streaming rows through a ring of bulk
    copies ran ahead of it at 1024-3008 rows of 7168 and behind it at
    d <= 4096; no path launches the former shapes, so it was not kept.
    float32 keeps the block kernel: the row kernel did not run every
    float32 shape as fast."""
    wide = 16 // dtype.itemsize
    width = wide if width is None else width
    if dtype != BF16 or width != wide:
        return Plan(BLOCK, *launch_shape(d, width), rows_per_block(rows))
    return Plan(ROW, *lane_shape(d, width), 1)


def scale_dtypes(x_dtype):
    """The scale dtypes the kernels take over rows of ``x_dtype``: float32
    or bfloat16 over bfloat16 rows (the reference's kernel widens either),
    float32 over float32 rows."""
    return (torch.float32, BF16) if x_dtype == BF16 else (torch.float32,)


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """x: (..., d) contiguous; scale: (d,); on one CUDA device, d <= 8192;
    x float32 or bfloat16, scale as :func:`scale_dtypes` allows.  Returns
    x's shape and dtype."""
    if x.dim() == 0:
        raise ValueError("rmsnorm: x must have a feature axis")
    d = x.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_cuda: x is on {dev}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} outside 1..{MAX_D}")
    check_operand("x", x, dev, x.shape, dtypes=(torch.float32, BF16))
    check_operand("scale", scale, dev, (d,), dtypes=scale_dtypes(x.dtype))
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    width = load_width(x, scale)
    plan = launch_plan(rows, d, x.dtype, width)
    lib = build.library()
    name = variant("rmsnorm", x)
    args = (x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, width,
            plan.threads, plan.vpt, plan.rows_per_block, plan.kernel)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if x.dtype == BF16:
            err = lib.rmsnorm_bf16(*args, int(scale.dtype == torch.float32),
                                   float(eps), stream)
        else:
            err = lib.rmsnorm_f32(*args, float(eps), stream)
    check_launch(name, err)
    launched(name, work(x.shape, x.element_size(), scale.element_size()))
    return y
