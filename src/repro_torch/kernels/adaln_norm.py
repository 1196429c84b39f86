"""Wrapper of the fused adaLN CUDA kernel (``csrc/adaln_norm.cu``).

Replaces ``repro.kernels.adaln_norm.adaln_norm_pallas``: LayerNorm plus
adaLN modulation, ``y = (LN(x) * w + b) * (1 + scale) + shift``, and the
gated-residual epilogue that first forms ``r = residual + gate * x`` and
returns ``(y, r)``.  Its plain version is :func:`repro_torch.kernels.ref.
adaln_norm`; :func:`repro_torch.kernels.ops.adaln_norm` picks between them
by the tensor's device.  As the reference's kernel, it takes float32 or
bfloat16 activations (x, the residual and the modulation in one dtype,
launched as ``adaln_norm_bf16`` / ``adaln_norm_epilogue_bf16`` in
bfloat16: :func:`repro_torch.kernels.variant`) with float32 or bfloat16
``weight`` / ``bias``, computes in float32 and rounds each output once.

The gradient of both forms is a kernel too (``csrc/adaln_norm_backward.
cu``, :func:`adaln_norm_backward_cuda`, float32 only), with no Pallas
counterpart: the reference differentiates its plain version with XLA.
Its plain version is
:func:`repro_torch.kernels.ref.adaln_norm_backward`, and
:class:`repro_torch.kernels.grad.AdaLNNormFn` joins the two kernels.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import (BF16, build, check_launch, check_operand,
                                 launched, variant)

MAX_D = 4096          # a row lives in one block's (or warp's) registers
MAX_THREADS = 512
ROW_MAX_D = 1024      # the rows kernel's widest row: 32 values a lane
ROW_VECTORS = (1, 2, 3, 4, 6, 8)   # its vectors a lane (6 and 8: float32)
ROW_WARPS = 4         # its warps, one row each, a block
BF16_EPILOGUE_ROWS_PER_SM = 7   # the bfloat16 epilogue's least rows an SM
BLOCKS_PER_SM = 4     # the backward's row blocks: about four an SM
CLUSTER = 8           # the backward's blocks a cluster (csrc kCluster)
MAX_BATCH = 65535     # the backward's grid: a batch row a grid row


def work(b: int, s: int, d: int, epilogue: bool, itemsize: int = 4,
         param_itemsize: int | None = None):
    """(flops, bytes) of one call on (B, S, d): 10 flops an element (12
    with the epilogue), x (and residual) read, y (and r) written, the (B,
    d) modulation rows (and gate) read once at ``itemsize`` bytes an
    element, weight and bias once at ``param_itemsize`` (by default
    ``itemsize``)."""
    rows = b * s * d
    if param_itemsize is None:
        param_itemsize = itemsize
    return ((12.0 if epilogue else 10.0) * rows,
            float(itemsize * ((4 if epilogue else 2) * rows
                              + (3 if epilogue else 2) * b * d)
                  + param_itemsize * 2 * d))


def backward_work(b: int, s: int, d: int, epilogue: bool, with_dr: bool,
                  itemsize: int = 4):
    """(flops, bytes) of the backward: 20 flops an element (25 with the
    epilogue); x, dy read and dx written, with the epilogue residual read
    and dresidual written and dr read where given; scale (and gate) read
    and their (B, d) gradients written; weight, bias read and their
    gradients written; ``itemsize`` bytes an element."""
    rows = b * s * d
    return ((25.0 if epilogue else 20.0) * rows,
            float(itemsize * ((3 + 2 * epilogue + with_dr) * rows
                              + (5 if epilogue else 3) * b * d + 4 * d)))


def load_width(x, shift, scale, weight, bias, gate=None, residual=None):
    """Values per load and store: 16 bytes of x's dtype (4 floats, 8
    bfloat16) where d is a multiple of that, every tensor starts on a
    16-byte boundary and every modulation row stride is a multiple of
    that many values, so every row of every operand is aligned (x and the
    residual are contiguous; weight and bias move the same number of
    values, 8 or 32 bytes where their dtype is not x's); else 1."""
    wide = 16 // x.element_size()
    if x.shape[-1] % wide:
        return 1
    tensors = [t for t in (x, shift, scale, weight, bias, gate, residual)
               if t is not None]
    if any(t.data_ptr() % 16 for t in tensors):
        return 1
    if any(t.stride(0) % wide for t in (shift, scale, gate)
           if t is not None):
        return 1
    return wide


def launch_shape(d: int, width: int, itemsize: int = 4):
    """(threads, vectors per thread) of the block that owns one row in the
    block-a-row kernel: two vectors a thread while the row has at most
    1024, else four or eight (one 16-byte vector a thread in bfloat16,
    ``itemsize`` 2, which takes d <= 4096 in at most 512 threads); a
    whole number of warps."""
    n = d // width
    vpt = 1 if itemsize == 2 and width > 1 else 2
    while -(-n // vpt) > MAX_THREADS:
        vpt *= 2
    threads = -(-(-(-n // vpt)) // 32) * 32
    return threads, vpt


def row_vectors(b: int, s: int, d: int, sms: int, *, itemsize: int = 4,
                epilogue: bool = False):
    """Vectors a lane of the rows kernel (``csrc/adaln_norm.cu``,
    ``adaln_rows_kernel``: a warp a row, lane l holding 16-byte vectors
    l + 32 k of ``itemsize``-byte values, ``ROW_WARPS`` consecutive rows
    of one batch row a block) for (B, S, d) on a card of ``sms`` SMs: the
    fewest it is built for (``ROW_VECTORS``) that cover the row.  None
    where the block-a-row kernel (:func:`launch_shape`) takes the call:
    rows wider than ``ROW_MAX_D`` (a lane's share of a row and its
    parameters stay in registers up to 32 values), and the bfloat16
    epilogue at fewer than ``BF16_EPILOGUE_ROWS_PER_SM`` rows an SM, where
    its longer chain a lane (every value widened, the residual, the gate,
    r written) leaves a warp a row slower than a block a row (measured on
    an H100, ``PERF.md`` §6)."""
    if d > ROW_MAX_D or (epilogue and itemsize == 2 and
                         b * s < BF16_EPILOGUE_ROWS_PER_SM * sms):
        return None
    return next(v for v in ROW_VECTORS if 32 * v * (16 // itemsize) >= d)


def launch_plan(b: int, s: int, d: int, width: int, itemsize: int,
                epilogue: bool, sms: int):
    """(warp_rows, threads, vectors per thread) of a forward call: the
    rows kernel (warp_rows 1, a lane's vectors) where 16-byte loads and
    :func:`row_vectors` allow it, else the block-a-row kernel (0)."""
    vectors = (row_vectors(b, s, d, sms, itemsize=itemsize,
                           epilogue=epilogue) if width > 1 else None)
    if vectors is None:
        return (0,) + launch_shape(d, width, itemsize)
    return 1, 32 * ROW_WARPS, vectors


def backward_grid(b: int, s: int, sms: int):
    """(rows a block, blocks a cluster, blocks a batch row) of the
    backward: a block walks R rows of one batch row, R such that the
    B * S rows make about ``BLOCKS_PER_SM`` blocks an SM (at most S, as a
    block's rows share one batch row's modulation); a batch row's
    ceil(S / R) blocks are padded to a multiple of the cluster size, and
    a block past the last row adds zeros to its cluster's sums."""
    rows = min(s, max(1, -(-(b * s) // (BLOCKS_PER_SM * sms))))
    blocks = -(-(-(-s // rows)) // CLUSTER) * CLUSTER
    return rows, CLUSTER, blocks


def _check(x, shift, scale, weight, bias, gate, residual, *,
           dtypes=(torch.float32, BF16)):
    """Validate the operands; returns (b, s, d, device).  x takes one of
    ``dtypes``, the residual and the modulation x's; weight takes one of
    ``dtypes``, bias weight's."""
    epilogue = residual is not None
    if epilogue != (gate is not None):
        raise ValueError("adaln_norm: gate and residual go together")
    if x.dim() != 3:
        raise ValueError(f"adaln_norm: x must be (B, S, d), got {tuple(x.shape)}")
    b, s, d = x.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"adaln_norm_cuda: x is on {dev}")
    if d > MAX_D:
        raise ValueError(f"adaln_norm: d={d} > {MAX_D} is not supported")
    check_operand("x", x, dev, (b, s, d), dtypes=dtypes)
    check_operand("weight", weight, dev, (d,), dtypes=dtypes)
    check_operand("bias", bias, dev, (d,), dtypes=(weight.dtype,))
    for name, t in (("shift", shift), ("scale", scale)) + (
            (("gate", gate),) if epilogue else ()):
        check_operand(name, t, dev, (b, d), contiguous=False,
                      dtypes=(x.dtype,))
    if epilogue:
        check_operand("residual", residual, dev, (b, s, d),
                      dtypes=(x.dtype,))
    return b, s, d, dev


def adaln_norm_cuda(x, shift, scale, weight, bias, gate=None, residual=None,
                    *, eps: float = 1e-5):
    """x/residual: (B, S, d); shift/scale/gate: (B, d) with unit stride in
    d (any row stride); weight/bias: (d,).  On one CUDA device, d <= 4096;
    x, the residual and the modulation float32 or bfloat16 (one dtype),
    weight and bias float32 or bfloat16 (one dtype); y and r in x's dtype.
    Operands that allow 16-byte loads take the rows kernel (a warp a row)
    where it is the faster, everything else the block-a-row kernel
    (:func:`launch_plan`).  The output carries no graph: a gradient goes
    through :class:`repro_torch.kernels.grad.AdaLNNormFn` (float32 only).
    """
    epilogue = residual is not None
    b, s, d, dev = _check(x, shift, scale, weight, bias, gate, residual)
    y = torch.empty_like(x)
    r = torch.empty_like(x) if epilogue else None
    if x.numel() == 0:
        return (y, r) if epilogue else y
    width = load_width(x, shift, scale, weight, bias, gate, residual)
    warp_rows, threads, vpt = launch_plan(b, s, d, width, x.element_size(),
                                          epilogue, _sm_count(dev))
    lib = build.library()
    name = variant("adaln_norm_epilogue" if epilogue else "adaln_norm", x)
    with torch.cuda.device(dev):
        fn = lib.adaln_norm_bf16 if x.dtype == BF16 else lib.adaln_norm_f32
        err = fn(
            x.data_ptr(), residual.data_ptr() if epilogue else None,
            gate.data_ptr() if epilogue else None,
            gate.stride(0) if epilogue else 0,
            shift.data_ptr(), shift.stride(0),
            scale.data_ptr(), scale.stride(0),
            weight.data_ptr(), bias.data_ptr(), int(weight.dtype == BF16),
            y.data_ptr(), r.data_ptr() if epilogue else None,
            b * s, s, d, width, threads, vpt, warp_rows, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(name, err)
    launched(name, work(b, s, d, epilogue, x.element_size(),
                        weight.element_size()))
    return (y, r) if epilogue else y


def adaln_norm_backward_cuda(x, shift, scale, weight, bias, dy, gate=None,
                             residual=None, dr=None, *, eps: float = 1e-5):
    """Gradients of :func:`adaln_norm_cuda` from its operands (as the
    forward takes them) and dy (B, S, d), with dr (B, S, d), the gradient
    of the returned r, optional in the epilogue form.  Returns contiguous
    float32 gradients in the forward's argument order: (dx, dshift,
    dscale, dweight, dbias), then (dgate, dresidual) in the epilogue form.
    One launch, in clusters (:func:`backward_grid`)."""
    epilogue = residual is not None
    b, s, d, dev = _check(x, shift, scale, weight, bias, gate, residual,
                          dtypes=(torch.float32,))
    check_operand("dy", dy, dev, (b, s, d))
    if dr is not None:
        if not epilogue:
            raise ValueError("adaln_norm_backward: dr belongs to the "
                             "epilogue form")
        check_operand("dr", dr, dev, (b, s, d))
    dx = torch.empty_like(x)
    dshift = torch.empty(b, d, device=dev)
    dscale = torch.empty(b, d, device=dev)
    dweight = torch.empty(d, device=dev)
    dbias = torch.empty(d, device=dev)
    dgate = torch.empty(b, d, device=dev) if epilogue else None
    dres = torch.empty_like(x) if epilogue else None
    grads = (dx, dshift, dscale, dweight, dbias) + (
        (dgate, dres) if epilogue else ())
    if x.numel() == 0:
        for t in grads[1:]:
            t.zero_()
        return grads
    width = load_width(x, shift, scale, weight, bias, gate, residual)
    if any(t is not None and t.data_ptr() % 16 for t in (dy, dr)):
        width = 1
    threads, vpt = launch_shape(d, width)
    if b > MAX_BATCH:
        raise ValueError(f"adaln_norm_backward: B={b} > {MAX_BATCH} is not "
                         "supported")
    rows, cluster, blocks = backward_grid(b, s, _sm_count(dev))
    kp = 3 if epilogue else 2
    work = torch.empty(b * (blocks // cluster * kp + 2) * d, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaln_norm_backward_f32(
            x.data_ptr(), residual.data_ptr() if epilogue else None,
            gate.data_ptr() if epilogue else None,
            gate.stride(0) if epilogue else 0,
            scale.data_ptr(), scale.stride(0),
            weight.data_ptr(), bias.data_ptr(), dy.data_ptr(),
            dr.data_ptr() if dr is not None else None,
            dx.data_ptr(), dres.data_ptr() if epilogue else None,
            dweight.data_ptr(), dbias.data_ptr(), dshift.data_ptr(),
            dscale.data_ptr(), dgate.data_ptr() if epilogue else None,
            work.data_ptr(), _tickets(dev, stream).data_ptr(), b, s, d,
            width, threads, vpt, rows, cluster, blocks, eps, stream)
    name = ("adaln_norm_epilogue_backward" if epilogue
            else "adaln_norm_backward")
    check_launch(name, err)
    launched(name, backward_work(b, s, d, epilogue, dr is not None))
    return grads


@functools.lru_cache(maxsize=None)
def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    """The backward's ticket counters on one stream of ``dev``: (MAX_BATCH
    + 1) * CLUSTER integers, zeroed once; each launch leaves them zero."""
    return torch.zeros((MAX_BATCH + 1) * CLUSTER, dtype=torch.int32,
                       device=dev)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
