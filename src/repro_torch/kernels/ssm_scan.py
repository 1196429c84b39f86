"""Wrappers of the selective-scan CUDA kernels, forward
(``csrc/ssm_scan.cu``) and backward (``csrc/ssm_scan_backward.cu``), and
the autograd function that joins them.

The forward replaces ``repro.kernels.ssm_scan.ssm_scan_pallas`` and, unlike
it, can also return the final state (the reference's prefill takes that
from its plain scan) and save the chunk-start states its backward needs;
it runs in float32 or, as the reference's Mamba block calls it in
bfloat16, with bfloat16 u, delta, B and C and float32 A and D (the
``ssm_scan_bf16`` launch: y bfloat16, the state and its checkpoints
float32).
The backward has no Pallas counterpart: the reference differentiates its
plain scan with XLA, which a kernel of the port does instead.  It runs in
float32 or, for the bfloat16 forward, with bfloat16 u, delta, B, C and dy
(the ``ssm_scan_backward_bf16`` launch: du, ddelta, dB and dC bfloat16,
rounded once, dA and dD float32, as the reference's gradient of its
float32 upcast gives them; the checkpoints, the workspace and every sum
float32).  The plain
version is :func:`repro_torch.kernels.ref.ssm_scan`, differentiated by
autograd; :func:`repro_torch.kernels.ops.ssm_scan` picks between them by
the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (BF16, build, check_launch, check_operand,
                                 launched, opaque, variant)

MAX_N = 16            # the states a channel keeps in registers
FWD_THREADS = 128     # threads a block of the forward kernel


def state_tile(n: int) -> int:
    """The states the kernels keep a channel: N padded to 4, 8 or 16."""
    return 4 if n <= 4 else (8 if n <= 8 else 16)


def scan_lanes(batch: int, din: int, n: int, sms: int) -> int:
    """Threads a channel of the forward kernel, a rule of the shape: one
    where one thread a channel (128 channels a block) gives each of the
    card's ``sms`` SMs a block, else ``state_tile(n) // 4``, four states a
    thread (Jamba's prefill, B=1 and Din=8192: 64 blocks of one thread a
    channel left half an H100 idle, four threads make 256)."""
    if batch * -(-din // FWD_THREADS) >= sms:
        return 1
    return state_tile(n) // 4


def work(u_shape, n: int, return_state: bool = False, itemsize: int = 4):
    """(flops, bytes) of the forward on u (B, L, Din) with N states: 6
    flops per (b, t, d, n) and 3 per (b, t, d) (its exponentials not
    counted); u, dt read, y written, B, C read (``itemsize`` bytes an
    element), A, D read once, and h_final written where returned
    (float32)."""
    b, length, din = u_shape
    rows, small = b * length * din, b * length * n
    return (float(rows * (6 * n + 3)),
            float(itemsize * (3 * rows + 2 * small)
                  + 4 * (din * n + din
                         + (b * din * n if return_state else 0))))


def backward_work(u_shape, n: int, itemsize: int = 4):
    """(flops, bytes) of the backward: 16 flops per (b, t, d, n) and 6
    per (b, t, d) (the forward's recomputation not counted); u, dt, dy,
    B, C read and du, ddt, dB, dC written once (``itemsize`` bytes an
    element), A, D read and dA, dD written once (float32)."""
    b, length, din = u_shape
    rows, small = b * length * din, b * length * n
    return (float(rows * (16 * n + 6)),
            float(itemsize * (5 * rows + 4 * small)
                  + 4 * 2 * (din * n + din)))


def _check(u, delta, a, bmat, cmat, d, dtypes=(torch.float32,)):
    if u.dim() != 3 or a.dim() != 2:
        raise ValueError("ssm_scan: u must be (B, L, Din) and a (Din, N)")
    b, length, din = u.shape
    n = a.shape[1]
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan_cuda: u is on {dev}")
    if not 0 < n <= MAX_N:
        raise ValueError(f"ssm_scan: d_state={n} outside 1..{MAX_N}")
    if b > 65535:
        raise ValueError(f"ssm_scan: batch {b} > 65535")
    check_operand("u", u, dev, (b, length, din), dtypes=dtypes)
    same = (u.dtype,)
    check_operand("delta", delta, dev, (b, length, din), dtypes=same)
    check_operand("a", a, dev, (din, n))
    check_operand("bmat", bmat, dev, (b, length, n), dtypes=same)
    check_operand("cmat", cmat, dev, (b, length, n), dtypes=same)
    check_operand("d", d, dev, (din,))
    return b, length, din, n, dev


def ssm_scan_cuda(u, delta, a, bmat, cmat, d, *, return_state: bool = False,
                  save_states: bool = False):
    """u, delta: (B, L, Din); a: (Din, N); bmat, cmat: (B, L, N); d: (Din,).
    Contiguous on one CUDA device, N <= 16; u, delta, bmat and cmat all
    float32 or all bfloat16, a and d float32; the state starts at 0.
    Returns (y (B, L, Din) in u's dtype, h_final (B, Din, N) float32 or
    None, states or None): h_final with ``return_state``, the chunk-start
    states the backward reads with ``save_states``."""
    b, length, din, n, dev = _check(u, delta, a, bmat, cmat, d,
                                    dtypes=(torch.float32, BF16))
    y = torch.empty_like(u)
    h_final = torch.empty(b, din, n, device=dev) if return_state else None
    if length == 0 or din == 0 or b == 0:
        if h_final is not None:
            h_final.zero_()
        return y, h_final, (torch.empty(0, device=dev) if save_states
                            else None)
    lib = build.library()
    states = (torch.empty(lib.ssm_scan_states_floats(b, length, din, n),
                          device=dev) if save_states else None)
    name = variant("ssm_scan", u)
    entry = lib.ssm_scan_bf16 if u.dtype == BF16 else lib.ssm_scan_f32
    lanes = scan_lanes(
        b, din, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        err = entry(
            u.data_ptr(), delta.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), d.data_ptr(), y.data_ptr(),
            h_final.data_ptr() if h_final is not None else None,
            states.data_ptr() if states is not None else None,
            b, length, din, n, lanes,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(name, err)
    launched(name, work(u.shape, n, return_state, u.element_size()))
    return y, h_final, states


def ssm_scan_backward_cuda(u, delta, a, bmat, cmat, d, states, gy):
    """Gradients of y from the forward's inputs and its ``states``
    (``ssm_scan_cuda(..., save_states=True)``): gy (B, L, Din), in u's
    dtype, is the gradient of y.  Returns (gu, gdelta, ga, gb, gc, gd),
    each in its input's dtype."""
    b, length, din, n, dev = _check(u, delta, a, bmat, cmat, d,
                                    dtypes=(torch.float32, BF16))
    check_operand("gy", gy, dev, (b, length, din), dtypes=(u.dtype,))
    gu, gdelta = torch.empty_like(u), torch.empty_like(delta)
    ga, gd = torch.empty_like(a), torch.empty_like(d)
    gb, gc = torch.empty_like(bmat), torch.empty_like(cmat)
    if length == 0 or din == 0 or b == 0:
        for t in (ga, gb, gc, gd):
            t.zero_()
        return gu, gdelta, ga, gb, gc, gd
    lib = build.library()
    want = lib.ssm_scan_states_floats(b, length, din, n)
    if (states is None or states.device != dev
            or states.dtype != torch.float32 or states.numel() != want
            or not states.is_contiguous()):
        raise ValueError("ssm_scan_backward: states must be the forward's "
                         f"{want} float32 checkpoints on {dev}")
    work = torch.empty(
        lib.ssm_scan_backward_workspace_floats(b, length, din, n), device=dev)
    name = variant("ssm_scan_backward", u)
    entry = (lib.ssm_scan_backward_bf16 if u.dtype == BF16
             else lib.ssm_scan_backward_f32)
    with torch.cuda.device(dev):
        err = entry(
            u.data_ptr(), delta.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), d.data_ptr(), states.data_ptr(), gy.data_ptr(),
            gu.data_ptr(), gdelta.data_ptr(), ga.data_ptr(), gb.data_ptr(),
            gc.data_ptr(), gd.data_ptr(), work.data_ptr(),
            b, length, din, n,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(name, err)
    launched(name, backward_work(u.shape, n, u.element_size()))
    return gu, gdelta, ga, gb, gc, gd


class SsmScanFn(torch.autograd.Function):
    """The scan's y on the card with a gradient: the forward kernel (saving
    its chunk-start states), the backward kernel for every input, in
    float32 or bfloat16 as the forward ran."""

    @staticmethod
    def forward(ctx, u, delta, a, bmat, cmat, d):
        y, _, states = ssm_scan_cuda(u, delta, a, bmat, cmat, d,
                                     save_states=True)
        ctx.save_for_backward(u, delta, a, bmat, cmat, d, states)
        return y

    @staticmethod
    @opaque
    def backward(ctx, gy):
        u, delta, a, bmat, cmat, d, states = ctx.saved_tensors
        return ssm_scan_backward_cuda(u, delta, a, bmat, cmat, d, states,
                                      gy.contiguous())
