"""Public kernel ops, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot);
a CPU tensor takes the plain PyTorch version from :mod:`repro_torch.kernels.
ref`.  There is no fallback from the card to the plain version and no knob
that selects it: the device is the only input to the choice, where the
reference's ``impl`` argument chose between Pallas and XLA.

Where autograd records (grad mode on and an input that requires grad), a
CUDA tensor goes through the kernel's ``torch.autograd.Function``
(``flash_attention``, ``rmsnorm``: :mod:`repro_torch.kernels.grad`;
``adaln_norm``, both forms, and ``ssm_scan``: forward and backward
kernels), and the CPU's plain versions are differentiated by autograd
itself.  ``decode_attention`` has no backward and refuses; so does
``adaln_norm`` with a bfloat16 operand, whose backward kernel is float32
only (on the card and on meta).

A bfloat16 input takes the kernel's bfloat16 variant on the card (where
the kernel has one) and, on the CPU, the same plain version, which
computes in float32 from any input dtype and rounds once to the output's,
as the reference's Pallas bodies do; either is charged under the
variant's name (:func:`repro_torch.kernels.variant`).

A meta tensor gets its output's shape and dtype and runs nothing, with a
gradient of the right shapes where one is wanted: the cost counter's dry run
(:mod:`repro_torch.launch.dryrun`) takes every kernel this way.  Every op
is charged to a counter in effect by its kernel's formula, once a call
(:func:`repro_torch.kernels.opaque`); on the CPU under a counter the
plain version runs as one autograd node (:func:`repro_torch.kernels.
unlaunched`), and with no counter exactly as it ran before counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (opaque, ref, refuse_grad, unlaunched,
                                 variant, wants_grad)
from repro_torch.kernels import adaln_norm as _adaln
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssm_scan as _scan
from repro_torch.kernels.adaln_norm import adaln_norm_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.grad import (AdaLNNormFn, FlashAttentionFn,
                                     RmsNormFn, refuse_bf16_grad)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.ssm_scan import SsmScanFn, ssm_scan_cuda


def _no_path(op: str, device):
    return ValueError(f"{op}: no implementation for device {device} "
                      "(CUDA runs the kernel, the CPU the plain version, "
                      "meta the shapes)")


def _empty(*specs):
    """Meta outputs of ``specs``, each (shape, dtype): the dtype the
    kernel writes."""
    out = tuple(torch.empty(s, dtype=dt, device="meta") for s, dt in specs)
    return out if len(out) > 1 else out[0]


@opaque
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float | None = None):
    """Causal/windowed GQA attention.  q: (B,Sq,H,D); k,v: (B,Sk,KH,D)."""
    if q.device.type == "cuda":
        if wants_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                          scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)

    def plain(q, k, v):
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)

    if q.device.type in ("cpu", "meta"):
        mask = dict(causal=causal, window=window, q_offset=q_offset,
                    itemsize=q.element_size())
        name = variant("flash_attention", q)
        return unlaunched(
            name, _flash.work(q.shape, k.shape, **mask),
            (q, k, v), plain, lambda q, k, v: _empty((q.shape, q.dtype)),
            (name + "_backward",
             lambda _: _flash.backward_work(q.shape, k.shape, **mask)))
    raise _no_path("flash_attention", q.device)


@opaque
def adaln_norm(x, shift, scale, weight, bias, gate=None, residual=None, *,
               eps: float = 1e-5):
    """Fused DiT adaLN: LayerNorm + shift/scale modulation.

    x: (B, S, d); shift/scale/gate: (B, d) or (B, 1, d); weight/bias: (d,).
    With ``gate``+``residual`` the previous sublayer's gated residual add is
    fused in first and ``(y, new_residual)`` is returned.
    """
    b, _, d = x.shape
    shift, scale = shift.reshape(b, d), scale.reshape(b, d)
    if gate is not None:
        gate = gate.reshape(b, d)
    if x.device.type == "cuda":
        if wants_grad(x, shift, scale, weight, bias, gate, residual):
            return AdaLNNormFn.apply(x, shift, scale, weight, bias, gate,
                                     residual, eps)
        return adaln_norm_cuda(x, shift, scale, weight, bias, gate=gate,
                               residual=residual, eps=eps)
    epilogue = residual is not None

    def plain(x, shift, scale, weight, bias, gate, residual):
        return ref.adaln_norm(x, shift, scale, weight, bias, gate=gate,
                              residual=residual, eps=eps)

    if x.device.type in ("cpu", "meta"):
        name = variant("adaln_norm_epilogue" if epilogue else "adaln_norm",
                       x)
        s = x.shape[1]
        operands = (x, shift, scale, weight, bias, gate, residual)
        if x.device.type == "meta" and wants_grad(*operands):
            refuse_bf16_grad(*operands)
        return unlaunched(
            name, _adaln.work(b, s, d, epilogue, x.element_size(),
                              weight.element_size()),
            operands, plain,
            lambda x, *_: _empty(*[(x.shape, x.dtype)] * (1 + epilogue)),
            (name + "_backward", lambda grads: _adaln.backward_work(
                b, s, d, epilogue, epilogue and grads[1] is not None,
                x.element_size())))
    raise _no_path("adaln_norm", x.device)


@opaque
def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None):
    """Single-token GQA cache attention.  q: (B,H,D); caches: (B,S,KH,D);
    lengths: (B,) int32."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, lengths,
                                     scale=scale)

    def plain(q, k_cache, v_cache, lengths):
        return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)

    if q.device.type in ("cpu", "meta"):
        if q.device.type == "meta":
            refuse_grad("decode_attention", q, k_cache, v_cache)
        return unlaunched(variant("decode_attention", k_cache),
                          _decode.work(q.shape, k_cache.shape,
                                       q.element_size(),
                                       k_cache.element_size()),
                          (q, k_cache, v_cache, lengths), plain,
                          lambda q, *_: _empty((q.shape, q.dtype)))
    raise _no_path("decode_attention", q.device)


@opaque
def rmsnorm(x, scale, *, eps: float = 1e-6):
    """Row RMSNorm over the last axis.  x: (..., D); scale: (D,)."""
    if x.device.type == "cuda":
        if wants_grad(x, scale):
            return RmsNormFn.apply(x, scale, eps)
        return rmsnorm_cuda(x, scale, eps=eps)

    def plain(x, scale):
        return ref.rmsnorm(x, scale, eps=eps)

    if x.device.type in ("cpu", "meta"):
        name = variant("rmsnorm", x)
        return unlaunched(name, _rms.work(x.shape, x.element_size(),
                                          scale.element_size()),
                          (x, scale), plain,
                          lambda x, _: _empty((x.shape, x.dtype)),
                          (name + "_backward",
                           lambda _: _rms.backward_work(x.shape)))
    raise _no_path("rmsnorm", x.device)


@opaque
def ssm_scan(u, delta, a, bmat, cmat, d, *, return_state: bool = False):
    """Selective scan from a zero state.  u, delta: (B, L, Din); a: (Din,
    N); bmat, cmat: (B, L, N); d: (Din,).  Returns y (B, L, Din), or (y,
    h_final) with ``return_state`` (the reference's ``ops.ssm_scan``
    returns y only and its prefill takes the state from ``ref.ssm_scan``;
    here both are the kernel on the card).  On the card only y carries a
    gradient, so ``return_state`` there wants grad mode off."""
    if u.device.type == "cuda":
        if wants_grad(u, delta, a, bmat, cmat, d):
            if return_state:
                raise NotImplementedError(
                    "ssm_scan: on the card the final state carries no "
                    "gradient; call the prefill under torch.no_grad()")
            return SsmScanFn.apply(u, delta, a, bmat, cmat, d)
        y, h_final, _ = ssm_scan_cuda(u, delta, a, bmat, cmat, d,
                                      return_state=return_state)
        return (y, h_final) if return_state else y

    def plain(*args):
        y, h_final = ref.ssm_scan(*args)
        return (y, h_final) if return_state else y

    args = (u, delta, a, bmat, cmat, d)
    if u.device.type in ("cpu", "meta"):
        b, _, din = u.shape
        n = a.shape[1]
        if u.device.type == "meta" and return_state and wants_grad(*args):
            raise NotImplementedError(
                "ssm_scan: on the card the final state carries no "
                "gradient; call the prefill under torch.no_grad()")
        return unlaunched(
            variant("ssm_scan", u),
            _scan.work(u.shape, n, return_state, u.element_size()), args,
            plain, lambda u, *_: _empty(
                (u.shape, u.dtype),
                *[((b, din, n), torch.float32)] * return_state),
            (variant("ssm_scan_backward", u),
             lambda _: _scan.backward_work(u.shape, n, u.element_size())))
    raise _no_path("ssm_scan", u.device)
