"""Gradients of the ``flash_attention``, ``rmsnorm`` and ``adaln_norm``
kernels on the card.

Each kernel becomes a :class:`torch.autograd.Function` whose forward is the
kernel, unchanged.  The reference has no backward kernel for any of them
(XLA differentiates its plain versions).  :class:`AdaLNNormFn`'s backward
is a kernel of its own (``csrc/adaln_norm_backward.cu``, plain version
:func:`repro_torch.kernels.ref.adaln_norm_backward`);
:class:`FlashAttentionFn` and :class:`RmsNormFn` write the gradient out in
torch ops, and hand-written backward kernels for those two are queued in
ROADMAP Queue 2 item 6.  The formulas are plain functions of tensors, so
the CPU tests hold them against autograd of the plain versions and
against ``jax.grad`` of the reference's.  (The scan's gradient is a
kernel too: :mod:`repro_torch.kernels.ssm_scan`.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import BF16, charge, opaque, variant
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels.adaln_norm import (adaln_norm_backward_cuda,
                                           adaln_norm_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda


def attention_backward(q, k, v, o, do, *, causal: bool = True,
                       window: int = 0, q_offset: int = 0,
                       scale: float | None = None):
    """(dq, dk, dv) of ``o = attention(q, k, v)`` given ``do``.

    q, o, do: (B, Sq, H, D); k, v: (B, Sk, KH, D).  P is recomputed from q
    and k under the forward's mask; then dV = P^T dO, dS = P * (dP -
    rowsum(dO * O)) with dP = dO V^T, dQ = scale dS K and dK = scale dS^T Q.
    Masked scores are constants in the forward (the finite -1e30), so dS is
    zero there.  With GQA each kv head sums the gradients of its H/KH query
    heads.  Float32 throughout."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    of, dof = o.float(), do.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", qf, kf) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = scores.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(scores, dim=-1)                        # (B, H, Sq, Sk)
    dv = torch.einsum("bhqs,bqhd->bshd", p, dof)
    dp = torch.einsum("bqhd,bshd->bhqs", dof, vf)
    rows = (dof * of).sum(-1).permute(0, 2, 1)[..., None]    # (B, H, Sq, 1)
    ds = (p * (dp - rows)).masked_fill(~mask[None, None], 0.0)
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqs,bqhd->bshd", ds, qf) * scale
    if g > 1:
        dk = dk.reshape(b, sk, kh, g, d).sum(3)
        dv = dv.reshape(b, sk, kh, g, d).sum(3)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


def rmsnorm_backward(x, scale, dy, eps: float = 1e-6):
    """(dx, dscale) of ``y = x * r * scale``, r = (mean(x^2) + eps)^-1/2,
    over the last axis: with gs = dy * scale,
    dx = r * gs - x * r^3 * mean(gs * x), and dscale sums dy * x * r over
    the rows.  Float32 throughout."""
    x32, dy32, w = x.float(), dy.float(), scale.float()
    r = ((x32 * x32).mean(dim=-1, keepdim=True) + eps) ** -0.5
    gs = dy32 * w
    dx = r * gs - x32 * r ** 3 * (gs * x32).mean(dim=-1, keepdim=True)
    dscale = (dy32 * x32 * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on the card with a gradient for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        o = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        return o

    @staticmethod
    @opaque
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        mask = {n: ctx.mask[n] for n in ("causal", "window", "q_offset")}
        charge(variant("flash_attention", q) + "_backward",
               fa.backward_work(q.shape, k.shape, **mask,
                                itemsize=q.element_size()))
        dq, dk, dv = attention_backward(q, k, v, o, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None


class RmsNormFn(torch.autograd.Function):
    """``rmsnorm`` on the card with a gradient for x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps=eps)

    @staticmethod
    @opaque
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        charge(variant("rmsnorm", x) + "_backward",
               rms.backward_work(x.shape))
        dx, dscale = rmsnorm_backward(x, scale, dy, ctx.eps)
        return dx, dscale, None


def refuse_bf16_grad(*operands) -> None:
    """Raise where any of ``operands``, those of an ``adaln_norm`` call
    that wants a gradient, is bfloat16: the backward kernel takes float32
    only, and the reference never trains the DiT in bfloat16 (its
    ``gdm_loss`` over a bfloat16 latent computes in float32)."""
    if any(t is not None and t.dtype == BF16 for t in operands):
        raise NotImplementedError(
            "adaln_norm: the backward kernel takes float32 only, and has "
            "no bfloat16 variant since the reference never trains the DiT "
            "in bfloat16 (its gdm_loss computes in float32); call it under "
            "torch.no_grad() or in float32")


class AdaLNNormFn(torch.autograd.Function):
    """``adaln_norm`` on the card, both forms, with a gradient for every
    operand: the forward kernel, then the backward kernel, which
    recomputes the row statistics from the saved operands.  In the
    epilogue form the output is ``(y, r)``; an unused r brings no
    gradient (grads are not materialised), so the kernel reads no dr.
    Float32 only: a bfloat16 operand raises (:func:`refuse_bf16_grad`)."""

    @staticmethod
    def forward(ctx, x, shift, scale, weight, bias, gate, residual, eps):
        refuse_bf16_grad(x, shift, scale, weight, bias, gate, residual)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, shift, scale, weight, bias, gate, residual)
        ctx.eps = eps
        return adaln_norm_cuda(x, shift, scale, weight, bias, gate=gate,
                               residual=residual, eps=eps)

    @staticmethod
    @opaque
    def backward(ctx, dy, dr=None):
        x, shift, scale, weight, bias, gate, residual = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = adaln_norm_backward_cuda(
            x, shift, scale, weight, bias, dy, gate=gate, residual=residual,
            dr=None if dr is None else dr.contiguous(), eps=ctx.eps)
        if residual is None:
            return grads + (None, None, None)
        return grads + (None,)
