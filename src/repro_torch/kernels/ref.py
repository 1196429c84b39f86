"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, in the same op order as
its counterpart in ``repro.kernels.ref``.  They are what a CPU tensor runs
(:mod:`repro_torch.kernels.ops`), the oracle the CPU tests pin to the JAX
reference, and what ``chip_smoke.py`` holds each kernel against on the
card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, scale: float | None = None):
    """Reference attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0.
    ``q_offset``: global position of q[0] (for chunked prefill).
    ``window``: 0 -> full; >0 -> sliding window of that many positions.
    Returns (B, Sq, H, D) in q.dtype; accumulation in float32.  GQA
    repeats each kv head over its H/KH query heads.
    """
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
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
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, vf)
    return out.to(q.dtype)


def adaln_norm(x, shift, scale, weight, bias, gate=None, residual=None,
               *, eps: float = 1e-5):
    """Fused DiT adaLN: ``LN(x) * (1 + scale) + shift``.

    x/residual: (B, S, d); shift/scale/gate: (B, d) per-batch modulation
    vectors; weight/bias: (d,) LayerNorm affine params.  With ``gate`` and
    ``residual`` the previous sublayer's gated residual add is folded in
    first (``r = residual + gate * x``) and ``(y, r)`` is returned.  Float32
    throughout, cast once at the end; the variance is the mean of squared
    deviations (ddof 0).
    """
    x32 = x.float()
    if residual is not None:
        x32 = residual.float() + gate.float()[:, None, :] * x32
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * (var + eps) ** -0.5
    y = y * weight.float() + bias.float()
    y = y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    y = y.to(x.dtype)
    return y if residual is None else (y, x32.to(x.dtype))
