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


def adaln_norm_backward(x, shift, scale, weight, bias, dy, gate=None,
                        residual=None, dr=None, *, eps: float = 1e-5):
    """Gradients of :func:`adaln_norm`, written out in float32.

    With x' = x (or r = residual + gate * x in the epilogue form),
    xh = (x' - mean) * rstd and z = xh * w + b, so y = z * (1 + sc) + sh:
    dsh = sum_s dy, dsc = sum_s dy * z per batch row; dz = dy * (1 + sc),
    dw = sum dz * xh and db = sum dz over every row; with g = dz * w,
    dx' = rstd * (g - mean(g) - xh * mean(g * xh)) + dr (``dr``, the
    gradient of the returned r, is zero where absent).  In the epilogue
    form dresidual = dx', dgate = sum_s dx' * x and dx = gate * dx'.
    ``shift`` is not read: y is linear in it.  Returns the gradients in
    the forward's argument order, (dx, dshift, dscale, dweight, dbias),
    then (dgate, dresidual) in the epilogue form.
    """
    del shift
    x32, dy32 = x.float(), dy.float()
    xr = x32
    if residual is not None:
        xr = residual.float() + gate.float()[:, None, :] * x32
    mean = xr.mean(dim=-1, keepdim=True)
    var = xr.var(dim=-1, keepdim=True, correction=0)
    rstd = (var + eps) ** -0.5
    xh = (xr - mean) * rstd
    w = weight.float()
    z = xh * w + bias.float()
    dshift = dy32.sum(1)
    dscale = (dy32 * z).sum(1)
    dz = dy32 * (1.0 + scale.float()[:, None, :])
    dweight = (dz * xh).sum((0, 1))
    dbias = dz.sum((0, 1))
    g = dz * w
    dxr = rstd * (g - g.mean(dim=-1, keepdim=True)
                  - xh * (g * xh).mean(dim=-1, keepdim=True))
    if dr is not None:
        dxr = dxr + dr.float()
    out = (dxr, dshift, dscale, dweight, dbias)
    if residual is not None:
        out = (gate.float()[:, None, :] * dxr, dshift, dscale, dweight,
               dbias, (dxr * x32).sum(1), dxr)
    return out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None):
    """One query token against a KV cache.

    q: (B, H, D); k_cache/v_cache: (B, S, KH, D); lengths: (B,) int.
    Attends to cache positions [0, lengths[b]); masked scores are the
    finite -1e30, so a row with length 0 gets the uniform average of its S
    values.  GQA repeats each kv head over its G = H/KH query heads (query
    head h reads kv head h // G).  Returns (B, H, D).
    """
    b, h, d = q.shape
    _, s, kh, _ = k_cache.shape
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qf, kf, vf = q.float(), k_cache.float(), v_cache.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", qf, kf) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, vf)
    return out.to(q.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,).  Float32 reduction, output in x.dtype:
    ``x * (mean(x^2) + eps) ** -0.5``, then ``* scale``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * (var + eps) ** -0.5 * scale.float()).to(x.dtype)


def ssm_scan(u, delta, a, bmat, cmat, d, *, h0=None):
    """Selective SSM scan (Mamba), as ``repro.kernels.ref.ssm_scan``.

    u, delta: (B, L, Din); a: (Din, N); bmat, cmat: (B, L, N); d: (Din,);
    h0: optional initial state (B, Din, N).  Per step, in float32:
    ``h = exp(dt * a) * h + (dt * B_t) * u_t`` and ``y_t = sum(h * C_t)``;
    then ``y += u * d``.  Returns (y (B, L, Din) in u.dtype, h_final
    (B, Din, N) float32).  A Python loop over t: differentiable by
    autograd, which is how the CPU trains through it.
    """
    bsz, length, din = u.shape
    n = a.shape[-1]
    uf, df, af = u.float(), delta.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    h = (torch.zeros(bsz, din, n, device=u.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(length):
        dt = df[:, t]
        da = torch.exp(dt[..., None] * af[None])              # (B, Din, N)
        db = dt[..., None] * bf[:, t, None, :]                # (B, Din, N)
        h = da * h + db * uf[:, t, :, None]
        ys.append((h * cf[:, t, None, :]).sum(-1))            # (B, Din)
    y = torch.stack(ys, 1) if ys else uf.new_zeros(bsz, 0, din)
    y = y + uf * d.float()[None, None]
    return y.to(u.dtype), h
