"""Mamba selective-SSM block (Jamba's non-attention layers), as
``repro.nn.ssm``.

The full-sequence path runs the ``ssm_scan`` kernel on the card
(:func:`repro_torch.kernels.ops.ssm_scan`; its plain version on the CPU),
the prefill path too, with the final state the kernel returns, where the
reference takes the state from its plain scan.  The decode path carries an
O(1) recurrent state (conv tail + SSM state) and runs one step in plain
PyTorch, as the reference does in plain jnp.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn.linear import Dense, _param, dense_apply


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, d_in): the causal conv's tail
    ssm: torch.Tensor    # (B, d_in, N) float32: the recurrent state


class DtProj(nn.Module):
    """``w`` (dt_rank, d_in) ~ N(0, 1/dt_rank); ``b`` the inverse softplus
    of a dt drawn log-uniform in [1e-3, 1e-1]."""

    def __init__(self, dt_rank: int, d_in: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = _param(dt_rank, d_in, device=device, dtype=dtype)
        self.b = _param(d_in, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # b drawn and transformed in float32, then rounded to its dtype
        self.w.normal_(0.0, self.w.shape[0] ** -0.5, generator=generator)
        dt = torch.empty(self.b.shape, device=self.b.device).uniform_(
            math.log(1e-3), math.log(1e-1), generator=generator).exp()
        self.b.copy_(torch.log(torch.expm1(dt)))


class Mamba(nn.Module):
    """The reference's ``mamba_init`` tree: ``in_proj`` (d, 2 d_in),
    ``conv_w`` (K, d_in), ``conv_b``, ``x_proj`` (d_in, dt_rank + 2N),
    ``dt_proj.{w, b}``, ``a_log`` (d_in, N), ``d`` (d_in,), ``out_proj``
    (d_in, d); ``a_log`` and ``d`` float32 whatever ``dtype`` is, as the
    reference keeps them."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        mc = cfg.mamba or MambaConfig()
        d = cfg.d_model
        d_in = mc.expand * d
        dt_rank = mc.resolved_dt_rank(d)
        self.in_proj = Dense(d, 2 * d_in, device=device, dtype=dtype)
        self.conv_w = _param(mc.d_conv, d_in, device=device, dtype=dtype)
        self.conv_b = _param(d_in, device=device, dtype=dtype)
        self.x_proj = Dense(d_in, dt_rank + 2 * mc.d_state, device=device,
                            dtype=dtype)
        self.dt_proj = DtProj(dt_rank, d_in, device=device, dtype=dtype)
        self.a_log = _param(d_in, mc.d_state, device=device)
        self.d = _param(d_in, device=device)
        self.out_proj = Dense(d_in, d,
                              stddev=d_in ** -0.5
                              / max(1, 2 * cfg.num_layers) ** 0.5,
                              device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # S4D-real A; the projections draw in their own reset_parameters
        k = self.conv_w.shape[0]
        self.conv_w.normal_(0.0, k ** -0.5, generator=generator)  # lecun
        self.conv_b.zero_()
        n = self.a_log.shape[1]
        self.a_log.copy_(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=self.a_log.device))
            .expand_as(self.a_log))
        self.d.fill_(1.0)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, L, d_in); w: (K, d_in).  The taps
    are summed in order i = 0..K-1, then the bias added, as the reference
    sums them (``F.conv1d`` sums in another order).  Returns (out, the
    last K - 1 rows of the padded input)."""
    k = w.shape[0]
    length = x.shape[1]
    if tail is None:
        tail = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    xp = torch.cat([tail, x], dim=1)                      # (B, L+K-1, d_in)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + length] * w[i].to(x.dtype)
    return out + b.to(x.dtype), (xp[:, -(k - 1):] if k > 1 else tail)


def _ssm_inputs(params: Mamba, xs, cfg: ModelConfig):
    """(dt, a, bmat, cmat) of the scan from the conv's activated output."""
    mc = cfg.mamba or MambaConfig()
    dt_rank = mc.resolved_dt_rank(cfg.d_model)
    x_dbl = dense_apply(params.x_proj, xs)
    dt, bmat, cmat = torch.split(x_dbl, [dt_rank, mc.d_state, mc.d_state],
                                 dim=-1)
    dt = _softplus(dt @ params.dt_proj.w.to(dt.dtype)
                   + params.dt_proj.b.to(dt.dtype))
    a = -torch.exp(params.a_log)
    return dt, a, bmat, cmat


def mamba_apply(params: Mamba, x, *, cfg: ModelConfig,
                return_state: bool = False):
    """Full-sequence forward.  x: (B, L, d_model) -> (B, L, d_model).

    ``return_state=True`` (prefill) also returns the :class:`MambaState`
    after the last position: the raw (pre-conv) input tail and the scan's
    final state."""
    xz = dense_apply(params.in_proj, x)
    xs_raw, z = xz.chunk(2, dim=-1)                       # (B, L, d_in) each
    xs, _ = _causal_conv(xs_raw, params.conv_w, params.conv_b)
    xs = F.silu(xs)
    dt, a, bmat, cmat = _ssm_inputs(params, xs, cfg)
    scanned = ops.ssm_scan(xs, dt, a, bmat.contiguous(), cmat.contiguous(),
                           params.d, return_state=return_state)
    y = scanned[0] if return_state else scanned
    y = y * F.silu(z)
    out = dense_apply(params.out_proj, y)
    if not return_state:
        return out
    k = params.conv_w.shape[0]
    tail = xs_raw[:, -(k - 1):] if k > 1 else xs_raw[:, :0]
    return out, MambaState(conv=tail, ssm=scanned[1])


def mamba_init_state(cfg: ModelConfig, batch: int, *,
                     dtype=torch.float32, device=None) -> MambaState:
    """Zero state: the conv tail in ``dtype``, the SSM state float32
    whatever ``dtype`` is, as the reference keeps it."""
    mc = cfg.mamba or MambaConfig()
    d_in = mc.expand * cfg.d_model
    return MambaState(
        conv=torch.zeros(batch, mc.d_conv - 1, d_in, dtype=dtype,
                         device=device),
        ssm=torch.zeros(batch, d_in, mc.d_state, device=device))


def mamba_decode(params: Mamba, x, state: MambaState, *, cfg: ModelConfig):
    """One-token step.  x: (B, 1, d_model) -> (y, new_state), one step of
    the recurrence in float32."""
    xz = dense_apply(params.in_proj, x)
    xs, z = xz.chunk(2, dim=-1)
    xs, new_tail = _causal_conv(xs, params.conv_w, params.conv_b,
                                tail=state.conv.to(xs.dtype))
    xs = F.silu(xs)
    dt, a, bmat, cmat = _ssm_inputs(params, xs, cfg)
    u_t, dt_t = xs[:, 0].float(), dt[:, 0].float()
    b_t, c_t = bmat[:, 0].float(), cmat[:, 0].float()
    da = torch.exp(dt_t[..., None] * a[None])              # (B, d_in, N)
    h = da * state.ssm + (dt_t * u_t)[..., None] * b_t[:, None, :]
    y_t = (h * c_t[:, None, :]).sum(-1) + params.d[None] * u_t
    y = y_t[:, None].to(x.dtype) * F.silu(z)
    new_state = MambaState(new_tail.to(state.conv.dtype), h)
    return dense_apply(params.out_proj, y), new_state
