"""xLSTM blocks: mLSTM (matrix memory, parallel form over a sequence) and
sLSTM (scalar memory, recurrent by design), as ``repro.nn.xlstm``
[arXiv:2405.04517].

The mLSTM runs a full sequence in the stabilised parallel form (the
quadratic gate matrix), its prefill also gives the closed-form final state
(no re-scan), and it decodes with the exact O(1) recurrence.  The sLSTM
feeds h_{t-1} into its gates, so a sequence is a Python loop over its S
cells (the reference's ``lax.scan``); its input projection is computed for
every position at once before the loop.  All of it is torch ops and
``torch.matmul``: the reference computes it in XLA ops, outside any Pallas
kernel.

The recurrent states are float32, as in the reference, and start their
stabiliser ``m`` at the finite ``NEG_INF``; the log-sigmoid gates use
``logaddexp`` (``jax.nn.softplus``), not ``F.softplus``, which switches to
x above its threshold.  The states are the inter-block "latents" the
placement engine ships between nodes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.distributed.op_cost import RepeatedSteps
from repro_torch.nn.linear import Dense, _param, dense_apply

NEG_INF = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor    # (B, H, dv, dk) matrix memory
    n: torch.Tensor    # (B, H, dk) normaliser
    m: torch.Tensor    # (B, H) stabiliser


class SLSTMState(NamedTuple):
    h: torch.Tensor    # (B, d)
    c: torch.Tensor    # (B, d)
    n: torch.Tensor    # (B, d)
    m: torch.Tensor    # (B, d)


def _d_inner(cfg: ModelConfig) -> int:
    xc = cfg.xlstm or XLSTMConfig()
    return int(xc.proj_factor * cfg.d_model)


def _down_stddev(d_in: int, num_layers: int) -> float:
    return d_in ** -0.5 / max(1, 2 * num_layers) ** 0.5


def _log_sigmoid(x):
    # -jax.nn.softplus(-x), with softplus = logaddexp(x, 0)
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """The reference's ``mlstm_init`` tree: ``up`` (d, 2 d_in), ``conv_w``
    (K, d_in), ``conv_b``, ``wq``/``wk``/``wv`` (d_in, d_in), ``w_if``
    (d_in, 2H), ``down`` (d_in, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        xc = cfg.xlstm or XLSTMConfig()
        d, d_in = cfg.d_model, _d_inner(cfg)
        self.up = Dense(d, 2 * d_in, device=device, dtype=dtype)
        self.conv_w = _param(xc.conv_kernel, d_in, device=device, dtype=dtype)
        self.conv_b = _param(d_in, device=device, dtype=dtype)
        self.wq = Dense(d_in, d_in, device=device, dtype=dtype)
        self.wk = Dense(d_in, d_in, device=device, dtype=dtype)
        self.wv = Dense(d_in, d_in, device=device, dtype=dtype)
        self.w_if = Dense(d_in, 2 * cfg.num_heads, device=device, dtype=dtype)
        self.down = Dense(d_in, d, stddev=_down_stddev(d_in, cfg.num_layers),
                          device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # the projections draw in their own reset_parameters
        k = self.conv_w.shape[0]
        self.conv_w.normal_(0.0, k ** -0.5, generator=generator)  # lecun
        self.conv_b.zero_()


def _conv_silu(x, w, b, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv then SiLU.  x: (B, L, d_in); w: (K, d_in).
    The taps are summed in order, as the reference sums them.  Returns
    (out, the last K - 1 rows of the padded input)."""
    k = w.shape[0]
    length = x.shape[1]
    if tail is None:
        tail = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    xp = torch.cat([tail, x], dim=1)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + length] * w[i].to(x.dtype)
    new_tail = xp[:, -(k - 1):] if k > 1 else tail
    return F.silu(out + b.to(x.dtype)), new_tail


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _mlstm_inputs(params: MLSTM, x, h: int):
    """(xm, z, q, k, v, log_i, log_f) of a sequence x (B, S, d_model):
    q, k, v (B, S, H, d_in / H) and the gates (B, S, H) in float32."""
    xm, z = dense_apply(params.up, x).chunk(2, dim=-1)      # (B, S, d_in)
    xc, _ = _conv_silu(xm, params.conv_w, params.conv_b)
    q = _heads(dense_apply(params.wq, xc), h).float()
    k = _heads(dense_apply(params.wk, xc), h).float()
    v = _heads(dense_apply(params.wv, xm), h).float()
    log_i, f_raw = dense_apply(params.w_if, xm).float().chunk(2, dim=-1)
    return xm, z, q, k, v, log_i, _log_sigmoid(f_raw)


def _mlstm_parallel(params: MLSTM, x, z, q, k, v, log_i, cum_f):
    """The stabilised parallel form: gate matrix d_ts = cumF_t - cumF_s +
    log_i_s (s <= t), the output projected down."""
    b, s, _ = x.shape
    dk = q.shape[-1]
    d_mat = (cum_f[:, :, None, :] - cum_f[:, None, :, :]
             + log_i[:, None, :, :])                        # (B, T, S, H)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    d_mat = torch.where(causal[None, :, :, None], d_mat,
                        torch.full((), NEG_INF, device=x.device))
    m = d_mat.amax(dim=2)                                    # (B, T, H)
    d_stab = torch.exp(d_mat - m[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q, k) * dk ** -0.5
    smat = scores * d_stab
    norm = torch.maximum(smat.sum(dim=2).abs(), torch.exp(-m))
    hcell = torch.einsum("btsh,bshd->bthd", smat, v) / norm[..., None]
    hcell = hcell.reshape(b, s, -1).to(x.dtype)
    return dense_apply(params.down, hcell * F.silu(z))


def mlstm_apply(params: MLSTM, x, *, cfg: ModelConfig):
    """Parallel-form training / prefill.  x: (B, S, d_model)."""
    _, z, q, k, v, log_i, log_f = _mlstm_inputs(params, x, cfg.num_heads)
    return _mlstm_parallel(params, x, z, q, k, v, log_i,
                           torch.cumsum(log_f, dim=1))


def mlstm_apply_with_state(params: MLSTM, x, *, cfg: ModelConfig):
    """Prefill: the parallel forward and the closed-form final recurrent
    state, C_S = sum_s exp(w_s - m) v_s k_s^T and n_S = sum_s exp(w_s - m)
    k_s with w_s = cumF_S - cumF_s + log_i_s and m = max_s w_s.  Returns
    (y, MLSTMState, conv_tail)."""
    xm, z, q, k, v, log_i, log_f = _mlstm_inputs(params, x, cfg.num_heads)
    cum_f = torch.cumsum(log_f, dim=1)
    y = _mlstm_parallel(params, x, z, q, k, v, log_i, cum_f)
    w = cum_f[:, -1:, :] - cum_f + log_i                    # (B, S, H)
    m_fin = w.amax(dim=1)                                   # (B, H)
    wexp = torch.exp(w - m_fin[:, None, :])
    c_fin = torch.einsum("bsh,bshv,bshk->bhvk", wexp, v, k)
    n_fin = torch.einsum("bsh,bshk->bhk", wexp, k)
    kk = params.conv_w.shape[0]
    tail = xm[:, -(kk - 1):] if kk > 1 else xm[:, :0]
    return y, MLSTMState(c_fin, n_fin, m_fin), tail


def mlstm_init_state(cfg: ModelConfig, batch: int, *,
                     device=None) -> MLSTMState:
    h = cfg.num_heads
    dh = _d_inner(cfg) // h
    return MLSTMState(
        c=torch.zeros(batch, h, dh, dh, device=device),
        n=torch.zeros(batch, h, dh, device=device),
        m=torch.full((batch, h), NEG_INF, device=device))


def mlstm_decode(params: MLSTM, x, state: MLSTMState, *, cfg: ModelConfig,
                 conv_tail=None):
    """The exact recurrent step.  x: (B, 1, d_model) -> (y, new_state,
    new conv tail)."""
    h = cfg.num_heads
    b = x.shape[0]
    xm, z = dense_apply(params.up, x).chunk(2, dim=-1)
    xc, new_tail = _conv_silu(xm, params.conv_w, params.conv_b, conv_tail)
    q = _heads(dense_apply(params.wq, xc), h)[:, 0].float()
    k = _heads(dense_apply(params.wk, xc), h)[:, 0].float()
    v = _heads(dense_apply(params.wv, xm), h)[:, 0].float()
    dk = q.shape[-1]
    log_i, f_raw = dense_apply(params.w_if, xm)[:, 0].float().chunk(2, dim=-1)
    log_f = _log_sigmoid(f_raw)                              # (B, H)

    m_new = torch.maximum(log_f + state.m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + state.m - m_new)
    c_new = (f_p[..., None, None] * state.c
             + i_p[..., None, None] * torch.einsum("bhv,bhk->bhvk", v, k))
    n_new = f_p[..., None] * state.n + i_p[..., None] * k
    qs = q * dk ** -0.5
    num = torch.einsum("bhvk,bhk->bhv", c_new, qs)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qs).abs(),
                        torch.exp(-m_new))
    hcell = (num / den[..., None]).reshape(b, 1, -1).to(x.dtype)
    y = dense_apply(params.down, hcell * F.silu(z))
    return y, MLSTMState(c_new, n_new, m_new), new_tail


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """The reference's ``slstm_init`` tree: ``wx`` (d, 4d), ``r`` (H, dh,
    4 dh) block-diagonal recurrent weights, ``up`` (d, 2d), ``down`` (d,
    d)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        dh = d // h
        self.wx = Dense(d, 4 * d, device=device, dtype=dtype)
        self.r = _param(h, dh, 4 * dh, device=device, dtype=dtype)
        self.up = Dense(d, 2 * d, device=device, dtype=dtype)
        self.down = Dense(d, d, stddev=_down_stddev(d, cfg.num_layers),
                          device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.r.normal_(0.0, self.r.shape[1] ** -0.5, generator=generator)


def _slstm_cell(params: SLSTM, zx, state: SLSTMState, h_heads: int):
    """One exponential-gated scalar-memory step (stabilised).  zx: (B, 4d)
    float32, the input's projection by ``wx``."""
    b, d = state.h.shape
    dh = d // h_heads
    rec = torch.einsum("bhd,hdk->bhk", state.h.reshape(b, h_heads, dh),
                       params.r.float())                     # (B, H, 4 dh)
    # gate-major: (B, H, 4, dh) -> (B, 4, H, dh) before the split
    rec = rec.reshape(b, h_heads, 4, dh).permute(0, 2, 1, 3).reshape(b, 4 * d)
    zi, zf, zz, zo = (zx + rec).chunk(4, dim=-1)             # (B, d) each
    log_f = _log_sigmoid(zf)
    m_new = torch.maximum(log_f + state.m, zi)
    i_p = torch.exp(zi - m_new)
    f_p = torch.exp(log_f + state.m - m_new)
    c_new = f_p * state.c + i_p * torch.tanh(zz)
    n_new = f_p * state.n + i_p
    h_new = torch.sigmoid(zo) * c_new / n_new.clamp_min(1e-6)
    return SLSTMState(h_new, c_new, n_new, m_new)


def _slstm_out(params: SLSTM, hs, dtype):
    u, g = dense_apply(params.up, hs.to(dtype)).chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return dense_apply(params.down, u * F.gelu(g, approximate="tanh"))


def slstm_apply(params: SLSTM, x, *, cfg: ModelConfig,
                return_state: bool = False):
    """Sequential forward, one cell per position.  x: (B, S, d_model).
    With ``return_state`` also the state after the last position.  On
    the meta device under a cost counter three cells run and the other
    S - 3 are counted as the second (:class:`~repro_torch.distributed.
    op_cost.RepeatedSteps`); their outputs are stand-ins of its shape."""
    b, s, _ = x.shape
    state = slstm_init_state(cfg, b, device=x.device)
    zx = dense_apply(params.wx, x.float()).float()           # (B, S, 4d)
    loop = RepeatedSteps(s, zx)
    hs = []
    for t in range(loop.run):
        state = loop.step(t, lambda: _slstm_cell(
            params, zx[:, t], state, cfg.num_heads), lambda st: st.h)
        hs.append(state.h)
    hs += loop.stand_ins(state.h)
    y = _slstm_out(params, torch.stack(hs, dim=1), x.dtype)
    return (y, state) if return_state else y


def slstm_init_state(cfg: ModelConfig, batch: int, *,
                     device=None) -> SLSTMState:
    d = cfg.d_model
    zeros = [torch.zeros(batch, d, device=device) for _ in range(3)]
    return SLSTMState(*zeros, m=torch.full((batch, d), NEG_INF,
                                           device=device))


def slstm_decode(params: SLSTM, x, state: SLSTMState, *, cfg: ModelConfig):
    """One-token step.  x: (B, 1, d_model) -> (y, new_state)."""
    zx = dense_apply(params.wx, x[:, 0].float()).float()
    new_state = _slstm_cell(params, zx, state, cfg.num_heads)
    return _slstm_out(params, new_state.h[:, None], x.dtype), new_state
