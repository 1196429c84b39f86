"""LSTM cell + sequence runner (the D3QL approximator's torso, Table II).

Port of ``repro.nn.recurrent``: the cell is written out by hand, gates
i, f, g, o in that order with ``+1.0`` inside the forget gate's sigmoid,
because ``torch.nn.LSTM`` (two biases, no forget offset) computes another
function.  Weights keep the reference's layout: ``wx`` (in, 4h) and ``wh``
(h, 4h) applied as ``x @ wx + h @ wh + b``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.nn.linear import _param


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), fans of an (in, out)
    matrix, as ``repro.nn.initializers.xavier_uniform``."""
    fan_in, fan_out = w.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)


class LSTM(nn.Module):
    """``wx`` (in, 4h) and ``wh`` (h, 4h) xavier-uniform, ``b`` (4h,) zero."""

    def __init__(self, in_dim: int, hidden: int, *, device=None):
        super().__init__()
        self.wx = _param(in_dim, 4 * hidden, device=device)
        self.wh = _param(hidden, 4 * hidden, device=device)
        self.b = _param(4 * hidden, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.wx, generator)
        xavier_uniform_(self.wh, generator)
        self.b.zero_()


def lstm_cell(params: LSTM, x, state: Tuple[torch.Tensor, torch.Tensor]):
    """x: (B, in); state: (h, c) each (B, hidden)."""
    h, c = state
    z = x @ params.wx + h @ params.wh + params.b
    i, f, g, o = torch.split(z, z.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def lstm_apply(params: LSTM, xs, state: Optional[Tuple] = None):
    """xs: (B, T, in) -> (hs (B, T, hidden), final_state)."""
    b, hidden = xs.shape[0], params.wh.shape[0]
    if state is None:
        zeros = xs.new_zeros((b, hidden))
        state = (zeros, zeros)
    hs = []
    for t in range(xs.shape[1]):
        h, state = lstm_cell(params, xs[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state
