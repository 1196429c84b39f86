"""The paper's Q-approximator (Table II): LSTM(128) + FC(128, 64, 32) with
dueling value/advantage heads (eq. 4), one advantage row per UE.

Port of ``repro.rl.networks``.  Action factorization as in the reference:
per-UE heads over a shared torso, Q_tot = Σ_i Q_i(a_i) (VDN).  The module
tree mirrors the reference's parameter pytree name for name (``lstm.wx``
here is ``["lstm"]["wx"]`` there, ``fc0.w`` is ``["fc0"]["w"]``), so
:func:`repro_torch.models.convert.qnet_from_jax` carries weights across.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.nn.linear import Dense, dense_apply
from repro_torch.nn.recurrent import LSTM, lstm_apply


class QNet(nn.Module):
    """LSTM torso, ReLU dense stack ``fc0..``, dueling ``value`` (U) and
    ``adv`` (U * A) heads."""

    def __init__(self, obs_dim: int, num_ues: int, num_actions: int, *,
                 lstm_units: int = 128, fc: tuple = (128, 64, 32),
                 device=None):
        super().__init__()
        self.num_ues, self.num_actions = num_ues, num_actions
        self.lstm = LSTM(obs_dim, lstm_units, device=device)
        in_dim = lstm_units
        self.fc = tuple(fc)
        for j, width in enumerate(fc):
            setattr(self, f"fc{j}", Dense(in_dim, width, bias=True,
                                          device=device))
            in_dim = width
        self.value = Dense(in_dim, num_ues, bias=True, device=device)
        self.adv = Dense(in_dim, num_ues * num_actions, bias=True,
                         device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions, drawn in module order: LSTM
        xavier-uniform, every dense weight N(0, in_dim^-1), zero biases."""
        self.lstm.reset_parameters(generator)
        for j in range(len(self.fc)):
            getattr(self, f"fc{j}").reset_parameters(generator)
        self.value.reset_parameters(generator)
        self.adv.reset_parameters(generator)


def qnet_init(obs_dim: int, num_ues: int, num_actions: int, *,
              lstm_units: int = 128, fc: tuple = (128, 64, 32), seed: int = 0,
              device=None) -> QNet:
    """A fresh Q-net: drawn on the CPU from ``torch.Generator`` seeded with
    ``seed``, then moved to ``device`` (the card by default), so a card
    and a CPU net from one seed start bit-identical."""
    device = resolve_device(device)
    net = QNet(obs_dim, num_ues, num_actions, lstm_units=lstm_units, fc=fc,
               device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(device)


def qnet_apply(net: QNet, obs_hist):
    """obs_hist: (B, H, obs_dim) -> Q-values (B, U, A) via dueling eq. (4)."""
    hs, _ = lstm_apply(net.lstm, obs_hist)
    x = hs[:, -1]                                            # last hidden state
    for j in range(len(net.fc)):
        x = torch.relu(dense_apply(getattr(net, f"fc{j}"), x))
    v = dense_apply(net.value, x)                            # (B, U)
    adv = dense_apply(net.adv, x).reshape(x.shape[0], net.num_ues,
                                          net.num_actions)
    return v[..., None] + adv - adv.mean(dim=-1, keepdim=True)
