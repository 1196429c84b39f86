"""GELU feed-forward block (the DiT's MLP), as in ``repro.nn.mlp``."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import Dense, dense_apply


class GeluMLP(nn.Module):
    """``up`` (d, d_ff) and ``down`` (d_ff, d), both with bias; ``down`` is
    scaled down by sqrt(2 * num_layers) as in the reference."""

    def __init__(self, d_model: int, d_ff: int, *, num_layers: int = 1,
                 device=None):
        super().__init__()
        self.up = Dense(d_model, d_ff, bias=True, device=device)
        self.down = Dense(d_ff, d_model, bias=True,
                          stddev=d_ff ** -0.5 / max(1, 2 * num_layers) ** 0.5,
                          device=device)


def gelu_mlp_apply(params: GeluMLP, x):
    # jax.nn.gelu defaults to the tanh approximation
    return dense_apply(params.down,
                       F.gelu(dense_apply(params.up, x), approximate="tanh"))
