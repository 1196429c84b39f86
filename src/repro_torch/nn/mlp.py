"""Feed-forward blocks: SwiGLU (llama-family) and GELU (the DiT), as in
``repro.nn.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import Dense, dense_apply


def _down_stddev(d_ff: int, num_layers: int) -> float:
    # the output projection is scaled down by sqrt(2 * num_layers)
    return d_ff ** -0.5 / max(1, 2 * num_layers) ** 0.5


class SwiGLU(nn.Module):
    """``gate`` and ``up`` (d, d_ff), ``down`` (d_ff, d); no biases."""

    def __init__(self, d_model: int, d_ff: int, *, num_layers: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.gate = Dense(d_model, d_ff, device=device, dtype=dtype)
        self.up = Dense(d_model, d_ff, device=device, dtype=dtype)
        self.down = Dense(d_ff, d_model,
                          stddev=_down_stddev(d_ff, num_layers),
                          device=device, dtype=dtype)


def swiglu_apply(params: SwiGLU, x):
    return dense_apply(params.down, F.silu(dense_apply(params.gate, x))
                       * dense_apply(params.up, x))


class GeluMLP(nn.Module):
    """``up`` (d, d_ff) and ``down`` (d_ff, d), both with bias."""

    def __init__(self, d_model: int, d_ff: int, *, num_layers: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.up = Dense(d_model, d_ff, bias=True, device=device, dtype=dtype)
        self.down = Dense(d_ff, d_model, bias=True,
                          stddev=_down_stddev(d_ff, num_layers),
                          device=device, dtype=dtype)


def gelu_mlp_apply(params: GeluMLP, x):
    # jax.nn.gelu defaults to the tanh approximation
    return dense_apply(params.down,
                       F.gelu(dense_apply(params.up, x), approximate="tanh"))
