"""LayerNorm.  Reductions always in float32, as in ``repro.nn.norm``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.linear import _param


class LayerNorm(nn.Module):
    """``scale`` = 1 and ``bias`` = 0 at init."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator                     # deterministic init: draws nothing
        self.scale.fill_(1.0)
        self.bias.zero_()


def layernorm_apply(params: LayerNorm, x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * (var + eps) ** -0.5
    y = y * params.scale.float() + params.bias.float()
    return y.to(x.dtype)
