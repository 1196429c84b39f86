"""RMSNorm and LayerNorm.  Reductions always in float32, as in
``repro.nn.norm``.

:func:`rmsnorm_apply` runs the ``rmsnorm`` kernel on the card (its plain
version on the CPU), which computes the reference's ``rmsnorm_apply`` op
for op; :func:`layernorm_apply` stays plain PyTorch (the DiT's adaLN
kernel covers its hot path)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn.linear import _param


class RMSNorm(nn.Module):
    """``scale`` = 1 at init."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = _param(dim, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator                     # deterministic init: draws nothing
        self.scale.fill_(1.0)


def rmsnorm_apply(params: RMSNorm, x, eps: float = 1e-6):
    return ops.rmsnorm(x, params.scale, eps=eps)


class LayerNorm(nn.Module):
    """``scale`` = 1 and ``bias`` = 0 at init."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = _param(dim, device=device, dtype=dtype)
        self.bias = _param(dim, device=device, dtype=dtype)

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
