"""Dense / Embedding layers: parameter holders and plain apply functions.

The holders are ``nn.Module``s so that a model's module tree mirrors the
reference's parameter pytree name for name (``attn.wq.w`` here is
``["attn"]["wq"]["w"]`` there).  Dense weights keep the reference's
``(in, out)`` layout and apply as ``x @ w``, not ``nn.Linear``'s
``(out, in)``.  Parameters are created empty; ``reset_parameters`` draws
them from an explicit generator with the reference's distributions.
"""
from __future__ import annotations

import torch
from torch import nn


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """``w`` (in, out) ~ N(0, stddev^2), stddev in_dim^-1/2 by default;
    optional zero bias ``b``."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 stddev: float | None = None, device=None):
        super().__init__()
        self.stddev = stddev if stddev is not None else in_dim ** -0.5
        self.w = _param(in_dim, out_dim, device=device)
        if bias:
            self.b = _param(out_dim, device=device)
        else:
            self.register_parameter("b", None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.normal_(0.0, self.stddev, generator=generator)
        if self.b is not None:
            self.b.zero_()


def dense_apply(params: Dense, x):
    y = x @ params.w.to(x.dtype)
    if params.b is not None:
        y = y + params.b.to(x.dtype)
    return y


class Embedding(nn.Module):
    """``table`` (vocab, dim) ~ N(0, 0.02^2)."""

    def __init__(self, vocab: int, dim: int, *, device=None):
        super().__init__()
        self.table = _param(vocab, dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.table.normal_(0.0, 0.02, generator=generator)


def embedding_apply(params: Embedding, ids):
    return params.table[ids]
