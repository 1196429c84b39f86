"""Rotary position embeddings (RoPE), as in ``repro.nn.rope``."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import uncounted


@functools.lru_cache(maxsize=None)
@uncounted
def _frequencies(head_dim: int, theta: float, device: torch.device):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    # theta ** e rounded once to float32, as the reference's float32 power
    # gives it (torch's float32 pow can land one ulp away, which moves the
    # angle by ~1e-5 at position 2e4 when theta is yi's 5e6)
    power = (theta ** exponents.double()).float()
    return (1.0 / power).to(device)


def rope_frequencies(head_dim: int, theta: float = 10_000.0, *,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32, as the
    reference computes them: float32 exponents, the power rounded to
    float32, a float32 division.  A table kept in float64 would move the
    angles at late positions when theta is large, as yi's 5e6."""
    return _frequencies(head_dim, float(theta), torch.device(device or "cpu"))


def apply_rope(x, positions, theta: float = 10_000.0):
    """Rotate ``x`` of shape (..., seq, heads, head_dim) by ``positions``
    (..., seq), split-halves convention (as in Llama-family code)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * inv_freq   # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
