"""Error-feedback int8 gradient compression, as ``repro.optim.compression``.

Each gradient, plus the residual the last step left, is quantized to int8
with one symmetric per-tensor scale and dequantized: the gradient a
data-parallel all-reduce of the int8 payload would deliver.  What the
quantization lost is kept as the next step's residual (error feedback,
Karimireddy et al., 2019).  Over ``{name: tensor}`` dicts, as the port's
optimizers; one scale per tensor, or per group of tensors that make one
leaf of the reference's tree.

Rounding is half-to-even on both sides (``torch.round``, ``jnp.round``).
The scale divides by a 0-dim tensor on the gradient's device: CUDA turns a
division by a Python number into a product with its reciprocal, which can
land an ulp away from the reference's quotient.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


class EFState(NamedTuple):
    residual: Params    # same keys and shapes as the gradients, float32


def init_error_feedback(params: Params) -> EFState:
    return EFState(residual={k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()})


def _scale(amax: torch.Tensor) -> torch.Tensor:
    amax = torch.clamp(amax, min=1e-12)
    return amax / amax.new_full((), 127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    scale = _scale(x.abs().max())
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Params, ef: EFState,
                   groups: Optional[Iterable[Sequence[str]]] = None
                   ) -> Tuple[Params, EFState]:
    """Returns (the gradients as dequantized after the all-reduce, the new
    error-feedback state).  ``groups`` lists the names that share one
    scale, by default each name alone: the reference quantizes each leaf
    of its tree, and a layer's leaf there is stacked over the periods, so
    the LM's trainer groups the port's per-period tensors of one leaf
    (``repro_torch.launch.steps``)."""
    new_g, new_r = {}, {}
    for names in (groups if groups is not None else [[k] for k in grads]):
        xs = [grads[k].float() + ef.residual[k] for k in names]
        scale = _scale(torch.stack([x.abs().max() for x in xs]).max())
        for k, x in zip(names, xs):
            deq = dequantize_int8(_quantize(x, scale), scale)
            new_g[k] = deq.to(grads[k].dtype)
            new_r[k] = x - deq
    return new_g, EFState(residual=new_r)
