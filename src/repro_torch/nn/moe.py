"""Mixture-of-Experts layer, as ``repro.nn.moe``: a top-k router and a
capacity-bounded dispatch sorted by expert.

Each token's router probabilities (softmax in float32) pick its k experts,
their gates renormalised to sum to one.  The (token, expert) pairs are
sorted by expert (a stable sort, so within an expert in token order), and
each takes the next row of its expert's ``capacity`` rows in an (E, C, d)
buffer; a pair past its expert's capacity is dropped (GShard: the token
falls through the residual) and adds zeros at row C - 1.  The experts run
as three batched products (SwiGLU: ``down(silu(gate x) * up x)``), and each
token sums its kept experts' outputs weighted by their gates.  The
Switch load-balancing loss ``E * sum_e mean(probs)_e * count_e / (T k)``
comes back beside the output for the train step.

The reference's expert products are XLA einsums, not Pallas kernels, so
here they are ``torch.bmm`` in float32 (TF32 stays off, ``repro_torch``).
Ties and order follow the reference exactly: the top k come from a stable
descending sort (``jax.lax.top_k`` puts the lower index first on a tie),
the sort by expert is stable and the rank in group is a left
``searchsorted``.  The combine is deterministic where the reference's
scatter-add would be atomics on the card: the pairs go back to token order
by a permutation, and each token adds its k outputs one at a time in
ascending expert order (the order of the reference's sorted scatter),
starting from zero; the dispatch's gradient sums a token's k rows by a
reduction, not a scatter-add.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.linear import _param


class MoE(nn.Module):
    """``router`` (d, E) float32 whatever ``dtype`` is, ``gate_w`` and
    ``up_w`` (E, d, f), ``down_w`` (E, f, d) in ``dtype``; f is
    ``moe_d_ff`` (``d_ff`` if 0).  Keeps the config's k and capacity
    factor."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.k = cfg.experts_per_token
        self.capacity_factor = cfg.moe_capacity_factor
        self.stddevs = (d ** -0.5, d ** -0.5, d ** -0.5,
                        f ** -0.5 / max(1, 2 * cfg.num_layers) ** 0.5)
        self.router = _param(d, e, device=device)
        self.gate_w = _param(e, d, f, device=device, dtype=dtype)
        self.up_w = _param(e, d, f, device=device, dtype=dtype)
        self.down_w = _param(e, f, d, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for p, std in zip((self.router, self.gate_w, self.up_w, self.down_w),
                          self.stddevs):
            p.normal_(0.0, std, generator=generator)


class Routing(NamedTuple):
    """The router's decisions for T tokens: ``probs`` (T, E), each token's
    ``gates`` and expert ``ids`` (T, k) in descending probability, and for
    the T·k pairs sorted by expert: ``order`` (the pair's flat index
    t·k + j), ``sorted_ids``, ``pos`` (its rank in its expert's group) and
    ``keep`` (rank below the capacity)."""
    probs: torch.Tensor
    gates: torch.Tensor
    ids: torch.Tensor
    order: torch.Tensor
    sorted_ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def capacity(module: MoE, tokens: int,
             capacity_factor: Optional[float] = None) -> int:
    """Rows per expert, computed in Python as the reference does."""
    cf = module.capacity_factor if capacity_factor is None \
        else capacity_factor
    e = module.router.shape[1]
    return int(max(module.k, cf * tokens * module.k / e))


def top_k_gates(router, xf, k: int):
    """The router's float32 softmax over the rows of ``xf`` (T, d) and
    each row's top ``k`` (a stable descending sort, lower index first on
    a tie, as ``jax.lax.top_k``): (probs (T, E), gates renormalised over
    ``max(sum, 1e-9)``, expert ids), the last two (T, k)."""
    probs = torch.softmax(xf.float() @ router, dim=-1)             # (T, E)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = top[:, :k], idx[:, :k]
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), ids


def load_balance_loss(probs, ids):
    """The Switch load-balancing loss ``E * sum_e mean(probs)_e *
    count_e / (T k)`` of T tokens' router ``probs`` (T, E) and top-k
    ``ids`` (T, k).

    The counts are sums of ones (exact in any order; ``bincount`` would
    read the card back for its length), divided by a 0-dim tensor filled
    on the device (CUDA turns a division by a Python number into a
    product with its reciprocal; a filled tensor, unlike a copied one,
    keeps the step capturable in a CUDA graph)."""
    e = probs.shape[1]
    n = ids.numel()
    me = probs.mean(dim=0)
    counts = probs.new_zeros(e).index_add_(0, ids.reshape(-1),
                                           probs.new_ones(n))
    ce = counts / probs.new_full((), float(n))
    return e * torch.sum(me * ce)


def route(module: MoE, xf, cap: int) -> Routing:
    """Route the rows of ``xf`` (T, d) to ``module``'s experts with
    ``cap`` rows per expert."""
    k, e = module.k, module.router.shape[1]
    t = xf.shape[0]
    probs, gates, ids = top_k_gates(module.router, xf, k)
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    starts = torch.searchsorted(
        sorted_ids, torch.arange(e, device=xf.device))              # left
    pos = torch.arange(t * k, device=xf.device) - starts[sorted_ids]
    return Routing(probs, gates, ids, order, sorted_ids, pos, pos < cap)


def moe_apply(module: MoE, x, *, capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux), aux the Switch load-balancing
    loss (float32 scalar)."""
    b, s, d = x.shape
    k, e = module.k, module.router.shape[1]
    t = b * s
    xf = x.reshape(t, d)
    cap = capacity(module, t, capacity_factor)
    r = route(module, xf, cap)

    aux = load_balance_loss(r.probs, r.ids)

    keep = r.keep.to(xf.dtype)
    pos_c = r.pos.clamp(max=cap - 1)
    # dispatch into (E, C, d): a dropped pair adds zeros at row C - 1,
    # where the one kept pair is the only nonzero, so the sum is exact in
    # any order; each token's k rows come from an expand, whose gradient
    # is a reduction over k
    rows = xf[:, None, :].expand(t, k, d).reshape(t * k, d)[r.order]
    buf = xf.new_zeros(e, cap, d).index_put_(
        (r.sorted_ids, pos_c), rows * keep[:, None], accumulate=True)

    g = torch.bmm(buf, module.gate_w.to(xf.dtype))
    u = torch.bmm(buf, module.up_w.to(xf.dtype))
    out_buf = torch.bmm(F.silu(g) * u, module.down_w.to(xf.dtype))

    # combine: back to pair order t·k + j by the inverse permutation, then
    # each token's k outputs in ascending expert order, summed one by one
    sorted_gates = r.gates.reshape(-1)[r.order]
    y_pair = out_buf[r.sorted_ids, pos_c] \
        * (keep * sorted_gates.to(xf.dtype))[:, None]
    y_pair = y_pair[torch.argsort(r.order)].reshape(t, k, d)
    by_expert = torch.argsort(r.ids, dim=1)
    y_pair = torch.gather(y_pair, 1, by_expert[:, :, None].expand(t, k, d))
    y = torch.zeros_like(xf)
    for j in range(k):
        y = y + y_pair[:, j]
    return y.reshape(b, s, d), aux
