"""Expert-parallel MoE with an explicit all-to-all dispatch, as
``repro.nn.moe_sharded``.

The tokens are split along the sequence over the model axis; each model
shard routes its T/tp tokens, packs one buffer of ``cap_s`` rows per
destination shard (the shard that owns the expert), ships them with one
all-to-all, runs its E/tp local experts over (E/tp, ``cap_e``, d) buffers
and ships the results back with a second all-to-all; the combine is then
local.  Only routed tokens move between shards.

The reference runs this under ``shard_map``; the port runs it from one
controller over a mesh of torch devices: each shard's work runs on its
device, and an all-to-all is the transpose of a list of lists (shard i's
block j goes to shard j's slot i), a copy where two shards sit on
different devices.  The data shards of ``batch_axes`` run one after the
other, each over its row of the mesh.  Everything is differentiable,
the copies between devices included.

A cost counter (:mod:`repro_torch.distributed.op_cost`) sees model shard
m's work at its mesh position and is charged each all-to-all, forward and
(through a gradient hook) backward, with the ring model's bytes, as
``hlo_cost`` counts the reference's ``all_to_all`` and its transpose.

Sums are deterministic where the reference's scatter-adds would be
atomics on the card: every packed buffer row has one nonzero
contribution (a dropped pair adds zeros), and each token adds its k
results one at a time, in the order of the reference's scatter (by
destination shard, then by rank in the top k), starting from zero.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.op_cost import collective, place, where
from repro_torch.distributed.sharding import _axes, shard_rows
from repro_torch.nn.moe import MoE, load_balance_loss, top_k_gates


def _rank_in_group(keys_sorted, groups: int):
    """Each sorted key's rank among the equal keys before it (the
    reference's left ``searchsorted`` of the group starts)."""
    n = keys_sorted.shape[0]
    starts = torch.searchsorted(
        keys_sorted, torch.arange(groups, device=keys_sorted.device))
    return torch.arange(n, device=keys_sorted.device) \
        - starts[keys_sorted.clamp(0, groups - 1)]


def _inverse(perm):
    return torch.argsort(perm, stable=True)


def _pack(xf, router, *, k: int, e_loc: int, tp: int, cap_s: int):
    """Route one shard's tokens xf (T_l, d) and pack its send buffers:
    (send_x (tp, cap_s, d), send_eid (tp, cap_s) local expert id or -1,
    the pairs' destination, row, kept mask and gate in destination order,
    the destination order itself, and the shard's aux loss)."""
    t_l, d = xf.shape
    probs, gates, ids = top_k_gates(router, xf, k)
    aux = load_balance_loss(probs, ids)
    flat_ids = ids.reshape(-1)
    dest = flat_ids // e_loc                                  # owning shard
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    pos = _rank_in_group(dest_s, tp)
    keep = pos < cap_s
    pos_c = pos.clamp(max=cap_s - 1)
    # each token's k rows from an expand, whose gradient is a reduction
    rows = xf[:, None, :].expand(t_l, k, d).reshape(t_l * k, d)[order]
    send_x = xf.new_zeros(tp, cap_s, d).index_put_(
        (dest_s, pos_c), rows * keep.to(xf.dtype)[:, None], accumulate=True)
    # the expert id rides along; a scatter-max from -1, as the reference's
    eid = torch.where(keep, flat_ids[order] % e_loc, -1)
    send_eid = torch.full((tp * cap_s,), -1, dtype=flat_ids.dtype,
                          device=xf.device).scatter_reduce_(
        0, dest_s * cap_s + pos_c, eid, reduce="amax").view(tp, cap_s)
    gates_s = gates.reshape(-1)[order]
    return send_x, send_eid, (dest_s, pos_c, keep, gates_s, order), aux


def _experts(recv_x, recv_eid, gate_w, up_w, down_w, *, cap_e: int):
    """One shard's local experts over what it received: (tp, cap_s, d)
    rows and their local expert ids -> results in the received layout."""
    tp, cap_s, d = recv_x.shape
    e_loc = gate_w.shape[0]
    rx = recv_x.reshape(tp * cap_s, d)
    reid = recv_eid.reshape(tp * cap_s)
    sort_key = torch.where(reid >= 0, reid, e_loc)     # invalid sorts last
    r_order = torch.argsort(sort_key, stable=True)
    key_s = sort_key[r_order]
    rpos = _rank_in_group(key_s, e_loc)
    rvalid = ((key_s < e_loc) & (rpos < cap_e)).to(rx.dtype)[:, None]
    rpos_c = rpos.clamp(0, cap_e - 1)
    reid_c = key_s.clamp(0, e_loc - 1)
    buf = rx.new_zeros(e_loc, cap_e, d).index_put_(
        (reid_c, rpos_c), rx[r_order] * rvalid, accumulate=True)
    g = torch.bmm(buf, gate_w.to(buf.dtype))
    u = torch.bmm(buf, up_w.to(buf.dtype))
    out_buf = torch.bmm(F.silu(g) * u, down_w.to(buf.dtype))
    y_sorted = out_buf[reid_c, rpos_c] * rvalid
    return y_sorted[_inverse(r_order)].reshape(tp, cap_s, d)


def _combine(y_back, meta, t_l: int, k: int):
    """A shard's tokens' outputs (T_l, d) from the results shipped home."""
    dest_s, pos_c, keep, gates_s, order = meta
    d = y_back.shape[-1]
    contrib = y_back[dest_s, pos_c] \
        * (keep.to(y_back.dtype) * gates_s.to(y_back.dtype))[:, None]
    # back to pair order t·k + j, then each token's k in the order they
    # take in the destination sort (the reference's scatter order)
    rank = _inverse(order)
    pairs = contrib[rank].reshape(t_l, k, d)
    by_dest = torch.argsort(rank.reshape(t_l, k), dim=1)
    pairs = torch.gather(pairs, 1, by_dest[:, :, None].expand(t_l, k, d))
    y = torch.zeros_like(pairs[:, 0])
    for j in range(k):
        y = y + pairs[:, j]
    return y


def _all_to_all(blocks: List[torch.Tensor], devs) -> List[torch.Tensor]:
    """blocks[i] (tp, ...) on shard i -> out[j] (tp, ...) on shard j,
    out[j][i] = blocks[i][j].  Charged to a cost counter as one
    all-to-all over the tp shards (its transpose too, where a gradient
    flows back)."""
    at = [where(b) for b in blocks]
    nbytes = blocks[0].numel() * blocks[0].element_size()
    tp = len(devs)
    collective("all-to-all", nbytes, tp, at)
    out = [place(torch.stack([b[j].to(dev) for b in blocks]), at[j])
           for j, dev in enumerate(devs)]
    if out[0].requires_grad:
        out[0].register_hook(
            lambda g: collective("all-to-all", nbytes, tp, at))
    return out


def _one_data_shard(module: MoE, x, devs, *, k: int, cf: float):
    """The dispatch over one row of model shards ``devs``.  x: (B, S, d)
    on ``devs[0]``; returns (y on ``devs[0]``, the model-mean aux)."""
    tp = len(devs)
    e = module.router.shape[1]
    e_loc = e // tp
    b, s, d = x.shape
    t_l = b * (s // tp)
    cap_s = max(k, int(cf * t_l * k / tp))        # per destination
    cap_e = max(k, int(cf * t_l * k * tp / e))    # per local expert
    sends, eids, metas, auxes = [], [], [], []
    row = where(x)[0]
    for m, (dev, x_l) in enumerate(zip(devs, x.chunk(tp, dim=1))):
        sx, se, meta, aux = _pack(
            place(x_l.to(dev), (row, m)).reshape(t_l, d),
            module.router.to(dev), k=k, e_loc=e_loc, tp=tp, cap_s=cap_s)
        sends.append(sx)
        eids.append(se)
        metas.append(meta)
        auxes.append(aux)
    results = []
    for m, (dev, rx, reid) in enumerate(zip(devs, _all_to_all(sends, devs),
                                            _all_to_all(eids, devs))):
        w = slice(m * e_loc, (m + 1) * e_loc)
        results.append(_experts(
            rx, reid, module.gate_w[w].to(dev), module.up_w[w].to(dev),
            module.down_w[w].to(dev), cap_e=cap_e))
    home = devs[0]
    ys = [place(_combine(y_back, meta, t_l, k).to(home), (row, 0))
          .reshape(b, s // tp, d)
          for y_back, meta in zip(_all_to_all(results, devs), metas)]
    aux = torch.stack([place(a.to(home), (row, 0)) for a in auxes]).mean()
    return torch.cat(ys, dim=1), aux


def data_shard_aux(auxes: List[torch.Tensor]) -> torch.Tensor:
    """The reference's aux over data shards: its ``shard_map`` returns
    the aux of data shard 0 (an output spec of ``P()`` over values that
    differ by data shard reads the first), while its transpose gives the
    gradient of their mean.  So: data shard 0's value, the mean's
    gradient."""
    if len(auxes) == 1:
        return auxes[0]
    home = auxes[0].device
    mean = torch.stack([a.to(home) for a in auxes]).mean()
    return auxes[0].detach() + (mean - mean.detach())


def moe_apply_sharded(module: MoE, x, *, cfg: ModelConfig, mesh,
                      model_axis: str = "model", batch_axes=(),
                      capacity_factor: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), the batch split over ``batch_axes``; returns (y on
    x's device, aux).  Needs S % tp == 0 (sequence-split dispatch) and
    num_experts % tp == 0, tp the size of ``model_axis``."""
    cf = cfg.moe_capacity_factor if capacity_factor is None \
        else capacity_factor
    rows = shard_rows(mesh, _axes(batch_axes), model_axis)
    tp = len(rows[0])
    if x.shape[1] % tp or cfg.num_experts % tp or x.shape[0] % len(rows):
        raise ValueError(f"S={x.shape[1]} and E={cfg.num_experts} must "
                         f"divide over {tp} model shards, B={x.shape[0]} "
                         f"over {len(rows)} data shards")
    ys, auxes = [], []
    for i, (devs, x_i) in enumerate(zip(rows, x.chunk(len(rows), dim=0))):
        x_i = x_i.to(devs[0])
        if len(rows) > 1:
            place(x_i, (i, 0))
        y, aux = _one_data_shard(module, x_i, devs,
                                 k=cfg.experts_per_token, cf=cf)
        ys.append(y.to(x.device))
        auxes.append(aux)
    return torch.cat(ys) if len(ys) > 1 else ys[0], data_shard_aux(auxes)
