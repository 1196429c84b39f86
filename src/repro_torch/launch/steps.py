"""Train / prefill / serve step factories and abstract input specs, as
``repro.launch.steps``.

``make_train_step`` returns ``train_step(model, opt_state, batch)``: the
loss and its gradients (``torch.autograd`` through the model; on the card
the kernels' own backward), global-norm clipping, AdamW on the cosine
schedule with weight decay on matrices only, applied to the model's
parameters in place.  ``make_prefill_step`` and ``make_serve_step`` are
the serving path: a prompt's prefill (with the enc-dec encoder's memory
and the VLM's patches) and one decode step (cross-attending to that
memory).  ``input_specs`` gives every model input of an (arch, shape) cell
as meta-device tensors, never allocated.

``StepOptions`` keeps the reference's levers that change what a step
computes: the chunked cross-entropy, gradient accumulation over
microbatches, the decode step's cache insert at one position for every
row (``fused_position``, the reference's default) or at each row's own,
int8 error-feedback gradient compression (applied when the step is given
an error-feedback state, as in the reference), the all-to-all MoE
dispatch, the split-K decode and ``remat`` (on by default, as in the
reference: the train step checkpoints every decoder period and runs its
forward again in the backward, ``models.lm.forward_shards``).  ``impl``
has no counterpart (the kernel follows the device), nor has
``seq_shard_carry`` (the port keeps no activation sharding between
layers).

The dtypes are the reference's: ``input_specs`` gives the stubs and the
decode state in ``dtype`` and ``make_prefill_step`` builds the state in
``state_dtype``, bfloat16 by default for both; the model's parameters
keep the dtype they were made in (``models.lm.LM(dtype=)``), as the
reference's params do.

Each factory takes ``mesh=`` and ``global_batch=``, as the reference's.
With both, the batch splits over the mesh's data axes by
:func:`~repro_torch.distributed.sharding.batch_spec` (which degrades for
an indivisible batch), and each data shard runs on the first device of
its row of the mesh, with the model there (a copy made for the step
where that device is not the model's).  Layer by layer every shard runs
before the next layer starts, since the einsum MoE dispatch routes the
whole batch, as the reference's GSPMD does.  The train step sums the
shards' losses, weighted by their rows, and their gradients into the
global ones on the model's device, where clipping, compression and AdamW
run once.  ``moe_a2a`` runs the MoE layers over the mesh's model axis
(:mod:`repro_torch.nn.moe_sharded`) when the model axis divides the
experts, and ``sharded_decode`` the split-K decode
(:mod:`repro_torch.distributed.flash_decode`) when it does not divide
the kv heads; otherwise the model axis computes what one device does.
Without ``global_batch`` the batch stays whole, as the reference's
activations then carry no constraint.  A mesh of one device gives the
bits of no mesh.

Each data shard's rows are placed at their mesh position for a cost
counter (:func:`repro_torch.distributed.op_cost.place`), and the train
step charges it the ring all-reduce of the gradients over the data
shards (:func:`repro_torch.distributed.op_cost.collective`), whether or
not the mesh repeats a device.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.op_cost import HOME, collective, place
from repro_torch.distributed.sharding import (NamedSharding, _axes,
                                              batch_spec, shard_rows,
                                              sub_mesh)
from repro_torch.models.lm import (LM, decode_shards, init_decode_state,
                                   loss_shards, prefill_shards,
                                   reference_leaf)
from repro_torch.optim import (EFState, adamw, apply_updates,
                               clip_by_global_norm, compress_grads,
                               cosine_decay)

Mark = Optional[Callable[[str], None]]


@dataclasses.dataclass(frozen=True)
class StepOptions:
    loss_chunk: int = 0              # chunked CE (0 = off)
    microbatch: int = 0              # gradient accumulation chunks (0 = off)
    fused_position: bool = True      # decode cache insert at one position
    grad_compression: bool = False   # int8 error-feedback DP all-reduce
    sharded_decode: bool = False     # split-K flash-decoding over a mesh
    moe_a2a: bool = False            # all-to-all EP dispatch
    remat: bool = True               # checkpoint every decoder period


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype=torch.bfloat16) -> Dict:
    """Stand-ins on the meta device for every model input of the (arch,
    shape) cell: int32 tokens and labels (train; tokens alone for prefill)
    with the stubs the family takes (``patch_embeds``, ``enc_frames``), or
    for decode one token, the decode state at ``shape.seq_len`` and the
    enc-dec encoder's ``memory``; the stubs, the memory and the state's
    caches and conv tails in ``dtype`` (the reference's default
    bfloat16)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty(b, s, dtype=torch.int32, device=meta)}
        if shape.kind == "train":
            specs["labels"] = torch.empty(b, s, dtype=torch.int32,
                                          device=meta)
        if cfg.num_patch_tokens:
            specs["patch_embeds"] = torch.empty(
                b, cfg.num_patch_tokens, cfg.d_model, dtype=dtype,
                device=meta)
        if cfg.is_encdec:
            specs["enc_frames"] = torch.empty(
                b, cfg.encoder_seq_len, cfg.d_model, dtype=dtype,
                device=meta)
        return specs
    specs = {"token": torch.empty(b, dtype=torch.int32, device=meta),
             "state": init_decode_state(cfg, b, s, dtype=dtype,
                                        device=meta)}
    if cfg.is_encdec:
        specs["memory"] = torch.empty(b, cfg.encoder_seq_len, cfg.d_model,
                                      dtype=dtype, device=meta)
    return specs


def trainable(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, each set to require grad (the
    port's parameters are created without, for the serving paths): an LM
    for the train step, or the DiT for ``gdm_loss``."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


class _Shards:
    """Where a step's data shards run: ``homes[i]`` is the first device of
    data shard i's row of the mesh (batch rows ``i·B/n`` on), ``models[i]``
    the model there, and ``batch_axes`` the mesh axes the batch splits
    over.  Without a mesh, one shard on the model's device.  A copy of the
    model is made for each home that is not the model's device, so it
    holds the model's current parameters."""

    def __init__(self, model: LM, mesh, global_batch: int):
        device = model.embed.table.device
        act_sh = _act_sharding(mesh, global_batch)
        self.batch_axes = _axes(act_sh.spec[0]) if act_sh else ()
        self.homes = [torch.device(r[0]) for r in shard_rows(
            mesh, self.batch_axes)] if mesh is not None else [device]
        copies: Dict[torch.device, LM] = {device: model}
        for home in self.homes:
            if home not in copies:
                copies[home] = copy.deepcopy(model).to(home)
        self.models = [copies[h] for h in self.homes]
        self.replicas = list(copies.values())

    def rows(self, n: int) -> List[slice]:
        k = len(self.homes)
        if n % k:
            raise ValueError(f"a batch of {n} does not split over {k} data "
                             "shards")
        return [slice(i * n // k, (i + 1) * n // k) for i in range(k)]

    def to(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """``t`` on shard i's home, placed at its mesh position."""
        return place(t.to(self.homes[i]), (i, 0))

    def split(self, batch: Dict) -> List[Dict]:
        """The batch dict's rows, shard by shard, each on its home."""
        rows = self.rows(next(iter(batch.values())).shape[0])
        return [{k: self.to(v[r], i) for k, v in batch.items()}
                for i, r in enumerate(rows)]


def _gather(ts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` on the first one's
    device."""
    if len(ts) == 1:
        return ts[0]
    return torch.cat([t.to(ts[0].device) for t in ts], dim)


def _state_leaves(state) -> List[torch.Tensor]:
    return [t for slot in state for v in slot.values()
            for t in (v if isinstance(v, tuple) else (v,))]


def _map_state(fn, state):
    return tuple({k: type(v)(*map(fn, v)) if isinstance(v, tuple) else fn(v)
                  for k, v in slot.items()} for slot in state)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    opts: StepOptions = StepOptions(), mesh=None,
                    global_batch: int = 0):
    """Returns ``train_step(model, opt_state, batch, ef_state=None,
    mark=None) -> (model, opt_state, metrics)``, or ``(model, opt_state,
    metrics, ef_state)`` when ``opts.grad_compression`` is on and an
    ``ef_state`` is given: then the gradients pass through
    :func:`~repro_torch.optim.compress_grads` before clipping, as in the
    reference.  batch: {"tokens", "labels"} (B, S) int tensors on the
    model's device.  ``mark``, if given, is called with "forward",
    "backward", "optimizer" and "end" as the step reaches each phase (once
    per microbatch for the first two).  With ``mesh`` and
    ``global_batch`` the batch splits over the data axes (module
    docstring); ``opts.moe_a2a`` runs the MoE layers through the
    all-to-all dispatch when the mesh has a model axis that divides the
    experts, as the reference decides."""
    lr = cosine_decay(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)
    _, opt_update = adamw(lr, b1=tcfg.b1, b2=tcfg.b2,
                          weight_decay=tcfg.weight_decay, wd_mask=_wd_mask)
    a2a = (opts.moe_a2a and cfg.is_moe and mesh is not None
           and "model" in mesh.axis_names
           and cfg.num_experts % mesh.shape["model"] == 0)

    def compute_grads(shards: _Shards, params, batch, mark):
        names = list(params)
        moe_ctx = (mesh, shards.batch_axes) if a2a else None
        leaves = [dict(m.named_parameters()) for m in shards.replicas]

        def metrics_and_grads(mb):
            mark("forward")
            total, metrics = loss_shards(shards.models, shards.split(mb),
                                         loss_chunk=opts.loss_chunk,
                                         moe_sharded_ctx=moe_ctx,
                                         remat=opts.remat)
            mark("backward")
            flat = [rep[k] for rep in leaves for k in names]
            grads = torch.autograd.grad(total, flat, allow_unused=True,
                                        materialize_grads=True)
            # each copy's gradients summed onto the model's device
            n = len(names)
            summed = list(grads[:n])
            for r in range(1, len(leaves)):
                summed = [g + h.to(g.device) for g, h in
                          zip(summed, grads[r * n:(r + 1) * n])]
            k = len(shards.homes)
            collective("all-reduce", sum(g.numel() * g.element_size()
                                         for g in summed), k,
                       [(i, 0) for i in range(k)])
            summed = [place(g, HOME) for g in summed]
            return ({k: v.detach() for k, v in metrics.items()},
                    dict(zip(names, summed)))

        b = batch["tokens"].shape[0]
        if not (opts.microbatch and b % opts.microbatch == 0):
            return metrics_and_grads(batch)
        # gradient accumulation: the mean of the microbatches' gradients,
        # the last microbatch's metrics, as in the reference
        nmb = opts.microbatch
        chunks = [dict(zip(batch, rows)) for rows in zip(
            *(t.reshape(nmb, b // nmb, *t.shape[1:]) for t in
              batch.values()))]
        g_acc = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        for mb in chunks:
            metrics, g = metrics_and_grads(mb)
            g_acc = {k: g_acc[k] + g[k].float() for k in names}
        return metrics, {k: g / nmb for k, g in g_acc.items()}

    def train_step(model: LM, opt_state, batch,
                   ef_state: Optional[EFState] = None, mark: Mark = None):
        mark = mark or (lambda _: None)
        params = trainable(model)
        shards = _Shards(model, mesh, global_batch)
        metrics, grads = compute_grads(shards, params, batch, mark)
        mark("optimizer")
        compress = opts.grad_compression and ef_state is not None
        if compress:
            grads, ef_state = compress_grads(grads, ef_state,
                                             _leaf_groups(grads))
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        updates, opt_state = opt_update(grads, opt_state, params)
        del grads
        apply_updates(params, updates)
        mark("end")
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        if compress:
            return model, opt_state, metrics, ef_state
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, max_seq: Optional[int] = None,
                      state_dtype=torch.bfloat16, mesh=None,
                      global_batch: int = 0):
    """Returns ``prefill_step(model, batch) -> {"logits", "state"(,
    "memory")}``: the prompt's prefill without a graph, the logits of its
    last position (B, padded_vocab), the decode state for ``max_seq``
    positions (the prompt's length by default; its caches and conv tails
    in ``state_dtype``, the reference's default bfloat16) and, for an
    enc-dec model, the encoder's memory.  batch: "tokens" (B, S) with the
    family's stubs ("patch_embeds", "enc_frames").  On a mesh the data
    shards' logits, states and memories are gathered on the first shard's
    device."""

    @torch.no_grad()
    def prefill_step(model: LM, batch) -> Dict:
        shards = _Shards(model, mesh, global_batch)
        logits, states, mems = prefill_shards(
            shards.models, shards.split(batch),
            max_seq=max_seq or batch["tokens"].shape[1],
            state_dtype=state_dtype)
        leaves = [_state_leaves(s) for s in states]
        it = iter([_gather(ts, 1) for ts in zip(*leaves)])
        out = {"logits": _gather([lg[:, -1] for lg in logits]),
               "state": _map_state(lambda _: next(it), states[0])}
        if mems[0] is not None:
            out["memory"] = _gather(mems)
        return out

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, opts: StepOptions = StepOptions(),
                    mesh=None, global_batch: int = 0):
    """Returns ``serve_step(model, token, state, memory=None) -> (logits
    (B, padded_vocab), state)``: one decode step without a graph (the
    state updated in place, as :func:`~repro_torch.models.lm.
    lm_decode_step` does), cross-attending to ``memory`` where given.  On
    a mesh each data shard decodes its rows of the state (a view of
    them, or a copy written back on another device);
    ``opts.fused_position`` inserts every row's new key and value at the
    first row's position (the reference's default) or, off, each at its
    own (:func:`~repro_torch.nn.attention.attention_decode`);
    ``opts.sharded_decode`` engages the split-K decode only when the model
    axis does not divide the kv heads, as in the reference (the
    ``decode_attention`` kernel runs otherwise)."""
    split_k = (opts.sharded_decode and mesh is not None
               and "model" in mesh.axis_names
               and cfg.num_kv_heads % mesh.shape["model"] != 0)

    @torch.no_grad()
    def serve_step(model: LM, token, state, memory=None):
        shards = _Shards(model, mesh, global_batch)
        rows = shards.rows(token.shape[0])
        views = [_map_state(lambda t: t[:, r], state) for r in rows]
        states = [_map_state(lambda t: shards.to(t, i), v)
                  for i, v in enumerate(views)]
        sd = [(shards.batch_axes, "model",
               sub_mesh(mesh, shards.batch_axes, i))
              for i in range(len(rows))] if split_k else None
        logits = decode_shards(
            shards.models, [shards.to(token[r], i)
                            for i, r in enumerate(rows)], states,
            memories=[None if memory is None else shards.to(memory[r], i)
                      for i, r in enumerate(rows)],
            fused_position=opts.fused_position, sharded_decode=sd)
        for v, st in zip(views, states):
            for a, b in zip(_state_leaves(v), _state_leaves(st)):
                if a is not b:          # a copy on another device
                    a.copy_(b)
        return _gather(logits), state

    return serve_step


def _act_sharding(mesh, global_batch: int) -> Optional[NamedSharding]:
    """(B, S, d) activations: batch over dp, as the reference's without
    its sequence-parallel option."""
    if mesh is None or not global_batch:
        return None
    return NamedSharding(mesh, batch_spec(mesh, global_batch, extra_dims=2))


def _leaf_groups(params: Dict[str, torch.Tensor]) -> List[List[str]]:
    """The port's names grouped by the reference leaf they make up (a
    layer's leaf is stacked over the periods there), in period order."""
    groups: Dict[tuple, List[str]] = {}
    for name in params:
        groups.setdefault(reference_leaf(name)[0], []).append(name)
    return list(groups.values())


def _wd_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """Weight decay on matrices only (no norms, biases or embeddings), leaf
    for leaf as the reference's rule reads its tree: the path
    ``layers/{slot}/...`` (the port's ``layers.{period}.{slot}...``) and the
    rank with the stacked period axis, so the per-channel vectors of a
    layer (Mamba's ``d`` and ``conv_b``) are decayed there, and here."""
    mask = {}
    for name, p in params.items():
        parts, period = reference_leaf(name)
        ndim = p.dim() + (period is not None)
        path = "/".join(parts)
        mask[name] = (ndim >= 2 and "norm" not in path
                      and not path.endswith("/b") and "embed" not in path)
    return mask
