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
computes on one card: the chunked cross-entropy, gradient accumulation
over microbatches and int8 error-feedback gradient compression (applied
when the step is given an error-feedback state, as in the reference); the
decode step inserts into the cache at one position for every row, the
reference's default.  The levers that need a mesh raise (ROADMAP
Queue 1 item 11): the all-to-all MoE dispatch, the sharded split-K decode
and ``mesh=``; ``remat`` and ``impl`` have no counterpart (PyTorch runs
eagerly and the kernel follows the device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models.lm import (LM, init_decode_state, lm_decode_step,
                                   lm_loss, lm_prefill, reference_leaf)
from repro_torch.optim import (EFState, adamw, apply_updates,
                               clip_by_global_norm, compress_grads,
                               cosine_decay)

Mark = Optional[Callable[[str], None]]


@dataclasses.dataclass(frozen=True)
class StepOptions:
    loss_chunk: int = 0              # chunked CE (0 = off)
    microbatch: int = 0              # gradient accumulation chunks (0 = off)
    grad_compression: bool = False   # int8 error-feedback DP all-reduce
    sharded_decode: bool = False     # split-K flash-decoding over a mesh
    moe_a2a: bool = False            # all-to-all EP dispatch


def _no_mesh(what: str):
    return NotImplementedError(
        f"{what} needs a mesh, which is not ported yet (ROADMAP Queue 1 "
        "item 11)")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Stand-ins on the meta device for every model input of the (arch,
    shape) cell: int32 tokens and labels (train; tokens alone for prefill)
    with the float32 stubs the family takes (``patch_embeds``,
    ``enc_frames``), or for decode one token, the decode state at
    ``shape.seq_len`` and the enc-dec encoder's ``memory``."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty(b, s, dtype=torch.int32, device=meta)}
        if shape.kind == "train":
            specs["labels"] = torch.empty(b, s, dtype=torch.int32,
                                          device=meta)
        if cfg.num_patch_tokens:
            specs["patch_embeds"] = torch.empty(
                b, cfg.num_patch_tokens, cfg.d_model, device=meta)
        if cfg.is_encdec:
            specs["enc_frames"] = torch.empty(
                b, cfg.encoder_seq_len, cfg.d_model, device=meta)
        return specs
    specs = {"token": torch.empty(b, dtype=torch.int32, device=meta),
             "state": init_decode_state(cfg, b, s, device=meta)}
    if cfg.is_encdec:
        specs["memory"] = torch.empty(b, cfg.encoder_seq_len, cfg.d_model,
                                      device=meta)
    return specs


def trainable(model: LM) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, each set to require grad (the
    port's parameters are created without, for the serving paths)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    opts: StepOptions = StepOptions(), mesh=None):
    """Returns ``train_step(model, opt_state, batch, ef_state=None,
    mark=None) -> (model, opt_state, metrics)``, or ``(model, opt_state,
    metrics, ef_state)`` when ``opts.grad_compression`` is on and an
    ``ef_state`` is given: then the gradients pass through
    :func:`~repro_torch.optim.compress_grads` before clipping, as in the
    reference.  batch: {"tokens", "labels"} (B, S) int tensors on the
    model's device.  ``mark``, if given, is called with "forward",
    "backward", "optimizer" and "end" as the step reaches each phase (once
    per microbatch for the first two)."""
    if opts.moe_a2a:
        raise _no_mesh("the all-to-all MoE dispatch (nn/moe_sharded)")
    if mesh is not None:
        raise _no_mesh("a sharded train step")
    lr = cosine_decay(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)
    _, opt_update = adamw(lr, b1=tcfg.b1, b2=tcfg.b2,
                          weight_decay=tcfg.weight_decay, wd_mask=_wd_mask)

    def compute_grads(model, params, batch, mark):
        names = list(params)

        def metrics_and_grads(mb):
            mark("forward")
            total, metrics = lm_loss(model, mb, loss_chunk=opts.loss_chunk)
            mark("backward")
            grads = torch.autograd.grad(total, [params[k] for k in names],
                                        allow_unused=True,
                                        materialize_grads=True)
            return ({k: v.detach() for k, v in metrics.items()},
                    dict(zip(names, grads)))

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
        metrics, grads = compute_grads(model, params, batch, mark)
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
                      mesh=None):
    """Returns ``prefill_step(model, batch) -> {"logits", "state"(,
    "memory")}``: the prompt's prefill without a graph, the logits of its
    last position (B, padded_vocab), the decode state for ``max_seq``
    positions (the prompt's length by default) and, for an enc-dec model,
    the encoder's memory.  batch: "tokens" (B, S) with the family's stubs
    ("patch_embeds", "enc_frames")."""
    if mesh is not None:
        raise _no_mesh("a sharded prefill")

    @torch.no_grad()
    def prefill_step(model: LM, batch) -> Dict:
        logits, state, memory = lm_prefill(
            model, batch["tokens"],
            max_seq=max_seq or batch["tokens"].shape[1],
            patch_embeds=batch.get("patch_embeds"),
            enc_frames=batch.get("enc_frames"))
        out = {"logits": logits[:, -1], "state": state}
        if memory is not None:
            out["memory"] = memory
        return out

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, opts: StepOptions = StepOptions(),
                    mesh=None):
    """Returns ``serve_step(model, token, state, memory=None) -> (logits
    (B, padded_vocab), state)``: one decode step without a graph (the
    state updated in place, as :func:`~repro_torch.models.lm.
    lm_decode_step` does), cross-attending to ``memory`` where given."""
    if opts.sharded_decode:
        raise _no_mesh("the sharded split-K decode")
    if mesh is not None:
        raise _no_mesh("a sharded decode step")

    @torch.no_grad()
    def serve_step(model: LM, token, state, memory=None):
        return lm_decode_step(model, token, state, memory=memory)

    return serve_step


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
