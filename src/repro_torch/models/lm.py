"""The LM stack of the edge launcher and the trainer: every family of the
reference's zoo.

Port of ``repro.models.lm``: token embedding, periods of pre-norm blocks
(a norm, a mixer, a norm, an MLP), a final norm and an untied (or tied)
head whose padded-vocab columns are -1e9.  The families, by their
periodic layer pattern (:func:`layer_pattern`):

* dense and MoE (and the VLM and the enc-dec decoder): GQA attention with
  RoPE in every block; SwiGLU, or a mixture of SwiGLU experts
  (:mod:`repro_torch.nn.moe`) whose load-balancing losses ``lm_forward``
  sums;
* hybrid (Jamba): attention first in each period of ``attn_every``, Mamba
  selective-SSM blocks after, experts on every ``moe_every``-th;
* xLSTM (``ssm`` with an ``XLSTMConfig``): one sLSTM block, then mLSTM
  blocks, per period of ``slstm_every``, no MLP (:mod:`repro_torch.nn.
  xlstm`);
* enc-dec (``encoder_layers`` > 0): LayerNorm (eps 1e-5) everywhere,
  GELU MLPs, a bidirectional encoder over the ``frame_proj``-ected audio
  frames, and cross-attention to its memory in every decoder block;
* VLM (``frontend="image_patches"``): ``patch_proj``-ected patch
  embeddings replace the first P token embeddings (the sequence keeps its
  length).

The reference expresses depth as a periodic layer pattern with
period-stacked parameters; the port keeps that structure by name —
``layers.{p}.{j}`` is slot j of period p, the reference's
``params["layers"][j]`` at index p, and ``encoder.layers.{i}.0`` the
encoder's layer i — so :mod:`repro_torch.models.convert` carries weights
across.

Every RMSNorm runs the ``rmsnorm`` kernel (2L + 1 launches a forward or a
decode step of an attention or Mamba stack, L + 1 of an xLSTM stack),
every Mamba block the ``ssm_scan`` kernel on a full sequence; decode
attention (self and cross) runs ``decode_attention``, prefill and the full
forward ``flash_attention`` (causal with rope; non-causal in the encoder
and against the memory).  LayerNorm, the xLSTM cells and the GELU MLP are
torch ops, as they are XLA ops in the reference.

On a mesh, :func:`forward_shards`, :func:`loss_shards`,
:func:`prefill_shards` and :func:`decode_shards` run the same layers over
a list of data shards (a model replica and a slice of the batch rows
each), layer by layer; ``lm_forward`` and the others are the one-shard
case.  ``moe_sharded_ctx`` = (mesh, batch_axes) sends the MoE layers
through the all-to-all dispatch (:mod:`repro_torch.nn.moe_sharded`), as
the reference's hook does, and ``sharded_decode`` the attention layers'
decode through the split-K decode.

``remat`` (``lm_forward``, ``lm_loss`` and their shard forms; off by
default, as in the reference, whose train step turns it on) runs each
decoder period under ``torch.utils.checkpoint``, the counterpart of the
reference's ``jax.checkpoint`` of its period: the period keeps only its
inputs, and the backward runs its forward again, through the same
kernels, before differentiating it.  The encoder, the prefill and the
decode step do not remat, as in the reference.

The decode state keeps the reference's stacked layout, one entry per
pattern slot, each tensor with a leading period axis: ``{"kv":
KVCache(k, v, length)}``, ``{"mamba": MambaState(conv, ssm)}``,
``{"mlstm": MLSTMState(c, n, m), "conv_tail": ...}`` or ``{"slstm":
SLSTMState(h, c, n, m)}``, so a request's payload has the reference's
bytes.  As in the reference, the KV caches and the conv tails take the
state's dtype (``init_decode_state(dtype=)``, ``lm_prefill(state_dtype=)``;
bfloat16 by default) and the recurrent states (Mamba's ``ssm``, the
mLSTM's and sLSTM's cells) are float32 whatever it is.  The parameters
take the model's dtype (``LM(dtype=)``, float32 by default, as the
reference's ``init_lm``), but for Mamba's ``a_log`` and ``d`` and the MoE
router, float32 in any model; activations run in the parameters' dtype,
and every norm, softmax and recurrence reduces in float32 and rounds once,
as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.op_cost import HOME, moved
from repro_torch.distributed.sharding import sub_mesh
from repro_torch.nn import (Attention, Dense, Embedding, GeluMLP, LayerNorm,
                            Mamba, MambaState, RMSNorm, SwiGLU, dense_apply,
                            embedding_apply, embedding_attend, gelu_mlp_apply,
                            layernorm_apply, mamba_apply, mamba_decode,
                            mamba_init_state, rmsnorm_apply, swiglu_apply)
from repro_torch.nn.attention import (KVCache, attention_apply,
                                      attention_decode,
                                      cross_attention_decode,
                                      prefill_kv_cache)
from repro_torch.nn.moe import MoE, moe_apply
from repro_torch.nn.moe_sharded import data_shard_aux, moe_apply_sharded
from repro_torch.nn.xlstm import (MLSTM, SLSTM, MLSTMState, SLSTMState,
                                  mlstm_apply, mlstm_apply_with_state,
                                  mlstm_decode, mlstm_init_state,
                                  slstm_apply, slstm_decode,
                                  slstm_init_state)

PAD_LOGIT = -1e9          # logits of the padded-vocab columns


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn | mamba | mlstm | slstm
    mlp: str            # swiglu | moe | gelu | none
    cross: bool = False  # decoder cross-attention (enc-dec)


def layer_pattern(cfg: ModelConfig, *, decoder: bool = True
                  ) -> List[LayerSpec]:
    """The repeating per-period layer pattern for ``cfg`` (the decoder's,
    or with ``decoder=False`` the enc-dec encoder's)."""
    if not decoder:
        return [LayerSpec("attn", "gelu")]
    if cfg.family == "ssm" and cfg.xlstm is not None:
        return [LayerSpec("slstm" if j == 0 else "mlstm", "none")
                for j in range(cfg.xlstm.slstm_every)]
    if cfg.family == "hybrid":
        return [LayerSpec("attn" if j == 0 else "mamba",
                          "moe" if cfg.is_moe and j % cfg.moe_every
                          == cfg.moe_every - 1 else "swiglu")
                for j in range(cfg.attn_every)]
    mlp = "moe" if cfg.is_moe else ("gelu" if cfg.is_encdec else "swiglu")
    return [LayerSpec("attn", mlp, cross=cfg.is_encdec)]


def _norm_module(cfg: ModelConfig, device, dtype):
    return (LayerNorm if cfg.is_encdec else RMSNorm)(
        cfg.d_model, device=device, dtype=dtype)


def _norm(cfg: ModelConfig, params, x):
    if cfg.is_encdec:
        return layernorm_apply(params, x)
    return rmsnorm_apply(params, x, eps=cfg.norm_eps)


class Block(nn.Module):
    """One sub-layer's parameters (the reference's ``layers[j]`` at one
    period): ``norm1``, the mixer (``attn``, ``mamba``, ``mlstm`` or
    ``slstm``), ``cross_norm`` and ``cross`` (enc-dec decoder), ``norm2``
    and ``mlp`` (SwiGLU or GELU) or ``moe`` (experts); no MLP in an xLSTM
    block."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = _norm_module(cfg, device, dtype)
        mixer = {"attn": Attention, "mamba": Mamba, "mlstm": MLSTM,
                 "slstm": SLSTM}[spec.mixer]
        setattr(self, spec.mixer, mixer(cfg, **kw))
        if spec.cross:
            self.cross_norm = _norm_module(cfg, device, dtype)
            self.cross = Attention(cfg, **kw)
        if spec.mlp == "none":
            return
        self.norm2 = _norm_module(cfg, device, dtype)
        if spec.mlp == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            mlp = GeluMLP if spec.mlp == "gelu" else SwiGLU
            self.mlp = mlp(cfg.d_model, cfg.d_ff, num_layers=cfg.num_layers,
                           **kw)


def _stack(cfg: ModelConfig, pattern, periods: int, device, dtype):
    return nn.ModuleList(
        nn.ModuleList(Block(cfg, spec, device=device, dtype=dtype)
                      for spec in pattern)
        for _ in range(periods))


class Encoder(nn.Module):
    """The enc-dec encoder: ``encoder_layers`` blocks of the encoder
    pattern and a final norm (the reference's ``params["encoder"]``)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.layers = _stack(cfg, layer_pattern(cfg, decoder=False),
                             cfg.encoder_layers, device, dtype)
        self.final_norm = _norm_module(cfg, device, dtype)


class LM(nn.Module):
    """Embedding, ``num_layers / period`` periods of blocks, final norm,
    (unless tied) the head, and the family's extras: the ``encoder`` and
    ``frame_proj`` (audio frames) or ``patch_proj`` (image patches).  The
    parameters in ``dtype`` (the reference's ``init_lm(dtype=)``, float32
    by default), but for the float32 leaves the reference keeps (Mamba's
    ``a_log`` and ``d``, the MoE router)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        pattern = layer_pattern(cfg)
        if cfg.num_layers % len(pattern):
            raise ValueError(f"{cfg.num_layers} layers do not make whole "
                             f"periods of {len(pattern)}")
        self.cfg = cfg
        self.pattern = pattern
        vpad = cfg.padded_vocab()
        self.embed = Embedding(vpad, cfg.d_model, **kw)
        self.final_norm = _norm_module(cfg, device, dtype)
        self.layers = _stack(cfg, pattern, cfg.num_layers // len(pattern),
                             device, dtype)
        if cfg.tie_embeddings:
            self.register_module("head", None)
        else:
            self.head = Dense(cfg.d_model, vpad, stddev=cfg.d_model ** -0.5,
                              **kw)
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, **kw)
        if cfg.frontend == "image_patches":
            self.patch_proj = Dense(cfg.d_model, cfg.d_model, **kw)
        if cfg.frontend == "audio_frames":
            self.frame_proj = Dense(cfg.d_model, cfg.d_model, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter with the reference's distributions, in
        module order, from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def reference_leaf(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The path of a parameter's leaf in the reference's params tree and
    the parameter's index on that leaf's stacked axis (None outside the
    layer stacks): the port's ``layers.{p}.{j}.<rest>`` is the reference's
    ``params["layers"][j][<rest>][p]``, and ``encoder.layers.{i}.{j}.
    <rest>`` is ``params["encoder"]["layers"][j][<rest>][i]``."""
    parts = tuple(name.split("."))
    if parts[0] == "layers":
        return ("layers", parts[2]) + parts[3:], int(parts[1])
    if parts[:2] == ("encoder", "layers"):
        return ("encoder", "layers", parts[3]) + parts[4:], int(parts[2])
    return parts, None


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None,
            dtype=torch.float32) -> LM:
    """An LM in ``dtype`` with weights drawn from ``torch.Generator(
    device).manual_seed(seed)``.  The draws follow the reference's
    distributions, not its numbers: weights that must equal the
    reference's come through :func:`repro_torch.models.convert.
    lm_from_jax`."""
    device = resolve_device(device)
    model = LM(cfg, device=device, dtype=dtype)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


def _embed(model: LM, tokens, patch_embeds):
    """Token embeddings, the first P replaced by the projected patch
    embeddings (B, P, d) where given."""
    x = embedding_apply(model.embed, tokens)
    if patch_embeds is None:
        return x
    proj = dense_apply(model.patch_proj, patch_embeds.to(x.dtype))
    return torch.cat([proj, x[:, patch_embeds.shape[1]:]], dim=1)


def _encode(model: LM, enc_frames, dtype):
    """The enc-dec encoder's memory (B, L_enc, d) over the audio frames
    (None for another family).  Bidirectional attention, GELU MLPs."""
    cfg = model.cfg
    if not cfg.is_encdec:
        return None
    if enc_frames is None:
        raise ValueError("enc-dec arch needs enc_frames")
    enc = model.encoder
    x = enc_frames.to(dtype)
    if cfg.frontend == "audio_frames":
        x = dense_apply(model.frame_proj, x)
    for (block,) in enc.layers:
        h = _norm(cfg, block.norm1, x)
        x = x + attention_apply(block.attn, h, cfg=cfg, causal=False)
        x = x + gelu_mlp_apply(block.mlp, _norm(cfg, block.norm2, x))
    return _norm(cfg, enc.final_norm, x)


def _lm_head(model: LM, x):
    cfg = model.cfg
    if cfg.tie_embeddings:
        logits = embedding_attend(model.embed, x)
    else:
        logits = dense_apply(model.head, x)
    if cfg.padded_vocab() != cfg.vocab_size:
        logits[..., cfg.vocab_size:].fill_(PAD_LOGIT)
    return logits


# -- data shards ---------------------------------------------------------------------------
#
# Every function below runs over a list of data shards: one model replica,
# one slice of the batch rows and one state each, on the replica's device.
# Without a mesh the list holds the one shard.  Each layer runs on every
# shard before the next layer starts, because the einsum MoE dispatch
# routes the whole batch at once, as the reference's GSPMD does: its
# capacity counts every token of the batch.

MoeFn = Callable[[List[MoE], List[torch.Tensor]],
                 Tuple[List[torch.Tensor], torch.Tensor]]


def _moe_einsum(mods: List[MoE], hs: List[torch.Tensor]):
    """The einsum dispatch over the whole batch: the data shards' rows
    gathered on the first shard's device, the outputs sent back."""
    if len(hs) == 1:
        y, aux = moe_apply(mods[0], hs[0])
        return [y], aux
    home = hs[0].device
    y, aux = moe_apply(mods[0], torch.cat([moved(h.to(home), HOME)
                                           for h in hs]))
    return [moved(c.to(h.device), (i, 0)) for i, (c, h) in
            enumerate(zip(y.split([h.shape[0] for h in hs]), hs))], aux


def _moe_a2a(cfg: ModelConfig, moe_sharded_ctx) -> MoeFn:
    """The all-to-all dispatch over ``moe_sharded_ctx`` = (mesh,
    batch_axes): the whole batch split by ``batch_axes``, or each data
    shard over its own row of the mesh."""
    mesh, batch_axes = moe_sharded_ctx

    def moe(mods, hs):
        if len(hs) == 1:
            y, aux = moe_apply_sharded(mods[0], hs[0], cfg=cfg, mesh=mesh,
                                       batch_axes=batch_axes)
            return [y], aux
        outs = [moe_apply_sharded(m, h, cfg=cfg,
                                  mesh=sub_mesh(mesh, batch_axes, i),
                                  batch_axes=batch_axes)
                for i, (m, h) in enumerate(zip(mods, hs))]
        return [y for y, _ in outs], data_shard_aux([a for _, a in outs])

    return moe


def _cross_and_mlp(blocks: List[Block], spec: LayerSpec, xs, cfg: ModelConfig,
                   memories, decode: bool, moe: MoeFn = _moe_einsum):
    """After the mixer's residual: the cross-attention to the memory
    (enc-dec, when a memory is given) and the MLP, each with its norm and
    residual, on every shard.  Returns (xs, the MoE's load-balancing loss
    or None)."""
    if spec.cross and memories[0] is not None:
        def cross(block, x, memory):
            h = _norm(cfg, block.cross_norm, x)
            return x + (cross_attention_decode(block.cross, h, memory,
                                               cfg=cfg)
                        if decode else
                        attention_apply(block.cross, h, cfg=cfg,
                                        memory=memory))
        xs = [cross(*a) for a in zip(blocks, xs, memories)]
    if spec.mlp == "none":
        return xs, None
    hs = [_norm(cfg, b.norm2, x) for b, x in zip(blocks, xs)]
    if spec.mlp == "moe":
        ys, aux = moe([b.moe for b in blocks], hs)
        return [x + y for x, y in zip(xs, ys)], aux
    mlp = gelu_mlp_apply if spec.mlp == "gelu" else swiglu_apply
    return [x + mlp(b.mlp, h) for b, x, h in zip(blocks, xs, hs)], None


def _mixer(spec: LayerSpec, block: Block, h, cfg: ModelConfig):
    """The full-sequence mixer of one block."""
    if spec.mixer == "attn":
        return attention_apply(block.attn, h, cfg=cfg)
    if spec.mixer == "mamba":
        return mamba_apply(block.mamba, h, cfg=cfg)
    if spec.mixer == "mlstm":
        return mlstm_apply(block.mlstm, h, cfg=cfg)
    return slstm_apply(block.slstm, h, cfg=cfg)


def _embed_all(models: List[LM], batches: List[Dict]):
    """Each shard's embeddings and (enc-dec) encoder memory."""
    xs = [_embed(m, b["tokens"], b.get("patch_embeds"))
          for m, b in zip(models, batches)]
    mems = [_encode(m, b.get("enc_frames"), x.dtype)
            for m, b, x in zip(models, batches, xs)]
    return xs, mems


def _blocks(models: List[LM], p: int):
    """Period p's blocks, slot by slot, one per shard."""
    return list(zip(*(m.layers[p] for m in models)))


def _period(models: List[LM], p: int, moe: MoeFn, mems, aux, *xs):
    """Period p of the decoder on every shard: (aux plus the period's MoE
    losses, then each shard's output)."""
    cfg = models[0].cfg
    xs = list(xs)
    for spec, blocks in zip(models[0].pattern, _blocks(models, p)):
        xs = [x + _mixer(spec, b, _norm(cfg, b.norm1, x), cfg)
              for b, x in zip(blocks, xs)]
        xs, a = _cross_and_mlp(blocks, spec, xs, cfg, mems, False, moe)
        if a is not None:
            aux = aux + a
    return (aux, *xs)


def forward_shards(models: List[LM], batches: List[Dict], *,
                   moe_sharded_ctx=None, remat: bool = False):
    """:func:`lm_forward` over data shards: ``batches[i]`` ("tokens" and
    the family's stubs) on ``models[i]``'s device.  Returns (the shards'
    logits, aux) with aux on the first shard's device.  With ``remat``
    each period runs under a checkpoint that takes every shard's
    activations, so layer by layer every shard still runs before the next
    layer starts.  The period draws no random numbers, so the checkpoint
    keeps no RNG state (``preserve_rng_state=False``: nothing to restore,
    and no device RNG to read on the meta device)."""
    cfg = models[0].cfg
    moe = _moe_einsum if moe_sharded_ctx is None \
        else _moe_a2a(cfg, moe_sharded_ctx)
    xs, mems = _embed_all(models, batches)
    aux = torch.zeros((), device=xs[0].device)
    for p in range(len(models[0].layers)):
        if remat:
            aux, *xs = checkpoint(
                lambda *a, p=p: _period(models, p, moe, mems, *a), aux, *xs,
                use_reentrant=False, preserve_rng_state=False)
        else:
            aux, *xs = _period(models, p, moe, mems, aux, *xs)
    return [_lm_head(m, _norm(cfg, m.final_norm, x))
            for m, x in zip(models, xs)], aux


def lm_forward(model: LM, tokens, *, patch_embeds=None, enc_frames=None,
               moe_sharded_ctx=None, remat: bool = False):
    """Full-sequence forward.  tokens: (B, S) int -> (logits (B, S,
    padded_vocab), aux), aux the float32 sum of the MoE layers'
    load-balancing losses (zero without experts).  ``patch_embeds`` (B, P,
    d) fill the first P positions (VLM); ``enc_frames`` (B, L_enc, d) are
    the encoder's input, which an enc-dec model requires.
    ``moe_sharded_ctx`` = (mesh, batch_axes) runs every MoE layer through
    the all-to-all dispatch (:mod:`repro_torch.nn.moe_sharded`); ``remat``
    checkpoints every decoder period (module docstring)."""
    logits, aux = forward_shards(
        [model], [dict(tokens=tokens, patch_embeds=patch_embeds,
                       enc_frames=enc_frames)],
        moe_sharded_ctx=moe_sharded_ctx, remat=remat)
    return logits[0], aux


def _nll(logits, labels, loss_chunk: int):
    """Mean negative log-likelihood of ``labels`` (B, S) under ``logits``;
    log-softmax in float32, chunk by chunk along the sequence where
    ``loss_chunk`` divides S."""
    labels = labels.long()
    b, s = labels.shape
    if loss_chunk and s % loss_chunk == 0:
        total_ll = torch.zeros((), device=logits.device)
        for c in range(0, s, loss_chunk):
            logp = torch.log_softmax(logits[:, c:c + loss_chunk].float(),
                                     dim=-1)
            ll = logp.gather(-1, labels[:, c:c + loss_chunk, None])[..., 0]
            total_ll = total_ll + ll.sum()
        return -total_ll / (b * s)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def loss_shards(models: List[LM], batches: List[Dict], *,
                aux_weight: float = 0.01, loss_chunk: int = 0,
                moe_sharded_ctx=None, remat: bool = False):
    """:func:`lm_loss` over data shards: each shard's mean
    log-likelihood, weighted by its share of the rows, summed on the first
    shard's device into the global mean."""
    logits, aux = forward_shards(models, batches,
                                 moe_sharded_ctx=moe_sharded_ctx, remat=remat)
    losses = [_nll(lg, b["labels"], loss_chunk)
              for lg, b in zip(logits, batches)]
    loss = losses[0]
    if len(losses) > 1:
        rows = [b["labels"].shape[0] for b in batches]
        home = losses[0].device
        loss = sum(moved(l.to(home), HOME) * (r / sum(rows))
                   for l, r in zip(losses, rows))
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux,
                   "perplexity": torch.exp(loss.clamp(max=20.0))}


def lm_loss(model: LM, batch, *, aux_weight: float = 0.01,
            loss_chunk: int = 0, moe_sharded_ctx=None, remat: bool = False):
    """Causal LM cross-entropy + MoE aux loss, as the reference's
    ``lm_loss``.  batch: {"tokens", "labels"} (B, S) int, with the stubs
    "patch_embeds" and "enc_frames" where the family takes them.
    Log-softmax in float32 over the padded vocab (its columns at -1e9).

    ``loss_chunk`` > 0 (and dividing S) sums the log-likelihood chunk by
    chunk along the sequence, never holding the whole (B, S, V)
    log-softmax.  ``remat`` checkpoints every decoder period.  Returns
    (total, {"loss", "aux", "perplexity"})."""
    return loss_shards([model], [batch], aux_weight=aux_weight,
                       loss_chunk=loss_chunk,
                       moe_sharded_ctx=moe_sharded_ctx, remat=remat)


def _stacked(per_period: List[Dict]) -> Dict:
    """One slot's per-period states stacked on a leading period axis."""
    out = {}
    for key, first in per_period[0].items():
        values = [s[key] for s in per_period]
        out[key] = (type(first)(*(torch.stack(t) for t in zip(*values)))
                    if isinstance(first, tuple) else torch.stack(values))
    return out


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      dtype=torch.bfloat16, device=None) -> Tuple[Dict, ...]:
    """Stacked (num_periods, ...) decode state, one entry per pattern
    slot: an empty KV cache (every length 0) for attention, zero conv tail
    and SSM state for Mamba, the mLSTM's and sLSTM's initial states
    (stabiliser at ``NEG_INF``) and a zero conv tail.  The caches and the
    conv tails in ``dtype`` (the reference's default bfloat16), the
    recurrent states float32."""
    device = resolve_device(device)
    pattern = layer_pattern(cfg)
    n_periods = cfg.num_layers // len(pattern)
    hd = cfg.resolved_head_dim

    def one(spec) -> Dict:
        if spec.mixer == "attn":
            shape = (batch, max_seq, cfg.num_kv_heads, hd)
            return {"kv": KVCache(
                torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(batch, dtype=torch.int32, device=device))}
        if spec.mixer == "mamba":
            return {"mamba": mamba_init_state(cfg, batch, dtype=dtype,
                                              device=device)}
        if spec.mixer == "mlstm":
            xc = cfg.xlstm
            d_in = int(xc.proj_factor * cfg.d_model)
            return {"mlstm": mlstm_init_state(cfg, batch, device=device),
                    "conv_tail": torch.zeros(batch, xc.conv_kernel - 1, d_in,
                                             dtype=dtype, device=device)}
        return {"slstm": slstm_init_state(cfg, batch, device=device)}

    return tuple(_stacked([one(spec) for _ in range(n_periods)])
                 for spec in pattern)


def _prefill_mixer(spec: LayerSpec, block: Block, h, cfg: ModelConfig,
                   max_seq: int, state_dtype):
    """The full-sequence mixer of one block and the decode state it
    leaves, its cache and conv tail in ``state_dtype``."""
    if spec.mixer == "attn":
        kv = prefill_kv_cache(block.attn, h, cfg=cfg, max_seq=max_seq,
                              dtype=state_dtype)
        return attention_apply(block.attn, h, cfg=cfg), {"kv": kv}
    if spec.mixer == "mamba":
        h, ms = mamba_apply(block.mamba, h, cfg=cfg, return_state=True)
        return h, {"mamba": ms._replace(conv=ms.conv.to(state_dtype))}
    if spec.mixer == "mlstm":
        h, mls, tail = mlstm_apply_with_state(block.mlstm, h, cfg=cfg)
        return h, {"mlstm": mls, "conv_tail": tail.to(state_dtype)}
    h, sls = slstm_apply(block.slstm, h, cfg=cfg, return_state=True)
    return h, {"slstm": sls}


def prefill_shards(models: List[LM], batches: List[Dict], *, max_seq: int,
                   state_dtype=torch.bfloat16):
    """:func:`lm_prefill` over data shards; returns the shards' logits,
    states and memories."""
    cfg = models[0].cfg
    xs, mems = _embed_all(models, batches)
    slots = [[[] for _ in models[0].pattern] for _ in models]
    for p in range(len(models[0].layers)):
        for j, (spec, blocks) in enumerate(zip(models[0].pattern,
                                               _blocks(models, p))):
            for i, (b, x) in enumerate(zip(blocks, xs)):
                h, st = _prefill_mixer(spec, b, _norm(cfg, b.norm1, x), cfg,
                                       max_seq, state_dtype)
                slots[i][j].append(st)
                xs[i] = x + h
            xs, _ = _cross_and_mlp(blocks, spec, xs, cfg, mems, False)
    logits = [_lm_head(m, _norm(cfg, m.final_norm, x))
              for m, x in zip(models, xs)]
    return logits, [tuple(map(_stacked, s)) for s in slots], mems


def lm_prefill(model: LM, tokens, *, max_seq: int, patch_embeds=None,
               enc_frames=None, state_dtype=torch.bfloat16):
    """Prompt prefill: the full forward that also builds the decode state.

    Returns (logits (B, S, padded_vocab), state, memory) — ``state`` laid
    out as :func:`init_decode_state` with every length S (each Mamba
    slot's conv tail and final scan state, each mLSTM's closed-form final
    state and conv tail, each sLSTM's last state; the caches and conv
    tails in ``state_dtype``, the reference's default bfloat16), and
    ``memory`` the enc-dec encoder's output (None for another family),
    which decode steps take for their cross-attention."""
    logits, states, mems = prefill_shards(
        [model], [dict(tokens=tokens, patch_embeds=patch_embeds,
                       enc_frames=enc_frames)], max_seq=max_seq,
        state_dtype=state_dtype)
    return logits[0], states[0], mems[0]


def _write(stacked: tuple, p: int, new: tuple) -> None:
    """Period p of a stacked NamedTuple state, overwritten in place."""
    for buf, value in zip(stacked, new):
        buf[p] = value


def _decode_mixer(spec: LayerSpec, block: Block, h, st: Dict, p: int,
                  cfg: ModelConfig, fused_position: bool, sharded_decode):
    """One block's mixer for one decode token, period p of the slot's
    stacked state ``st`` updated in place."""
    if spec.mixer == "attn":
        kv = st["kv"]
        h, new = attention_decode(
            block.attn, h, KVCache(kv.k[p], kv.v[p], kv.length[p]),
            cfg=cfg, fused_position=fused_position,
            sharded_decode=sharded_decode)
        kv.length[p] = new.length
    elif spec.mixer == "mamba":
        ms = st["mamba"]
        h, new = mamba_decode(block.mamba, h,
                              MambaState(ms.conv[p], ms.ssm[p]), cfg=cfg)
        _write(ms, p, new)
    elif spec.mixer == "mlstm":
        mls = st["mlstm"]
        h, new, tail = mlstm_decode(
            block.mlstm, h, MLSTMState(*(t[p] for t in mls)), cfg=cfg,
            conv_tail=st["conv_tail"][p].to(h.dtype))
        _write(mls, p, new)
        st["conv_tail"][p] = tail
    else:
        sls = st["slstm"]
        h, new = slstm_decode(block.slstm, h,
                              SLSTMState(*(t[p] for t in sls)), cfg=cfg)
        _write(sls, p, new)
    return h


def decode_shards(models: List[LM], tokens, states, *, memories=None,
                  fused_position: bool = True, sharded_decode=None):
    """:func:`lm_decode_step` over data shards: ``tokens[i]`` (B_i,) and
    ``states[i]`` on ``models[i]``'s device, ``sharded_decode[i]`` the
    split-K context of shard i (or None).  Returns the shards' logits;
    the states are updated in place."""
    cfg = models[0].cfg
    n = len(models)
    memories = memories or [None] * n
    sharded_decode = sharded_decode or [None] * n
    xs = [embedding_apply(m.embed, t[:, None])                    # (B,1,d)
          for m, t in zip(models, tokens)]
    for p in range(len(models[0].layers)):
        for j, (spec, blocks) in enumerate(zip(models[0].pattern,
                                               _blocks(models, p))):
            xs = [x + _decode_mixer(spec, b, _norm(cfg, b.norm1, x),
                                    st[j], p, cfg, fused_position, sd)
                  for b, x, st, sd in zip(blocks, xs, states,
                                          sharded_decode)]
            xs, _ = _cross_and_mlp(blocks, spec, xs, cfg, memories, True)
    return [_lm_head(m, _norm(cfg, m.final_norm, x))[:, 0]
            for m, x in zip(models, xs)]


def lm_decode_step(model: LM, token, state, *, memory=None,
                   fused_position: bool = True, sharded_decode=None):
    """One decode step.  token: (B,) int -> (logits (B, padded_vocab),
    state).  ``memory`` (B, L_enc, d) is the enc-dec encoder's output
    (from :func:`lm_prefill`); without it the decoder's cross-attention is
    skipped, as in the reference.  ``sharded_decode`` = (batch_axes,
    model_axis, mesh) runs every attention layer's split-K decode over
    the mesh (:func:`repro_torch.nn.attention.attention_decode`).

    The state is updated in place and returned: each attention layer
    writes its new key/value row into its slice of the stacked cache and
    advances its lengths, each recurrent layer overwrites its slice of its
    state (and conv tail).  Clone the state first to keep the old one."""
    logits = decode_shards([model], [token], [state], memories=[memory],
                           fused_position=fused_position,
                           sharded_decode=[sharded_decode])
    return logits[0], state
