"""The LM stack of the edge launcher and the trainer: the dense, the MoE
and the hybrid (Jamba) families.

Port of ``repro.models.lm``: token embedding, periods of pre-norm blocks
(RMSNorm, a mixer, RMSNorm, an MLP), a final RMSNorm and an untied (or
tied) head whose padded-vocab columns are -1e9.  The mixer is GQA
attention with RoPE (dense and MoE: every block; hybrid: the first block
of each period of ``attn_every``) or a Mamba selective-SSM block (the
others).  The MLP is SwiGLU, or a mixture of SwiGLU experts
(:mod:`repro_torch.nn.moe`) in every block of the MoE family and in every
``moe_every``-th block of a hybrid with experts; ``lm_forward`` sums their
load-balancing losses.
The reference expresses depth as a periodic layer pattern with
period-stacked parameters; the port keeps that structure by name —
``layers.{p}.{j}`` is slot j of period p, the reference's
``params["layers"][j]`` at index p — so :mod:`repro_torch.models.convert`
carries weights across.

Every norm runs the ``rmsnorm`` kernel (2L + 1 launches a forward or a
decode step), every Mamba block the ``ssm_scan`` kernel on a full
sequence (training and prefill; its backward kernel in training);
decode attention runs ``decode_attention``, prefill and the full forward
``flash_attention`` (causal, rope).  The decode state keeps the
reference's stacked layout, one entry per pattern slot:
``{"kv": KVCache(k, v, length)}`` with k, v (P, B, S, KH, D) float32 and
length (P, B) int32, or ``{"mamba": MambaState(conv, ssm)}`` with conv
(P, B, K-1, d_in) and ssm (P, B, d_in, N) float32, so a request's payload
has the reference's bytes.  The xLSTM (``ssm``) and enc-dec families
wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.nn import (Attention, Dense, Embedding, Mamba, MambaState,
                            RMSNorm, SwiGLU, dense_apply, embedding_apply,
                            embedding_attend, mamba_apply, mamba_decode,
                            mamba_init_state, rmsnorm_apply, swiglu_apply)
from repro_torch.nn.attention import (KVCache, attention_apply,
                                      attention_decode, prefill_kv_cache)
from repro_torch.nn.moe import MoE, moe_apply

PAD_LOGIT = -1e9          # logits of the padded-vocab columns


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn | mamba (mlstm | slstm in later slices)
    mlp: str            # swiglu | moe (gelu | none in later slices)


def layer_pattern(cfg: ModelConfig) -> List[LayerSpec]:
    """The repeating per-period layer pattern for ``cfg``: one attention
    sub-layer with SwiGLU (dense) or experts (MoE, or dense with experts),
    or ``attn_every`` sub-layers, attention first and Mamba after, with
    experts on every ``moe_every``-th (hybrid)."""
    if cfg.family == "hybrid":
        specs = [LayerSpec("attn" if j == 0 else "mamba",
                           "moe" if cfg.is_moe and j % cfg.moe_every
                           == cfg.moe_every - 1 else "swiglu")
                 for j in range(cfg.attn_every)]
    elif cfg.family in ("dense", "moe"):
        specs = [LayerSpec("attn", "moe" if cfg.is_moe else "swiglu")]
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: xLSTM and enc-dec "
            "follow (ROADMAP Queue 1 item 12)")
    return specs


class Block(nn.Module):
    """One sub-layer's parameters (the reference's ``layers[j]`` at one
    period): ``norm1``, the mixer (``attn`` or ``mamba``), ``norm2`` and
    ``mlp`` (SwiGLU) or ``moe`` (experts)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if spec.mixer == "attn":
            self.attn = Attention(cfg, device=device)
        else:
            self.mamba = Mamba(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        if spec.mlp == "moe":
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff,
                              num_layers=cfg.num_layers, device=device)


class LM(nn.Module):
    """Embedding, ``num_layers / period`` periods of blocks, final norm
    and (unless tied) the head."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        pattern = layer_pattern(cfg)
        if cfg.num_layers % len(pattern):
            raise ValueError(f"{cfg.num_layers} layers do not make whole "
                             f"periods of {len(pattern)}")
        self.cfg = cfg
        self.pattern = pattern
        vpad = cfg.padded_vocab()
        self.embed = Embedding(vpad, cfg.d_model, device=device)
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.layers = nn.ModuleList(
            nn.ModuleList(Block(cfg, spec, device=device) for spec in pattern)
            for _ in range(cfg.num_layers // len(pattern)))
        if cfg.tie_embeddings:
            self.register_module("head", None)
        else:
            self.head = Dense(cfg.d_model, vpad, stddev=cfg.d_model ** -0.5,
                              device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter with the reference's distributions, in
        module order, from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def reference_leaf(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The path of a parameter's leaf in the reference's params tree and
    the parameter's index on that leaf's stacked period axis (None outside
    ``layers``): the port's ``layers.{p}.{j}.<rest>`` is the reference's
    ``params["layers"][j][<rest>][p]``."""
    parts = tuple(name.split("."))
    if parts[0] == "layers":
        return ("layers", parts[2]) + parts[3:], int(parts[1])
    return parts, None


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """An LM with weights drawn from ``torch.Generator(device).manual_seed(
    seed)``.  The draws follow the reference's distributions, not its
    numbers: weights that must equal the reference's come through
    :func:`repro_torch.models.convert.lm_from_jax`."""
    device = resolve_device(device)
    model = LM(cfg, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


def _lm_head(model: LM, x):
    cfg = model.cfg
    if cfg.tie_embeddings:
        logits = embedding_attend(model.embed, x)
    else:
        logits = dense_apply(model.head, x)
    if cfg.padded_vocab() != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = PAD_LOGIT
    return logits


def _mlp(block: Block, spec: LayerSpec, x, cfg: ModelConfig):
    """``x`` plus the sub-layer's MLP of its norm, and the MoE's
    load-balancing loss (None for SwiGLU)."""
    h = rmsnorm_apply(block.norm2, x, eps=cfg.norm_eps)
    if spec.mlp == "moe":
        h, aux = moe_apply(block.moe, h)
        return x + h, aux
    return x + swiglu_apply(block.mlp, h), None


def lm_forward(model: LM, tokens):
    """Full-sequence forward.  tokens: (B, S) int -> (logits (B, S,
    padded_vocab), aux), aux the float32 sum of the MoE layers'
    load-balancing losses (zero without experts)."""
    cfg = model.cfg
    x = embedding_apply(model.embed, tokens)
    aux = torch.zeros((), device=x.device)
    for period in model.layers:
        for spec, block in zip(model.pattern, period):
            h = rmsnorm_apply(block.norm1, x, eps=cfg.norm_eps)
            if spec.mixer == "attn":
                h = attention_apply(block.attn, h, cfg=cfg)
            else:
                h = mamba_apply(block.mamba, h, cfg=cfg)
            x, a = _mlp(block, spec, x + h, cfg)
            if a is not None:
                aux = aux + a
    x = rmsnorm_apply(model.final_norm, x, eps=cfg.norm_eps)
    return _lm_head(model, x), aux


def lm_loss(model: LM, batch, *, aux_weight: float = 0.01,
            loss_chunk: int = 0):
    """Causal LM cross-entropy + MoE aux loss, as the reference's
    ``lm_loss``.  batch: {"tokens", "labels"} (B, S) int.  Log-softmax in
    float32 over the padded vocab (its columns at -1e9).

    ``loss_chunk`` > 0 (and dividing S) sums the log-likelihood chunk by
    chunk along the sequence, never holding the whole (B, S, V)
    log-softmax.  Returns (total, {"loss", "aux", "perplexity"})."""
    logits, aux = lm_forward(model, batch["tokens"])
    labels = batch["labels"].long()
    b, s = labels.shape
    if loss_chunk and s % loss_chunk == 0:
        total_ll = torch.zeros((), device=logits.device)
        for c in range(0, s, loss_chunk):
            logp = torch.log_softmax(logits[:, c:c + loss_chunk].float(),
                                     dim=-1)
            ll = logp.gather(-1, labels[:, c:c + loss_chunk, None])[..., 0]
            total_ll = total_ll + ll.sum()
        loss = -total_ll / (b * s)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(-1, labels[..., None])[..., 0].mean()
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux,
                   "perplexity": torch.exp(loss.clamp(max=20.0))}


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None) -> Tuple[Dict, ...]:
    """Stacked (num_periods, ...) float32 decode state, one entry per
    pattern slot: an empty KV cache (every length 0) for attention, zero
    conv tail and SSM state for Mamba."""
    device = resolve_device(device)
    pattern = layer_pattern(cfg)
    n_periods = cfg.num_layers // len(pattern)
    state = []
    for spec in pattern:
        if spec.mixer == "attn":
            shape = (n_periods, batch, max_seq, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            state.append({"kv": KVCache(
                torch.zeros(shape, device=device),
                torch.zeros(shape, device=device),
                torch.zeros((n_periods, batch), dtype=torch.int32,
                            device=device))})
        else:
            state.append({"mamba": MambaState(*(
                torch.stack([t] * n_periods)
                for t in mamba_init_state(cfg, batch, device=device)))})
    return tuple(state)


def lm_prefill(model: LM, tokens, *, max_seq: int):
    """Prompt prefill: the full forward that also builds the decode state.

    Returns (logits (B, S, padded_vocab), state) — ``state`` laid out as
    :func:`init_decode_state` with every length S (and each Mamba slot's
    conv tail and final scan state), so decode continues from it."""
    cfg = model.cfg
    x = embedding_apply(model.embed, tokens)
    slots: List[list] = [[] for _ in model.pattern]
    for period in model.layers:
        for j, (spec, block) in enumerate(zip(model.pattern, period)):
            h = rmsnorm_apply(block.norm1, x, eps=cfg.norm_eps)
            if spec.mixer == "attn":
                slots[j].append(prefill_kv_cache(block.attn, h, cfg=cfg,
                                                 max_seq=max_seq))
                h = attention_apply(block.attn, h, cfg=cfg)
            else:
                h, ms = mamba_apply(block.mamba, h, cfg=cfg,
                                    return_state=True)
                slots[j].append(ms)
            x, _ = _mlp(block, spec, x + h, cfg)
    x = rmsnorm_apply(model.final_norm, x, eps=cfg.norm_eps)
    state = tuple(
        {"kv": KVCache(*(torch.stack(t) for t in zip(*slot)))}
        if spec.mixer == "attn" else
        {"mamba": MambaState(*(torch.stack(t) for t in zip(*slot)))}
        for spec, slot in zip(model.pattern, slots))
    return _lm_head(model, x), state


def lm_decode_step(model: LM, token, state, *, fused_position: bool = True):
    """One decode step.  token: (B,) int -> (logits (B, padded_vocab),
    state).

    The state is updated in place and returned: each attention layer
    writes its new key/value row into its slice of the stacked cache and
    advances its lengths, each Mamba layer overwrites its slice of the conv
    tail and SSM state.  Clone the state first to keep the old one."""
    cfg = model.cfg
    x = embedding_apply(model.embed, token[:, None])               # (B,1,d)
    for p, period in enumerate(model.layers):
        for j, (spec, block) in enumerate(zip(model.pattern, period)):
            h = rmsnorm_apply(block.norm1, x, eps=cfg.norm_eps)
            if spec.mixer == "attn":
                kv = state[j]["kv"]
                h, new = attention_decode(
                    block.attn, h, KVCache(kv.k[p], kv.v[p], kv.length[p]),
                    cfg=cfg, fused_position=fused_position)
                kv.length[p] = new.length
            else:
                ms = state[j]["mamba"]
                h, new = mamba_decode(block.mamba, h,
                                      MambaState(ms.conv[p], ms.ssm[p]),
                                      cfg=cfg)
                ms.conv[p] = new.conv
                ms.ssm[p] = new.ssm
            x, _ = _mlp(block, spec, x + h, cfg)
    x = rmsnorm_apply(model.final_norm, x, eps=cfg.norm_eps)
    return _lm_head(model, x)[:, 0], state
