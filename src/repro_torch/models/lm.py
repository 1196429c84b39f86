"""The dense LM of the edge launcher's decode service.

Port of the dense family of ``repro.models.lm``: token embedding, L
pre-norm blocks (RMSNorm, GQA attention with RoPE, RMSNorm, SwiGLU), a final
RMSNorm and an untied (or tied) head whose padded-vocab columns are -1e9.
The reference expresses depth as a periodic layer pattern with
period-stacked parameters; the port keeps that structure by name —
``layers.{p}.{j}`` is slot j of period p, the reference's
``params["layers"][j]`` at index p — so :mod:`repro_torch.models.convert`
carries weights across and later families fit the same tree.

Every norm runs the ``rmsnorm`` kernel (2L + 1 launches a decode step);
decode attention runs ``decode_attention`` (L launches a step), prefill and
the full forward ``flash_attention`` (causal, rope).  The decode state keeps
the reference's stacked layout, one entry per pattern slot:
``{"kv": KVCache(k, v, length)}`` with k, v (P, B, S, KH, D) float32 and
length (P, B) int32, so a request's payload has the reference's bytes.
The MoE, hybrid (Mamba), xLSTM and enc-dec families, and ``lm_loss``, wait
for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.nn import (Attention, Dense, Embedding, RMSNorm, SwiGLU,
                            dense_apply, embedding_apply, embedding_attend,
                            rmsnorm_apply, swiglu_apply)
from repro_torch.nn.attention import (KVCache, attention_apply,
                                      attention_decode, prefill_kv_cache)

PAD_LOGIT = -1e9          # logits of the padded-vocab columns


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn (mamba | mlstm | slstm in later slices)
    mlp: str            # swiglu (moe | gelu | none in later slices)


def layer_pattern(cfg: ModelConfig) -> List[LayerSpec]:
    """The repeating per-period layer pattern for ``cfg`` (dense: one
    attention + SwiGLU sub-layer per period)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the hybrid (Jamba) "
            "family is the next slice (ROADMAP Queue 2 item 4); MoE, xLSTM "
            "and enc-dec follow (ROADMAP Queue 1 item 12)")
    return [LayerSpec("attn", "swiglu")]


class Block(nn.Module):
    """One attention + SwiGLU sub-layer's parameters (the reference's
    ``layers[j]`` at one period)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, num_layers=cfg.num_layers,
                          device=device)


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
            nn.ModuleList(Block(cfg, device=device) for _ in pattern)
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


def _mlp(block: Block, x, cfg: ModelConfig):
    return x + swiglu_apply(block.mlp, rmsnorm_apply(block.norm2, x,
                                                     eps=cfg.norm_eps))


def lm_forward(model: LM, tokens):
    """Full-sequence forward.  tokens: (B, S) int -> logits (B, S,
    padded_vocab).  (The reference also returns the MoE load-balancing
    loss, which the dense family does not have.)"""
    cfg = model.cfg
    x = embedding_apply(model.embed, tokens)
    for period in model.layers:
        for block in period:
            h = rmsnorm_apply(block.norm1, x, eps=cfg.norm_eps)
            x = x + attention_apply(block.attn, h, cfg=cfg)
            x = _mlp(block, x, cfg)
    x = rmsnorm_apply(model.final_norm, x, eps=cfg.norm_eps)
    return _lm_head(model, x)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None) -> Tuple[Dict[str, KVCache], ...]:
    """Stacked (num_periods, ...) float32 decode state, one entry per
    pattern slot, every length 0."""
    device = resolve_device(device)
    n_periods = cfg.num_layers // len(layer_pattern(cfg))
    shape = (n_periods, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return tuple(
        {"kv": KVCache(torch.zeros(shape, device=device),
                       torch.zeros(shape, device=device),
                       torch.zeros((n_periods, batch), dtype=torch.int32,
                                   device=device))}
        for _ in layer_pattern(cfg))


def lm_prefill(model: LM, tokens, *, max_seq: int):
    """Prompt prefill: the full forward that also builds the decode state.

    Returns (logits (B, S, padded_vocab), state) — ``state`` laid out as
    :func:`init_decode_state` with every length S, so decode continues
    from it."""
    cfg = model.cfg
    x = embedding_apply(model.embed, tokens)
    caches: List[List[KVCache]] = [[] for _ in model.pattern]
    for period in model.layers:
        for j, block in enumerate(period):
            h = rmsnorm_apply(block.norm1, x, eps=cfg.norm_eps)
            caches[j].append(prefill_kv_cache(block.attn, h, cfg=cfg,
                                              max_seq=max_seq))
            x = x + attention_apply(block.attn, h, cfg=cfg)
            x = _mlp(block, x, cfg)
    x = rmsnorm_apply(model.final_norm, x, eps=cfg.norm_eps)
    state = tuple({"kv": KVCache(*(torch.stack(t) for t in zip(*slot)))}
                  for slot in caches)
    return _lm_head(model, x), state


def lm_decode_step(model: LM, token, state, *, fused_position: bool = True):
    """One decode step.  token: (B,) int -> (logits (B, padded_vocab),
    state).

    The state is updated in place and returned: each layer writes its new
    key/value row into its slice of the stacked cache and advances its
    lengths.  Clone the state first to keep the old one."""
    cfg = model.cfg
    x = embedding_apply(model.embed, token[:, None])               # (B,1,d)
    for p, period in enumerate(model.layers):
        for j, block in enumerate(period):
            kv = state[j]["kv"]
            h = rmsnorm_apply(block.norm1, x, eps=cfg.norm_eps)
            h, new = attention_decode(
                block.attn, h, KVCache(kv.k[p], kv.v[p], kv.length[p]),
                cfg=cfg, fused_position=fused_position)
            kv.length[p] = new.length
            x = _mlp(block, x + h, cfg)
    x = rmsnorm_apply(model.final_norm, x, eps=cfg.norm_eps)
    return _lm_head(model, x)[:, 0], state
