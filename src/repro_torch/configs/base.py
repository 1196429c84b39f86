"""Model and input-shape configuration for the port.

A copy of the fields of ``repro.configs.base.ModelConfig`` with the same
defaults, derived properties and ``reduced()`` rule, so a config built here
equals the reference's field for field; ``MambaConfig``, ``XLSTMConfig``,
``ShapeConfig`` (with the four assigned shapes in ``SHAPES``),
``MeshConfig`` (with ``SINGLE_POD`` / ``MULTI_POD``), ``TrainConfig`` and
``ServeConfig`` are copies too, and so is the reference's parameter-count
formula (``param_count`` / ``active_param_count``, which the dry run's
MODEL_FLOPS read).  ``dtype`` is carried as the reference's
(``"bfloat16"``; ``reduced()`` sets ``"float32"``) and, as there, nothing
reads it: a model's dtype is its constructor's (``LM(dtype=)``), a
state's its step's (``state_dtype``).  The reference's ``gdm_impl`` has
no counterpart: the kernel follows the tensor's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MambaConfig:
    """Selective-SSM (Mamba) block hyper-parameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix: ratio of mLSTM to sLSTM blocks (paper: 7:1)."""
    slstm_every: int = 8          # one sLSTM block every N blocks
    proj_factor: float = 2.0      # mLSTM up-projection factor
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------
    name: str = "model"
    family: str = "dense"         # dense | moe | hybrid | ssm | vlm | audio | gdm
    # transformer core ----------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 256
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # MoE ----------------------------------------------------------------
    num_experts: int = 0          # 0 -> dense MLP
    experts_per_token: int = 0
    moe_d_ff: int = 0             # per-expert hidden (0 -> d_ff)
    moe_every: int = 1            # MoE layer every N layers (jamba: 2)
    moe_capacity_factor: float = 1.25  # GShard-style capacity (drops overflow)
    # hybrid (jamba) -------------------------------------------------------
    attn_every: int = 1           # attention layer every N layers (jamba: 8)
    mamba: Optional[MambaConfig] = None
    # ssm (xlstm) ----------------------------------------------------------
    xlstm: Optional[XLSTMConfig] = None
    # encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0       # >0 -> encoder-decoder model
    cross_attention: bool = False
    encoder_seq_len: int = 0      # stub modality memory length
    # multimodal stubs -----------------------------------------------------
    num_patch_tokens: int = 0     # vlm: precomputed patch embeddings prepended
    frontend: str = "none"        # none | audio_frames | image_patches
    # numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    # long context ---------------------------------------------------------
    attention_window: int = 0     # 0 -> full attention; >0 sliding window
    subquadratic: bool = False    # True for ssm/hybrid (eligible for long_500k)
    # GDM service ----------------------------------------------------------
    gdm_blocks: int = 0           # B in the paper; >0 marks a GDM service
    latent_hw: int = 0            # latent spatial size (patch grid)

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded to a multiple of ``multiple`` (the reference pads
        for even sharding; the port keeps the shapes)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    # -- parameter counting (used for roofline MODEL_FLOPS = 6*N*D) --------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    # -- reduced smoke-test variant -----------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's rule)."""
        kw: Dict = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers,
                           4 if self.family in ("hybrid", "ssm") else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            dtype="float32",
        )
        if self.is_moe:
            # generous capacity: tiny batches must not drop tokens
            kw.update(num_experts=4, experts_per_token=2, moe_d_ff=64,
                      moe_capacity_factor=8.0)
        if self.family == "hybrid":
            kw.update(num_layers=8, attn_every=min(self.attn_every, 8),
                      moe_every=self.moe_every,
                      mamba=MambaConfig(d_state=8, d_conv=4, expand=2))
        if self.family == "ssm" and self.xlstm is not None:
            kw.update(num_layers=4, d_ff=0, xlstm=XLSTMConfig(slstm_every=2))
        if self.is_encdec:
            kw.update(encoder_layers=2, cross_attention=True,
                      encoder_seq_len=16)
        if self.num_patch_tokens:
            kw.update(num_patch_tokens=8)
        if self.gdm_blocks:
            kw.update(gdm_blocks=min(self.gdm_blocks, 4), latent_hw=4)
        return replace(self, **kw)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Approximate parameter count (embedding + per-layer weights).

    The reference's formula, copied: it is not the count of the built
    model (seamless-m4t-large-v2 2.035 B here, 1.634 B as built;
    xlstm-1.3b 2.02 B, 3.581 B as built, its mLSTM q, k, v counted
    block-diagonal)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n = 0
    n += cfg.vocab_size * d                     # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d                 # lm head
    def attn_params() -> int:
        qkv = d * cfg.q_dim + 2 * d * cfg.kv_dim
        if cfg.qkv_bias:
            qkv += cfg.q_dim + 2 * cfg.kv_dim
        return qkv + cfg.q_dim * d
    def dense_mlp() -> int:
        return 3 * d * cfg.d_ff if cfg.d_ff else 0
    def moe_mlp() -> int:
        dff = cfg.moe_d_ff or cfg.d_ff
        e = cfg.experts_per_token if active_only else cfg.num_experts
        return e * 3 * d * dff + d * cfg.num_experts   # experts + router
    def mamba_params() -> int:
        mc = cfg.mamba or MambaConfig()
        d_in = mc.expand * d
        dt_rank = mc.resolved_dt_rank(d)
        return (d * 2 * d_in + d_in * mc.d_conv + d_in * (dt_rank + 2 * mc.d_state)
                + dt_rank * d_in + d_in * mc.d_state + d_in + d_in * d)
    def xlstm_params() -> int:
        xc = cfg.xlstm or XLSTMConfig()
        d_in = int(xc.proj_factor * d)
        # mLSTM: up/gate/down proj + qkv + gates
        return 2 * d * d_in + d_in * d + 3 * d_in * d_in // max(cfg.num_heads, 1) + 4 * d_in
    for layer in range(cfg.num_layers):
        if cfg.family == "ssm" and cfg.xlstm is not None:
            n += xlstm_params() + 2 * d
            continue
        is_attn = (layer % cfg.attn_every == 0) if cfg.attn_every > 1 else True
        if cfg.family == "hybrid" and not is_attn:
            n += mamba_params()
        else:
            n += attn_params()
        if cfg.is_moe and (layer % cfg.moe_every == (cfg.moe_every - 1) or cfg.moe_every == 1):
            n += moe_mlp()
        else:
            n += dense_mlp()
        n += 2 * d                               # norms
    for _ in range(cfg.encoder_layers):
        n += attn_params() + dense_mlp() + 2 * d
        if cfg.cross_attention:
            n += attn_params() + d               # decoder cross-attn counted here
    return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                     # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "long_decode", 524_288, 1)

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def tp(self) -> int:
        return self.shape[self.axes.index("model")] if "model" in self.axes else 1

    @property
    def dp(self) -> int:
        d = self.shape[self.axes.index("data")] if "data" in self.axes else 1
        if "pod" in self.axes:
            d *= self.shape[self.axes.index("pod")]
        return d


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatch: int = 0           # 0 -> no gradient accumulation
    remat: bool = True
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 2_048
    page_size: int = 128
    early_exit_quality: float = 0.0   # >0 -> adaptive chain-length reduction
    seed: int = 0
