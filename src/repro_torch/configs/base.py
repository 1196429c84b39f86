"""Model and input-shape configuration for the port.

A copy of the fields of ``repro.configs.base.ModelConfig`` with the same
defaults, derived properties and ``reduced()`` rule, so a config built here
equals the reference's field for field; ``MambaConfig``, ``XLSTMConfig``,
``ShapeConfig`` (with the four assigned shapes in ``SHAPES``),
``MeshConfig`` (with ``SINGLE_POD`` / ``MULTI_POD``) and ``TrainConfig``
are copies too.  The port is float32 throughout, so the
reference's ``dtype`` and ``gdm_impl`` fields have no counterpart: the
dtype is fixed, and the kernel follows the tensor's device.
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
