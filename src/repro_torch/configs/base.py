"""Model configuration for the port.

A copy of the fields of ``repro.configs.base.ModelConfig`` that the DiT and
the dense LM read, with the same defaults, derived properties and
``reduced()`` rule, so a config built here equals the reference's field for
field.  The port is float32 throughout, so the reference's ``dtype`` and
``gdm_impl`` fields have no counterpart: the dtype is fixed, and the kernel
follows the tensor's device.  The MoE, hybrid, SSM and enc-dec fields come
with the slices that port those families.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------
    name: str = "model"
    family: str = "dense"         # "dense" (LM) and "gdm" run in the port
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
    # long context ---------------------------------------------------------
    attention_window: int = 0     # 0 -> full attention; >0 sliding window
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

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded to a multiple of ``multiple`` (the reference pads
        for even sharding; the port keeps the shapes)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    # -- reduced smoke-test variant -----------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's rule for
        a dense or GDM config)."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
        )
        if self.gdm_blocks:
            kw.update(gdm_blocks=min(self.gdm_blocks, 4), latent_hw=4)
        return replace(self, **kw)
