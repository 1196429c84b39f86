"""Model configuration for the port.

A copy of the fields of ``repro.configs.base.ModelConfig`` that the DiT
reads, with the same defaults, derived properties and ``reduced()`` rule,
so a config built here equals the reference's field for field.  The port is
float32 throughout, so the reference's ``dtype`` and ``gdm_impl`` fields
have no counterpart: the dtype is fixed, and the kernel follows the
tensor's device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------
    name: str = "model"
    family: str = "dense"         # only "gdm" runs in the port so far
    # transformer core ----------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 256
    qkv_bias: bool = False
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
