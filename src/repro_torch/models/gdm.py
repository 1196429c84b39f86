"""The paper's GDM service: a DiT-style latent denoiser with B blocks.

Port of ``repro.models.gdm``.  A paper "block" (Table II: B = 4) is
``steps_per_block`` consecutive DDIM steps; the inter-block tensor (the
*latent* x_t that the placement engine ships between BSs, eq. C9) is the
(B, H*W, C) latent.  Quality Omega(k) is the SSIM proxy between the block-k
x0 estimate and the full-chain output (the paper's Fig. 1 protocol).

The DiT is an ``nn.Module`` whose module tree mirrors the reference's
parameter pytree (one :class:`DiTLayer` per entry of its stacked
``layers``), so :mod:`repro_torch.models.convert` carries weights across by
name.  Each layer runs the two hand-written kernels: ``adaln_norm`` twice
(plain, then with the gated-residual epilogue) and ``flash_attention`` once
(non-causal, no rope).  The matrix products stay ``@``, as the reference
leaves them to XLA.  Nothing here takes gradients (training waits for a
later slice).
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn import (Attention, Dense, Embedding, GeluMLP, LayerNorm,
                            attention_apply, dense_apply, embedding_apply,
                            gelu_mlp_apply, layernorm_apply)
from repro_torch.nn.linear import _param

LATENT_CHANNELS = 4
TIMESTEP_DIM = 256


# ---------------------------------------------------------------------------
# DiT denoiser
# ---------------------------------------------------------------------------

class DiTLayer(nn.Module):
    """One DiT block's parameters (the reference's ``layers[i]``)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm1 = LayerNorm(d, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = LayerNorm(d, device=device)
        self.mlp = GeluMLP(d, cfg.d_ff, num_layers=cfg.num_layers,
                           device=device)
        self.ada = Dense(d, 6 * d, device=device)   # adaLN-zero modulation

    def forward(self, x, cond):
        return _dit_layer(self, x, cond, self.cfg)


class DiT(nn.Module):
    """The denoiser: patch embedding, timestep + prompt conditioning,
    ``cfg.num_layers`` DiT blocks, final norm and patch projection."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.patch_in = Dense(LATENT_CHANNELS, d, device=device)
        self.pos = _param(1, cfg.latent_hw ** 2, d, device=device)
        self.t_embed = Dense(TIMESTEP_DIM, d, device=device)
        self.t_embed2 = Dense(d, d, device=device)
        self.prompt_embed = Embedding(cfg.vocab_size, d, device=device)
        self.final_norm = LayerNorm(d, device=device)
        self.patch_out = Dense(d, LATENT_CHANNELS, device=device)
        self.layers = nn.ModuleList(DiTLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter with the reference's distributions, in
        module order, from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        self.pos.normal_(0.0, 0.02, generator=generator)

    def forward(self, latent, t, prompt):
        return gdm_denoise(self, latent, t, prompt)


def init_gdm(cfg: ModelConfig, *, seed: int = 0, device=None) -> DiT:
    """A DiT with weights drawn from ``torch.Generator(device).manual_seed(
    seed)``.  The draws follow the reference's distributions, not its
    numbers: weights that must equal the reference's come through
    :func:`repro_torch.models.convert.dit_from_jax`."""
    device = resolve_device(device)
    model = DiT(cfg, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


@functools.lru_cache(maxsize=None)
def _timestep_freqs(half: int, device: torch.device):
    """Sinusoidal frequency table, made once per device from the same numpy
    expression as the reference's (float64, then float32)."""
    freqs = np.exp(-np.log(10_000.0) * np.arange(half, dtype=np.float32) / half)
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def _timestep_embedding(t, dim: int = TIMESTEP_DIM):
    """Sinusoidal timestep embedding.  t: (B,) number."""
    freqs = _timestep_freqs(dim // 2, t.device)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _dit_layer(layer: DiTLayer, x, cond, cfg: ModelConfig):
    """One DiT block on residual stream ``x`` (B, S, d).

    Norm + adaLN modulation run through the fused ``adaln_norm`` kernel:
    the attention sublayer's gated residual add is folded into the second
    norm's pass.  Attention runs through ``flash_attention`` (non-causal,
    no rope) via ``attention_apply``.
    """
    mods = dense_apply(layer.ada, F.silu(cond))
    sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
    h = ops.adaln_norm(x, sh1, sc1, layer.norm1.scale, layer.norm1.bias)
    h = attention_apply(layer.attn, h, cfg=cfg, causal=False, rope=False)
    h, x = ops.adaln_norm(h, sh2, sc2, layer.norm2.scale, layer.norm2.bias,
                          g1, x)
    h = gelu_mlp_apply(layer.mlp, h)
    return x + g2 * h


def gdm_denoise(model: DiT, latent, t, prompt):
    """Predict noise eps for latent x_t.

    latent: (B, H*W, C) float32; t: (B,) int; prompt: (B, P) int token ids.
    Returns eps with the latent's shape.
    """
    x = dense_apply(model.patch_in, latent) + model.pos.to(latent.dtype)
    temb = dense_apply(model.t_embed, _timestep_embedding(t).to(x.dtype))
    temb = dense_apply(model.t_embed2, F.silu(temb))
    pemb = embedding_apply(model.prompt_embed, prompt).mean(dim=1)
    cond = (temb + pemb.to(temb.dtype))[:, None]             # (B, 1, d)
    for layer in model.layers:
        x = layer(x, cond)
    x = layernorm_apply(model.final_norm, x)
    return dense_apply(model.patch_out, x)


# ---------------------------------------------------------------------------
# Diffusion schedule + sampling in blocks
# ---------------------------------------------------------------------------

def make_schedule(num_steps: int, beta_min: float = 1e-4,
                  beta_max: float = 0.02, *, device=None) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    betas = torch.linspace(beta_min, beta_max, num_steps, dtype=torch.float32,
                           device=device)
    alphas = 1.0 - betas
    alpha_bar = torch.cumprod(alphas, dim=0)
    return {"betas": betas, "alphas": alphas, "alpha_bar": alpha_bar}


def _ddim_update(latent, eps, ab_t, ab_prev):
    """The DDIM posterior update given the gathered schedule terms."""
    x0 = (latent - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    return torch.sqrt(ab_prev) * x0 + torch.sqrt(1 - ab_prev) * eps, x0


def _ab_prev(ab, t):
    return torch.where(t > 0, ab[(t - 1).clamp(min=0)],
                       torch.ones((), dtype=ab.dtype, device=ab.device))


def ddim_step(model: DiT, latent, step_idx, prompt, schedule, *,
              total_steps: int):
    """One deterministic DDIM step from t=step_idx to step_idx-1.

    ``step_idx`` may be a scalar (whole batch at the same step) or a
    per-sample ``(B,)`` int vector (each latent at its own chain position).
    """
    del total_steps                        # kept for the reference's signature
    t = torch.as_tensor(step_idx, device=latent.device).long().expand(
        latent.shape[0])
    eps = gdm_denoise(model, latent, t, prompt)
    ab = schedule["alpha_bar"]
    return _ddim_update(latent, eps, ab[t][:, None, None],
                        _ab_prev(ab, t)[:, None, None])


def run_block_batched(model: DiT, latent, prompt, schedule, block_idx, *,
                      steps_per_block: int, total_steps: int):
    """Advance each sample of a mixed batch through ITS OWN block.

    ``block_idx``: (B,) int — sample b executes block ``block_idx[b]``
    (``steps_per_block`` DDIM steps starting at that block's position in the
    chain).  This is the serving engine's per-(node, quantum) execution
    unit.  Returns (latent after the block, current x0 estimate).  The
    (steps_per_block, B) schedule slice is gathered once per call.
    """
    dev = latent.device
    block_idx = torch.as_tensor(block_idx, device=dev).long()
    start = total_steps - 1 - block_idx * steps_per_block
    t_all = start[None, :] - torch.arange(steps_per_block, device=dev)[:, None]
    ab = schedule["alpha_bar"]
    ab_t_all = ab[t_all]                                    # (spb, B)
    ab_prev_all = _ab_prev(ab, t_all)
    lat, x0 = latent, torch.zeros_like(latent)
    for i in range(steps_per_block):
        eps = gdm_denoise(model, lat, t_all[i], prompt)
        lat, x0 = _ddim_update(lat, eps, ab_t_all[i][:, None, None],
                               ab_prev_all[i][:, None, None])
    return lat, x0


def run_block(model: DiT, latent, prompt, schedule, *, block_idx: int,
              steps_per_block: int, total_steps: int):
    """Execute denoising block k (the paper's per-frame execution unit).

    Blocks count down the chain: block 0 covers steps [T-1 .. T-spb], etc.
    Returns (latent after the block, current x0 estimate).
    """
    idx = torch.full((latent.shape[0],), block_idx, dtype=torch.long,
                     device=latent.device)
    return run_block_batched(model, latent, prompt, schedule, idx,
                             steps_per_block=steps_per_block,
                             total_steps=total_steps)


def sample_chain(model: DiT, latent, prompt, *, num_blocks: int,
                 steps_per_block: int = 4) -> List[torch.Tensor]:
    """Full chain of B blocks from the given noise ``latent`` (P, H*W, C);
    returns the list of per-block x0 estimates."""
    total = num_blocks * steps_per_block
    schedule = make_schedule(total, device=latent.device)
    outs = []
    for b in range(num_blocks):
        latent, x0 = run_block(model, latent, prompt, schedule, block_idx=b,
                               steps_per_block=steps_per_block,
                               total_steps=total)
        outs.append(x0)
    return outs


# ---------------------------------------------------------------------------
# Quality Omega(k): SSIM proxy (paper Fig. 1 protocol)
# ---------------------------------------------------------------------------

def ssim_proxy(a, b, *, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Global-statistics SSIM between two latents (per-sample mean)."""
    dims = tuple(range(1, a.dim()))
    bshape = (-1,) + (1,) * (a.dim() - 1)
    mu_a = a.mean(dim=dims)
    mu_b = b.mean(dim=dims)
    var_a = a.var(dim=dims, correction=0)
    var_b = b.var(dim=dims, correction=0)
    cov = ((a - mu_a.reshape(bshape)) * (b - mu_b.reshape(bshape))).mean(dim=dims)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return num / den


def quality_per_block(model: DiT, latent, prompt, *, num_blocks: int,
                      steps_per_block: int = 4) -> torch.Tensor:
    """Omega(k) for k = 1..B: SSIM of the block-k x0 estimate vs the final
    output, averaged over the prompts.  ``latent`` is the initial noise
    (P, H*W, C) and ``prompt`` the (P, L) token ids, both given so that two
    implementations can be fed the same draws."""
    outs = sample_chain(model, latent, prompt, num_blocks=num_blocks,
                        steps_per_block=steps_per_block)
    final = outs[-1]
    return torch.stack([ssim_proxy(o, final).clamp(0.0, 1.0).mean()
                        for o in outs])
