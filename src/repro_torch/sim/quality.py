"""Per-service quality curves Omega_s(k) (paper Fig. 1 / C7).

Two sources, as in ``repro.sim.quality``:
  * synthetic concave curves (a carried copy of ``synthetic_curves``; the
    world draw consumes it);
  * measured from the DiT denoiser (``from_gdm_model``): SSIM-vs-final per
    block (:func:`repro_torch.models.gdm.quality_per_block`), one reduced
    ``gdm-dit`` per service.  :class:`repro_torch.serving.gdm_service.
    GDMService` measures its own Omega the same way.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def synthetic_curves(num_services: int, max_blocks: int,
                     rng: np.random.Generator) -> np.ndarray:
    """(S, B+1) array; row s is Omega_s(0..B), Omega_s(0) = 0, concave up to 1."""
    gammas = rng.uniform(0.45, 1.1, size=num_services)
    scale = rng.uniform(0.8, 1.0, size=num_services)
    k = np.arange(max_blocks + 1, dtype=float)
    curves = scale[:, None] * (k[None, :] / max_blocks) ** gammas[:, None]
    curves[:, 0] = 0.0
    return np.minimum(curves, 1.0)


def from_gdm_model(num_services: int, max_blocks: int, *, seed: int = 0,
                   steps_per_block: int = 2, device=None,
                   models: Optional[Sequence] = None,
                   prompts: Optional[Sequence] = None,
                   noise: Optional[Sequence] = None) -> np.ndarray:
    """Measure Omega from the reduced DiT denoiser (one model per service),
    on ``device`` (the card unless given).

    Service s draws its weights with ``init_gdm(cfg, seed=seed + s)`` and
    its 4 prompts of 8 tokens in [0, vocab) and the chain's starting noise
    from a ``torch.Generator`` seeded ``seed + s`` on the device, prompts
    first.  ``models``, ``prompts`` and ``noise`` (one entry per service)
    replace those draws, so a comparison can run the reference's weights
    and ``jax.random`` draws.  Returns the (S, B+1) curves, Omega_s(0) = 0
    and each row forced monotone by a running max.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.gdm import (LATENT_CHANNELS, init_gdm,
                                        quality_per_block)

    device = resolve_device(device)
    cfg = get_config("gdm-dit").reduced()
    curves = np.zeros((num_services, max_blocks + 1))
    for s in range(num_services):
        gen = torch.Generator(device=device).manual_seed(seed + s)
        model = (models[s] if models is not None
                 else init_gdm(cfg, seed=seed + s, device=device))
        prompt = (torch.as_tensor(prompts[s], device=device)
                  if prompts is not None else
                  torch.randint(0, cfg.vocab_size, (4, 8), generator=gen,
                                device=device))
        latent = (torch.as_tensor(noise[s], device=device)
                  if noise is not None else
                  torch.randn((prompt.shape[0], cfg.latent_hw ** 2,
                               LATENT_CHANNELS), generator=gen,
                              device=device))
        with torch.no_grad():
            q = quality_per_block(model, latent, prompt,
                                  num_blocks=max_blocks,
                                  steps_per_block=steps_per_block)
        # enforce monotone (measured SSIM is monotone in expectation only)
        curves[s, 1:] = np.maximum.accumulate(
            np.clip(q.cpu().numpy(), 0.0, 1.0))
    return curves
