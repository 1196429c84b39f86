"""Per-service quality curves Omega_s(k) (paper Fig. 1 / C7).

Carried copy of ``repro.sim.quality.synthetic_curves`` (the world draw
consumes it).  Curves measured from the DiT come from
:func:`repro_torch.models.gdm.quality_per_block` through
:class:`repro_torch.serving.gdm_service.GDMService`.
"""
from __future__ import annotations

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
