"""The paper's edge-network world (§II): configuration and static draws.

State & symbols follow Table I: association graph Psi (one BS per service
area, 4x4 grid), C slotted uplink channels, per-BS capacity W_hat ~ U(1,3),
inference cost eps_n ~ U(1,4), inter-node transmission cost Y_hat
(distance-based), per-service quality curves Omega_s(k), per-UE thresholds
Qbar ~ U(0.1, 0.5).

Carried copy of the parts of ``repro.sim.env`` the serving engine and the
request traces read.  The simulator itself (``EdgeSimulator``) comes with
the RL slice.  Draw order is byte-identical to the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.sim.quality import synthetic_curves

IDLE = -1          # chain not running
PENDING = 0        # prompt uploaded, first block may start next frame (C6)


def draw_static_world(cfg: "SimConfig", rng: np.random.Generator,
                      quality: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Sample one environment's static world (Table II draws).

    The draw ORDER is part of the spec: every engine replays it to stay
    bit-identical with the reference simulator under the same seed.
    """
    n, u, s, b = cfg.num_bs, cfg.num_ues, cfg.num_services, cfg.max_blocks
    w_hat = rng.integers(cfg.capacity_low, cfg.capacity_high + 1, size=n)
    eps = rng.uniform(cfg.eps_low, cfg.eps_high, size=n)
    qbar = rng.uniform(cfg.qbar_low, cfg.qbar_high, size=u)
    service_of = rng.integers(0, s, size=u)                    # Lambda matrix
    omega = quality if quality is not None else synthetic_curves(s, b, rng)
    return {"w_hat": w_hat, "eps": eps, "qbar": qbar,
            "service_of": service_of, "omega": omega}


def grid_trans_cost(cfg: "SimConfig") -> np.ndarray:
    """Y_hat: grid Manhattan distance * unit cost; 0 on the diagonal.
    Deterministic in cfg — shared by every env instance."""
    n = cfg.num_bs
    gx, gy = np.divmod(np.arange(n), cfg.grid)
    return (np.abs(gx[:, None] - gx[None, :])
            + np.abs(gy[:, None] - gy[None, :])) * cfg.trans_cost_unit


@dataclasses.dataclass(frozen=True)
class SimConfig:
    grid: int = 4                      # 4x4 service areas (Table II)
    num_ues: int = 15                  # default UEs (Table II)
    num_channels: int = 2              # default channels (Table II)
    num_services: int = 3              # S (Table II)
    max_blocks: int = 4                # B (Table II)
    horizon: int = 40                  # frames per episode (Fig. 3 caption)
    capacity_low: int = 1              # W_hat ~ U(1,3)
    capacity_high: int = 3
    eps_low: float = 1.0               # eps_n ~ U(1,4)
    eps_high: float = 4.0
    qbar_low: float = 0.1              # Qbar ~ U(0.1, 0.5)
    qbar_high: float = 0.5
    alpha: float = 0.1                 # execution cost scale (Table II)
    beta: float = 0.1                  # transmission cost scale (Table II)
    trans_cost_unit: float = 0.2       # Y_hat per grid hop
    arrival_prob: float = 0.35         # new-request probability when idle
    side: float = 400.0                # area side (m); 4x4 of 100m cells
    speed: float = 10.0                # RWP speed (paper §IV)
    pause: float = 3.0                 # RWP pause (paper §IV)
    seed: int = 0

    @property
    def num_bs(self) -> int:
        return self.grid * self.grid
