"""Random Waypoint mobility over the paper's grid of service areas (§IV).

Carried copy of ``repro.sim.mobility.RandomWaypoint`` (the request traces'
PoA stream); the vectorized variant comes with the RL slice.
"""
from __future__ import annotations

import numpy as np


class RandomWaypoint:
    """RWP with pause: average speed 10 m/s, pause 3 s (paper Table/IV text).

    Positions live in a ``side x side`` meter square partitioned into a
    ``grid x grid`` lattice of service areas; ``area_of`` maps a position to
    its area index (= associated BS index, one BS per area).
    """

    def __init__(self, num_ues: int, *, grid: int = 4, side: float = 400.0,
                 speed: float = 10.0, pause: float = 3.0,
                 frame_duration: float = 1.0, rng: np.random.Generator | None = None):
        self.u = num_ues
        self.grid = grid
        self.side = side
        self.speed = speed
        self.pause = pause
        self.dt = frame_duration
        self.rng = rng or np.random.default_rng(0)
        self.pos = self.rng.uniform(0, side, size=(num_ues, 2))
        self.dest = self.rng.uniform(0, side, size=(num_ues, 2))
        self.pause_left = np.zeros(num_ues)

    def step(self) -> np.ndarray:
        """Advance one frame; returns area index per UE (shape (U,), int)."""
        delta = self.dest - self.pos
        dist = np.linalg.norm(delta, axis=1)
        moving = (self.pause_left <= 0)
        step_len = np.minimum(self.speed * self.dt, dist)
        with np.errstate(invalid="ignore", divide="ignore"):
            direction = np.where(dist[:, None] > 1e-9, delta / np.maximum(dist[:, None], 1e-9), 0.0)
        self.pos = np.where(moving[:, None], self.pos + direction * step_len[:, None], self.pos)
        arrived = moving & (dist <= self.speed * self.dt + 1e-9)
        self.pause_left = np.where(arrived, self.pause, self.pause_left - self.dt)
        need_new = (self.pause_left <= 0) & arrived
        # after pause expires pick a fresh waypoint
        expired = (~moving) & (self.pause_left <= 0)
        pick = need_new | expired
        n_pick = int(pick.sum())
        if n_pick:
            self.dest[pick] = self.rng.uniform(0, self.side, size=(n_pick, 2))
        return self.area_of(self.pos)

    def area_of(self, pos: np.ndarray) -> np.ndarray:
        cell = np.clip((pos / (self.side / self.grid)).astype(int), 0, self.grid - 1)
        return cell[:, 0] * self.grid + cell[:, 1]
