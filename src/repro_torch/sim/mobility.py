"""Random Waypoint mobility over the paper's grid of service areas (§IV).

Carried copy of ``repro.sim.mobility``: the same draws in the same order.
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


class VecRandomWaypoint:
    """E independent RandomWaypoint instances as stacked (E, U, ...) arrays.

    All kinematics are vectorized over (E, U); the only per-env work is the
    waypoint redraw, which must consume each env's own generator in exactly
    the order the scalar class does (``if n_pick: rng.uniform(...)``) so that
    env e's trajectory is bit-identical to ``RandomWaypoint`` seeded the same
    way.  ``rngs`` is shared with the owning :class:`VecEdgeSimulator`.
    """

    def __init__(self, num_envs: int, num_ues: int, *, grid: int = 4,
                 side: float = 400.0, speed: float = 10.0, pause: float = 3.0,
                 frame_duration: float = 1.0,
                 rngs: list[np.random.Generator] | None = None):
        self.e = num_envs
        self.u = num_ues
        self.grid = grid
        self.side = side
        self.speed = speed
        self.pause = pause
        self.dt = frame_duration
        self.rngs = rngs or [np.random.default_rng(i) for i in range(num_envs)]
        assert len(self.rngs) == num_envs
        self.pos = np.empty((num_envs, num_ues, 2))
        self.dest = np.empty((num_envs, num_ues, 2))
        # scalar draw order per env: pos, then dest
        for e, rng in enumerate(self.rngs):
            self.pos[e] = rng.uniform(0, side, size=(num_ues, 2))
            self.dest[e] = rng.uniform(0, side, size=(num_ues, 2))
        self.pause_left = np.zeros((num_envs, num_ues))

    def step(self, redraw: np.ndarray | None = None) -> np.ndarray:
        """Advance one frame; returns area index per UE, shape (E, U) int.

        ``redraw``: optional (E, U, 2) uniforms in [0, side) used for the
        waypoint redraw instead of the per-env generators — the injection
        hook for an engine driven with identical randomness.
        """
        delta = self.dest - self.pos
        dist = np.linalg.norm(delta, axis=-1)                  # (E, U)
        moving = (self.pause_left <= 0)
        step_len = np.minimum(self.speed * self.dt, dist)
        with np.errstate(invalid="ignore", divide="ignore"):
            direction = np.where(dist[..., None] > 1e-9,
                                 delta / np.maximum(dist[..., None], 1e-9), 0.0)
        self.pos = np.where(moving[..., None],
                            self.pos + direction * step_len[..., None], self.pos)
        arrived = moving & (dist <= self.speed * self.dt + 1e-9)
        self.pause_left = np.where(arrived, self.pause, self.pause_left - self.dt)
        need_new = (self.pause_left <= 0) & arrived
        expired = (~moving) & (self.pause_left <= 0)
        pick = need_new | expired
        if redraw is not None:
            self.dest = np.where(pick[..., None], redraw, self.dest)
        else:
            for e, rng in enumerate(self.rngs):                # O(E), not O(E*U)
                n_pick = int(pick[e].sum())
                if n_pick:
                    self.dest[e][pick[e]] = rng.uniform(0, self.side,
                                                        size=(n_pick, 2))
        return self.area_of(self.pos)

    def area_of(self, pos: np.ndarray) -> np.ndarray:
        cell = np.clip((pos / (self.side / self.grid)).astype(int),
                       0, self.grid - 1)
        return cell[..., 0] * self.grid + cell[..., 1]
