"""Multiple access schemes (paper §III, Algorithm 1 lines 4–8).

The greedy MAC sorts UEs by priority max{1/(Qbar - Q), 1e-8} — UEs whose
ongoing inference is *closest below* the quality threshold first — and
assigns the C channels per BS (respecting C5, so controller-scheduled
transmissions never collide; scarcity shows up as fewer grants per frame).
A RandomAccess scheme (UEs pick channels independently) is provided for the
collision ablation.

Carried copy of ``repro.core.mac`` (numpy; the same draws in the same order).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.env import EdgeSimulator
from repro_torch.sim.vec_env import segment_positions


def greedy_mac(env: EdgeSimulator) -> np.ndarray:
    """Returns (U,) channel assignment in [0, C) or -1 (silent)."""
    cfg = env.cfg
    mac = np.full(cfg.num_ues, -1, dtype=int)
    need = env.needs_uplink()
    if not need.any():
        return mac
    pr = env._priorities()
    for bs in np.unique(env.poa[need]):
        ues = np.where(need & (env.poa == bs))[0]
        ues = ues[np.argsort(-pr[ues], kind="stable")]
        for c, i in enumerate(ues[:cfg.num_channels]):
            mac[i] = c
    return mac


def vec_greedy_mac(venv) -> np.ndarray:
    """Batched greedy MAC over a :class:`~repro_torch.sim.vec_env.VecEdgeSimulator`.

    Returns (E, U) channel assignments in [0, C) or -1 (silent).  Same
    semantics as :func:`greedy_mac` per env, with the per-(env, BS) top-C
    selection done as one lexsort + segment-position pass instead of nested
    Python loops: within each (env, BS) group, needy UEs ordered by priority
    rank take channels 0..C-1; the rest stay silent.
    """
    cfg = venv.cfg
    e, u, n, c = venv.num_envs, cfg.num_ues, cfg.num_bs, cfg.num_channels
    mac = np.full((e, u), -1, dtype=int)
    need = venv.needs_uplink()
    if not need.any():
        return mac
    _, rank = venv._order_and_rank()
    group = venv._env_col * n + venv.poa                      # (E, U)

    flat = need.ravel()
    sel, channel = segment_positions(group.ravel()[flat],
                                     rank.ravel()[flat])      # pos within BS
    idx = np.flatnonzero(flat)[sel]
    mac.ravel()[idx[channel < c]] = channel[channel < c]
    return mac


def random_access(env: EdgeSimulator, *, attempt_prob: float = 0.8,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Uncoordinated ALOHA-style access — collisions happen (ablation)."""
    cfg = env.cfg
    rng = rng or env.rng
    mac = np.full(cfg.num_ues, -1, dtype=int)
    need = env.needs_uplink()
    attempt = need & (rng.random(cfg.num_ues) < attempt_prob)
    mac[attempt] = rng.integers(0, cfg.num_channels, size=int(attempt.sum()))
    return mac


def vec_random_access(venv, *, attempt_prob: float = 0.8) -> np.ndarray:
    """Batched ALOHA ablation over a VecEdgeSimulator, (E, U) channels.

    Draws come from each env's own generator (O(E) calls) so env streams
    stay independent and reproducible.
    """
    cfg = venv.cfg
    u = cfg.num_ues
    need = venv.needs_uplink()
    mac = np.full(need.shape, -1, dtype=int)
    attempts = np.stack([rng.random(u) for rng in venv.rngs]) < attempt_prob
    attempt = need & attempts
    for e, rng in enumerate(venv.rngs):
        n = int(attempt[e].sum())
        if n:
            mac[e][attempt[e]] = rng.integers(0, cfg.num_channels, size=n)
    return mac
