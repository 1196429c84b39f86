"""Non-learned baselines: GR (greedy-at-PoA) and OPT (full-knowledge bound).

GR (paper red line): every block executes at the UE's current PoA, chains
always run to the full length B — no placement intelligence, no early exit.

OPT (paper black line, Gurobi there): full knowledge of UE mobility.  Gurobi
is not installable offline, so we solve the same objective with an exact
per-UE dynamic program over (frame, blocks-done, node) given the *known*
mobility trajectory, relaxing the inter-UE coupling constraints (BS capacity
C3 and channel counts C4–C6 beyond one-frame upload latency).  A relaxation
of a maximization is a valid upper bound — matching the role OPT plays in
Fig. 4 (a bound all methods sit under).  The DP additionally enforces C8
(deliver only at-or-above threshold, or not at all) exactly as (2) requires.

Carried copy of ``repro.core.baselines`` (numpy).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.learn_gdm import EpisodeStats
from repro_torch.core.mac import greedy_mac
from repro_torch.sim.env import IDLE, EdgeSimulator
from repro_torch.sim.mobility import RandomWaypoint


# ---------------------------------------------------------------------------
# GR
# ---------------------------------------------------------------------------

class GreedyController:
    """Every block at the PoA; full-length chains; greedy MAC."""

    def __init__(self, env: EdgeSimulator):
        self.env = env

    def run_episode(self, *, seed: Optional[int] = None) -> EpisodeStats:
        env = self.env
        env.reset(seed=seed)
        total = dict(reward=0.0, quality_gain=0.0, exec_cost=0.0, trans_cost=0.0)
        done = False
        while not done:
            mac = greedy_mac(env)
            placement = np.where(env.chain_state != IDLE, env.poa, -1)
            res = env.step(mac, placement)
            done = res["done"]
            for k in total:
                total[k] += res[k]
        return EpisodeStats(
            reward=total["reward"], quality_gain=total["quality_gain"],
            exec_cost=total["exec_cost"], trans_cost=total["trans_cost"],
            delivered_quality=env.total_delivered,
            num_delivered=env.num_delivered,
            collisions=env.num_collisions, losses=[])

    def evaluate(self, episodes: int, *, seed0: int = 9_000,
                 engine: str = "vectorized",
                 num_envs: Optional[int] = None,
                 seed: int = 0, device=None) -> Dict[str, float]:
        """GR through the unified policy/engine seam (same engine knob
        semantics as ``LearnGDMController.evaluate``; "scalar" keeps the
        original reference loop; ``device`` is the fused engine's, the
        card by default)."""
        from repro_torch.core.policy import GreedyPoAPolicy, evaluate_policy
        return evaluate_policy(
            GreedyPoAPolicy(), self.env, episodes, engine=engine,
            num_envs=num_envs, seed0=seed0, seed=seed,
            scalar_episode=lambda s: self.run_episode(seed=s),
            device=device)


# ---------------------------------------------------------------------------
# OPT upper bound
# ---------------------------------------------------------------------------

def _poa_trajectory(env: EdgeSimulator, seed: int) -> np.ndarray:
    """Replay the (action-independent) mobility for a given episode seed."""
    cfg = env.cfg
    rng = np.random.default_rng(seed)
    mob = RandomWaypoint(cfg.num_ues, grid=cfg.grid, side=cfg.side,
                         speed=cfg.speed, pause=cfg.pause, rng=rng)
    traj = [mob.area_of(mob.pos)]
    for _ in range(cfg.horizon):
        traj.append(mob.step())
    return np.stack(traj)                                  # (T+1, U)


def opt_upper_bound(env: EdgeSimulator, *, seed: int) -> Dict[str, float]:
    """Exact per-UE DP on the relaxed problem; returns objective components.

    Value(2) = sum over UEs of the best chain schedule given full mobility
    knowledge: quality gains (thresholded, per eq. 8 accounting), minus
    alpha * execution costs, minus beta * transmission costs (uplink +
    latent hops + downlink, C9).
    """
    cfg = env.cfg
    traj = _poa_trajectory(env, seed)                      # (T+1, U)
    t_max, u = cfg.horizon, cfg.num_ues
    n, b = cfg.num_bs, cfg.max_blocks

    total = dict(reward=0.0, quality_gain=0.0, exec_cost=0.0, trans_cost=0.0,
                 delivered_quality=0.0, num_delivered=0.0)

    for i in range(u):
        omega = env.omega[env.service_of[i]]               # (B+1,)
        qbar = env.qbar[i]
        gains = np.zeros(b + 1)
        for k in range(1, b + 1):
            gains[k] = (omega[k] - omega[k - 1]) * (omega[k] >= qbar)
        # value[t] = best objective achievable from frame t onward (idle state)
        value = np.zeros(t_max + 2)
        best_detail = [None] * (t_max + 2)
        for t in range(t_max - 1, -1, -1):
            best = value[t + 1]                            # stay idle this frame
            # start a chain: upload at t (1 frame), first block at t+1
            if t + 1 < t_max:
                v, detail = _chain_dp(env, i, traj, t + 1, gains, omega, qbar,
                                      value)
                if v > best:
                    best = v
                    best_detail[t] = detail
            value[t] = best
        total["reward"] += value[0]
        # accumulate component telemetry from the chosen plans
        t = 0
        while t < t_max:
            if best_detail[t] is not None:
                d = best_detail[t]
                total["quality_gain"] += d["gain"]
                total["exec_cost"] += d["exec"]
                total["trans_cost"] += d["trans"]
                total["delivered_quality"] += d["delivered_q"]
                total["num_delivered"] += 1
                t = d["end"]
            else:
                t += 1
    return total


def _chain_dp(env: EdgeSimulator, i: int, traj: np.ndarray, t0: int,
              gains: np.ndarray, omega: np.ndarray, qbar: float,
              value_after: np.ndarray):
    """DP over (frame, k, node) for one chain starting its first block at t0.

    Returns (best total value incl. continuation, detail dict).
    """
    cfg = env.cfg
    t_max, n, b = cfg.horizon, cfg.num_bs, cfg.max_blocks
    alpha, beta = cfg.alpha, cfg.beta
    neg = -1e18

    # f[k][node] = best partial value of having done k blocks, last at node
    f = np.full((b + 1, n), neg)
    back_best = {}
    # first block at frame t0 on any node (uplink from poa at t0-1)
    up_src = traj[t0 - 1, i] if t0 >= 1 else traj[0, i]
    detail_best = None
    best_total = neg
    for k in range(1, b + 1):
        t = t0 + k - 1
        if t >= t_max:
            break
        for node in range(n):
            if k == 1:
                val = gains[1] - alpha * env.eps[node] \
                    - beta * env.y_hat[up_src, node]
                exec_c = env.eps[node]
                trans_c = env.y_hat[up_src, node]
                prev = (0, -1, 0.0, 0.0)
            else:
                prev_vals = f[k - 1] - beta * env.y_hat[:, node]
                pbest = int(np.argmax(prev_vals))
                if f[k - 1, pbest] <= neg / 2:
                    continue
                val = prev_vals[pbest] + gains[k] - alpha * env.eps[node]
                exec_c = back_best[(k - 1, pbest)][0] + env.eps[node]
                trans_c = back_best[(k - 1, pbest)][1] + env.y_hat[pbest, node]
                prev = (k - 1, pbest, 0.0, 0.0)
            if val > f[k, node]:
                f[k, node] = val
                back_best[(k, node)] = (exec_c, trans_c)
            # option: deliver after block k (C8: only if above threshold)
            if omega[k] >= qbar and t + 1 <= t_max:
                down = beta * env.y_hat[node, traj[min(t + 1, t_max), i]]
                cont = value_after[min(t + 1, t_max + 1)]
                tot = f[k, node] - down + cont
                if tot > best_total:
                    best_total = tot
                    ec, tc = back_best[(k, node)]
                    detail_best = {
                        "gain": float(sum(gains[1:k + 1])),
                        "exec": float(ec),
                        "trans": float(tc + env.y_hat[node, traj[min(t + 1, t_max), i]]),
                        "delivered_q": float(omega[k]),
                        "end": t + 1,
                    }
    if detail_best is None:
        return -1e18, None
    return best_total, detail_best
