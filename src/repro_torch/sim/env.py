"""Edge-network simulator implementing the paper's system model (§II).

State & symbols follow Table I exactly: association graph Psi (one BS per
service area, 4x4 grid), C slotted uplink channels with per-BS exclusivity
(C5), per-BS capacity W_hat ~ U(1,3) (C3), inference cost eps_n ~ U(1,4),
inter-node transmission cost Y_hat (distance-based), per-service quality
curves Omega_s(k), per-UE thresholds Qbar ~ U(0.1, 0.5).

The environment enforces the constraint system (C1–C9) mechanically: the
controller *proposes* MAC and placement actions; ``step`` executes only the
feasible subset and returns reward components per eq. (8) plus everything
needed for the observation vector (7).  Episode dynamics (frames, chains,
delivery, new-request arrivals) follow Algorithm 1's environment loop.

Carried copy of ``repro.sim.env``: the same draws in the same order, so a
simulator here is bit-identical to the reference's under the same seed
(``tests/test_torch_sim.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.sim.mobility import RandomWaypoint
from repro_torch.sim.quality import synthetic_curves

IDLE = -1          # chain not running
PENDING = 0        # prompt uploaded, first block may start next frame (C6)


def draw_static_world(cfg: "SimConfig", rng: np.random.Generator,
                      quality: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Sample one environment's static world (Table II draws).

    The draw ORDER is part of the spec: the vectorized engine replays it
    per-env with per-env generators to stay bit-identical with the scalar
    simulator under the same seed.
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


class EdgeSimulator:
    """One paper environment instance.  All arrays are numpy; seeded."""

    def __init__(self, cfg: SimConfig, *, quality: Optional[np.ndarray] = None):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng
        # static world (drawn once per instance, as in Table II)
        world = draw_static_world(cfg, rng, quality)
        self.w_hat = world["w_hat"]
        self.eps = world["eps"]
        self.qbar = world["qbar"]
        self.service_of = world["service_of"]
        self.omega = world["omega"]                            # (S, B+1)
        self.y_hat = grid_trans_cost(cfg)

        self.mobility: Optional[RandomWaypoint] = None
        self.reset()

    # -- episode control ----------------------------------------------------

    def reset(self, seed: Optional[int] = None) -> None:
        cfg = self.cfg
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.mobility = RandomWaypoint(
            cfg.num_ues, grid=cfg.grid, side=cfg.side, speed=cfg.speed,
            pause=cfg.pause, rng=self.rng)
        self.frame = 0
        self.poa = self.mobility.area_of(self.mobility.pos)    # Psi^t
        self.prev_poa = self.poa.copy()
        u = cfg.num_ues
        self.blocks_done = np.zeros(u, dtype=int)              # k_i
        self.chain_state = np.full(u, IDLE)                    # IDLE/PENDING/1=running
        self.cur_node = np.full(u, -1)                         # last execution BS
        self.has_request = self.rng.random(u) < 0.9            # want to upload
        self.uploaded = np.zeros(u, dtype=bool)                # m_i^{t-1}
        self.delivered_quality = np.zeros(u)                   # final Q on delivery
        self.quality_now = np.zeros(u)                         # Omega(k_i) ongoing
        self.total_delivered = 0.0
        self.num_delivered = 0
        self.num_collisions = 0

    # -- helpers -------------------------------------------------------------

    def ue_quality(self) -> np.ndarray:
        return self.omega[self.service_of, self.blocks_done]

    def needs_uplink(self) -> np.ndarray:
        """UEs that must transmit a prompt before their chain can start."""
        return self.has_request & (self.chain_state == IDLE)

    # -- one frame -----------------------------------------------------------

    def step(self, mac: np.ndarray, placement: np.ndarray) -> Dict:
        """Advance one time frame.

        mac: (U,) int — channel index in [0, C) or -1 (no transmission).
        placement: (U,) int — BS index in [0, N) or -1 (null action a_i = 0).

        Returns a dict with reward components and per-frame telemetry.
        """
        cfg = self.cfg
        u, n = cfg.num_ues, cfg.num_bs
        q_prev = self.ue_quality()
        # C6: first blocks this frame require an upload in an EARLIER frame —
        # snapshot chain states before this frame's MAC runs.
        pre_mac_state = self.chain_state.copy()

        # ---- multiple access (collision semantics, C4/C5) ----
        uploaded_now = np.zeros(u, dtype=bool)
        want = self.needs_uplink() & (mac >= 0)
        for bs in np.unique(self.poa[want]):
            at_bs = want & (self.poa == bs)
            for c in np.unique(mac[at_bs]):
                senders = np.where(at_bs & (mac == c))[0]
                if len(senders) == 1:
                    uploaded_now[senders[0]] = True
                elif len(senders) > 1:
                    self.num_collisions += 1                   # all fail
        # C6: chain may start next frame
        self.chain_state = np.where(uploaded_now, PENDING, self.chain_state)

        # ---- placement execution (C1-C3) ----
        exec_cost = 0.0
        trans_cost = np.zeros(u)
        delivered = np.zeros(u, dtype=bool)
        bs_load = np.zeros(n, dtype=int)
        # priority-descending, ties stable by UE index (same order as MAC and
        # as the vectorized engine, which relies on deterministic tie-breaking)
        order = np.argsort(-(self._priorities()), kind="stable")
        for i in order:
            a = placement[i]
            k = self.blocks_done[i]
            state = pre_mac_state[i]                           # C6 snapshot
            if state == IDLE:
                continue
            if k >= cfg.max_blocks:                            # max reached: deliver
                delivered[i] = True
                continue
            if a < 0:                                          # null action
                if k > 0:                                      # stop & deliver
                    delivered[i] = True
                continue
            if bs_load[a] >= self.w_hat[a]:                    # C3 capacity: blocked
                if k > 0:
                    delivered[i] = True                        # deliver what exists
                continue
            # execute block k+1 of UE i on BS a
            bs_load[a] += 1
            exec_cost += self.eps[a]
            src = self.prev_poa[i] if k == 0 else self.cur_node[i]
            trans_cost[i] += self.y_hat[src, a]                # uplink or latent hop
            self.cur_node[i] = a
            self.blocks_done[i] = k + 1
            self.chain_state[i] = 1
            if self.blocks_done[i] == cfg.max_blocks:
                delivered[i] = True

        # ---- delivery (downlink leg of C9) ----
        for i in np.where(delivered)[0]:
            if self.blocks_done[i] > 0:
                trans_cost[i] += self.y_hat[self.cur_node[i], self.poa[i]]
                self.delivered_quality[i] = self.omega[self.service_of[i],
                                                       self.blocks_done[i]]
                self.total_delivered += self.delivered_quality[i]
                self.num_delivered += 1
            self.blocks_done[i] = 0
            self.chain_state[i] = IDLE
            self.cur_node[i] = -1
            self.has_request[i] = False

        # ---- reward, eq. (8) ----
        q_now = self.ue_quality()
        self.quality_now = q_now
        gain = (q_now - q_prev) * (q_now >= self.qbar)
        reward = float(gain.sum()) - cfg.alpha * exec_cost \
            - cfg.beta * float(trans_cost.sum())

        # ---- world evolution ----
        self.uploaded = uploaded_now
        self.prev_poa = self.poa.copy()
        self.poa = self.mobility.step()
        new_req = (~self.has_request) & (self.rng.random(u) < cfg.arrival_prob)
        self.has_request |= new_req
        self.frame += 1

        return {
            "reward": reward,
            "quality_gain": float(gain.sum()),
            "exec_cost": float(exec_cost),
            "trans_cost": float(trans_cost.sum()),
            "delivered": delivered,
            "bs_load": bs_load,
            "uploaded": uploaded_now,
            "done": self.frame >= cfg.horizon,
        }

    def _priorities(self) -> np.ndarray:
        """Algorithm 1 line 4: max{1/(Qbar - Q), 1e-8}."""
        diff = self.qbar - self.ue_quality()
        with np.errstate(divide="ignore"):
            pr = np.where(diff > 0, 1.0 / np.maximum(diff, 1e-12), 1e-8)
        return np.maximum(pr, 1e-8)

    # -- observation (eq. 7) ---------------------------------------------------

    def observation(self, bs_load: Optional[np.ndarray] = None) -> np.ndarray:
        cfg = self.cfg
        n, u = cfg.num_bs, cfg.num_ues
        load = (bs_load if bs_load is not None else np.zeros(n)) / np.maximum(self.w_hat, 1)
        psi = np.zeros((u, n))
        psi[np.arange(u), self.poa] = 1.0
        parts = [
            load,                                   # W_n / W_hat_n
            self.eps / self.cfg.eps_high,           # eps_n (normalized)
            self.ue_quality() - self.qbar,          # Q_i - Qbar_i
            self.uploaded.astype(float),            # m_i^{t-1}
            psi.reshape(-1),                        # psi_{i,n}
        ]
        return np.concatenate(parts).astype(np.float32)

    @property
    def obs_dim(self) -> int:
        cfg = self.cfg
        return 2 * cfg.num_bs + 2 * cfg.num_ues + cfg.num_ues * cfg.num_bs
