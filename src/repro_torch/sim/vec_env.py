"""Vectorized multi-env rollout engine: E independent EdgeSimulators stacked.

All per-frame work of :class:`repro_torch.sim.env.EdgeSimulator` — MAC collision
resolution (C4/C5), priority-ordered placement under per-BS capacity (C1–C3),
delivery (C9) and the eq. (8) reward — is expressed as segment/sort
operations over stacked ``(E, U)`` / ``(E, N)`` arrays with **no per-UE or
per-BS Python loops**.  The only Python-level iteration is O(E) generator
draws (mobility waypoint redraws, arrival sampling), which must consume each
env's own stream in the scalar order to keep env ``e`` bit-identical to a
scalar ``EdgeSimulator`` seeded the same way.

Carried copy of ``repro.sim.vec_env`` (``tests/test_torch_sim.py`` pins it
to the reference).  The scalar simulator remains the reference
implementation; the equivalence harness pins this engine at E=1 to the scalar
trajectory exactly (poa, blocks_done, rewards, collisions).  Two details make
the float arithmetic — not just the logic — line up:

* execution costs are accumulated **in priority-rank order per env** (the
  scalar loop's processing order) via a rank-reordered row sum;
* episode totals (``total_delivered``) use ``np.add.at`` so per-delivery
  additions happen one at a time in UE-index order, as the scalar loop does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sim.env import (IDLE, PENDING, SimConfig,
                                 draw_static_world, grid_trans_cost)
from repro_torch.sim.mobility import VecRandomWaypoint


def segment_positions(groups: np.ndarray, ranks: np.ndarray):
    """Order entries by (group, rank) and number them within each group.

    Returns ``(sel, pos)``: ``sel`` sorts the flat entries by group then
    rank; ``pos[j]`` is entry ``sel[j]``'s 0-based position inside its
    group.  This is the segment primitive behind both per-(env, BS)
    capacity masking (grant while ``pos < W_hat``) and greedy channel
    assignment (channel = ``pos`` while ``pos < C``).
    """
    sel = np.lexsort((ranks, groups))
    g_sorted = groups[sel]
    first = np.empty(len(g_sorted), dtype=bool)
    if len(g_sorted):
        first[0] = True
        first[1:] = g_sorted[1:] != g_sorted[:-1]
    seg_start = np.maximum.accumulate(
        np.where(first, np.arange(len(g_sorted)), 0))
    return sel, np.arange(len(g_sorted)) - seg_start


class VecEdgeSimulator:
    """E stacked paper environments.  State arrays are (E, U) / (E, N)."""

    def __init__(self, cfg: SimConfig, num_envs: int, *,
                 seeds: Optional[Sequence[int]] = None,
                 quality: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.num_envs = int(num_envs)
        e, n, u = self.num_envs, cfg.num_bs, cfg.num_ues
        if seeds is None:
            seeds = cfg.seed + np.arange(e)
        assert len(seeds) == e
        self.rngs: List[np.random.Generator] = [
            np.random.default_rng(int(s)) for s in seeds]

        # per-env static worlds, replaying the scalar draw order per stream
        worlds = [draw_static_world(cfg, rng, quality) for rng in self.rngs]
        self.w_hat = np.stack([w["w_hat"] for w in worlds])       # (E, N)
        self.eps = np.stack([w["eps"] for w in worlds])           # (E, N)
        self.qbar = np.stack([w["qbar"] for w in worlds])         # (E, U)
        self.service_of = np.stack([w["service_of"] for w in worlds])
        self.omega = np.stack([w["omega"] for w in worlds])       # (E, S, B+1)
        self.y_hat = grid_trans_cost(cfg)                         # (N, N) shared

        # precomputed index helpers for the vectorized step
        self._env_col = np.arange(e)[:, None]                     # (E, 1)
        self._env_flat = np.repeat(np.arange(e), u)               # (E*U,)

        self.mobility: Optional[VecRandomWaypoint] = None
        self.reset()

    # -- episode control ----------------------------------------------------

    def reset(self, seeds: Optional[Sequence[int]] = None) -> None:
        cfg = self.cfg
        e, u = self.num_envs, cfg.num_ues
        if seeds is not None:
            assert len(seeds) == e
            self.rngs = [np.random.default_rng(int(s)) for s in seeds]
        self.mobility = VecRandomWaypoint(
            e, u, grid=cfg.grid, side=cfg.side, speed=cfg.speed,
            pause=cfg.pause, rngs=self.rngs)
        self.frame = 0
        self.poa = self.mobility.area_of(self.mobility.pos)       # (E, U)
        self.prev_poa = self.poa.copy()
        self.blocks_done = np.zeros((e, u), dtype=int)
        self.chain_state = np.full((e, u), IDLE)
        self.cur_node = np.full((e, u), -1)
        # scalar draw order per env continues: has_request after mobility init
        self.has_request = np.stack(
            [rng.random(u) < 0.9 for rng in self.rngs])
        self.uploaded = np.zeros((e, u), dtype=bool)
        self.delivered_quality = np.zeros((e, u))
        self.quality_now = np.zeros((e, u))
        self.total_delivered = np.zeros(e)
        self.num_delivered = np.zeros(e, dtype=int)
        self.num_collisions = np.zeros(e, dtype=int)

    # -- helpers -------------------------------------------------------------

    def ue_quality(self) -> np.ndarray:
        return self.omega[self._env_col, self.service_of, self.blocks_done]

    def needs_uplink(self) -> np.ndarray:
        return self.has_request & (self.chain_state == IDLE)

    def _priorities(self) -> np.ndarray:
        diff = self.qbar - self.ue_quality()
        with np.errstate(divide="ignore"):
            pr = np.where(diff > 0, 1.0 / np.maximum(diff, 1e-12), 1e-8)
        return np.maximum(pr, 1e-8)

    def _order_and_rank(self) -> tuple:
        """order[e, j] = UE processed j-th in env e (priority-descending,
        same argsort kind as the scalar loop — stable, ties by UE index —
        row-wise); rank is its inverse: rank[e, i] = processing position of
        UE i."""
        order = np.argsort(-self._priorities(), axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(self.cfg.num_ues), order.shape), axis=1)
        return order, rank

    # -- one frame -----------------------------------------------------------

    def step(self, mac: np.ndarray, placement: np.ndarray, *,
             arrival_draws: Optional[np.ndarray] = None,
             waypoint_redraw: Optional[np.ndarray] = None) -> Dict:
        """Advance one frame for all E envs.

        mac: (E, U) int — channel in [0, C) or -1 (silent).
        placement: (E, U) int — BS in [0, N) or -1 (null action).
        arrival_draws: optional (E, U) uniforms in [0, 1) replacing the
            per-env generator draws for new-request arrivals.
        waypoint_redraw: optional (E, U, 2) uniforms in [0, side) replacing
            the mobility waypoint redraw draws.  Both hooks exist so another
            engine can be driven with *identical* randomness for a
            logic-equivalence harness; when omitted the native per-env
            streams are consumed exactly as before.

        Returns per-env reward components; ``rewards`` etc. have shape (E,).
        """
        cfg = self.cfg
        e, u, n, c = self.num_envs, cfg.num_ues, cfg.num_bs, cfg.num_channels
        q_prev = self.ue_quality()
        pre_mac_state = self.chain_state.copy()                   # C6 snapshot

        # ---- multiple access (C4/C5 collision semantics) ----
        want = self.needs_uplink() & (mac >= 0)
        mac_safe = np.where(want, mac, 0)
        key = (self._env_col * n + self.poa) * c + mac_safe       # (E, U)
        counts = np.bincount(key.ravel()[want.ravel()], minlength=e * n * c)
        uploaded_now = want & (counts[key] == 1)
        # one collision event per (env, BS, channel) group with >1 senders
        coll_envs = np.flatnonzero(counts > 1) // (n * c)
        self.num_collisions += np.bincount(coll_envs, minlength=e)
        self.chain_state = np.where(uploaded_now, PENDING, self.chain_state)

        # ---- placement execution (C1-C3): capacity masking by rank ----
        k = self.blocks_done                                      # pre-frame
        active = pre_mac_state != IDLE
        eligible = active & (k < cfg.max_blocks) & (placement >= 0)
        _, rank = self._order_and_rank()
        a_safe = np.where(placement >= 0, placement, 0)
        group = self._env_col * n + a_safe                        # (E, U)

        flat_el = eligible.ravel()
        g_el = group.ravel()[flat_el]
        r_el = rank.ravel()[flat_el]
        sel, pos_in_bs = segment_positions(g_el, r_el)
        granted_sorted = pos_in_bs < self.w_hat.ravel()[g_el[sel]]

        granted = np.zeros(e * u, dtype=bool)
        granted[np.flatnonzero(flat_el)[sel[granted_sorted]]] = True
        granted = granted.reshape(e, u)

        bs_load = np.bincount(group.ravel()[granted.ravel()],
                              minlength=e * n).reshape(e, n)

        # exec cost: one add at a time, per env in priority-rank order — the
        # scalar loop's exact accumulation sequence, so the float total is
        # bit-identical (np.sum's 8-way unrolled reduction would not be)
        exec_cost = np.zeros(e)
        gr_idx = np.flatnonzero(granted.ravel())
        gr_sel = np.lexsort((rank.ravel()[gr_idx], self._env_flat[gr_idx]))
        gr_idx = gr_idx[gr_sel]
        np.add.at(exec_cost, self._env_flat[gr_idx],
                  self.eps.ravel()[group.ravel()[gr_idx]])

        # transmission cost: uplink / latent hop for executed blocks
        src = np.where(k == 0, self.prev_poa, self.cur_node)
        src_safe = np.where(src >= 0, src, 0)
        hop = self.y_hat[src_safe, a_safe]
        trans_cost = np.where(granted, hop, 0.0)

        # state updates for executed blocks
        new_blocks = np.where(granted, k + 1, k)
        new_cur = np.where(granted, placement, self.cur_node)
        self.chain_state = np.where(granted, 1, self.chain_state)

        # ---- delivery decision (mirrors the scalar branch ladder) ----
        delivered = active & (
            (k >= cfg.max_blocks)
            | ((placement < 0) & (k > 0))
            | (eligible & ~granted & (k > 0))                     # C3 blocked
            | (granted & (new_blocks == cfg.max_blocks)))

        # ---- delivery (downlink leg of C9) ----
        deliver_q = delivered & (new_blocks > 0)
        new_cur_safe = np.where(new_cur >= 0, new_cur, 0)
        trans_cost += np.where(deliver_q, self.y_hat[new_cur_safe, self.poa], 0.0)
        dq = self.omega[self._env_col, self.service_of, new_blocks]
        self.delivered_quality = np.where(deliver_q, dq, self.delivered_quality)
        flat_dq = deliver_q.ravel()
        np.add.at(self.total_delivered, self._env_flat[flat_dq],
                  dq.ravel()[flat_dq])
        self.num_delivered += deliver_q.sum(axis=1)
        self.blocks_done = np.where(delivered, 0, new_blocks)
        self.chain_state = np.where(delivered, IDLE, self.chain_state)
        self.cur_node = np.where(delivered, -1, new_cur)
        self.has_request &= ~delivered

        # ---- reward, eq. (8) ----
        q_now = self.ue_quality()
        self.quality_now = q_now
        gain = (q_now - q_prev) * (q_now >= self.qbar)
        trans_sum = trans_cost.sum(axis=1)
        rewards = gain.sum(axis=1) - cfg.alpha * exec_cost \
            - cfg.beta * trans_sum

        # ---- world evolution ----
        self.uploaded = uploaded_now
        self.prev_poa = self.poa.copy()
        self.poa = self.mobility.step(redraw=waypoint_redraw)
        draws = arrival_draws if arrival_draws is not None \
            else np.stack([rng.random(u) for rng in self.rngs])
        new_req = (~self.has_request) & (draws < cfg.arrival_prob)
        self.has_request |= new_req
        self.frame += 1

        return {
            "rewards": rewards,                                   # (E,)
            "quality_gain": gain.sum(axis=1),
            "exec_cost": exec_cost,
            "trans_cost": trans_sum,
            "delivered": delivered,                               # (E, U)
            "executed": granted,                                  # (E, U)
            "bs_load": bs_load,                                   # (E, N)
            "uploaded": uploaded_now,                             # (E, U)
            "done": self.frame >= cfg.horizon,
        }

    # -- observation (eq. 7), batched ----------------------------------------

    def observation(self, bs_load: Optional[np.ndarray] = None) -> np.ndarray:
        cfg = self.cfg
        e, n, u = self.num_envs, cfg.num_bs, cfg.num_ues
        load = (bs_load if bs_load is not None else np.zeros((e, n))) \
            / np.maximum(self.w_hat, 1)
        psi = np.zeros((e * u, n))
        psi[np.arange(e * u), self.poa.ravel()] = 1.0
        parts = [
            load,                                       # (E, N)
            self.eps / cfg.eps_high,                    # (E, N)
            self.ue_quality() - self.qbar,              # (E, U)
            self.uploaded.astype(float),                # (E, U)
            psi.reshape(e, u * n),                      # (E, U*N)
        ]
        return np.concatenate(parts, axis=1).astype(np.float32)

    @property
    def obs_dim(self) -> int:
        cfg = self.cfg
        return 2 * cfg.num_bs + 2 * cfg.num_ues + cfg.num_ues * cfg.num_bs
