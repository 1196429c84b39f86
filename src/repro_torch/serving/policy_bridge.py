"""Sim ↔ serving decision seam: core policies drive the serving engine.

Carried copy of ``repro.serving.policy_bridge``.  :class:`ServingPolicy`
adapts any :class:`repro_torch.core.policy.Policy` (:class:`LearnedPolicy`,
:class:`GreedyPoAPolicy`, :class:`RandomPolicy`) to
``ServingEngine.placement_fn`` — sim-trained Q-networks place real
requests.  The bridge maps the engine's per-request scheduling state onto
the sim observation convention (eq. 7) once per quantum:

* each request occupies its UE slot (``Request.ue``); idle slots look like
  IDLE sim UEs (quality 0, the world-draw Qbar, last-known PoA);
* node loads are the PREVIOUS quantum's (``engine.prev_loads``), exactly as
  the sim observation carries the previous frame's ``bs_load``;
* ``uploaded`` maps to "admitted, chain not yet started" (the sim's PENDING
  convention), and the observation history window follows the controller's
  eq. (7) rule (:func:`repro_torch.core.learn_gdm.obs_history_window`);
* policy actions follow the controller convention — 0 = null (early exit),
  n+1 = node n — so the null action flows through the engine's
  early-exit path unchanged.

The engine calls ``begin_quantum(engine)`` once per scheduling quantum
(matching the sim's one-act-per-frame semantics); the per-request
``placement_fn`` calls then read the cached slot actions back.

Also here: :func:`engine_from_scenario` (build a ServingEngine whose nodes
ARE the sim world — same W_hat/eps draw, same Y_hat — so a policy trained
in that world serves the matching deployment) and :func:`serve_trace` (the
loop that feeds a :class:`repro_torch.sim.scenarios.RequestTrace` through
an engine with the sim's idle-gated Bernoulli arrival semantics).  Under the
engine's built-in placement (``placement_fn=None``, the paper's GR
baseline) these serve a trace with no RL code.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.learn_gdm import obs_history_window
from repro_torch.serving.engine import (EngineConfig, NodeExecutor, NodeSpec,
                                        Request, ServingEngine)
from repro_torch.sim.env import (IDLE, PENDING, SimConfig, draw_static_world,
                                 grid_trans_cost)


@dataclasses.dataclass
class _SlotView:
    """Duck-typed one-env ``VecEdgeSimulator`` view over the engine's UE
    slots — exactly the attributes ``Policy.act_batch`` /
    ``variant_action_mask_vec`` read."""
    cfg: SimConfig
    num_envs: int
    chain_state: np.ndarray          # (1, U)
    poa: np.ndarray                  # (1, U)
    cur_node: np.ndarray             # (1, U)
    blocks_done: np.ndarray          # (1, U)
    # (1, N) node liveness, or None when every node is up — the action-mask
    # hook (variant_action_mask_vec) masks placements onto dead nodes
    node_up: Optional[np.ndarray] = None


class ServingPolicy:
    """Adapter: one core policy as a ``ServingEngine.placement_fn``.

    ``world`` pins the observation's static terms (W_hat, eps, default
    Qbar) — pass the same world the engine was built from
    (:func:`engine_from_scenario` returns it).  ``record=True`` keeps a
    per-quantum trace of ``(frame, obs_hist, actions)`` for the cross-layer
    pinning tests.
    """

    def __init__(self, policy, cfg: SimConfig, *,
                 world: Optional[Dict[str, np.ndarray]] = None,
                 record: bool = False):
        self.policy = policy
        self.cfg = cfg
        world = world if world is not None else draw_static_world(
            cfg, np.random.default_rng(cfg.seed))
        self.w_hat = np.asarray(world["w_hat"])
        self.eps = np.asarray(world["eps"])
        self.qbar_default = np.asarray(world["qbar"])
        self.history: deque = deque(maxlen=policy.history)
        self.record = record
        self.trace: List[tuple] = []
        self._actions = np.zeros(cfg.num_ues, dtype=int)
        self._last_poa = np.zeros(cfg.num_ues, dtype=int)
        self._seen: set = set()
        self._poa_fed = False

    def update_poa(self, poa: np.ndarray) -> None:
        """Feed the UEs' current PoAs (the trace's mobility stream) for the
        next quantum's observation — in the sim convention psi carries UE
        *locations*, never execution nodes (``serve_trace`` calls this every
        frame).  Without it the bridge falls back to each request's arrival
        origin."""
        self._last_poa = np.asarray(poa, dtype=int).copy()
        self._poa_fed = True

    # -- once per scheduling quantum ------------------------------------------

    def begin_quantum(self, engine: ServingEngine) -> None:
        cfg = self.cfg
        u, n = cfg.num_ues, cfg.num_bs
        quality = np.zeros(u)
        qbar = self.qbar_default.copy()
        blocks = np.zeros(u, dtype=int)
        cur_node = np.full(u, -1)
        chain = np.full(u, IDLE)
        uploaded = np.zeros(u, dtype=bool)
        for req in engine.active:
            assert 0 <= req.ue < u, \
                f"bridged requests need ue in [0, {u}); got {req.ue}"
            s = req.ue
            quality[s] = req.quality
            qbar[s] = req.quality_threshold
            blocks[s] = req.blocks_done
            cur_node[s] = req.node
            chain[s] = PENDING if req.blocks_done == 0 else 1
            # the sim's m^{t-1}: 1 only on the quantum right after the
            # upload (= admission) of a FRESH chain — not for every
            # not-yet-started chain, and not for a handed-over mid-chain
            # request this bridge is seeing for the first time (uploaded
            # never co-occurs with blocks_done > 0 in sim training)
            first_seen = req.rid not in self._seen
            uploaded[s] = first_seen and req.blocks_done == 0
            if first_seen:
                self._seen.add(req.rid)
                if not self._poa_fed:
                    self._last_poa[s] = req.origin     # fallback PoA
        poa = self._last_poa.copy()

        obs_hist = None
        if self.policy.needs_obs:
            load = engine.prev_loads / np.maximum(self.w_hat, 1)
            psi = np.zeros((u, n))
            psi[np.arange(u), poa] = 1.0
            obs = np.concatenate([
                load,                                # W_n / W_hat_n
                self.eps / cfg.eps_high,             # eps_n (normalized)
                quality - qbar,                      # Q_i - Qbar_i
                uploaded.astype(float),              # m_i^{t-1} ~ pending
                psi.reshape(-1),                     # psi_{i,n}
            ]).astype(np.float32)[None]              # (1, obs_dim)
            self.history.append(obs)
            obs_hist = obs_history_window(self.history, self.policy.history)

        # surface the engine's fault state to the policy's action mask; None
        # while healthy keeps the zero-fault observation/mask path untouched
        up = engine._node_up
        view = _SlotView(cfg, 1, chain[None], poa[None], cur_node[None],
                         blocks[None],
                         node_up=up[None] if engine._fault_active
                         and not up.all() else None)
        if engine.tracer is not None:
            # wall-clock the batched decision into the metrics registry
            # (observation only; the action path is untouched)
            t0 = time.perf_counter()
            acts = self.policy.act_batch(view, obs_hist)
            engine.tracer.metrics.histogram("policy_act_batch_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            engine.tracer.metrics.counter("policy_act_batch_calls").inc()
        else:
            acts = self.policy.act_batch(view, obs_hist)
        self._actions = np.asarray(acts)[0].astype(int)
        if self.record:
            self.trace.append((engine.frame,
                               None if obs_hist is None else obs_hist.copy(),
                               self._actions.copy()))

    def __call__(self, req: Request, loads: np.ndarray) -> int:
        # controller convention: 0 = null action (-1 to the engine)
        return int(self._actions[req.ue]) - 1


# -- deployment helpers --------------------------------------------------------



def engine_from_scenario(cfg: SimConfig, services: Dict[int, object], *,
                         engine_cfg: Optional[EngineConfig] = None,
                         world: Optional[Dict[str, np.ndarray]] = None,
                         early_exit: bool = True, recovery=None,
                         tracer=None):
    """Build the ServingEngine matching a sim scenario's world.

    Nodes replicate the Table II world draw (one node per BS, capacity
    ``W_hat``, cost ``eps``), inter-node costs are the sim's ``Y_hat``, and
    admission slots map the C uplink channels.  ``services`` maps service id
    -> an object with ``block_fn(state, k)`` (and optionally
    ``run_batch(states, ks)`` for the one-call-per-(node, quantum) path) or
    a plain ``(state, k) -> (state, quality)`` callable.

    Returns ``(engine, world)``.  ``tracer`` (or ``engine_cfg.tracing``)
    opts into request-level tracing (:mod:`repro_torch.serving.tracing`).
    """
    world = world if world is not None else draw_static_world(
        cfg, np.random.default_rng(cfg.seed))
    block_fns = {s: (svc.block_fn if hasattr(svc, "block_fn") else svc)
                 for s, svc in services.items()}
    batch_fns = {s: svc.run_batch for s, svc in services.items()
                 if hasattr(svc, "run_batch")}
    nodes = [NodeExecutor(NodeSpec(i, int(world["w_hat"][i]),
                                   float(world["eps"][i])),
                          block_fns, batch_fns)
             for i in range(cfg.num_bs)]
    ecfg = engine_cfg or EngineConfig(
        max_blocks=cfg.max_blocks, admission_slots=cfg.num_channels,
        alpha=cfg.alpha, beta=cfg.beta, early_exit=early_exit, seed=cfg.seed)
    return ServingEngine(nodes, ecfg, grid_trans_cost(cfg),
                         recovery=recovery, tracer=tracer), world


def submit_arrivals(engine: ServingEngine, trace, t: int,
                    outstanding: np.ndarray, services: Dict[int, object],
                    rng: np.random.Generator, rid: int,
                    ues: Optional[np.ndarray] = None) -> int:
    """Submit frame ``t``'s idle-gated arrivals from ``trace`` to ``engine``.

    Idle gating via ``outstanding`` (mutated in place), per-(frame, UE)
    thresholds when the trace carries a heavy-tailed mix (``qbar_t``),
    request origin = the UE's PoA this frame.  Returns the next request id.
    ``ues`` restricts submission to a UE subset (a boolean (U,) mask);
    submission order stays UE-index order either way.
    """
    qbar_t = getattr(trace, "qbar_t", None)
    fire = trace.arrivals[t] & ~outstanding
    if ues is not None:
        fire = fire & ues
    for ue in np.where(fire)[0]:
        service = int(trace.service_of[ue])
        svc = services[service]
        state = svc.init_state(rng) if hasattr(svc, "init_state") else {}
        thr = float(trace.qbar[ue]) if qbar_t is None \
            else float(qbar_t[t, ue])
        engine.submit(Request(
            rid=rid, service=service, arrival_frame=t,
            quality_threshold=thr, ue=int(ue),
            origin=int(trace.poa[t, ue]), state=state))
        outstanding[ue] = True
        rid += 1
    return rid


def serve_trace(engine: ServingEngine, trace, services: Dict[int, object], *,
                seed: int = 0) -> Dict[str, float]:
    """Feed a :class:`repro_torch.sim.scenarios.RequestTrace` through an
    engine.

    Per frame: every UE whose trace draw fires AND whose previous request
    has completed submits a new request (the sim's idle-gated Bernoulli
    arrivals), originating at the UE's PoA that frame; then one engine
    quantum runs.  Returns the engine summary plus submission counts.
    """
    u = trace.cfg.num_ues
    rng = np.random.default_rng(seed)
    outstanding = np.zeros(u, dtype=bool)
    completed_cursor = 0
    failed_cursor = 0
    rid = 0
    update_poa = getattr(engine.placement_fn, "update_poa", None)
    for t in range(trace.frames):
        engine.set_poa(trace.poa[t])     # per-node admission + downlink leg
        if update_poa is not None:
            update_poa(trace.poa[t])
        rid = submit_arrivals(engine, trace, t, outstanding, services, rng,
                              rid)
        engine.step()
        for req in engine.completed[completed_cursor:]:
            if req.ue >= 0:
                outstanding[req.ue] = False
        completed_cursor = len(engine.completed)
        # terminal failures (deadline sheds / drops) free the UE slot too
        for req in engine.failed[failed_cursor:]:
            if req.ue >= 0:
                outstanding[req.ue] = False
        failed_cursor = len(engine.failed)
    out = engine.summary(trace.frames)
    out["submitted"] = rid
    out["satisfied"] = sum(r.quality >= r.quality_threshold
                           for r in engine.completed)
    return out
