"""Deployment helpers: a scenario's world as a serving engine, and the loop
that serves a request trace.

Carried copy of ``engine_from_scenario``, ``submit_arrivals`` and
``serve_trace`` from ``repro.serving.policy_bridge``.  Under the engine's
built-in placement (``placement_fn=None``, the paper's GR baseline) these
serve a request trace with no RL code; the learned-policy adapter
(``ServingPolicy``) comes with the RL slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.serving.engine import (EngineConfig, NodeExecutor, NodeSpec,
                                        Request, ServingEngine)
from repro_torch.sim.env import SimConfig, draw_static_world, grid_trans_cost


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
