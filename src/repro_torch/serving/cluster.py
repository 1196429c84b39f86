"""Fleet-scale serving: C cells under one clock with stacked execution.

Carried copy of ``repro.serving.cluster``, pinned to it by
``tests/test_torch_fleet.py`` and, on a mesh, by
``tests/test_torch_mesh.py``.

A *cell* is one :class:`~repro_torch.serving.engine.ServingEngine` (one
scenario-derived world + bridged policy); the :class:`ClusterEngine` runs C
of them as one fleet:

* **One clock.**  Per scheduling quantum every cell runs
  ``begin_step`` (admission + placement + transmission charging), then the
  cluster executes ALL planned blocks, then every cell runs ``end_step``
  (delivery + accounting).  Cell frames advance in lock-step.
* **Stacked execution.**  With ``stacked=True`` (the production path) the
  cluster merges every cell's ``node -> requests`` plan by service and
  advances each service's fleet-wide batch in ONE ``run_batch`` call — for
  the real DiT services that is one
  :func:`repro_torch.models.gdm.run_block_batched` call per (service, quantum)
  for the WHOLE fleet, so device throughput scales with cells instead of
  degrading to a Python loop over (cell, node) groups.  ``stacked=False``
  falls back to per-cell per-node execution (the sequential baseline
  ``benchmarks/bench_cluster.py`` measures against).  Both paths do
  identical per-request bookkeeping
  (:func:`repro_torch.serving.engine.apply_block_results`), so for per-sample-
  independent services the results are identical — the cell-equivalence
  harness in ``tests/test_cluster.py`` pins each cell to a standalone
  ``ServingEngine`` run frame-for-frame.
* **Cross-cell handover.**  A UE that moves between cells mid-chain takes
  its in-flight latents along: the request leaves the source cell's active
  set, the transfer is charged through the
  :class:`~repro_torch.serving.kv_manager.TransferLedger` (C9 bytes =
  ``state_nbytes`` of the live payload), and the request re-enters the
  destination cell at the UE's new PoA with chain progress intact
  (``node = -1``: placement restarts from the new origin).  Candidates come
  from the workload layer (:class:`repro_torch.sim.workloads.FleetTrace`); a
  candidate is applied only if the UE has an in-flight request in the
  source cell and the destination UE slot is free.

:func:`cluster_from_scenario` builds the fleet from a named scenario (every
cell shares the scenario's Table II world and the SAME service instances —
sharing is what makes stacking possible); :func:`serve_fleet` drives a
:class:`~repro_torch.sim.workloads.FleetTrace` through it with the same
idle-gated arrival semantics as the single-cell
:func:`~repro_torch.serving.policy_bridge.serve_trace`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import (EngineConfig, Request, ServingEngine,
                                  apply_block_results)
from repro_torch.serving.policy_bridge import (ServingPolicy, engine_from_scenario,
                                         submit_arrivals)
from repro_torch.serving.kv_manager import TransferLedger, state_nbytes
from repro_torch.serving.telemetry import TelemetryLog
from repro_torch.serving.tracing import Tracer, latency_summary
from repro_torch.sim.env import SimConfig


@dataclasses.dataclass
class HandoverEvent:
    """One applied (or candidate) cross-cell UE move."""
    ue: int
    src_cell: int
    dst_cell: int
    dst_origin: int                  # the UE's PoA node in the new cell


class ClusterEngine:
    """C serving cells under one clock with fleet-stacked execution."""

    def __init__(self, engines: List[ServingEngine],
                 services: Dict[int, object], *, stacked: bool = True,
                 handover_cost: float = 0.4,
                 ledger: Optional[TransferLedger] = None,
                 mesh=None, batch_axis: str = "batch",
                 tracer: Optional[Tracer] = None):
        assert engines, "a cluster needs at least one cell"
        self.engines = engines
        self.services = services
        self.stacked = stacked
        self.handover_cost = handover_cost
        # the fleet ledger records cross-cell handovers (src/dst are CELL
        # ids); per-cell ledgers on the engines record intra-cell legs
        self.ledger = ledger
        # the fleet shares ONE tracer (cells hold the same object, so
        # cross-cell requests keep a single span tree); default to whatever
        # the cells were built with
        self.tracer = tracer if tracer is not None else next(
            (e.tracer for e in engines if e.tracer is not None), None)
        self.handovers_applied = 0
        # mesh-sharded fleet: each cell has a home device (round-robin) and
        # the stacked per-service batch is sharded over the batch axis by
        # the services themselves (build them with the same mesh).  The
        # bookkeeping here only adds accounting: a handover between cells
        # on different home devices moves latents across shards and is
        # recorded as a "shard" transfer (bytes real, cost 0.0 — the
        # latency charge already rides the handover event itself).
        self.mesh = mesh
        ndev = 1 if mesh is None else mesh.shape[batch_axis]
        self.device_of_cell = [c % ndev for c in range(len(engines))]
        # scalar fallbacks for services without a batch entry point
        self._block_fns = {
            s: (svc.block_fn if hasattr(svc, "block_fn") else svc)
            for s, svc in services.items()}

    @property
    def num_cells(self) -> int:
        return len(self.engines)

    @property
    def frame(self) -> int:
        return self.engines[0].frame

    def submit(self, cell: int, req: Request) -> None:
        self.engines[cell].submit(req)

    # -- faults ----------------------------------------------------------------

    def apply_faults(self, faults, t: int) -> None:
        """Feed frame ``t`` of a :class:`repro_torch.sim.faults.FaultTrace` to
        every cell (before handovers/arrivals, so the whole quantum sees
        it).  A ``"none"`` trace leaves every engine's fault state inert —
        the zero-fault pin."""
        for c, eng in enumerate(self.engines):
            node_up, cap_scale, link_scale = faults.cell_state(t, c)
            eng.set_fault_state(node_up, cap_scale=cap_scale,
                                link_scale=link_scale)

    # -- handover --------------------------------------------------------------

    def apply_handovers(self, events: Sequence[HandoverEvent]
                        ) -> List[HandoverEvent]:
        """Apply the feasible subset of ``events``; returns what moved."""
        applied = []
        for ev in events:
            if self._apply_handover(ev):
                applied.append(ev)
        return applied

    def _apply_handover(self, ev: HandoverEvent) -> bool:
        src, dst = self.engines[ev.src_cell], self.engines[ev.dst_cell]
        req = next((r for r in src.active
                    if r.ue == ev.ue and not r.done), None)
        if req is None:
            # pending — not just active — requests follow their UE: a
            # queued request re-queues in the destination cell at the
            # UE's new PoA.  No latents have shipped (uplink is charged at
            # first placement, from the new cell), so the move itself is
            # free — but it still counts as an applied handover and the
            # ledger records a zero-cost, zero-byte row so handover rows
            # keep matching handovers_applied.
            pending = next((r for r in src.pending
                            if r.ue == ev.ue and not r.done), None)
            if pending is None:                  # nothing in flight: no-op
                return False
            busy = any(r.ue == ev.ue for r in dst.active) or \
                any(r.ue == ev.ue for r in dst.pending)
            if busy:
                return False
            if dst._fault_active and not dst._node_up.any():
                return False
            src.pending.remove(pending)
            pending.origin = ev.dst_origin
            pending.node = -1
            dst.pending.append(pending)
            for ledger in {id(led): led for led in (dst.ledger, self.ledger)
                           if led is not None}.values():
                ledger.record(self.frame, pending.rid, "handover",
                              ev.src_cell, ev.dst_cell, 0, 0.0)
            if self.tracer is not None:          # mirror the zero-byte row
                self.tracer.on_transfer(pending.rid, "handover", ev.src_cell,
                                        ev.dst_cell, 0, 0.0, self.frame,
                                        ev.dst_cell)
            self.handovers_applied += 1
            return True
        busy = any(r.ue == ev.ue for r in dst.active) or \
            any(r.ue == ev.ue for r in dst.pending)
        if busy:                                 # destination slot occupied
            return False
        # a whole-cell outage at the destination defers the move: the
        # request stays in the source cell rather than strand its latents
        # in a cell that cannot execute anything (guarded on _fault_active
        # so the zero-fault path never evaluates it)
        if dst._fault_active and not dst._node_up.any():
            return False
        src.active.remove(req)
        # ship the live latents: charged through the destination engine's
        # _charge (request fields + per-quantum telemetry legs + the cell's
        # ledger — src/dst are CELL ids for handover events); the fleet
        # ledger gets the event too unless it IS the cell's ledger
        # (cluster_from_scenario shares one object for both)
        cost = self.handover_cost
        dst._charge(req, "handover", ev.src_cell, ev.dst_cell, cost)
        if self.ledger is not None and self.ledger is not dst.ledger:
            self.ledger.record(self.frame, req.rid, "handover", ev.src_cell,
                               ev.dst_cell, state_nbytes(req.state), cost)
        src_dev = self.device_of_cell[ev.src_cell]
        dst_dev = self.device_of_cell[ev.dst_cell]
        if self.ledger is not None and src_dev != dst_dev:
            self.ledger.record(self.frame, req.rid, "shard", src_dev,
                               dst_dev, state_nbytes(req.state), 0.0)
        if self.tracer is not None and src_dev != dst_dev:
            self.tracer.on_transfer(req.rid, "shard", src_dev, dst_dev,
                                    state_nbytes(req.state), 0.0, self.frame,
                                    ev.dst_cell)
        req.origin = ev.dst_origin               # re-enter at the new PoA
        req.node = -1                            # placement restarts there
        dst.active.append(req)                   # admission carries over
        self.handovers_applied += 1
        return True

    # -- one fleet quantum -----------------------------------------------------

    def step(self, handovers: Sequence[HandoverEvent] = ()
             ) -> List[Dict[str, float]]:
        """One scheduling quantum for every cell; returns per-cell stats."""
        if handovers:
            self.apply_handovers(handovers)
        plans = [eng.begin_step() for eng in self.engines]
        if self.stacked:
            self._execute_stacked(plans)
        else:
            for eng, plan in zip(self.engines, plans):
                for target, reqs in plan.items():
                    eng.nodes[target].run_batch(reqs)
        stats = [eng.end_step(plan)
                 for eng, plan in zip(self.engines, plans)]
        assert len({eng.frame for eng in self.engines}) == 1, \
            "cluster cells fell out of lock-step"
        return stats

    def _execute_stacked(self, plans: List[Dict[int, List[Request]]]) -> None:
        """Advance every planned request in ONE ``run_batch`` per service —
        the whole fleet's (cell, node) groups stacked into a single device
        call per service."""
        groups: Dict[int, tuple] = {}
        for eng, plan in zip(self.engines, plans):
            for target, reqs in plan.items():
                cost = eng.nodes[target].spec.exec_cost
                for req in reqs:
                    reqs_s, costs_s = groups.setdefault(req.service, ([], []))
                    reqs_s.append(req)
                    costs_s.append(cost)
        for service in sorted(groups):
            reqs, costs = groups[service]
            svc = self.services[service]
            if hasattr(svc, "run_batch"):
                states, qualities = svc.run_batch(
                    [r.state for r in reqs],
                    np.asarray([r.blocks_done for r in reqs], dtype=int))
                apply_block_results(reqs, states, qualities, costs)
            else:
                block_fn = self._block_fns[service]
                for req, cost in zip(reqs, costs):
                    state, quality = block_fn(req.state, req.blocks_done)
                    apply_block_results([req], [state], [quality], [cost])

    # -- aggregate -------------------------------------------------------------

    def summary(self, frames: int) -> Dict[str, object]:
        per_cell = [eng.summary(frames) for eng in self.engines]
        done = [r for eng in self.engines for r in eng.completed]
        lat = [r.delivered_frame - r.arrival_frame + 1 for r in done]
        out = {
            "cells": self.num_cells,
            "frames": frames,
            "completed": len(done),
            "mean_quality": float(np.mean([r.quality for r in done]))
            if done else 0.0,
            "mean_latency_frames": float(np.mean(lat)) if lat else 0.0,
            "p95_latency_frames": float(np.percentile(lat, 95)) if lat
            else 0.0,
            "objective": float(sum(c["objective"] for c in per_cell)),
            "handovers": self.handovers_applied,
            "handover_cost": float(sum(r.handover_cost for r in done)),
            # fleet resilience totals (all zero on a healthy run)
            "goodput": int(sum(c["goodput"] for c in per_cell)),
            "drops": int(sum(c["drops"] for c in per_cell)),
            "retries": int(sum(c["retries"] for c in per_cell)),
            "deadline_misses": int(sum(c["deadline_misses"]
                                       for c in per_cell)),
            "failovers": int(sum(c["failovers"] for c in per_cell)),
            "throttled": int(sum(c["throttled"] for c in per_cell)),
            "per_cell": per_cell,
        }
        out.update(latency_summary(lat))
        if self.tracer is not None:
            # fleet-wide which-leg-dominates rollup (every completed rid —
            # cells share one tracer); only present with tracing on
            out["critical_path"] = self.tracer.critical_path_report(
                {r.rid for r in done})
        return out


# -- deployment helpers --------------------------------------------------------

def cluster_from_scenario(cfg: SimConfig, num_cells: int,
                          services: Dict[int, object], *,
                          policy_factory: Optional[Callable[[int], object]]
                          = None,
                          engine_cfg: Optional[EngineConfig] = None,
                          world: Optional[Dict[str, np.ndarray]] = None,
                          early_exit: bool = True, stacked: bool = True,
                          handover_cost: float = 0.4,
                          telemetry: Optional[TelemetryLog] = None,
                          ledger: Optional[TransferLedger] = None,
                          mesh=None, batch_axis: str = "batch",
                          recovery=None, sched=None,
                          tracing: bool = False,
                          tracer: Optional[Tracer] = None) -> ClusterEngine:
    """Build a C-cell fleet for one named scenario.

    Every cell replicates the scenario's Table II world (same nodes, same
    Y_hat) and shares the SAME service instances — sharing is what lets the
    cluster stack all cells' batches into one device call per service.
    ``policy_factory(cell) -> repro_torch.core.policy.Policy`` gives each cell its
    own bridged policy (per-cell :class:`ServingPolicy` instances are
    stateful — histories and PoA streams must not be shared); ``None``
    leaves the engine's default locality-greedy placement.

    ``mesh`` shards the stacked fleet batch across devices: build the
    shared services with the SAME mesh (``make_gdm_services(mesh=...)``) so
    their device calls split the batch over its devices; the cluster
    itself only adds the cell→device map and cross-shard transfer
    accounting.

    ``recovery`` (a :class:`repro_torch.serving.engine.RecoveryConfig`) arms
    every cell's failure-recovery machinery; ``None`` (the default) keeps
    the pre-fault behaviour exactly.

    ``sched`` (a :class:`repro_torch.serving.scheduler.SchedulerConfig`) is
    attached to every cell via
    :func:`repro_torch.serving.scheduler.attach_scheduler`; pair it with
    ``engine_cfg.scheduling == "continuous"`` to opt into the
    iteration-level scheduler.

    ``tracing=True`` (or an explicit ``tracer``) attaches ONE shared
    :class:`repro_torch.serving.tracing.Tracer` to every cell — cross-cell
    requests keep a single span tree — and instruments the shared services'
    device calls into its metrics registry.  Pure observation: the run
    stays frame-for-frame identical (``tests/test_tracing.py``).
    """
    if tracer is None and (tracing
                           or (engine_cfg is not None and engine_cfg.tracing)):
        tracer = Tracer()
    if tracer is not None:
        for svc in services.values():
            instrument = getattr(svc, "instrument", None)
            if instrument is not None:
                instrument(tracer.metrics)
    engines = []
    for c in range(num_cells):
        engine, world = engine_from_scenario(
            cfg, services, engine_cfg=engine_cfg, world=world,
            early_exit=early_exit, recovery=recovery, tracer=tracer)
        engine.cell_id = c
        engine.telemetry = telemetry
        engine.ledger = ledger
        if policy_factory is not None:
            engine.placement_fn = ServingPolicy(policy_factory(c), cfg,
                                                world=world)
        engines.append(engine)
    cluster = ClusterEngine(engines, services, stacked=stacked,
                            handover_cost=handover_cost, ledger=ledger,
                            mesh=mesh, batch_axis=batch_axis, tracer=tracer)
    if sched is not None:
        from repro_torch.serving.scheduler import attach_scheduler
        attach_scheduler(cluster, sched)
    return cluster


def serve_fleet(cluster: ClusterEngine, fleet, services: Dict[int, object],
                *, seed: int = 0, collect_steps: bool = False,
                faults=None) -> Dict[str, object]:
    """Drive a :class:`repro_torch.sim.workloads.FleetTrace` through a fleet.

    Per frame and per cell: feed the frame's fault state (``faults``, a
    :class:`repro_torch.sim.faults.FaultTrace` — omitted or ``"none"`` leaves the
    engines untouched), feed the PoA stream (admission + downlink + bridge
    observation), apply the frame's feasible handover candidates, submit
    idle-gated arrivals (the single-cell ``serve_trace`` semantics, with
    fleet-unique request ids), then run ONE cluster quantum.  Returns the
    fleet summary plus submission counts (and the per-frame per-cell step
    stats when ``collect_steps`` — the cell-equivalence harness reads
    those).

    With ``EngineConfig.scheduling = "continuous"`` the fleet runs under
    the iteration-level scheduler instead
    (:func:`repro_torch.serving.scheduler.serve_fleet_continuous`): same
    submission rule and bookkeeping, but the lockstep cell loop becomes a
    step-ordered event heap with per-cell quantum skew and requests
    join/leave the in-flight batch at every block step.
    """
    if cluster.engines[0].cfg.scheduling == "continuous":
        from repro_torch.serving.scheduler import serve_fleet_continuous
        return serve_fleet_continuous(cluster, fleet, services, seed=seed,
                                      collect_steps=collect_steps,
                                      faults=faults)
    cfg = fleet.cfg
    u = cfg.num_ues
    c_n = cluster.num_cells
    assert len(fleet.cells) == c_n, \
        f"fleet trace has {len(fleet.cells)} cells, cluster has {c_n}"
    if faults is not None:
        assert faults.num_cells == c_n, \
            f"fault trace has {faults.num_cells} cells, cluster has {c_n}"
        assert faults.frames >= fleet.frames, \
            f"fault trace covers {faults.frames} frames, fleet needs " \
            f"{fleet.frames}"
    rngs = [np.random.default_rng((seed, c)) for c in range(c_n)]
    outstanding = np.zeros((c_n, u), dtype=bool)
    cursors = [0] * c_n
    fail_cursors = [0] * c_n
    rid = 0
    steps: List[List[Dict[str, float]]] = []
    by_frame: Dict[int, List] = {}
    for frame, ue, src, dst in np.asarray(fleet.handovers).reshape(-1, 4):
        by_frame.setdefault(int(frame), []).append((int(ue), int(src),
                                                    int(dst)))
    for t in range(fleet.frames):
        if faults is not None:
            cluster.apply_faults(faults, t)
        for c, eng in enumerate(cluster.engines):
            eng.set_poa(fleet.cells[c].poa[t])
            update_poa = getattr(eng.placement_fn, "update_poa", None)
            if update_poa is not None:
                update_poa(fleet.cells[c].poa[t])
        events = [HandoverEvent(ue, src, dst,
                                int(fleet.cells[dst].poa[t, ue]))
                  for ue, src, dst in by_frame.get(t, ())]
        for ev in cluster.apply_handovers(events):
            outstanding[ev.src_cell, ev.ue] = False
            outstanding[ev.dst_cell, ev.ue] = True
        for c in range(c_n):
            # the SAME submission rule as single-cell serve_trace
            # (outstanding[c] is a row view: idle gating mutates in place)
            rid = submit_arrivals(cluster.engines[c], fleet.cells[c], t,
                                  outstanding[c], services, rngs[c], rid)
        stats = cluster.step()
        if collect_steps:
            steps.append(stats)
        for c, eng in enumerate(cluster.engines):
            for req in eng.completed[cursors[c]:]:
                if req.ue >= 0:
                    outstanding[c, req.ue] = False
            cursors[c] = len(eng.completed)
            # terminal failures free the UE slot too — otherwise a single
            # drop would silence that UE's traffic for the rest of the run
            for req in eng.failed[fail_cursors[c]:]:
                if req.ue >= 0:
                    outstanding[c, req.ue] = False
            fail_cursors[c] = len(eng.failed)
    out = cluster.summary(fleet.frames)
    out["submitted"] = rid
    out["satisfied"] = sum(r.quality >= r.quality_threshold
                           for eng in cluster.engines
                           for r in eng.completed)
    if collect_steps:
        out["steps"] = steps
    return out
