"""Iteration-level (continuous-batching) scheduler for the denoise fleet.

Carried copy of ``repro.serving.scheduler``, pinned to it by
``tests/test_torch_fleet.py``.

The quantum engine advances every placed request by exactly ONE block per
scheduling quantum and every cell shares one global clock — a request
admitted mid-quantum idles until the next boundary, and a cell's stacked
batch is frozen for the full quantum even as requests complete early.
This module is the vLLM-style fix, scheduling at the denoise-block step:

* **Join/leave per block step.**  :func:`continuous_step` drives one
  quantum as a sequence of block steps (``SchedulerConfig.steps_per_quantum``,
  default the chain length): completed/failed samples vacate their batch
  slot at the step they finish, newly admitted requests join at the next
  step (``ServingEngine._admit(fresh=False)`` — the C admission channels
  and the W_hat block budget stay per-QUANTUM, shared across steps, so a
  continuous quantum never admits or executes more than the reference).
  Under backlog a request can run several blocks within one quantum
  (run-to-completion in priority order) — the SRPT-flavoured discipline
  that cuts p95 latency versus the one-block-per-quantum round-robin.
* **Per-cell quantum skew.**  :func:`serve_fleet_continuous` drains a
  step-ordered event heap instead of the lockstep cell loop: cell ``c``
  runs its quanta at times ``t + skew * c / C``, so cells no longer share
  one global barrier.  Telemetry events carry the skewed timestamp
  (``QuantumEvent.time``).  Cells with equal phase group into one stacked
  quantum — ``skew=0`` degenerates to the lockstep fleet clock, and the
  stacked per-service device call is preserved within each group.
* **Backpressure admission.**  ``backpressure_depth > 0`` arms a
  per-service live cap inside ``ServingEngine._admit`` that throttles
  admission BEFORE the retry/backoff machinery charges a denial; requests
  older than ``starvation_age`` quanta bypass the throttle.
* **Sub-quantum arrivals.**  With ``sub_quantum_arrivals`` and a trace
  carrying ``arrival_offset``, a frame's arrivals are submitted at the
  block step matching their offset instead of all at the boundary.

**The synchronous path stays the reference:** continuous mode is opt-in
via ``EngineConfig.scheduling = "continuous"``, and with join/leave and
skew disabled (``SchedulerConfig(join_leave=False)``) the scheduler runs
exactly one plan/finish step per quantum — structurally the same calls as
the quantum engine — and is pinned frame-for-frame to it (steps,
summaries, telemetry JSON, ledger events) by ``tests/test_scheduler.py``,
across default / greedy-bridge / learned-bridge placement and under fault
traces: the same standing-invariant pattern as zero-fault equivalence.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import ServingEngine, apply_block_results


@dataclasses.dataclass
class SchedulerConfig:
    """Knobs of the iteration-level scheduler (attach via
    :func:`attach_scheduler` or ``engine.sched_cfg``).  The defaults arm
    the full continuous behaviour; ``join_leave=False`` with ``skew=0``
    is *sync mode* — pinned frame-for-frame to the quantum engine."""
    steps_per_quantum: int = 0       # block steps per quantum; 0 = chain length
    join_leave: bool = True          # join/leave the batch between steps
    skew: float = 0.0                # cell c quantum phase: skew * c / C
    backpressure_depth: float = 0.0  # per-service live cap as a fraction of
    #                                  fleet capacity; 0 disables throttling
    starvation_age: int = 4          # quanta after which a pending request
    #                                  bypasses the backpressure throttle
    sub_quantum_arrivals: bool = False   # honour RequestTrace.arrival_offset

    def __post_init__(self):
        assert self.steps_per_quantum >= 0
        assert 0.0 <= self.skew < 1.0, "skew is a fraction of one quantum"
        assert self.backpressure_depth >= 0.0
        assert self.starvation_age >= 1

    @property
    def sync_mode(self) -> bool:
        """True when the scheduler is pinned to the quantum engine."""
        return not self.join_leave and self.skew == 0.0


def quantum_steps(engine: ServingEngine,
                  sched: SchedulerConfig) -> int:
    """Block steps one continuous quantum runs: 1 in sync mode (join/leave
    off ⇒ nothing can change between steps), else ``steps_per_quantum``
    (0 = the chain length, so a lone request can finish in one quantum)."""
    if not sched.join_leave:
        return 1
    return sched.steps_per_quantum or engine.cfg.max_blocks


def attach_scheduler(engines, sched: Optional[SchedulerConfig] = None
                     ) -> SchedulerConfig:
    """Attach one :class:`SchedulerConfig` to every engine (a
    :class:`~repro_torch.serving.cluster.ClusterEngine` or a list/single
    :class:`ServingEngine`); returns the attached config."""
    sched = sched or SchedulerConfig()
    if hasattr(engines, "engines"):
        engines = engines.engines
    elif isinstance(engines, ServingEngine):
        engines = [engines]
    for eng in engines:
        eng.sched_cfg = sched
    return sched


# -- one continuous quantum, standalone engine ---------------------------------

def continuous_step(engine: ServingEngine) -> Dict[str, float]:
    """One continuous quantum for a standalone engine (what
    ``ServingEngine.step`` dispatches to when ``cfg.scheduling ==
    "continuous"``).  Per block step: mid-quantum admission (join), one
    placement pass, execution, then delivery (leave) — stopping early once
    a step plans and delivers nothing."""
    sched = engine.sched_cfg or SchedulerConfig()
    steps = quantum_steps(engine, sched)
    engine.begin_quantum()
    for s in range(steps):
        if s > 0:
            engine._admit(fresh=False)           # joins: budget carries over
        assigned = engine.plan_step(final=s == 0)
        if s > 0 and not assigned and not engine._step_scratch:
            engine._q_steps -= 1                 # idle probe: not a step
            engine._step_scratch = None
            break
        for target, reqs in assigned.items():
            engine.nodes[target].run_batch(reqs)
        engine.finish_step(assigned)
    return engine.end_quantum()


# -- fleet driver: event-heap clock with per-cell skew -------------------------

def _execute_step(cluster, pairs: List[Tuple[ServingEngine, Dict]],
                  use_slots: bool) -> None:
    """Advance one block step's plans — the whole group's (cell, node)
    batches stacked into one device call per service, like
    ``ClusterEngine._execute_stacked``, but routed through the services'
    slot-resident batches (``slot_batch``) when the scheduler is in
    join/leave mode, so continuing requests are not restaged every step."""
    if not cluster.stacked:
        for eng, plan in pairs:
            for target, reqs in plan.items():
                eng.nodes[target].run_batch(reqs)
        return
    groups: Dict[int, tuple] = {}
    for eng, plan in pairs:
        for target, reqs in plan.items():
            cost = eng.nodes[target].spec.exec_cost
            for req in reqs:
                reqs_s, costs_s = groups.setdefault(req.service, ([], []))
                reqs_s.append(req)
                costs_s.append(cost)
    if cluster.tracer is not None:
        # stacked batch size per step into the metrics registry (how full
        # the fused device call runs under continuous scheduling)
        cluster.tracer.metrics.histogram("fleet_step_batch_rows").observe(
            sum(len(reqs) for _, plan in pairs for reqs in plan.values()))
    for service in sorted(groups):
        reqs, costs = groups[service]
        svc = cluster.services[service]
        slot_batch = getattr(svc, "slot_batch", None) if use_slots else None
        if slot_batch is not None:
            states, qualities = slot_batch().step(
                [(r.rid, r.state, r.blocks_done) for r in reqs])
            apply_block_results(reqs, states, qualities, costs)
        elif hasattr(svc, "run_batch"):
            states, qualities = svc.run_batch(
                [r.state for r in reqs],
                np.asarray([r.blocks_done for r in reqs], dtype=int))
            apply_block_results(reqs, states, qualities, costs)
        else:
            block_fn = cluster._block_fns[service]
            for req, cost in zip(reqs, costs):
                state, quality = block_fn(req.state, req.blocks_done)
                apply_block_results([req], [state], [quality], [cost])


def serve_fleet_continuous(cluster, fleet, services: Dict[int, object], *,
                           seed: int = 0, collect_steps: bool = False,
                           faults=None) -> Dict[str, object]:
    """Drive a :class:`repro_torch.sim.workloads.FleetTrace` through a fleet
    under the iteration-level scheduler (the continuous-mode twin of
    :func:`repro_torch.serving.cluster.serve_fleet` — same submission rule, same
    per-cell rng streams, same bookkeeping).

    The fleet clock is a step-ordered event heap of ``(frame, phase,
    cell)`` entries: cell ``c`` runs quantum ``t`` at time ``t + phase_c``
    with ``phase_c = skew * c / C``.  Cells with equal phase pop as one
    group and execute their block steps stacked (one device call per
    service per step); with ``skew = 0`` every quantum is one fleet-wide
    group popped in cell order — exactly the lockstep cadence.  Handover
    candidates for frame ``t`` apply at the FIRST event of frame ``t``
    (all phases < 1, so every cell is then exactly at frame ``t`` — the
    lockstep application point), and they move pending as well as active
    requests (:meth:`ClusterEngine._apply_handover`).
    """
    from repro_torch.serving.cluster import HandoverEvent
    from repro_torch.serving.policy_bridge import submit_arrivals

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
    engines = cluster.engines
    scheds = [eng.sched_cfg or SchedulerConfig() for eng in engines]
    use_slots = all(sc.join_leave for sc in scheds)
    for c, (eng, sc) in enumerate(zip(engines, scheds)):
        eng.skew = sc.skew * c / c_n if c_n > 1 else 0.0
    rngs = [np.random.default_rng((seed, c)) for c in range(c_n)]
    outstanding = np.zeros((c_n, u), dtype=bool)
    cursors = [0] * c_n
    fail_cursors = [0] * c_n
    rid = 0
    steps: List[List[Optional[Dict[str, float]]]] = \
        [[None] * c_n for _ in range(fleet.frames)]
    by_frame: Dict[int, List] = {}
    for frame, ue, src, dst in np.asarray(fleet.handovers).reshape(-1, 4):
        by_frame.setdefault(int(frame), []).append((int(ue), int(src),
                                                    int(dst)))
    handover_done: set = set()
    heap = [(0, engines[c].skew, c) for c in range(c_n)]
    heapq.heapify(heap)
    while heap:
        t, phase = heap[0][0], heap[0][1]
        group: List[int] = []
        while heap and heap[0][0] == t and heap[0][1] == phase:
            group.append(heapq.heappop(heap)[2])     # pops in cell order

        if faults is not None:
            for c in group:
                node_up, cap_scale, link_scale = faults.cell_state(t, c)
                engines[c].set_fault_state(node_up, cap_scale=cap_scale,
                                           link_scale=link_scale)
        for c in group:
            eng = engines[c]
            eng.set_poa(fleet.cells[c].poa[t])
            update_poa = getattr(eng.placement_fn, "update_poa", None)
            if update_poa is not None:
                update_poa(fleet.cells[c].poa[t])
        if t not in handover_done:
            handover_done.add(t)
            events = [HandoverEvent(ue, src, dst,
                                    int(fleet.cells[dst].poa[t, ue]))
                      for ue, src, dst in by_frame.get(t, ())]
            for ev in cluster.apply_handovers(events):
                outstanding[ev.src_cell, ev.ue] = False
                outstanding[ev.dst_cell, ev.ue] = True

        # arrivals: boundary arrivals now; with sub-quantum offsets, the
        # rest are submitted at the block step matching their offset
        steps_of = {c: quantum_steps(engines[c], scheds[c]) for c in group}
        step_of_ue: Dict[int, np.ndarray] = {}
        for c in group:
            sc = scheds[c]
            off = getattr(fleet.cells[c], "arrival_offset", None)
            if sc.sub_quantum_arrivals and sc.join_leave and off is not None:
                step_of_ue[c] = np.minimum(
                    (off[t] * steps_of[c]).astype(int), steps_of[c] - 1)
                rid = submit_arrivals(engines[c], fleet.cells[c], t,
                                      outstanding[c], services, rngs[c],
                                      rid, ues=step_of_ue[c] == 0)
            else:
                rid = submit_arrivals(engines[c], fleet.cells[c], t,
                                      outstanding[c], services, rngs[c], rid)

        # the grouped continuous quantum
        live = dict.fromkeys(group, True)
        sub_next = dict.fromkeys(step_of_ue, 1)      # first unsubmitted step
        for c in group:
            engines[c].begin_quantum()
        for s in range(max(steps_of.values())):
            pairs: List[Tuple[ServingEngine, Dict]] = []
            for c in group:
                if not live[c] or s >= steps_of[c]:
                    continue
                eng = engines[c]
                if s > 0:
                    if c in step_of_ue:
                        rid = submit_arrivals(eng, fleet.cells[c], t,
                                              outstanding[c], services,
                                              rngs[c], rid,
                                              ues=step_of_ue[c] == s)
                        sub_next[c] = s + 1
                    eng._admit(fresh=False)
                assigned = eng.plan_step(final=s == 0)
                if s > 0 and not assigned and not eng._step_scratch:
                    eng._q_steps -= 1                # idle probe: not a step
                    eng._step_scratch = None
                    live[c] = False
                    continue
                pairs.append((eng, assigned))
            if not pairs:
                break
            _execute_step(cluster, pairs, use_slots)
            for eng, assigned in pairs:
                eng.finish_step(assigned)

        # flush: arrivals whose offset maps to a block step the cell never
        # reached (idle probe / early break) still enter the pending queue
        # this frame — they just wait for the next quantum's admission, like
        # a boundary arrival.  Without this they would be lost entirely.
        for c, nxt in sub_next.items():
            if nxt < steps_of[c]:
                rid = submit_arrivals(engines[c], fleet.cells[c], t,
                                      outstanding[c], services, rngs[c],
                                      rid, ues=step_of_ue[c] >= nxt)

        for c in group:
            stats = engines[c].end_quantum()
            steps[t][c] = stats
            eng = engines[c]
            for req in eng.completed[cursors[c]:]:
                if req.ue >= 0:
                    outstanding[c, req.ue] = False
            cursors[c] = len(eng.completed)
            for req in eng.failed[fail_cursors[c]:]:
                if req.ue >= 0:
                    outstanding[c, req.ue] = False
            fail_cursors[c] = len(eng.failed)
            if t + 1 < fleet.frames:
                heapq.heappush(heap, (t + 1, eng.skew, c))

    out = cluster.summary(fleet.frames)
    out["submitted"] = rid
    out["satisfied"] = sum(r.quality >= r.quality_threshold
                           for eng in engines for r in eng.completed)
    if collect_steps:
        out["steps"] = steps
    return out
