"""Serving engine: continuous batching + chain execution driven by the
paper's placement controller.

This is the production-level face of LEARN-GDM (DESIGN.md §2): requests for
iterative services (GDM denoising chains, LM decode) arrive at *nodes*
(stage groups of the mesh, the paper's BSs); admission follows the greedy
MAC priority rule (eq. in Algorithm 1 line 4 — closest-below-threshold
first, reinterpreted as admission slots); per scheduling quantum, the
placement engine decides which node executes each request's next block and
whether a chain early-exits (adaptive chain length on quality/latency).

The engine is deliberately backend-agnostic: ``NodeExecutor`` wraps the
block function for one node (here :class:`repro_torch.serving.gdm_service.
GDMService`, which runs the DiT on the card).

Carried copy of the reference engine (``repro.serving.engine``), pinned
frame for frame to it by ``tests/test_torch_serving.py``; its two lazy
imports, the fault-leg order and the continuous scheduler, come from the
port's copies of those modules.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_manager import TransferLedger, state_nbytes
from repro_torch.serving.telemetry import QuantumEvent, TelemetryLog
from repro_torch.serving.tracing import Tracer, latency_summary
from repro_torch.sim.faults import FAULT_LEGS


@dataclasses.dataclass
class Request:
    rid: int
    service: int
    arrival_frame: int
    quality_threshold: float
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # origin (the paper's UE): which UE slot issued the request and which
    # node (the UE's PoA at arrival) it entered the system at — the decision
    # seam maps requests back onto the sim's per-UE observation slots
    ue: int = -1
    origin: int = 0
    # chain progress
    blocks_done: int = 0
    node: int = -1                   # current executing node
    state: Any = None                # latent / KV state (the C9 payload)
    quality: float = 0.0
    done: bool = False
    delivered_frame: int = -1
    trans_cost: float = 0.0
    exec_cost: float = 0.0
    admitted: bool = False
    # C9 cost decomposition (trans_cost stays the running total): the
    # uplink hop (PoA -> first node), latent hops between nodes inside a
    # cell, cross-cell handover (repro.serving.cluster), and the delivery
    # leg (execution node -> UE PoA)
    uplink_cost: float = 0.0
    migration_cost: float = 0.0
    handover_cost: float = 0.0
    downlink_cost: float = 0.0
    # resilience (all inert at their defaults; see RecoveryConfig):
    # absolute deadline frame (-1 = none), terminal outcome ("completed" /
    # "deadline-shed" / "drop"), admission-retry backoff state, and the
    # failover trail — the dead node a latent is being re-placed from plus
    # its cumulative failover leg charge
    deadline: int = -1
    outcome: str = ""
    retries: int = 0
    next_retry_frame: int = 0
    failover_from: int = -1
    failovers: int = 0
    failover_cost: float = 0.0
    # effective chain cap after graceful degradation (-1 = full chain)
    degraded_to: int = -1


def apply_block_results(reqs: List[Request], states: List[Any],
                        qualities, exec_costs) -> None:
    """Write one executed block's results back onto ``reqs`` — shared by the
    per-node batch path (:meth:`NodeExecutor.run_batch`) and the cluster's
    cross-cell stacked execution, so both paths do identical bookkeeping."""
    for req, state, quality, cost in zip(reqs, states, qualities, exec_costs):
        req.state = state
        req.quality = float(quality)
        req.blocks_done += 1
        req.exec_cost += float(cost)


@dataclasses.dataclass
class NodeSpec:
    node_id: int
    capacity: int                    # blocks per quantum (paper W_hat)
    exec_cost: float                 # eps_n


class NodeExecutor:
    """Executes chain blocks of the services hosted on one node.

    ``block_fns[service]``: callable(request_state, block_idx) -> (state,
    quality) — supplied by the model layer (GDM denoise block / LM decode
    quantum).  ``batch_fns[service]`` (optional): callable(states, block_idxs)
    -> (states, qualities) advancing a whole stacked batch in ONE call — the
    engine routes every request scheduled on this node in a quantum through
    it (one jitted call per (node, service, quantum) instead of a Python
    loop)."""

    def __init__(self, spec: NodeSpec,
                 block_fns: Dict[int, Callable[[Any, int], Tuple[Any, float]]],
                 batch_fns: Optional[Dict[int, Callable]] = None):
        self.spec = spec
        self.block_fns = block_fns
        self.batch_fns = batch_fns or {}

    def run_block(self, req: Request) -> None:
        state, quality = self.block_fns[req.service](req.state, req.blocks_done)
        req.state = state
        req.quality = float(quality)
        req.blocks_done += 1
        req.exec_cost += self.spec.exec_cost

    def run_batch(self, reqs: List[Request]) -> None:
        """Execute one block for every request in ``reqs`` (all scheduled on
        this node this quantum).  Requests whose service provides a batch
        entry point are stacked and advanced in one call per service; the
        rest fall back to per-request :meth:`run_block`."""
        by_service: Dict[int, List[Request]] = {}
        for req in reqs:
            by_service.setdefault(req.service, []).append(req)
        for service, group in by_service.items():
            batch_fn = self.batch_fns.get(service)
            if batch_fn is None or len(group) == 0:
                for req in group:
                    self.run_block(req)
                continue
            states, qualities = batch_fn(
                [r.state for r in group],
                np.asarray([r.blocks_done for r in group], dtype=int))
            apply_block_results(group, states, qualities,
                                [self.spec.exec_cost] * len(group))


@dataclasses.dataclass
class EngineConfig:
    max_blocks: int = 4
    admission_slots: int = 2         # the paper's C channels per quantum/node
    alpha: float = 0.1
    beta: float = 0.1
    early_exit: bool = True          # adaptive chain length
    charge_downlink: bool = True     # C9 last leg: execution node -> UE PoA
    seed: int = 0
    # "quantum": one placement pass + one block per request per quantum (the
    # reference engine).  "continuous": the iteration-level scheduler in
    # repro.serving.scheduler drives the quantum as a sequence of block
    # steps (join/leave, per-cell skew, backpressure admission) — with those
    # knobs disabled it is pinned frame-for-frame to the quantum engine.
    scheduling: str = "quantum"
    # opt-in request-level tracing (repro_torch.serving.tracing.Tracer): strictly
    # pure observation — a tracing run is pinned frame-for-frame to a
    # tracing-off run (tests/test_tracing.py), like the zero-fault pin
    tracing: bool = False

    def __post_init__(self):
        assert self.scheduling in ("quantum", "continuous"), \
            f"unknown scheduling mode {self.scheduling!r}"


@dataclasses.dataclass
class RecoveryConfig:
    """Failure-recovery policy for an engine (opt-in: an engine built
    without one behaves exactly like the pre-fault engine, faults or not).

    ``mode``:

    * ``"drop"``     — an in-flight request on a failed node is final-dropped
      (the drop-only baseline ``benchmarks/bench_resilience.py`` measures
      against);
    * ``"failover"`` — the latent is re-placed from the last completed
      block onto a surviving node, charged as a ``"failover"`` transfer leg.

    ``deadline_frames`` (> 0) stamps every submitted request with an
    absolute deadline ``arrival_frame + deadline_frames``; requests that
    can no longer deliver in time are shed (outcome ``"deadline-shed"``)
    instead of burning blocks.  Admission-denied requests retry under
    capped exponential backoff (``base * 2**retries`` quanta, capped) —
    with ``base=1`` the first retry lands the next quantum, exactly the
    pre-backoff cadence.  ``degrade=True`` turns on the graceful-degradation
    controller: under failure- or backpressure-induced load (demand /
    surviving capacity above ``degrade_pressure``) the remaining chain
    length of deadline-carrying requests is cut (the paper's step-reduction
    knob), converting quality margin into deadline compliance.
    """
    mode: str = "failover"           # "drop" | "failover"
    deadline_frames: int = 0         # relative deadline at submit; 0 = none
    retry_backoff_base: int = 1      # quanta before retry k is 2**k * base
    retry_backoff_cap: int = 8       # max backoff delay in quanta
    degrade: bool = False
    degrade_pressure: float = 1.0    # demand/capacity ratio arming the cut

    def __post_init__(self):
        assert self.mode in ("drop", "failover"), \
            f"unknown recovery mode {self.mode!r}"
        assert self.retry_backoff_base >= 1 and self.retry_backoff_cap >= 1


class ServingEngine:
    """Continuous-batching chain scheduler over heterogeneous nodes.

    One engine is one *cell* of the fleet: ``cell_id`` tags its telemetry
    events, an optional :class:`~repro_torch.serving.kv_manager.TransferLedger`
    records every charged C9 leg, and an optional
    :class:`~repro_torch.serving.telemetry.TelemetryLog` receives one
    :class:`~repro_torch.serving.telemetry.QuantumEvent` per quantum.  The
    scheduling quantum is split into :meth:`begin_step` (admission +
    placement + transmission charging) and :meth:`end_step` (delivery +
    accounting) around the block execution, so a
    :class:`~repro.serving.cluster.ClusterEngine` can stack the execution of
    many cells into one device call per service; :meth:`step` composes the
    three for standalone use and is behaviour-identical to the former
    monolithic quantum.
    """

    def __init__(self, nodes: List[NodeExecutor], cfg: EngineConfig,
                 trans_cost: np.ndarray,
                 placement_fn: Optional[Callable] = None, *,
                 cell_id: int = 0, ledger: Optional[TransferLedger] = None,
                 telemetry: Optional[TelemetryLog] = None,
                 recovery: Optional[RecoveryConfig] = None,
                 tracer: Optional[Tracer] = None):
        self.nodes = nodes
        self.cfg = cfg
        self.y_hat = trans_cost                     # (N, N) node-to-node cost
        self.placement_fn = placement_fn or self._default_placement
        self.pending: deque = deque()
        self.active: List[Request] = []
        self.completed: List[Request] = []
        self.frame = 0
        # loads of the LAST quantum — the "W_n / W_hat_n" term of the sim
        # observation (eq. 7 uses the previous frame's loads there too)
        self.prev_loads = np.zeros(len(nodes), dtype=int)
        self.cell_id = cell_id
        self.ledger = ledger
        self.telemetry = telemetry
        # request-level tracer (repro_torch.serving.tracing): a fleet shares ONE
        # tracer (cluster_from_scenario passes it in) so cross-cell requests
        # keep a single span tree; a standalone engine with cfg.tracing set
        # creates its own.  Every hook below is guarded and pure observation.
        self.tracer = tracer if tracer is not None else (
            Tracer() if cfg.tracing else None)
        self.ue_poa: Optional[np.ndarray] = None    # UE -> PoA node stream
        self._last_admitted = 0
        self._last_dropped = 0
        self._denied_once: set = set()              # rids counted as dropped
        # C9 costs charged THIS quantum (reset after the telemetry event);
        # the cluster adds cross-cell handover charges here too
        self._legs_quantum = {"uplink": 0.0, "migration": 0.0,
                              "handover": 0.0, "downlink": 0.0,
                              "failover": 0.0}
        # continuous-scheduling hooks (inert in quantum mode): the
        # iteration-level scheduler attaches its config here, and ``skew``
        # is this cell's quantum phase offset (stamped on telemetry events)
        self.sched_cfg = None                       # SchedulerConfig | None
        self.skew = 0.0
        # per-quantum scratch shared by the phase methods (begin_quantum /
        # plan_step / finish_step / end_quantum); quantum mode runs exactly
        # one plan/finish step per quantum, continuous mode several
        self._q_loads = np.zeros(len(nodes), dtype=int)
        self._q_exec = 0.0
        self._q_trans = 0.0
        self._q_delivered: List[Request] = []
        self._q_steps = 0
        self._q_planned = 0                         # blocks planned (occupancy)
        self._admit_node_taken = np.zeros(len(nodes), dtype=int)
        self._step_scratch: Optional[List[Request]] = None
        # -- fault state (fed per quantum via set_fault_state; the healthy
        # defaults keep EVERY fault/recovery branch below strictly inert, so
        # the zero-fault path is frame-for-frame the pre-fault engine)
        self.recovery = recovery
        n = len(nodes)
        self._spec_caps = np.asarray([x.spec.capacity for x in nodes])
        self._node_up = np.ones(n, dtype=bool)
        self._caps_q = self._spec_caps              # this quantum's effective
        self._link_scale: Dict[str, float] = {}
        self._fault_active = False
        # terminal failures + lifetime counters (surfaced by summary())
        self.failed: List[Request] = []
        self.failovers_total = 0
        self.retries_total = 0
        self.deadline_misses_total = 0
        self.drops_total = 0
        # per-quantum counters for the telemetry event
        self._q_failovers = 0
        self._q_retries = 0
        self._q_deadline_misses = 0
        self._q_drops = 0
        # continuous-batching telemetry (schema v3): requests joining /
        # leaving the in-flight batch this quantum, admission throttles
        # under backpressure, and the rids currently holding a batch slot
        self.throttled_total = 0
        self._q_joins = 0
        self._q_leaves = 0
        self._q_throttled = 0
        self._batch_rids: set = set()

    # -- request lifecycle -----------------------------------------------------

    def submit(self, req: Request) -> None:
        req.arrival_frame = self.frame
        if self.recovery is not None and self.recovery.deadline_frames > 0 \
                and req.deadline < 0:
            req.deadline = self.frame + self.recovery.deadline_frames
        self.pending.append(req)
        if self.tracer is not None:
            self.tracer.on_submit(req.rid, req.ue, req.service, self.cell_id,
                                  self.frame)

    def set_fault_state(self, node_up=None, *, cap_scale=None,
                        link_scale=None) -> None:
        """Feed this quantum's fault state (one row of a
        :class:`repro.sim.faults.FaultTrace`, via ``cell_state``).

        ``node_up``: (N,) bool — dead nodes are masked out of placement and
        admission, and their in-flight requests fail over or drop per the
        engine's :class:`RecoveryConfig`.  ``cap_scale``: (N,) straggler
        capacity multipliers in (0, 1].  ``link_scale``: per-leg cost
        multipliers — a mapping, or an array in
        :data:`repro_torch.sim.faults.FAULT_LEGS` order.  All-healthy input makes
        every fault branch a no-op (the zero-fault pin)."""
        n = len(self.nodes)
        self._node_up = np.ones(n, dtype=bool) if node_up is None \
            else np.asarray(node_up, dtype=bool).copy()
        assert self._node_up.shape == (n,)
        caps = self._spec_caps
        if cap_scale is not None:
            scale = np.asarray(cap_scale, dtype=float)
            assert scale.shape == (n,)
            if (scale != 1.0).any():
                # a straggler still makes progress: ceil keeps >= 1 block
                caps = np.ceil(caps * scale).astype(int)
        self._caps_q = np.where(self._node_up, caps, 0)
        if link_scale is None:
            self._link_scale = {}
        elif isinstance(link_scale, dict):
            self._link_scale = {k: float(v) for k, v in link_scale.items()
                                if float(v) != 1.0}
        else:
            self._link_scale = {
                leg: float(s) for leg, s in zip(FAULT_LEGS, link_scale)
                if float(s) != 1.0}
        self._fault_active = (not self._node_up.all()
                              or caps is not self._spec_caps
                              or bool(self._link_scale))

    def set_poa(self, poa: np.ndarray) -> None:
        """Feed the UEs' current PoAs (the trace's mobility stream).  Used
        for per-node admission (a pending UE competes for its CURRENT cell's
        uplink slots, like the sim's per-BS MAC) and for the downlink
        delivery leg; without it both fall back to each request's arrival
        origin."""
        self.ue_poa = np.asarray(poa, dtype=int)

    def _entry_node(self, req: Request) -> int:
        if self.ue_poa is not None and 0 <= req.ue < len(self.ue_poa):
            return int(self.ue_poa[req.ue])
        return req.origin

    def _charge(self, req: Request, kind: str, src: int, dst: int,
                cost: float) -> None:
        """Charge one C9 transmission leg + record it in the ledger."""
        if self._fault_active and kind in self._link_scale:
            cost = cost * self._link_scale[kind]    # degraded link
        req.trans_cost += cost
        setattr(req, f"{kind}_cost", getattr(req, f"{kind}_cost") + cost)
        self._legs_quantum[kind] += cost
        if self.ledger is not None or self.tracer is not None:
            nbytes = state_nbytes(req.state)     # walk the payload ONCE
            if self.ledger is not None:
                self.ledger.record(self.frame, req.rid, kind, src, dst,
                                   nbytes, cost)
            if self.tracer is not None:
                self.tracer.on_transfer(req.rid, kind, src, dst, nbytes,
                                        cost, self.frame, self.cell_id)

    @staticmethod
    def _priority(req: Request) -> float:
        """Algorithm 1 line 4: max{1/(Qbar - Q), 1e-8} — matching
        ``EdgeSimulator._priorities``.  Already-satisfied requests
        (Q >= Qbar) fall to the floor priority instead of the former
        1/max(Qbar-Q, 1e-12) -> ~1e12 blow-up that ranked them FIRST and
        let them keep consuming blocks."""
        diff = req.quality_threshold - req.quality
        return 1.0 / diff if diff > 0 else 1e-8

    def _admit(self, fresh: bool = True) -> None:
        """Greedy MAC as admission control: threshold-closest first, C slots
        per NODE — matching the sim's per-BS MAC (each UE competes for the C
        uplink channels of ITS current cell), not the former top C·N global
        cut.  A pending request enters at its UE's current PoA
        (``set_poa`` stream) or, without one, at its arrival origin.

        With a :class:`RecoveryConfig`, denied requests retry under capped
        exponential backoff (a request backing off skips the competition
        entirely) and a dead entry node denies its whole queue for the
        quantum; without one the pre-fault cadence is untouched.

        The continuous scheduler calls this again between block steps
        (mid-quantum joins): the per-node slot budget and the admitted /
        dropped counters accumulate across the quantum via engine state
        (``begin_quantum`` resets them), so a quantum never admits more than
        the C channels either way.  With a
        :class:`~repro.serving.scheduler.SchedulerConfig` attached and
        ``backpressure_depth > 0``, a per-service live cap throttles
        admission BEFORE the retry/backoff machinery — a throttled request
        stays pending with its backoff state untouched, and requests older
        than ``starvation_age`` quanta bypass the throttle (no starvation)."""
        if fresh:                     # quantum-opening call: new slot budget
            self._last_admitted = 0
            self._last_dropped = 0
            self._admit_node_taken[:] = 0
        if not self.pending:
            return
        rec = self.recovery
        slots = self.cfg.admission_slots
        sched = self.sched_cfg
        throttle = sched is not None and sched.backpressure_depth > 0
        if throttle:
            cap_total = max(int(self._caps_q.sum()), 1)
            live_by_svc: Dict[int, int] = {}
            for r in self.active:
                live_by_svc[r.service] = live_by_svc.get(r.service, 0) + 1
            n_svc = len({r.service for r in self.pending}
                        | set(live_by_svc)) or 1
            svc_cap = max(1, int(sched.backpressure_depth
                                 * cap_total / n_svc))
        candidates = sorted(self.pending, key=self._priority, reverse=True)
        taken = set()
        throttled = set()
        node_taken = self._admit_node_taken
        for req in candidates:
            if rec is not None and req.next_retry_frame > self.frame:
                continue                             # still backing off
            if throttle:
                age = self.frame - req.arrival_frame
                if live_by_svc.get(req.service, 0) >= svc_cap \
                        and age < sched.starvation_age:
                    self._q_throttled += 1
                    self.throttled_total += 1
                    throttled.add(id(req))
                    continue         # backpressure: no retry/backoff charge
            if rec is not None and req.retries > 0:
                self.retries_total += 1              # one retry attempt
                self._q_retries += 1
            entry = self._entry_node(req)
            denied = (self._fault_active and not self._node_up[entry]) \
                or node_taken[entry] >= slots
            if denied:
                if rec is not None:
                    delay = min(rec.retry_backoff_cap,
                                rec.retry_backoff_base
                                << min(req.retries, 16))
                    req.next_retry_frame = self.frame + delay
                    req.retries += 1
                    if self.tracer is not None:
                        self.tracer.on_backoff(req.rid, self.cell_id,
                                               self.frame,
                                               req.next_retry_frame)
                continue
            node_taken[entry] += 1
            req.admitted = True
            self.active.append(req)
            taken.add(id(req))
            if self.tracer is not None:
                self.tracer.on_admit(req.rid, self.frame)
            if throttle:
                live_by_svc[req.service] = \
                    live_by_svc.get(req.service, 0) + 1
        self._last_admitted += len(taken)
        # one O(n) rebuild preserving arrival order (the former per-request
        # deque.remove was O(n) per admitted request -> quadratic quanta)
        self.pending = deque(r for r in self.pending if id(r) not in taken)
        # a request counts as an admission drop ONCE (its first denied
        # quantum) — re-counting the whole backlog every quantum would let
        # summed telemetry drops exceed total submissions; keyed by rid
        # (stable across the request's lifetime, unlike id()), pruned on
        # completion/final-drop so a recycled rid is counted again.  A
        # throttled request was deliberately deferred, not denied — it is
        # reported via admission_throttled, not as a drop
        for r in self.pending:
            if id(r) in throttled:
                continue
            if r.rid not in self._denied_once:
                self._denied_once.add(r.rid)
                self._last_dropped += 1

    def _default_placement(self, req: Request, loads: np.ndarray) -> int:
        """Capacity-aware locality-greedy placement (non-learned default):
        stay at the current node (or the UE's current PoA before the first
        block), spilling to the nearest unsaturated node.  Dead nodes are
        masked out entirely (the fault-state analogue of the bridged
        policy's action mask)."""
        src = req.failover_from if req.failover_from >= 0 else (
            req.node if req.node >= 0 else self._entry_node(req))
        rank = self.y_hat[src] + 10.0 * (loads >= self._caps_q)
        if self._fault_active:
            rank = rank + 1e9 * ~self._node_up
        order = np.argsort(rank)
        return int(order[0])

    # -- failure handling (all no-ops while the fault state is healthy) --------

    def _finalize_failure(self, req: Request, outcome: str) -> None:
        """Terminal non-delivery: every submitted rid ends exactly once in
        {completed, deadline-shed, drop} — the conservation invariant the
        resilience tests pin."""
        req.done = True
        req.outcome = outcome
        self.failed.append(req)
        self._denied_once.discard(req.rid)
        if self.tracer is not None:
            self.tracer.on_failed(req.rid, self.frame, outcome)
        if req.rid in self._batch_rids:              # vacate its batch slot
            self._batch_rids.discard(req.rid)
            self._q_leaves += 1
        if outcome == "drop":
            self.drops_total += 1
            self._q_drops += 1
        else:
            self.deadline_misses_total += 1
            self._q_deadline_misses += 1

    def _handle_node_failures(self) -> None:
        """In-flight requests on a dead node: final-drop (mode "drop") or
        mark for failover — the latent survives from the last completed
        block and placement re-runs it onto a surviving node, charged as a
        "failover" leg when placed."""
        if self.recovery is None or self._node_up.all():
            return
        dead = [r for r in self.active
                if r.node >= 0 and not self._node_up[r.node]]
        for req in dead:
            if self.recovery.mode == "drop":
                self.active.remove(req)
                self._finalize_failure(req, "drop")
            else:
                req.failover_from = req.node
                req.node = -1                        # placement restarts

    def _shed_deadlines(self) -> None:
        """Shed hopeless requests: past-deadline work (pending or active)
        can no longer contribute to goodput, so it stops consuming blocks
        and admission slots."""
        if self.recovery is None:
            return
        late_active = [r for r in self.active
                       if 0 <= r.deadline < self.frame]
        for req in late_active:
            self.active.remove(req)
            self._finalize_failure(req, "deadline-shed")
        if any(0 <= r.deadline < self.frame for r in self.pending):
            keep: deque = deque()
            for req in self.pending:
                if 0 <= req.deadline < self.frame:
                    self._finalize_failure(req, "deadline-shed")
                else:
                    keep.append(req)
            self.pending = keep

    def _block_limit(self, req: Request) -> int:
        return req.degraded_to if 0 <= req.degraded_to < self.cfg.max_blocks \
            else self.cfg.max_blocks

    def _degrade(self) -> None:
        """Graceful degradation: under failure- or backpressure-induced
        load, cut the remaining chain length of deadline-carrying requests
        (the paper's step-reduction knob) so quality margin converts into
        deadline compliance.  The per-request budget is the quanta left
        before its deadline, shrunk by the demand/capacity pressure ratio
        when the surviving fleet is oversubscribed."""
        rec = self.recovery
        if rec is None or not rec.degrade:
            return
        live = [r for r in self.active if not r.done]
        demand = len(live) + len(self.pending)
        capacity = int(self._caps_q.sum())
        pressure = demand / max(capacity, 1)
        squeeze = pressure > rec.degrade_pressure
        for req in live:
            if req.deadline < 0:
                continue
            remaining = req.deadline - self.frame + 1   # quanta incl. now
            if remaining <= 0:
                continue                                # shed path owns it
            budget = int(np.ceil(remaining / pressure)) if squeeze \
                else remaining
            if budget < self.cfg.max_blocks - req.blocks_done:
                req.degraded_to = req.blocks_done + max(budget, 1)
            else:
                req.degraded_to = -1                    # pressure receded

    # -- one scheduling quantum (paper time frame) -------------------------------
    #
    # The quantum is decomposed into four phases so the iteration-level
    # scheduler (repro.serving.scheduler) can run SEVERAL block steps per
    # quantum — requests join/leave the in-flight batch between steps —
    # while the quantum engine composes exactly one plan/finish step per
    # quantum (begin_step / end_step below), byte-identical to the former
    # monolithic halves:
    #
    #   begin_quantum()            admission + resilience pre-passes, scratch
    #   plan_step() -> assigned    one placement pass (policy obs rebuilt)
    #   finish_step(assigned)      delivery + downlink for executed blocks
    #   end_quantum() -> stats     telemetry event + frame advance
    #
    # Node capacity (W_hat) and admission slots (C) are per-QUANTUM budgets
    # shared across the quantum's block steps: loads accumulate in
    # ``_q_loads`` and admission in ``_admit_node_taken``, so continuous
    # mode never executes or admits more per quantum than the reference.

    def begin_quantum(self) -> None:
        """Open a quantum: resilience pre-passes + admission (strict no-ops
        for a healthy fault state and/or no RecoveryConfig, keeping the
        zero-fault path frame-for-frame identical to the pre-fault engine),
        then reset the per-quantum scratch the block steps accumulate into."""
        self._shed_deadlines()
        self._handle_node_failures()
        self._admit()
        self._degrade()
        self._q_loads = np.zeros(len(self.nodes), dtype=int)
        self._q_exec = 0.0
        self._q_trans = 0.0
        self._q_delivered = []
        self._q_steps = 0
        self._q_planned = 0

    def plan_step(self, final: bool = True) -> Dict[int, List[Request]]:
        """One placement pass over the active set: batched policy decision,
        placement, and transmission charging.  Returns the ``node ->
        requests`` execution plan; the caller advances every planned request
        by one block and then calls :meth:`finish_step`.  Loads accumulate
        against the per-quantum capacity budget, so later steps of a
        continuous quantum only plan into whatever W_hat is left.

        ``final``: this is the request's last placement chance this quantum
        — a capacity-blocked request is delivered with whatever quality it
        has ("deliver what exists") instead of waiting.  True for the
        quantum engine's single pass and the continuous scheduler's first
        step (sync equivalence); later continuous steps pass False, where
        a blocked request just waits for the next quantum's budget."""
        # policy-driven placement hook: a placement_fn exposing
        # ``begin_quantum`` (the ServingPolicy bridge) computes one batched
        # decision for every request slot — rebuilt on the scheduler's
        # cadence (once per quantum in quantum mode, once per block step in
        # continuous mode); the per-request calls below then just read it
        begin = getattr(self.placement_fn, "begin_quantum", None)
        if begin is not None:
            begin(self)
        loads = self._q_loads
        delivered: List[Request] = []
        assigned: Dict[int, List[Request]] = {}

        # threshold-closest priority within the step (Algorithm 1 order)
        order = sorted(self.active, key=self._priority, reverse=True)
        for req in order:
            if req.done:
                continue
            if req.blocks_done >= self._block_limit(req):
                delivered.append(req)
                continue
            if self.cfg.early_exit and req.blocks_done > 0 and \
                    req.quality >= req.quality_threshold:
                delivered.append(req)                # satisfied: no more blocks
                continue
            target = self.placement_fn(req, loads)
            if target < 0:                           # null action: early exit
                if self.cfg.early_exit and req.blocks_done > 0:
                    delivered.append(req)
                continue
            if self._fault_active and not self._node_up[target]:
                continue                             # dead node: wait + retry
            if loads[target] >= self._caps_q[target]:
                if final and req.blocks_done > 0 and self.cfg.early_exit:
                    delivered.append(req)            # deliver what exists
                continue
            # C9 transmission: uplink hop (the UE's CURRENT PoA -> first
            # node) for the first block, latent shipping between nodes
            # afterwards — the sim's  src = prev_poa if k == 0 else
            # cur_node  rule.  _entry_node follows the set_poa stream (a UE
            # that moved while queued uplinks from where it IS), falling
            # back to the arrival origin without one — consistent with
            # per-node admission and the downlink leg.  A request failing
            # over re-places its last-completed-block latent FROM the dead
            # node, charged as the dedicated "failover" leg.
            fo = req.failover_from
            src = fo if fo >= 0 else (
                req.node if req.node >= 0 else self._entry_node(req))
            if src != target or fo >= 0:
                cost = float(self.y_hat[src, target])
                kind = "failover" if fo >= 0 else (
                    "migration" if req.node >= 0 else "uplink")
                self._charge(req, kind, src, target, cost)
                self._q_trans += cost
            if fo >= 0:
                req.failover_from = -1
                req.failovers += 1
                self.failovers_total += 1
                self._q_failovers += 1
            loads[target] += 1
            req.node = target
            assigned.setdefault(target, []).append(req)

        if self.tracer is not None:
            # one compute span per planned block, on the (cell, node) track,
            # at this quantum's current micro-step (_q_steps is 0-based here;
            # it advances just below)
            step = self._q_steps
            for target, reqs in assigned.items():
                for req in reqs:
                    self.tracer.on_compute(req.rid, self.cell_id, target,
                                           self.frame, step)
        self._q_steps += 1
        planned = sum(len(v) for v in assigned.values())
        self._q_planned += planned
        for reqs in assigned.values():               # batch joins (schema v3)
            for req in reqs:
                if req.rid not in self._batch_rids:
                    self._batch_rids.add(req.rid)
                    self._q_joins += 1
        self._step_scratch = delivered
        return assigned

    def finish_step(self, assigned: Dict[int, List[Request]]
                    ) -> List[Request]:
        """Close one block step: post-execution delivery checks, the
        downlink leg, and completion bookkeeping — delivered requests vacate
        their batch slot immediately (the continuous scheduler refills it
        next step)."""
        assert self._step_scratch is not None, "finish_step without plan_step"
        delivered = self._step_scratch
        self._step_scratch = None
        for target, reqs in assigned.items():
            self._q_exec += self.nodes[target].spec.exec_cost * len(reqs)
            for req in reqs:
                if req.blocks_done >= self._block_limit(req) or (
                        self.cfg.early_exit
                        and req.quality >= req.quality_threshold):
                    delivered.append(req)

        for req in delivered:
            # C9's last hop, mirroring the sim's delivery rule: the final
            # latent ships from the execution node to the UE's current PoA
            if self.cfg.charge_downlink and req.blocks_done > 0 \
                    and req.node >= 0:
                dst = self._entry_node(req)
                cost = float(self.y_hat[req.node, dst])
                if cost != 0.0 or self.ledger is not None:
                    self._charge(req, "downlink", req.node, dst, cost)
                self._q_trans += cost
            req.done = True
            req.outcome = "completed"
            req.delivered_frame = self.frame
            self.active.remove(req)
            self.completed.append(req)
            if self.tracer is not None:
                self.tracer.on_complete(req.rid, self.frame)
            # prune the denied-once set: a long-running engine must not
            # leak an entry per rid, and a recycled rid must be counted
            # as a fresh admission drop
            self._denied_once.discard(req.rid)
            if req.rid in self._batch_rids:          # batch leaves (schema v3)
                self._batch_rids.discard(req.rid)
                self._q_leaves += 1
        self._q_delivered.extend(delivered)
        return delivered

    def end_quantum(self) -> Dict[str, float]:
        """Close a quantum: the telemetry event, counter resets, and the
        frame advance.  Returns the same per-quantum stats dict as the
        former monolithic ``end_step``."""
        loads = self._q_loads
        delivered = self._q_delivered
        if self.telemetry is not None:
            # every leg is what was CHARGED this quantum (uplink/migration
            # at placement, handover by the cluster, downlink at delivery,
            # compute for the executed blocks) — one consistent per-quantum
            # decomposition whose totals match the transfer ledger
            caps = int(self._caps_q.sum())
            denom = self._q_steps * caps
            self.telemetry.record(QuantumEvent(
                frame=self.frame, cell=self.cell_id,
                queue_depth=len(self.pending), admitted=self._last_admitted,
                dropped=self._last_dropped, active=len(self.active),
                delivered=len(delivered),
                node_load=[int(x) for x in loads],
                node_capacity=[n.spec.capacity for n in self.nodes],
                legs={"compute": self._q_exec, **self._legs_quantum},
                node_down=int((~self._node_up).sum())
                if self._fault_active else 0,
                failovers=self._q_failovers, retries=self._q_retries,
                deadline_misses=self._q_deadline_misses,
                final_drops=self._q_drops,
                batch_join=self._q_joins, batch_leave=self._q_leaves,
                slot_occupancy=float(self._q_planned / denom) if denom
                else 0.0,
                admission_throttled=self._q_throttled,
                time=float(self.frame) + self.skew))
        self._last_dropped = 0
        self._legs_quantum = {k: 0.0 for k in self._legs_quantum}
        self._q_failovers = self._q_retries = 0
        self._q_deadline_misses = self._q_drops = 0
        self._q_joins = self._q_leaves = self._q_throttled = 0
        if self.tracer is not None:
            # quantum mark: micro-step count + skewed timestamp — resolves
            # compute-span step indices to timeline positions at export
            self.tracer.on_quantum(self.cell_id, self.frame,
                                   max(self._q_steps, 1),
                                   float(self.frame) + self.skew)

        self.prev_loads = loads
        self.frame += 1
        stats = {
            "frame": self.frame - 1,
            "delivered": len(delivered),
            "active": len(self.active),
            "pending": len(self.pending),
            "exec_cost": self._q_exec,
            "trans_cost": self._q_trans,
            "mean_quality": float(np.mean([r.quality for r in delivered]))
            if delivered else 0.0,
        }
        self._q_delivered = []
        return stats

    def begin_step(self) -> Dict[int, List[Request]]:
        """First half of a quantum-mode quantum: :meth:`begin_quantum` +
        exactly one :meth:`plan_step` — the composition is what the cluster's
        lock-step executor and the pre-decomposition tests run."""
        self.begin_quantum()
        return self.plan_step()

    def end_step(self, assigned: Dict[int, List[Request]]) -> Dict[str, float]:
        """Second half of a quantum-mode quantum: :meth:`finish_step` +
        :meth:`end_quantum`."""
        self.finish_step(assigned)
        return self.end_quantum()

    def step(self) -> Dict[str, float]:
        if self.cfg.scheduling == "continuous":
            from repro_torch.serving.scheduler import continuous_step
            return continuous_step(self)
        assigned = self.begin_step()
        # deferred batched execution: ONE run_batch per (node, quantum) —
        # placement never reads intra-quantum block results, so this is
        # behaviour-identical to inline per-request execution
        for target, reqs in assigned.items():
            self.nodes[target].run_batch(reqs)
        return self.end_step(assigned)

    def summary(self, frames: int) -> Dict[str, float]:
        """Aggregate stats over everything completed so far (objective (2):
        threshold-gated quality minus scaled execution/transmission cost)."""
        done = self.completed
        lat = [r.delivered_frame - r.arrival_frame + 1 for r in done]
        out = {
            "completed": len(done),
            # completions that landed within their deadline (deadline-free
            # requests always count) — the resilience bench's headline metric
            "goodput": sum(1 for r in done
                           if r.deadline < 0
                           or r.delivered_frame <= r.deadline),
            "mean_quality": float(np.mean([r.quality for r in done]))
            if done else 0.0,
            "mean_latency_frames": float(np.mean(lat)) if lat else 0.0,
            "p95_latency_frames": float(np.percentile(lat, 95)) if lat else 0.0,
            "objective": sum(r.quality * (r.quality >= r.quality_threshold)
                             - self.cfg.alpha * r.exec_cost
                             - self.cfg.beta * r.trans_cost
                             for r in done),
            # mean per-request C9 cost decomposition (telemetry carries the
            # per-quantum stream; this is the completed-set aggregate)
            "legs": {
                leg: float(np.mean([getattr(r, field) for r in done]))
                if done else 0.0
                for leg, field in (("uplink", "uplink_cost"),
                                   ("compute", "exec_cost"),
                                   ("migration", "migration_cost"),
                                   ("handover", "handover_cost"),
                                   ("downlink", "downlink_cost"),
                                   ("failover", "failover_cost"))
            },
            # lifetime resilience totals (all zero on a healthy run)
            "drops": self.drops_total,
            "retries": self.retries_total,
            "deadline_misses": self.deadline_misses_total,
            "failovers": self.failovers_total,
            # admissions throttled by backpressure (zero without a
            # SchedulerConfig arming backpressure_depth)
            "throttled": self.throttled_total,
            "frames": frames,
        }
        # p50/p99/max ride alongside the pre-existing mean/p95 (same lat
        # list -> identical whether or not tracing is on)
        out.update(latency_summary(lat))
        if self.tracer is not None:
            # which-leg-dominates rollup over THIS cell's completed set (a
            # fleet-shared tracer holds every cell's spans); only present
            # with tracing on — pin tests strip it before comparing
            out["critical_path"] = self.tracer.critical_path_report(
                {r.rid for r in done})
        return out

    def run(self, frames: int) -> Dict[str, float]:
        for _ in range(frames):
            self.step()
        return self.summary(frames)
