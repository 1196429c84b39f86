"""Request-level distributed tracing + metrics for the serving fleet.

The telemetry layer (:mod:`repro_torch.serving.telemetry`) answers "what did the
fleet do this quantum" in aggregate; this module answers "where did request
42's frames go".  A :class:`Tracer` records one span tree per request on
per-(cell, node) timelines:

* **queue spans** — admission wait (submit → first admission) and every
  retry-backoff interval the recovery machinery imposes;
* **compute spans** — one per executed block step, on the (cell, node)
  track it ran on, at micro-step resolution (the iteration-level
  scheduler's ``plan_step``/``finish_step`` cadence);
* **transfer spans** — every charged :class:`TransferLedger` leg
  (uplink / migration / handover / failover / downlink / shard) with its
  bytes and cost.

Time is the engine's *logical* clock: one scheduling quantum = one frame,
subdivided by the continuous scheduler's block steps (and shifted by the
per-cell quantum skew).  Wall-clock observation rides separately in the
:class:`MetricsRegistry` (counters / gauges / fixed-bucket histograms with
exact p50/p95/p99): in the reference, ``GDMService.instrument`` hooks
compile events and per-compiled-call wall time around the jitted runners,
and the policy bridge times its batched decisions (neither is carried yet).

Carried copy of ``repro.serving.tracing``; the engine imports
:class:`Tracer` and :func:`latency_summary` from here.

Exports:

* :meth:`Tracer.to_json` — a versioned, schema-validated trace document
  (:data:`TRACE_SCHEMA`, sibling of the telemetry contract; the input
  format for the ROADMAP digital-twin replayer), round-tripping through
  :meth:`Tracer.from_json`;
* :meth:`Tracer.to_chrome_trace` — Chrome trace-event JSON loadable in
  Perfetto (``ui.perfetto.dev``): cells are processes, nodes are threads,
  compute/transfer/queue slices are complete ("X") events.

**Discipline:** tracing is opt-in (``EngineConfig.tracing``) and strictly
pure observation — a tracing-enabled run is pinned frame-for-frame (steps,
summaries, telemetry JSON, ledger events) to a tracing-off run by
``tests/test_tracing.py``, mirroring the zero-fault equivalence pin.

The critical-path analyzer (:meth:`Tracer.request_segments` /
:meth:`Tracer.critical_path_report`) decomposes each completed request's
end-to-end latency into queueing / transmission / compute / retry frames:
every frame of a request's life is attributed to exactly ONE segment
(compute wins over transmission over retry over queueing within a frame),
so the segments sum to the measured latency exactly — the conservation
invariant the tests pin.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.serving.telemetry import validate

TRACE_VERSION = "repro.serving.tracing/1"
TRACE_SCHEMA_VERSION = 1

# one scheduling quantum on the Perfetto timeline, in trace microseconds
FRAME_US = 1000.0

# the critical-path segments every completed request's latency decomposes
# into (request_segments attributes each frame to exactly one)
SEGMENTS = ("queueing", "transmission", "compute", "retry")

# synthetic Perfetto thread ids for the non-node tracks of each cell
# (node tracks are tid = node id; node counts stay far below these)
TRANSFER_TID = 1_000
QUEUE_TID = 1_001


# -- metrics registry ----------------------------------------------------------

# default latency buckets (log-spaced, microseconds-flavoured but unitless):
# fixed boundaries keep histogram JSON stable across runs
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                   1_000.0, 2_000.0, 5_000.0, 10_000.0, 20_000.0, 50_000.0,
                   100_000.0, 1_000_000.0)


class Counter:
    """Monotonic event counter."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram that also retains exact observations.

    The fixed buckets give a stable JSON shape (cumulative-free per-bucket
    counts) for dashboards/diffs; the retained raw values make
    :meth:`percentile` EXACT (``np.percentile`` semantics) rather than
    bucket-interpolated — serving runs are small enough that exactness is
    cheaper than being wrong about a p99.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(self.buckets)
        self.values: List[float] = []
        self.total = 0.0
        self._snapshot: Optional[dict] = None

    @property
    def count(self) -> int:
        if self._snapshot is not None:
            return int(self._snapshot["count"])
        return len(self.values)

    def observe(self, v: float) -> None:
        # the hot path is a plain append — bucketing happens lazily in
        # ``counts`` (one vectorized pass at read-out), keeping observe
        # cheap enough to sit on per-call serving hooks
        if self._snapshot is not None:
            # resuming live observation discards the frozen summary —
            # per-observation values were never serialized, so the two
            # cannot be merged
            self._snapshot = None
            self.total = 0.0
        v = float(v)
        self.values.append(v)
        self.total += v

    @property
    def counts(self) -> List[int]:
        """Per-bucket counts (last = overflow), bucket i holding
        ``buckets[i-1] < v <= buckets[i]``."""
        if self._snapshot is not None:
            return list(self._snapshot["bucket_counts"])
        if not self.values:
            return [0] * (len(self.buckets) + 1)
        idx = np.searchsorted(self.buckets, self.values, side="left")
        return np.bincount(idx, minlength=len(self.buckets) + 1).tolist()

    def percentile(self, q: float) -> float:
        """Exact percentile over every observation (0 when empty)."""
        if self._snapshot is not None:
            key = {50: "p50", 95: "p95", 99: "p99"}.get(q)
            if key is None:
                raise ValueError(
                    f"histogram restored from JSON only stores p50/p95/p99 "
                    f"(asked for p{q})")
            return float(self._snapshot[key])
        if not self.values:
            return 0.0
        return float(np.percentile(self.values, q))

    @property
    def mean(self) -> float:
        if self._snapshot is not None:
            return float(self._snapshot["mean"])
        return self.total / self.count if self.values else 0.0

    @property
    def max(self) -> float:
        if self._snapshot is not None:
            return float(self._snapshot["max"])
        return float(max(self.values)) if self.values else 0.0

    def to_json(self) -> dict:
        if self._snapshot is not None:
            return dict(self._snapshot)
        return {
            "count": self.count,
            "total": float(self.total),
            "mean": float(self.mean),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "max": self.max,
            "buckets": list(self.buckets),
            "bucket_counts": list(self.counts),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Histogram":
        """Rebuild from a serialized snapshot.  Exact observations are not
        serialized, so the result is a FROZEN summary: ``to_json`` re-emits
        the snapshot verbatim (round-trip exact) and mean/percentile/max
        answer from the stored fields; the first ``observe`` discards the
        snapshot and resumes live (append) mode from empty."""
        h = cls(doc["buckets"])
        h.total = float(doc["total"])
        h._snapshot = {k: doc[k] for k in (
            "count", "total", "mean", "p50", "p95", "p99", "max",
            "buckets", "bucket_counts")}
        return h


class MetricsRegistry:
    """Named counters / gauges / histograms (one flat namespace)."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets)
        return h

    def to_json(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.to_json()
                           for k, h in sorted(self.histograms.items())},
        }


def latency_summary(lat: Sequence[float]) -> Dict[str, float]:
    """The p50/p99/max latency fields engine/cluster summaries report
    alongside the pre-existing mean/p95 — sourced from a
    :class:`Histogram` so the summary numbers and any exported histogram
    agree by construction."""
    h = Histogram()
    for v in lat:
        h.observe(v)
    return {
        "p50_latency_frames": h.percentile(50),
        "p99_latency_frames": h.percentile(99),
        "max_latency_frames": h.max,
    }


# -- span records --------------------------------------------------------------


@dataclasses.dataclass
class RequestRecord:
    """One request's lifetime: the root of its span tree."""
    rid: int
    ue: int
    service: int
    cell: int                        # submission cell (handover may move it)
    arrival_frame: int
    admitted_frame: int = -1         # first admission (-1: never admitted)
    end_frame: int = -1              # terminal frame (-1: still in flight)
    outcome: str = ""                # "completed" / "deadline-shed" / "drop"


@dataclasses.dataclass
class ComputeSpan:
    """One executed block step on a (cell, node) track."""
    rid: int
    cell: int
    node: int
    frame: int
    step: int                        # micro-step index within the quantum


@dataclasses.dataclass
class TransferSpan:
    """One charged transfer leg (mirrors the TransferLedger row)."""
    rid: int
    kind: str
    src: int                         # node id (cell/device id for
    dst: int                         # handover/shard, like the ledger)
    nbytes: int
    cost: float
    frame: int
    cell: int


@dataclasses.dataclass
class BackoffSpan:
    """One admission-retry backoff interval: [frame, until) quanta."""
    rid: int
    cell: int
    frame: int
    until: int


@dataclasses.dataclass
class QuantumMark:
    """Step count + skewed timestamp of one (cell, frame) quantum —
    resolves micro-step indices to timeline positions at export time."""
    cell: int
    frame: int
    steps: int
    time: float                      # frame + cell skew


# -- the tracer ----------------------------------------------------------------


class Tracer:
    """Per-request span recorder for one engine or one whole fleet.

    Engines call the ``on_*`` hooks (all O(1) appends, guarded by
    ``engine.tracer is not None`` at every call site); a
    :class:`~repro.serving.cluster.ClusterEngine` shares ONE tracer across
    its cells so cross-cell requests keep a single span tree.
    """

    def __init__(self, frame_us: float = FRAME_US):
        self.frame_us = float(frame_us)
        self.requests: Dict[int, RequestRecord] = {}
        self.compute: List[ComputeSpan] = []
        self.transfers: List[TransferSpan] = []
        self.backoffs: List[BackoffSpan] = []
        self.quanta: Dict[Tuple[int, int], QuantumMark] = {}
        self.metrics = MetricsRegistry()

    # -- engine hooks (pure observation) ---------------------------------------

    def on_submit(self, rid: int, ue: int, service: int, cell: int,
                  frame: int) -> None:
        self.requests[rid] = RequestRecord(rid, ue, service, cell, frame)

    def on_admit(self, rid: int, frame: int) -> None:
        rec = self.requests.get(rid)
        if rec is not None and rec.admitted_frame < 0:
            rec.admitted_frame = frame

    def on_backoff(self, rid: int, cell: int, frame: int, until: int) -> None:
        self.backoffs.append(BackoffSpan(rid, cell, frame, until))

    def on_compute(self, rid: int, cell: int, node: int, frame: int,
                   step: int) -> None:
        self.compute.append(ComputeSpan(rid, cell, node, frame, step))

    def on_transfer(self, rid: int, kind: str, src: int, dst: int,
                    nbytes: int, cost: float, frame: int, cell: int) -> None:
        self.transfers.append(TransferSpan(rid, kind, src, dst, int(nbytes),
                                           float(cost), frame, cell))

    def on_complete(self, rid: int, frame: int) -> None:
        self._finish(rid, frame, "completed")

    def on_failed(self, rid: int, frame: int, outcome: str) -> None:
        self._finish(rid, frame, outcome)

    def _finish(self, rid: int, frame: int, outcome: str) -> None:
        rec = self.requests.get(rid)
        if rec is not None:
            rec.end_frame = frame
            rec.outcome = outcome

    def on_quantum(self, cell: int, frame: int, steps: int,
                   time: float) -> None:
        self.quanta[(cell, frame)] = QuantumMark(cell, frame, max(steps, 1),
                                                 float(time))

    # -- critical-path analysis ------------------------------------------------

    def _frames_by_rid(self) -> Tuple[Dict[int, Set[int]],
                                      Dict[int, Set[int]],
                                      Dict[int, List[Tuple[int, int]]]]:
        # span lists are append-only, so an index keyed on their lengths
        # stays valid until the next span arrives — one build serves the
        # per-cell AND fleet-level critical-path rollups of one summary
        key = (len(self.compute), len(self.transfers), len(self.backoffs))
        cached = getattr(self, "_index_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        comp: Dict[int, Set[int]] = {}
        for s in self.compute:
            comp.setdefault(s.rid, set()).add(s.frame)
        trans: Dict[int, Set[int]] = {}
        for t in self.transfers:
            trans.setdefault(t.rid, set()).add(t.frame)
        back: Dict[int, List[Tuple[int, int]]] = {}
        for b in self.backoffs:
            back.setdefault(b.rid, []).append((b.frame, b.until))
        self._index_cache = (key, (comp, trans, back))
        return comp, trans, back

    def request_segments(self, rid: int, *, _index=None) -> Dict[str, int]:
        """Decompose one finished request's end-to-end latency (frames,
        inclusive of arrival and terminal frame) into the
        :data:`SEGMENTS`.  Each frame of the request's life is attributed
        to exactly one segment — compute > transmission > retry > queueing
        within a frame — so ``sum(segments.values()) == latency`` EXACTLY
        (the per-request conservation invariant).
        """
        rec = self.requests[rid]
        assert rec.end_frame >= 0, f"rid {rid} has not finished"
        comp, trans, back = _index if _index is not None \
            else self._frames_by_rid()
        lo, hi = rec.arrival_frame, rec.end_frame
        # O(spans), not O(latency): attribute by set arithmetic with the
        # same per-frame priority (compute > transmission > retry;
        # queueing is the remainder)
        comp_in = {f for f in comp.get(rid, ()) if lo <= f <= hi}
        trans_in = {f for f in trans.get(rid, ()) if lo <= f <= hi}
        trans_in -= comp_in
        retry_in: Set[int] = set()
        for b_lo, b_hi in back.get(rid, ()):
            retry_in.update(range(max(b_lo, lo), min(b_hi, hi + 1)))
        retry_in -= comp_in
        retry_in -= trans_in
        out = dict.fromkeys(SEGMENTS, 0)
        out["compute"] = len(comp_in)
        out["transmission"] = len(trans_in)
        out["retry"] = len(retry_in)
        out["queueing"] = (hi - lo + 1) - len(comp_in) - len(trans_in) \
            - len(retry_in)
        return out

    def critical_path_report(self, rids: Optional[Set[int]] = None
                             ) -> Dict[str, object]:
        """Fleet-level "which leg dominates" rollup over every COMPLETED
        request (optionally restricted to ``rids`` — per-cell engine
        summaries pass their own completed set).  Segment totals are in
        frames; ``fractions`` normalizes by total latency; ``dominant``
        names the largest segment."""
        index = self._frames_by_rid()
        totals = dict.fromkeys(SEGMENTS, 0)
        n = 0
        for rid, rec in self.requests.items():
            if rec.outcome != "completed":
                continue
            if rids is not None and rid not in rids:
                continue
            segs = self.request_segments(rid, _index=index)
            for k in SEGMENTS:
                totals[k] += segs[k]
            n += 1
        latency = sum(totals.values())
        return {
            "requests": n,
            "latency_frames": latency,
            "segments": totals,
            "fractions": {k: totals[k] / latency if latency else 0.0
                          for k in SEGMENTS},
            "dominant": max(SEGMENTS, key=lambda k: totals[k]) if latency
            else "",
        }

    # -- schema-validated JSON round-trip --------------------------------------

    def to_json(self) -> dict:
        doc = {
            "version": TRACE_VERSION,
            "schema_version": TRACE_SCHEMA_VERSION,
            "frame_us": self.frame_us,
            "requests": [dataclasses.asdict(r)
                         for r in self.requests.values()],
            "compute": [dataclasses.asdict(s) for s in self.compute],
            "transfers": [dataclasses.asdict(t) for t in self.transfers],
            "backoffs": [dataclasses.asdict(b) for b in self.backoffs],
            "quanta": [dataclasses.asdict(q) for q in self.quanta.values()],
            "metrics": self.metrics.to_json(),
        }
        validate_trace(doc)
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "Tracer":
        validate_trace(doc)
        if doc["version"] != TRACE_VERSION:
            raise ValueError(f"trace version mismatch: {doc['version']!r}")
        if doc["schema_version"] != TRACE_SCHEMA_VERSION:
            raise ValueError(f"trace schema_version mismatch: "
                             f"{doc['schema_version']!r} "
                             f"(expected {TRACE_SCHEMA_VERSION})")
        tr = cls(frame_us=doc["frame_us"])
        for r in doc["requests"]:
            tr.requests[r["rid"]] = RequestRecord(**r)
        tr.compute = [ComputeSpan(**s) for s in doc["compute"]]
        tr.transfers = [TransferSpan(**t) for t in doc["transfers"]]
        tr.backoffs = [BackoffSpan(**b) for b in doc["backoffs"]]
        for q in doc["quanta"]:
            tr.quanta[(q["cell"], q["frame"])] = QuantumMark(**q)
        # metrics re-load as snapshots (histograms come back frozen: exact
        # values are not serialized per-observation, so the restored
        # histogram re-emits the stored summary verbatim — round-trip exact)
        m = doc.get("metrics", {})
        for k, v in m.get("counters", {}).items():
            tr.metrics.counter(k).inc(int(v))
        for k, v in m.get("gauges", {}).items():
            tr.metrics.gauge(k).set(v)
        for k, h in m.get("histograms", {}).items():
            tr.metrics.histograms[k] = Histogram.from_json(h)
        return tr

    # -- Chrome trace-event export (Perfetto) ----------------------------------

    def _ts(self, cell: int, frame: int, step: int) -> Tuple[float, float]:
        """(ts, dur) of block step ``step`` of quantum ``(cell, frame)`` in
        trace microseconds, honouring per-cell skew and micro-step count."""
        mark = self.quanta.get((cell, frame))
        steps = mark.steps if mark is not None else 1
        base = mark.time if mark is not None else float(frame)
        dur = self.frame_us / steps
        return (base * self.frame_us + step * dur, dur)

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` array format):
        ``chrome://tracing`` / Perfetto render cells as processes, node
        tracks as threads, and compute / transfer / queue / backoff slices
        as complete ("X") events.  Load the dumped file directly in
        ``ui.perfetto.dev``."""
        events: List[dict] = []
        cells = sorted({s.cell for s in self.compute}
                       | {r.cell for r in self.requests.values()}
                       | {c for c, _ in self.quanta})
        nodes_of: Dict[int, Set[int]] = {}
        for s in self.compute:
            nodes_of.setdefault(s.cell, set()).add(s.node)
        for cell in cells:
            events.append({"ph": "M", "name": "process_name", "pid": cell,
                           "tid": 0, "args": {"name": f"cell {cell}"}})
            for node in sorted(nodes_of.get(cell, ())):
                events.append({"ph": "M", "name": "thread_name", "pid": cell,
                               "tid": node,
                               "args": {"name": f"node {node}"}})
            events.append({"ph": "M", "name": "thread_name", "pid": cell,
                           "tid": TRANSFER_TID,
                           "args": {"name": "transfers"}})
            events.append({"ph": "M", "name": "thread_name", "pid": cell,
                           "tid": QUEUE_TID,
                           "args": {"name": "queue/backoff"}})
        for s in self.compute:
            ts, dur = self._ts(s.cell, s.frame, s.step)
            events.append({"ph": "X", "name": f"rid {s.rid} block",
                           "cat": "compute", "pid": s.cell, "tid": s.node,
                           "ts": ts, "dur": dur,
                           "args": {"rid": s.rid, "step": s.step}})
        for t in self.transfers:
            ts, dur = self._ts(t.cell, t.frame, 0)
            events.append({"ph": "X", "name": t.kind, "cat": "transfer",
                           "pid": t.cell, "tid": TRANSFER_TID,
                           "ts": ts, "dur": max(dur * 0.25, 1.0),
                           "args": {"rid": t.rid, "src": t.src, "dst": t.dst,
                                    "nbytes": t.nbytes, "cost": t.cost}})
        for rec in self.requests.values():
            wait_end = rec.admitted_frame if rec.admitted_frame >= 0 \
                else rec.end_frame
            if wait_end is None or wait_end < 0:
                continue
            dur = max((wait_end - rec.arrival_frame) * self.frame_us, 1.0)
            events.append({"ph": "X", "name": f"rid {rec.rid} wait",
                           "cat": "queue", "pid": rec.cell, "tid": QUEUE_TID,
                           "ts": rec.arrival_frame * self.frame_us,
                           "dur": dur,
                           "args": {"rid": rec.rid,
                                    "outcome": rec.outcome}})
        for b in self.backoffs:
            events.append({"ph": "X", "name": f"rid {b.rid} backoff",
                           "cat": "retry", "pid": b.cell, "tid": QUEUE_TID,
                           "ts": b.frame * self.frame_us,
                           "dur": max((b.until - b.frame) * self.frame_us,
                                      1.0),
                           "args": {"rid": b.rid}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- trace document schema -----------------------------------------------------

_REQUEST_SCHEMA = {
    "type": "object",
    "required": ["rid", "ue", "service", "cell", "arrival_frame",
                 "admitted_frame", "end_frame", "outcome"],
    "properties": {
        **{k: {"type": "integer"} for k in
           ("rid", "ue", "service", "cell", "arrival_frame",
            "admitted_frame", "end_frame")},
        "outcome": {"type": "string"},
    },
}

_COMPUTE_SCHEMA = {
    "type": "object",
    "required": ["rid", "cell", "node", "frame", "step"],
    "properties": {k: {"type": "integer"}
                   for k in ("rid", "cell", "node", "frame", "step")},
}

_TRANSFER_SCHEMA = {
    "type": "object",
    "required": ["rid", "kind", "src", "dst", "nbytes", "cost", "frame",
                 "cell"],
    "properties": {
        **{k: {"type": "integer"} for k in
           ("rid", "src", "dst", "nbytes", "frame", "cell")},
        "kind": {"type": "string"},
        "cost": {"type": "number"},
    },
}

_BACKOFF_SCHEMA = {
    "type": "object",
    "required": ["rid", "cell", "frame", "until"],
    "properties": {k: {"type": "integer"}
                   for k in ("rid", "cell", "frame", "until")},
}

_QUANTUM_SCHEMA = {
    "type": "object",
    "required": ["cell", "frame", "steps", "time"],
    "properties": {
        **{k: {"type": "integer"} for k in ("cell", "frame", "steps")},
        "time": {"type": "number"},
    },
}

TRACE_SCHEMA = {
    "type": "object",
    "required": ["version", "schema_version", "frame_us", "requests",
                 "compute", "transfers", "backoffs", "quanta", "metrics"],
    "properties": {
        "version": {"type": "string"},
        "schema_version": {"type": "integer"},
        "frame_us": {"type": "number"},
        "requests": {"type": "array", "items": _REQUEST_SCHEMA},
        "compute": {"type": "array", "items": _COMPUTE_SCHEMA},
        "transfers": {"type": "array", "items": _TRANSFER_SCHEMA},
        "backoffs": {"type": "array", "items": _BACKOFF_SCHEMA},
        "quanta": {"type": "array", "items": _QUANTUM_SCHEMA},
        "metrics": {"type": "object"},
    },
}


def validate_trace(doc: dict) -> None:
    """Validate a trace document against :data:`TRACE_SCHEMA` (raises
    ``ValueError`` naming the offending path, like the telemetry
    contract's validator — they share the same checker)."""
    validate(doc, TRACE_SCHEMA)
