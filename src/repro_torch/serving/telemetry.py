"""Per-quantum serving telemetry: typed trace events + JSON schema.

Every scheduling quantum of a :class:`~repro_torch.serving.engine.ServingEngine`
(standalone or as one cell of a :class:`~repro.serving.cluster.ClusterEngine`)
emits one :class:`QuantumEvent`: queue depth, admission counts, per-node
load/capacity, the quantum's cost decomposition into the C9 legs
(uplink / compute / migration / handover / downlink), and the resilience
counters (nodes down, failovers, retries, deadline misses, final drops).
The log serializes to a versioned JSON document validated against
:data:`TELEMETRY_SCHEMA` — the contract ``benchmarks/bench_cluster.py`` and
external consumers read, and the round-trip (``to_json`` → ``validate`` →
``from_json``) is pinned by ``tests/test_workloads.py``.

Schema versioning: documents carry an integer ``schema_version``
(:data:`SCHEMA_VERSION`, currently 3).  Version 2 added the failure-counter
fields; version 3 adds the continuous-batching fields: batch
join/leave counts, slot occupancy across the quantum's block steps,
admissions throttled by backpressure, and the skewed-quantum ``time``
stamp (``frame + cell skew``).  Version-1 documents (no ``schema_version``
key) and version-2 documents are still accepted by
:meth:`TelemetryLog.from_json`, which validates them against the kept
older schemas and zero-fills the missing fields — so older BENCH artifacts
keep loading.

No external schema library: :func:`validate` is a minimal checker for the
subset of JSON Schema the contract uses (type / required / properties /
items).

Carried copy of ``repro.serving.telemetry``: the port writes the same
documents, under the same version strings, as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

TELEMETRY_VERSION = "repro.serving.telemetry/3"
TELEMETRY_VERSION_V2 = "repro.serving.telemetry/2"
TELEMETRY_VERSION_V1 = "repro.serving.telemetry/1"
SCHEMA_VERSION = 3
SCHEMA_VERSION_V2 = 2

# the v1 C9 legs; schema v2 added the "failover" leg (a migration forced
# by node failure — see repro_torch.serving.kv_manager.TRANSFER_KINDS)
LEGS_V1 = ("uplink", "compute", "migration", "handover", "downlink")
LEGS = LEGS_V1 + ("failover",)

# per-quantum resilience counters added in schema v2
FAULT_FIELDS = ("node_down", "failovers", "retries", "deadline_misses",
                "final_drops")

# continuous-batching fields added in schema v3: batch
# join/leave counts, slot occupancy over the quantum's block steps,
# backpressure throttles, and the skewed-quantum timestamp
BATCH_INT_FIELDS = ("batch_join", "batch_leave", "admission_throttled")
BATCH_NUM_FIELDS = ("slot_occupancy", "time")
BATCH_FIELDS = BATCH_INT_FIELDS + BATCH_NUM_FIELDS

_EVENT_FIELDS_V1 = ["frame", "cell", "queue_depth", "admitted", "dropped",
                    "active", "delivered", "node_load", "node_capacity",
                    "legs"]

_EVENT_SCHEMA_V1 = {
    "type": "object",
    "required": list(_EVENT_FIELDS_V1),
    "properties": {
        "frame": {"type": "integer"},
        "cell": {"type": "integer"},
        "queue_depth": {"type": "integer"},
        "admitted": {"type": "integer"},
        "dropped": {"type": "integer"},
        "active": {"type": "integer"},
        "delivered": {"type": "integer"},
        "node_load": {"type": "array", "items": {"type": "integer"}},
        "node_capacity": {"type": "array", "items": {"type": "integer"}},
        "legs": {
            "type": "object",
            "required": list(LEGS_V1),
            "properties": {leg: {"type": "number"} for leg in LEGS_V1},
        },
    },
}

_EVENT_SCHEMA_V2 = {
    "type": "object",
    "required": _EVENT_FIELDS_V1 + list(FAULT_FIELDS),
    "properties": {
        **_EVENT_SCHEMA_V1["properties"],
        "legs": {
            "type": "object",
            "required": list(LEGS),
            "properties": {leg: {"type": "number"} for leg in LEGS},
        },
        **{f: {"type": "integer"} for f in FAULT_FIELDS},
    },
}

_EVENT_SCHEMA = {
    "type": "object",
    "required": (_EVENT_FIELDS_V1 + list(FAULT_FIELDS)
                 + list(BATCH_FIELDS)),
    "properties": {
        **_EVENT_SCHEMA_V2["properties"],
        **{f: {"type": "integer"} for f in BATCH_INT_FIELDS},
        **{f: {"type": "number"} for f in BATCH_NUM_FIELDS},
    },
}

TELEMETRY_SCHEMA_V1 = {
    "type": "object",
    "required": ["version", "events"],
    "properties": {
        "version": {"type": "string"},
        "events": {"type": "array", "items": _EVENT_SCHEMA_V1},
    },
}

TELEMETRY_SCHEMA_V2 = {
    "type": "object",
    "required": ["version", "schema_version", "events"],
    "properties": {
        "version": {"type": "string"},
        "schema_version": {"type": "integer"},
        "events": {"type": "array", "items": _EVENT_SCHEMA_V2},
    },
}

TELEMETRY_SCHEMA = {
    "type": "object",
    "required": ["version", "schema_version", "events"],
    "properties": {
        "version": {"type": "string"},
        "schema_version": {"type": "integer"},
        "events": {"type": "array", "items": _EVENT_SCHEMA},
    },
}


def validate(doc, schema=TELEMETRY_SCHEMA, path: str = "$") -> None:
    """Check ``doc`` against the schema subset the telemetry contract uses;
    raises ``ValueError`` naming the offending path."""
    kind = schema.get("type")
    if kind == "object":
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: expected object, got {type(doc).__name__}")
        for key in schema.get("required", ()):
            if key not in doc:
                raise ValueError(f"{path}: missing required key {key!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in doc:
                validate(doc[key], sub, f"{path}.{key}")
    elif kind == "array":
        if not isinstance(doc, list):
            raise ValueError(f"{path}: expected array, got {type(doc).__name__}")
        items = schema.get("items")
        if items is not None:
            for i, item in enumerate(doc):
                validate(item, items, f"{path}[{i}]")
    elif kind == "integer":
        if not isinstance(doc, int) or isinstance(doc, bool):
            raise ValueError(f"{path}: expected integer, got {doc!r}")
    elif kind == "number":
        if isinstance(doc, bool) or not isinstance(doc, (int, float)):
            raise ValueError(f"{path}: expected number, got {doc!r}")
    elif kind == "string":
        if not isinstance(doc, str):
            raise ValueError(f"{path}: expected string, got {doc!r}")
    else:
        raise ValueError(f"{path}: unsupported schema type {kind!r}")


@dataclasses.dataclass
class QuantumEvent:
    """One scheduling quantum of one cell."""
    frame: int
    cell: int
    queue_depth: int                 # pending requests after admission
    admitted: int                    # admitted this quantum
    dropped: int                     # requests denied their FIRST slot this
    #                                  quantum (each request counts once, so
    #                                  summed drops never exceed submissions)
    active: int                      # in-flight after the quantum
    delivered: int                   # delivered this quantum
    node_load: List[int]             # blocks executed per node
    node_capacity: List[int]         # W_hat per node
    legs: Dict[str, float]           # costs CHARGED this quantum, per LEG
    # -- resilience counters (schema v2; all zero on a healthy run) ------------
    node_down: int = 0               # nodes down at this quantum
    failovers: int = 0               # in-flight latents re-placed this quantum
    retries: int = 0                 # denied requests re-considered this quantum
    deadline_misses: int = 0         # requests shed past their deadline
    final_drops: int = 0             # requests terminally dropped (no failover)
    # -- continuous-batching fields (schema v3) --------------------------------
    batch_join: int = 0              # requests that joined the in-flight batch
    batch_leave: int = 0             # requests that vacated their batch slot
    admission_throttled: int = 0     # admissions deferred by backpressure
    slot_occupancy: float = 0.0      # planned blocks / (steps * capacity)
    time: float = 0.0                # skewed-quantum timestamp: frame + skew

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["node_load"] = [int(x) for x in self.node_load]
        d["node_capacity"] = [int(x) for x in self.node_capacity]
        # a leg kind the schema doesn't know would silently vanish from
        # artifacts if we just projected onto LEGS — fail loudly instead so
        # adding a transfer kind forces a schema rev
        unknown = set(self.legs) - set(LEGS)
        if unknown:
            raise ValueError(
                f"QuantumEvent.legs has keys outside the schema "
                f"({sorted(unknown)}); add them to LEGS and rev the "
                f"telemetry schema")
        d["legs"] = {k: float(self.legs.get(k, 0.0)) for k in LEGS}
        for f in FAULT_FIELDS:
            d[f] = int(d[f])
        for f in BATCH_INT_FIELDS:
            d[f] = int(d[f])
        for f in BATCH_NUM_FIELDS:
            d[f] = float(d[f])
        return d


class TelemetryLog:
    """Append-only per-quantum event log with a validated JSON round-trip."""

    def __init__(self):
        self.events: List[QuantumEvent] = []

    def record(self, event: QuantumEvent) -> None:
        self.events.append(event)

    # -- aggregates (what bench_cluster reports) -------------------------------

    def utilization(self) -> float:
        """Mean per-node load / capacity over all recorded quanta."""
        if not self.events:
            return 0.0
        ratios = [np.asarray(ev.node_load) /
                  np.maximum(np.asarray(ev.node_capacity), 1)
                  for ev in self.events]
        return float(np.mean(ratios))

    def leg_totals(self) -> Dict[str, float]:
        out = {k: 0.0 for k in LEGS}
        for ev in self.events:
            for k in LEGS:
                out[k] += float(ev.legs.get(k, 0.0))
        return out

    def summary(self) -> Dict[str, float]:
        depth = [ev.queue_depth for ev in self.events]
        return {
            "quanta": len(self.events),
            "mean_queue_depth": float(np.mean(depth)) if depth else 0.0,
            "max_queue_depth": int(np.max(depth)) if depth else 0,
            "admitted": int(sum(ev.admitted for ev in self.events)),
            "dropped": int(sum(ev.dropped for ev in self.events)),
            "delivered": int(sum(ev.delivered for ev in self.events)),
            "mean_node_utilization": self.utilization(),
            "legs": self.leg_totals(),
            # resilience totals: zero on a healthy run
            "failovers": int(sum(ev.failovers for ev in self.events)),
            "retries": int(sum(ev.retries for ev in self.events)),
            "deadline_misses": int(sum(ev.deadline_misses
                                       for ev in self.events)),
            "final_drops": int(sum(ev.final_drops for ev in self.events)),
            "max_node_down": int(max((ev.node_down for ev in self.events),
                                     default=0)),
            # continuous-batching totals: joins == leaves on a
            # drained run; throttles zero without backpressure armed
            "batch_joins": int(sum(ev.batch_join for ev in self.events)),
            "batch_leaves": int(sum(ev.batch_leave for ev in self.events)),
            "admission_throttled": int(sum(ev.admission_throttled
                                           for ev in self.events)),
            "mean_slot_occupancy": float(np.mean(
                [ev.slot_occupancy for ev in self.events]))
            if self.events else 0.0,
        }

    # -- JSON round-trip -------------------------------------------------------

    def to_json(self) -> dict:
        doc = {"version": TELEMETRY_VERSION,
               "schema_version": SCHEMA_VERSION,
               "events": [ev.to_json() for ev in self.events]}
        validate(doc)
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "TelemetryLog":
        """Load a telemetry document; v1 documents (no ``schema_version``)
        and v2 documents are accepted with their missing fields zero-filled
        (failure counters for v1, continuous-batching fields for both)."""
        version = doc.get("schema_version") if isinstance(doc, dict) else None
        if version is None:
            validate(doc, TELEMETRY_SCHEMA_V1)
            if doc["version"] != TELEMETRY_VERSION_V1:
                raise ValueError(
                    f"telemetry version mismatch: {doc['version']!r}")
        elif version == SCHEMA_VERSION_V2:
            validate(doc, TELEMETRY_SCHEMA_V2)
            if doc["version"] != TELEMETRY_VERSION_V2:
                raise ValueError(
                    f"telemetry version mismatch: {doc['version']!r}")
        else:
            validate(doc)
            if version != SCHEMA_VERSION:
                raise ValueError(f"telemetry schema_version mismatch: "
                                 f"{version!r} (expected {SCHEMA_VERSION})")
            if doc["version"] != TELEMETRY_VERSION:
                raise ValueError(
                    f"telemetry version mismatch: {doc['version']!r}")
        log = cls()
        for ev in doc["events"]:
            log.record(QuantumEvent(
                frame=ev["frame"], cell=ev["cell"],
                queue_depth=ev["queue_depth"], admitted=ev["admitted"],
                dropped=ev["dropped"], active=ev["active"],
                delivered=ev["delivered"], node_load=list(ev["node_load"]),
                node_capacity=list(ev["node_capacity"]),
                legs=dict(ev["legs"]),
                **{f: int(ev.get(f, 0)) for f in FAULT_FIELDS},
                **{f: int(ev.get(f, 0)) for f in BATCH_INT_FIELDS},
                **{f: float(ev.get(f, 0.0)) for f in BATCH_NUM_FIELDS}))
        return log
