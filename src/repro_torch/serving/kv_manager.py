"""KV/latent transfer accounting.

:func:`state_nbytes` / :class:`TransferLedger` are the migration
*accounting* seam.  Every byte that moves a request's live state between
nodes (latent hops inside a cell) or between cells (fleet handover,
``repro.serving.cluster`` in the reference) is recorded here as a typed
transfer event, so telemetry and benchmarks can decompose latency/cost into
uplink / migration / handover / downlink without re-deriving it from engine
internals.  ``ServingEngine`` records through an optional ledger.

Carried copy of the accounting half of ``repro.serving.kv_manager``; the
paged KV pool there serves LM decode and comes with the LM slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# "shard" records cross-DEVICE latent movement on a mesh-sharded cluster
# (a handover whose src/dst cells live on different mesh devices): bytes
# are real, cost is 0.0 — the latency charge already rides the handover
# event; the extra row keeps the byte accounting honest per device link.
# "failover" is a migration forced by node failure: the latent re-places
# from the dead node (last completed block) onto a survivor — same byte
# math as "migration", separate kind so resilience cost is decomposable.
TRANSFER_KINDS = ("uplink", "migration", "handover", "downlink", "shard",
                  "failover")


def state_nbytes(state) -> int:
    """C9 payload size of a request's live state, in bytes.

    Sums every array-valued leaf of the payload (dict values, nested dicts,
    lists of arrays); non-array leaves are free.  A paged LM request whose
    payload carries a pool handle reports its live pages instead (via a
    ``migration_nbytes`` key or method).
    """
    if state is None:
        return 0
    custom = getattr(state, "migration_nbytes", None)
    if custom is not None:                       # paged/pooled payloads
        return int(custom() if callable(custom) else custom)
    nbytes = getattr(state, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(state, dict):
        if "migration_nbytes" in state:
            custom = state["migration_nbytes"]
            return int(custom() if callable(custom) else custom)
        return sum(state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_nbytes(v) for v in state)
    return 0


@dataclasses.dataclass
class TransferEvent:
    frame: int
    rid: int
    kind: str                        # one of TRANSFER_KINDS
    src: int                         # node id (or cell id for handover)
    dst: int
    nbytes: int
    cost: float


class TransferLedger:
    """Typed record of every state transfer the serving layer charges.

    The engine appends one event per charged C9 leg; ``totals()`` gives the
    per-kind byte/cost aggregate the telemetry layer and ``bench_cluster``
    report.  Keeping this in ``kv_manager`` puts all migration byte-math in
    one place, next to the page pool whose ``migration_bytes`` feeds it for
    paged LM services.
    """

    def __init__(self):
        self.events: List[TransferEvent] = []

    def record(self, frame: int, rid: int, kind: str, src: int, dst: int,
               nbytes: int, cost: float) -> None:
        assert kind in TRANSFER_KINDS, f"unknown transfer kind {kind!r}"
        self.events.append(TransferEvent(frame, rid, kind, src, dst,
                                         int(nbytes), float(cost)))

    def totals(self) -> Dict[str, Dict[str, float]]:
        out = {k: {"count": 0, "nbytes": 0, "cost": 0.0}
               for k in TRANSFER_KINDS}
        for ev in self.events:
            t = out[ev.kind]
            t["count"] += 1
            t["nbytes"] += ev.nbytes
            t["cost"] += ev.cost
        return out

    def per_request(self) -> Dict[int, Dict[str, Dict[str, float]]]:
        """Per-rid, per-kind byte/cost aggregate — the ledger-side view the
        tracer's transfer spans must reconcile with (``tests/test_tracing.py``
        cross-checks them event for event)."""
        out: Dict[int, Dict[str, Dict[str, float]]] = {}
        for ev in self.events:
            kinds = out.setdefault(ev.rid, {})
            t = kinds.setdefault(ev.kind,
                                 {"count": 0, "nbytes": 0, "cost": 0.0})
            t["count"] += 1
            t["nbytes"] += ev.nbytes
            t["cost"] += ev.cost
        return out
