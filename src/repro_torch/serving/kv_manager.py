"""KV/latent transfer accounting + paged KV-cache manager.

Two pieces back the C9 transmission legs of the serving layer:

* :func:`state_nbytes` / :class:`TransferLedger` — the migration
  *accounting* seam.  Every byte that moves a request's live state between
  nodes (latent hops inside a cell) or between cells (fleet handover,
  ``repro_torch.serving.cluster``) is recorded here as a typed transfer
  event, so telemetry and benchmarks can decompose latency/cost into
  uplink / migration / handover / downlink without re-deriving it from
  engine internals.  ``ServingEngine`` records through an optional ledger.
* :class:`KVPagePool` — paged physical state for the LM-decode services.
  Pages of ``page_size`` positions are allocated from a fixed pool per
  node; a request's logical cache maps to a page table.  Moving a chain
  ships only its live pages (C9 bytes = pages * page_bytes), and the
  free-list makes admission decisions capacity-aware.

Carried copy of ``repro.serving.kv_manager``, with the same free-list
order and byte counts.  The physical pages live in the node's device
memory: a float32 tensor on the card unless ``device=`` says otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch import resolve_device

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


@dataclasses.dataclass
class PageTable:
    rid: int
    pages: List[int]
    length: int = 0


class KVPagePool:
    """``num_pages`` pages of ``page_size`` positions: ``data`` is
    (pages, layers, 2, page_size, kv_heads, head_dim) float32 on
    ``device`` (the card unless given); ``free`` the free page ids, the
    next taken from its end; ``tables`` each request's page table."""

    def __init__(self, num_pages: int, page_size: int, *, kv_heads: int,
                 head_dim: int, num_layers: int, device=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free = list(range(num_pages))[::-1]
        self.tables: Dict[int, PageTable] = {}
        # physical pool: (pages, layers, 2, page_size, kv_heads, head_dim)
        self.data = torch.zeros(
            (num_pages, num_layers, 2, page_size, kv_heads, head_dim),
            device=resolve_device(device))

    # -- allocation -----------------------------------------------------------

    def can_admit(self, expected_len: int) -> bool:
        need = (expected_len + self.page_size - 1) // self.page_size
        return len(self.free) >= need

    def allocate(self, rid: int) -> PageTable:
        if rid in self.tables:
            raise ValueError(f"request {rid} already has a page table")
        pt = PageTable(rid, [])
        self.tables[rid] = pt
        return pt

    def append_token(self, rid: int) -> int:
        """Reserve room for one more position; returns the page id used."""
        pt = self.tables[rid]
        if pt.length % self.page_size == 0:
            if not self.free:
                raise MemoryError("KV pool exhausted")
            pt.pages.append(self.free.pop())
        pt.length += 1
        return pt.pages[-1]

    def release(self, rid: int) -> None:
        pt = self.tables.pop(rid, None)
        if pt:
            self.free.extend(pt.pages)

    # -- migration (the C9 latent hop) -----------------------------------------

    def extract(self, rid: int) -> Dict:
        """Serialize a request's pages for shipping to another node: a
        copy of its pages, on this pool's device."""
        pt = self.tables[rid]
        return {
            "length": pt.length,
            "pages": self.data[pt.pages].clone(),
        }

    def inject(self, rid: int, blob: Dict) -> None:
        """Install shipped pages into this pool (copied onto its device)."""
        n = blob["pages"].shape[0]
        if len(self.free) < n:
            raise MemoryError("KV pool exhausted on migration")
        pt = self.allocate(rid)
        pt.length = blob["length"]
        pt.pages = [self.free.pop() for _ in range(n)]
        self.data[pt.pages] = blob["pages"].to(self.data.device)

    def migration_bytes(self, rid: int) -> int:
        pt = self.tables[rid]
        per_page = self.data[0].nbytes
        return len(pt.pages) * per_page

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.num_pages
