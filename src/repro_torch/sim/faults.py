"""Seeded fault processes: named failure schedules over scenario × workload.

Carried copy of ``repro.sim.faults`` (numpy): every schedule draws the
same trace from the same seed, pinned by ``tests/test_torch_fleet.py``.

The serving stack assumed every node, link, and cell stays healthy forever;
edge deployments are exactly where that assumption breaks.  This registry
makes failure a first-class, deterministically replayable input — a named
*fault schedule* composes with any scenario (``repro_torch.sim.scenarios``) and
any workload (``repro_torch.sim.workloads``) the same way workloads compose with
scenarios, emitting a :class:`FaultTrace` the fleet driver replays
frame-for-frame:

    from repro_torch.sim.scenarios import get_scenario
    from repro_torch.sim.faults import fault_trace
    cfg = get_scenario("paper-fig3")
    faults = fault_trace(cfg, frames=200, num_cells=4,
                         schedule="node-churn", seed=3, mttf=40, mttr=8)

Shipped schedules:

* ``none``         — a STRICT no-op: every node up, every scale 1.0.  The
  zero-fault equivalence pin (``tests/test_resilience.py``) drives this
  trace through the full fault plumbing and asserts the run is
  frame-for-frame identical to an engine that never saw the faults module.
* ``node-churn``   — per-(cell, node) two-state crash/repair Markov chain
  parameterized by MTTF/MTTR (mean frames to failure / repair).
* ``link-degrade`` — per-(cell, leg) two-state degradation on the
  uplink/migration/downlink transmission legs: a degraded leg's charged
  cost is scaled by ``factor`` (> 1) until the link recovers.
* ``stragglers``   — transient per-(frame, cell, node) slowdowns: a
  straggling node's per-quantum block capacity is scaled by ``factor``
  (< 1) for that frame.
* ``cell-outage``  — one whole-cell outage window per cell (every node of
  the cell down for ``duration`` frames, start drawn per cell).
* ``mixed``        — node-churn + link-degrade + stragglers composed from
  independent sub-streams of the schedule's rng.

Determinism contract: everything is keyed by ``(cfg.seed, seed)`` on a
dedicated sub-stream (:data:`_FAULT_STREAM`), so adding faults to a run
never perturbs the workload's arrival/mobility draws and two schedules
differing only in fault parameters see the same traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.sim.env import SimConfig

_FAULTS: Dict[str, Callable] = {}
_DESCRIPTIONS: Dict[str, str] = {}

# dedicated rng sub-stream: fault draws must never share a stream with the
# workload's arrival/mobility draws (_ENVELOPE_STREAM=7, _HANDOVER_STREAM=13
# in repro_torch.sim.workloads) or composing faults onto a run would change the
# traffic it sees
_FAULT_STREAM = 29

# the transmission legs a link-degradation schedule can scale, in the
# fixed column order of ``FaultTrace.link_scale``
FAULT_LEGS = ("uplink", "migration", "downlink")


@dataclasses.dataclass
class FaultDraw:
    """What a schedule contributes; ``None`` fields mean "healthy"."""
    node_up: Optional[np.ndarray] = None      # (T, C, N) bool
    cap_scale: Optional[np.ndarray] = None    # (T, C, N) in (0, 1]
    link_scale: Optional[np.ndarray] = None   # (T, C, len(FAULT_LEGS)) >= 1


@dataclasses.dataclass
class FaultTrace:
    """A deterministic, replayable fleet fault schedule.

    ``node_up[t, c, n]`` — node ``n`` of cell ``c`` is alive at frame ``t``;
    ``cap_scale[t, c, n]`` — straggler capacity multiplier in (0, 1];
    ``link_scale[t, c, l]`` — cost multiplier (>= 1) for transmission leg
    ``FAULT_LEGS[l]``.  A whole-cell outage is simply ``node_up[t, c]`` all
    ``False``.
    """
    cfg: SimConfig
    frames: int
    num_cells: int
    schedule: str
    node_up: np.ndarray
    cap_scale: np.ndarray
    link_scale: np.ndarray

    @property
    def any_fault(self) -> bool:
        return (not self.node_up.all()
                or bool((self.cap_scale != 1.0).any())
                or bool((self.link_scale != 1.0).any()))

    def cell_state(self, t: int, c: int):
        """The (node_up, cap_scale, link_scale) triple one cell's engine
        consumes at frame ``t`` (``ServingEngine.set_fault_state``)."""
        return self.node_up[t, c], self.cap_scale[t, c], self.link_scale[t, c]


def register_fault(name: str, desc: str):
    """Decorator: register ``fn(cfg, frames, num_cells, rng, **params) ->
    FaultDraw`` as a named fault schedule."""

    def deco(fn: Callable):
        assert name not in _FAULTS, f"duplicate fault schedule {name!r}"
        _FAULTS[name] = fn
        _DESCRIPTIONS[name] = desc
        return fn

    return deco


def get_fault(name: str) -> Callable:
    if name not in _FAULTS:
        raise KeyError(f"unknown fault schedule {name!r}; "
                       f"known: {sorted(_FAULTS)}")
    return _FAULTS[name]


def fault_names() -> List[str]:
    return sorted(_FAULTS)


def fault_descriptions() -> Dict[str, str]:
    return dict(_DESCRIPTIONS)


def fault_trace(cfg: SimConfig, frames: int, num_cells: int = 1,
                schedule: str = "none", *, seed: int = 0,
                **params) -> FaultTrace:
    """Draw a named fault schedule for a ``num_cells``-cell fleet.

    Missing pieces of the schedule's draw are filled with the healthy
    defaults (all nodes up, all scales 1.0), so ``schedule="none"`` yields
    arrays the engine treats as a strict no-op.
    """
    n = cfg.num_bs
    rng = np.random.default_rng((cfg.seed, seed, _FAULT_STREAM))
    draw = get_fault(schedule)(cfg, frames, num_cells, rng, **params)
    node_up = np.ones((frames, num_cells, n), dtype=bool) \
        if draw.node_up is None else np.asarray(draw.node_up, dtype=bool)
    cap_scale = np.ones((frames, num_cells, n)) \
        if draw.cap_scale is None else np.asarray(draw.cap_scale, float)
    link_scale = np.ones((frames, num_cells, len(FAULT_LEGS))) \
        if draw.link_scale is None else np.asarray(draw.link_scale, float)
    assert node_up.shape == (frames, num_cells, n), \
        f"{schedule!r} node_up shape {node_up.shape}"
    assert cap_scale.shape == (frames, num_cells, n), \
        f"{schedule!r} cap_scale shape {cap_scale.shape}"
    assert link_scale.shape == (frames, num_cells, len(FAULT_LEGS)), \
        f"{schedule!r} link_scale shape {link_scale.shape}"
    assert ((cap_scale > 0.0) & (cap_scale <= 1.0)).all(), \
        f"{schedule!r} cap_scale outside (0, 1]"
    assert (link_scale >= 1.0).all(), f"{schedule!r} link_scale below 1"
    return FaultTrace(cfg=cfg, frames=frames, num_cells=num_cells,
                      schedule=schedule, node_up=node_up,
                      cap_scale=cap_scale, link_scale=link_scale)


def _two_state(rng, frames: int, shape, p_fail: float, p_repair: float
               ) -> np.ndarray:
    """(T, *shape) bool up/down Markov chains, all starting up.  Draws are
    batched per frame so the stream is shape-stable for a given (T, shape)."""
    up = np.ones((frames,) + shape, dtype=bool)
    state = np.ones(shape, dtype=bool)
    switch = rng.random((frames,) + shape)
    for t in range(frames):
        flip = switch[t] < np.where(state, p_fail, p_repair)
        state = state ^ flip
        up[t] = state
    return up


# -- the schedules -------------------------------------------------------------

@register_fault("none", "strict no-op: every node up, every scale 1.0")
def _none(cfg: SimConfig, frames: int, num_cells: int, rng,
          **params) -> FaultDraw:
    return FaultDraw()


@register_fault("node-churn",
                "per-(cell, node) crash/repair Markov chain with mean "
                "frames-to-failure `mttf` and mean frames-to-repair `mttr`")
def _node_churn(cfg: SimConfig, frames: int, num_cells: int, rng, *,
                mttf: float = 40.0, mttr: float = 8.0) -> FaultDraw:
    assert mttf > 0 and mttr > 0
    up = _two_state(rng, frames, (num_cells, cfg.num_bs),
                    min(1.0 / mttf, 1.0), min(1.0 / mttr, 1.0))
    return FaultDraw(node_up=up)


@register_fault("link-degrade",
                "per-(cell, leg) two-state degradation scaling charged "
                "uplink/migration/downlink costs by `factor` while degraded")
def _link_degrade(cfg: SimConfig, frames: int, num_cells: int, rng, *,
                  p_degrade: float = 0.05, p_recover: float = 0.25,
                  factor: float = 3.0) -> FaultDraw:
    assert factor >= 1.0
    healthy = _two_state(rng, frames, (num_cells, len(FAULT_LEGS)),
                         p_degrade, p_recover)
    return FaultDraw(link_scale=np.where(healthy, 1.0, factor))


@register_fault("stragglers",
                "transient per-(frame, cell, node) slowdowns: capacity "
                "scaled by `factor` with prob `prob` each frame")
def _stragglers(cfg: SimConfig, frames: int, num_cells: int, rng, *,
                prob: float = 0.1, factor: float = 0.5) -> FaultDraw:
    assert 0.0 < factor <= 1.0
    slow = rng.random((frames, num_cells, cfg.num_bs)) < prob
    return FaultDraw(cap_scale=np.where(slow, factor, 1.0))


@register_fault("cell-outage",
                "one whole-cell outage window per cell: every node down "
                "for `duration` frames, start drawn per cell")
def _cell_outage(cfg: SimConfig, frames: int, num_cells: int, rng, *,
                 duration: int = 6, prob: float = 1.0) -> FaultDraw:
    duration = min(max(int(duration), 1), frames)
    up = np.ones((frames, num_cells, cfg.num_bs), dtype=bool)
    starts = rng.integers(0, max(frames - duration, 0) + 1, size=num_cells)
    hit = rng.random(num_cells) < prob
    for c in range(num_cells):
        if hit[c]:
            up[starts[c]:starts[c] + duration, c, :] = False
    return FaultDraw(node_up=up)


@register_fault("mixed",
                "node-churn + link-degrade + stragglers composed from "
                "independent sub-streams")
def _mixed(cfg: SimConfig, frames: int, num_cells: int, rng, *,
           mttf: float = 40.0, mttr: float = 8.0,
           p_degrade: float = 0.05, p_recover: float = 0.25,
           link_factor: float = 3.0, straggle_prob: float = 0.1,
           straggle_factor: float = 0.5) -> FaultDraw:
    # independent child streams so each component's draw is stable no
    # matter how the others are parameterized
    sub = [np.random.default_rng((int(rng.integers(1 << 31)), i))
           for i in range(3)]
    churn = _node_churn(cfg, frames, num_cells, sub[0], mttf=mttf, mttr=mttr)
    links = _link_degrade(cfg, frames, num_cells, sub[1],
                          p_degrade=p_degrade, p_recover=p_recover,
                          factor=link_factor)
    slow = _stragglers(cfg, frames, num_cells, sub[2], prob=straggle_prob,
                       factor=straggle_factor)
    return FaultDraw(node_up=churn.node_up, cap_scale=slow.cap_scale,
                     link_scale=links.link_scale)
