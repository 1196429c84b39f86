"""Nonstationary workload generators: named arrival processes over scenarios.

The single Bernoulli-rate :func:`repro_torch.sim.scenarios.request_trace` models
stationary traffic; production fleets see diurnal cycles, flash crowds, and
bursty correlated arrivals.  This registry composes a named *workload* (an
arrival-rate envelope, optionally a per-request service mix) with any named
*scenario* (the environment regime) — the two axes stay orthogonal:

    from repro_torch.sim.scenarios import get_scenario
    from repro_torch.sim.workloads import workload_trace
    cfg = get_scenario("paper-fig3")
    trace = workload_trace(cfg, frames=200, workload="flash-crowd", seed=3)

Shipped workloads:

* ``stationary``   — the legacy regime; ``workload_trace(...,
  "stationary")`` is draw-for-draw identical to ``request_trace`` under the
  same seed (pinned by ``tests/test_workloads.py``).
* ``diurnal``      — sinusoidal rate envelope (one day per ``period``
  frames), the classic day/night demand cycle.
* ``flash-crowd``  — a burst window at ``peak`` rate over a ``base`` floor
  (viral-event traffic).
* ``mmpp``         — 2-state Markov-modulated Bernoulli process: bursts of
  ``high``-rate traffic separated by ``low``-rate stretches.
* ``heavy-tail``   — stationary arrivals with a heavy-tailed service mix: a
  ``tail_prob`` minority of requests carries near-full-chain quality
  thresholds (per-(frame, UE) ``qbar_t`` on the trace).

Determinism contract: everything is keyed by ``(cfg.seed, seed)``; the
envelope/service-mix randomness draws from a separate stream than the
trace's arrival/mobility randomness, so the stationary workload replays
``request_trace`` exactly and two workloads differing only in envelope see
the same mobility.

:func:`fleet_trace` stacks per-cell traces for the cluster engine
(``repro.serving.cluster``, still to be carried) and draws the cross-cell
handover schedule.

Carried copy of ``repro.sim.workloads``: every trace equals the reference's
under the same seeds (``tests/test_torch_sim.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.sim.env import SimConfig, draw_static_world
from repro_torch.sim.mobility import RandomWaypoint
from repro_torch.sim.scenarios import RequestTrace

_WORKLOADS: Dict[str, Callable] = {}
_DESCRIPTIONS: Dict[str, str] = {}

# sub-stream tags: the envelope/mix stream, the handover stream, and the
# sub-quantum arrival-offset stream must not perturb the trace's
# arrival/mobility stream (keyed by (cfg.seed, seed) alone), or stationary
# would stop replaying request_trace exactly
_ENVELOPE_STREAM = 7
_HANDOVER_STREAM = 13
_OFFSET_STREAM = 17


@dataclasses.dataclass
class WorkloadDraw:
    """What a workload contributes to a trace: the per-frame arrival rate
    envelope and (optionally) per-(frame, UE) quality thresholds."""
    rates: np.ndarray                         # (T,) in [0, 1]
    qbar_t: Optional[np.ndarray] = None       # (T, U)


def register_workload(name: str, desc: str):
    """Decorator: register ``fn(cfg, frames, rng, **params) -> WorkloadDraw``
    as a named workload."""

    def deco(fn: Callable):
        assert name not in _WORKLOADS, f"duplicate workload {name!r}"
        _WORKLOADS[name] = fn
        _DESCRIPTIONS[name] = desc
        return fn

    return deco


def get_workload(name: str) -> Callable:
    if name not in _WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; "
                       f"known: {sorted(_WORKLOADS)}")
    return _WORKLOADS[name]


def workload_names() -> List[str]:
    return sorted(_WORKLOADS)


def workload_descriptions() -> Dict[str, str]:
    return dict(_DESCRIPTIONS)


def arrival_envelope(name: str, cfg: SimConfig, frames: int, *,
                     seed: int = 0, **params) -> np.ndarray:
    """The (T,) arrival-rate envelope a workload would use — the analytical
    surface the rate-correctness tests (and plots) check against."""
    rng = np.random.default_rng((cfg.seed, seed, _ENVELOPE_STREAM))
    return get_workload(name)(cfg, frames, rng, **params).rates


# -- trace construction --------------------------------------------------------

def workload_trace(cfg: SimConfig, frames: int, workload: str = "stationary",
                   *, seed: int = 0, **params) -> RequestTrace:
    """Derive a serving trace from a scenario under a named workload.

    Mirrors :func:`repro_torch.sim.scenarios.request_trace` exactly — same world
    draw, same RandomWaypoint mobility, same per-frame Bernoulli arrival
    consumption order — but the per-frame rate comes from the workload's
    envelope instead of the constant ``cfg.arrival_prob``, and heavy-tailed
    mixes attach per-(frame, UE) thresholds (``qbar_t``).
    """
    u = cfg.num_ues
    world = draw_static_world(cfg, np.random.default_rng(cfg.seed))
    draw = get_workload(workload)(
        cfg, frames, np.random.default_rng((cfg.seed, seed,
                                            _ENVELOPE_STREAM)), **params)
    rates = np.clip(np.asarray(draw.rates, dtype=float), 0.0, 1.0)
    assert rates.shape == (frames,), \
        f"workload {workload!r} envelope shape {rates.shape} != ({frames},)"
    rng = np.random.default_rng((cfg.seed, seed))
    rwp = RandomWaypoint(u, grid=cfg.grid, side=cfg.side, speed=cfg.speed,
                         pause=cfg.pause, rng=rng)
    poa = np.empty((frames, u), dtype=int)
    arrivals = np.empty((frames, u), dtype=bool)
    poa[0] = rwp.area_of(rwp.pos)
    arrivals[0] = rng.random(u) < rates[0]
    for t in range(1, frames):
        poa[t] = rwp.step()
        arrivals[t] = rng.random(u) < rates[t]
    # sub-quantum arrival timestamps: uniform offsets in [0, 1) on their own
    # dedicated stream (a quantum-boundary consumer just ignores them)
    offsets = np.random.default_rng(
        (cfg.seed, seed, _OFFSET_STREAM)).random((frames, u))
    return RequestTrace(cfg=cfg, frames=frames, arrivals=arrivals, poa=poa,
                        qbar=world["qbar"], service_of=world["service_of"],
                        rates=rates, qbar_t=draw.qbar_t, workload=workload,
                        arrival_offset=offsets)


@dataclasses.dataclass
class FleetTrace:
    """A fleet workload: one trace per cell plus the handover schedule.

    ``handovers`` rows are ``(frame, ue, src_cell, dst_cell)`` — candidate
    cross-cell UE moves; the cluster applies a candidate only when the UE
    has an in-flight request in ``src_cell`` and the destination slot is
    free (the serving-side analogue of the trace's idle-gated arrivals).
    """
    cfg: SimConfig
    frames: int
    cells: List[RequestTrace]
    handovers: np.ndarray            # (K, 4) int

    @property
    def num_cells(self) -> int:
        return len(self.cells)


def fleet_trace(cfg: SimConfig, frames: int, num_cells: int, *,
                workload: str = "stationary", seed: int = 0,
                handover_rate: float = 0.0, **params) -> FleetTrace:
    """Stack ``num_cells`` independent workload traces under one clock and
    draw the cross-cell handover candidates (per frame, per (cell, UE),
    Bernoulli ``handover_rate``; the destination cell is uniform over the
    others)."""
    cells = [workload_trace(cfg, frames, workload,
                            seed=seed * 100_003 + c, **params)
             for c in range(num_cells)]
    rows = []
    if handover_rate > 0.0 and num_cells > 1:
        rng = np.random.default_rng((cfg.seed, seed, _HANDOVER_STREAM))
        u = cfg.num_ues
        for t in range(1, frames):
            fire = rng.random((num_cells, u)) < handover_rate
            shift = rng.integers(1, num_cells, size=(num_cells, u))
            for c, ue in zip(*np.nonzero(fire)):
                rows.append((t, int(ue), int(c),
                             int((c + shift[c, ue]) % num_cells)))
    handovers = np.asarray(rows, dtype=int).reshape(-1, 4)
    return FleetTrace(cfg=cfg, frames=frames, cells=cells,
                      handovers=handovers)


# -- the workloads -------------------------------------------------------------

@register_workload("stationary",
                   "constant cfg.arrival_prob (the legacy request_trace)")
def _stationary(cfg: SimConfig, frames: int, rng, **params) -> WorkloadDraw:
    rates = np.full(frames, cfg.arrival_prob)
    rates[0] = 0.9                   # env.reset initial-request burst
    return WorkloadDraw(rates=rates)


@register_workload("diurnal",
                   "sinusoidal day/night cycle: one period per `period` "
                   "frames around `base`, swing `amp`")
def _diurnal(cfg: SimConfig, frames: int, rng, *, base: float = None,
             amp: float = 0.8, period: int = None,
             phase: float = 0.0) -> WorkloadDraw:
    base = cfg.arrival_prob if base is None else base
    period = frames if period is None else period
    t = np.arange(frames)
    rates = base * (1.0 + amp * np.sin(2.0 * np.pi * t / max(period, 1)
                                       + phase))
    return WorkloadDraw(rates=np.clip(rates, 0.0, 1.0))


@register_workload("flash-crowd",
                   "viral burst: `peak` rate over [start, start+duration), "
                   "`base` floor elsewhere")
def _flash_crowd(cfg: SimConfig, frames: int, rng, *, base: float = None,
                 peak: float = 0.95, start: int = None,
                 duration: int = None) -> WorkloadDraw:
    base = cfg.arrival_prob if base is None else base
    start = frames // 3 if start is None else start
    duration = max(frames // 6, 1) if duration is None else duration
    rates = np.full(frames, base)
    rates[start:start + duration] = peak
    return WorkloadDraw(rates=np.clip(rates, 0.0, 1.0))


@register_workload("mmpp",
                   "2-state Markov-modulated Bernoulli arrivals: bursts at "
                   "`high` separated by `low` stretches")
def _mmpp(cfg: SimConfig, frames: int, rng, *, low: float = 0.05,
          high: float = 0.8, p_lh: float = 0.1,
          p_hl: float = 0.25) -> WorkloadDraw:
    state = 0                        # start calm
    rates = np.empty(frames)
    switch = rng.random(frames)
    for t in range(frames):
        rates[t] = high if state else low
        state = (1 - state) if switch[t] < (p_hl if state else p_lh) \
            else state
    return WorkloadDraw(rates=rates)


@register_workload("heavy-tail",
                   "stationary arrivals, heavy-tailed service mix: a "
                   "`tail_prob` minority demands near-full chains")
def _heavy_tail(cfg: SimConfig, frames: int, rng, *, tail_prob: float = 0.15,
                tail_qbar: float = 0.95) -> WorkloadDraw:
    rates = np.full(frames, cfg.arrival_prob)
    rates[0] = 0.9
    u = cfg.num_ues
    body = rng.uniform(cfg.qbar_low, cfg.qbar_high, size=(frames, u))
    tail = rng.uniform(cfg.qbar_high, tail_qbar, size=(frames, u))
    is_tail = rng.random((frames, u)) < tail_prob
    return WorkloadDraw(rates=rates, qbar_t=np.where(is_tail, tail, body))
