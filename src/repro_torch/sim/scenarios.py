"""Scenario registry: named :class:`SimConfig` factories.

A *scenario* is a reproducible environment regime — the paper's Table II
grids plus regimes beyond the paper (heavy traffic, channel starvation,
larger service areas, heterogeneous edge capacity).  Every factory accepts
keyword overrides that are applied on top of the scenario's defaults, so a
sweep varies one axis of a named regime without re-deriving the rest:

    from repro_torch.sim.scenarios import get_scenario
    cfg = get_scenario("paper-fig4a", num_ues=25)

Adding a scenario is one decorated function returning the default field
dict; benchmarks (``python -m benchmarks.run --scenario <name>``) and
``examples/train_agent.py --scenario <name>`` resolve names through this
registry.  Keep factories cheap and deterministic — world randomness stays
where it belongs, in ``SimConfig.seed``.

Carried copy of ``repro.sim.scenarios``: draw order is byte-identical, so
a trace built here equals the reference's (``tests/test_torch_serving.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.sim.env import SimConfig, draw_static_world
from repro_torch.sim.mobility import RandomWaypoint

_REGISTRY: Dict[str, Callable[[], dict]] = {}
_DESCRIPTIONS: Dict[str, str] = {}


def register_scenario(name: str, desc: str):
    """Decorator: register ``fn() -> dict of SimConfig fields`` as a named
    scenario."""

    def deco(fn: Callable[[], dict]):
        assert name not in _REGISTRY, f"duplicate scenario {name!r}"
        _REGISTRY[name] = fn
        _DESCRIPTIONS[name] = desc
        return fn

    return deco


def get_scenario(name: str, **overrides) -> SimConfig:
    """Resolve a scenario name to a :class:`SimConfig`, applying keyword
    overrides on top of the scenario defaults."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    fields = _REGISTRY[name]()
    fields.update(overrides)
    return SimConfig(**fields)


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


# -- serving workloads from scenarios ------------------------------------------

@dataclasses.dataclass
class RequestTrace:
    """A serving workload derived from a named scenario: per-frame Bernoulli
    arrival draws, the RWP PoA stream (request origins), and the world-draw
    per-UE thresholds / service assignment.  ``arrivals[t, u]`` fires a new
    request for UE ``u`` at frame ``t`` *iff* that UE is idle — the serving loop
    (``repro_torch.serving.policy_bridge.serve_trace``) applies the same idle
    gating the simulator's arrival process has."""
    cfg: SimConfig
    frames: int
    arrivals: np.ndarray             # (T, U) bool — candidate arrivals
    poa: np.ndarray                  # (T, U) int  — UE PoA per frame
    qbar: np.ndarray                 # (U,) quality thresholds (world draw)
    service_of: np.ndarray           # (U,) service assignment (world draw)
    # optional nonstationary annotations (repro.sim.workloads): the arrival
    # rate envelope the trace was drawn from, per-(frame, UE) thresholds for
    # heavy-tailed service mixes, and the generating workload's name
    rates: Optional[np.ndarray] = None        # (T,) arrival prob per frame
    qbar_t: Optional[np.ndarray] = None       # (T, U) per-arrival thresholds
    workload: str = "stationary"
    # sub-quantum arrival timestamps (repro.sim.workloads): an
    # arrival at frame t with offset o lands at continuous time t + o.  The
    # quantum engine ignores them (arrivals land at the frame boundary);
    # the iteration-level scheduler (SchedulerConfig.sub_quantum_arrivals)
    # admits the request at the matching block step inside the quantum.
    arrival_offset: Optional[np.ndarray] = None   # (T, U) float in [0, 1)


def request_trace(cfg: SimConfig, frames: int, seed: int = 0) -> RequestTrace:
    """Derive a serving arrival trace from a scenario's :class:`SimConfig`.

    Mirrors the simulator's episode semantics: per-UE thresholds and service
    assignments come from the SAME Table II world draw (``cfg.seed``) the
    engine/policy world uses; mobility is the paper's RandomWaypoint; frame
    0 arrivals fire with the env's initial 0.9 request probability, later
    frames with ``cfg.arrival_prob``.  ``seed`` picks the episode stream
    (arrivals + mobility) independently of the world.
    """
    u = cfg.num_ues
    world = draw_static_world(cfg, np.random.default_rng(cfg.seed))
    rng = np.random.default_rng((cfg.seed, seed))
    rwp = RandomWaypoint(u, grid=cfg.grid, side=cfg.side, speed=cfg.speed,
                         pause=cfg.pause, rng=rng)
    poa = np.empty((frames, u), dtype=int)
    arrivals = np.empty((frames, u), dtype=bool)
    poa[0] = rwp.area_of(rwp.pos)
    arrivals[0] = rng.random(u) < 0.9            # env.reset initial requests
    for t in range(1, frames):
        poa[t] = rwp.step()
        arrivals[t] = rng.random(u) < cfg.arrival_prob
    return RequestTrace(cfg=cfg, frames=frames, arrivals=arrivals, poa=poa,
                        qbar=world["qbar"], service_of=world["service_of"])


def scenario_descriptions() -> Dict[str, str]:
    return dict(_DESCRIPTIONS)


# -- the paper's grids ---------------------------------------------------------

@register_scenario("paper-fig3", "Table II defaults (Fig. 3 convergence run)")
def _paper_fig3() -> dict:
    return dict(num_ues=15, num_channels=2, horizon=40, seed=0)


@register_scenario("paper-fig4a", "Fig. 4A base: sweep num_ues, C=2")
def _paper_fig4a() -> dict:
    return dict(num_ues=15, num_channels=2, horizon=40, seed=0)


@register_scenario("paper-fig4b", "Fig. 4B base: sweep num_channels, U=15")
def _paper_fig4b() -> dict:
    return dict(num_ues=15, num_channels=2, horizon=40, seed=0)


# -- beyond the paper ----------------------------------------------------------

@register_scenario("heavy-traffic",
                   "U=50 with hot request arrivals — contention everywhere")
def _heavy_traffic() -> dict:
    return dict(num_ues=50, num_channels=3, arrival_prob=0.6, horizon=40,
                seed=0)


@register_scenario("channel-starved",
                   "one uplink channel for 20 UEs — MAC is the bottleneck")
def _channel_starved() -> dict:
    return dict(num_ues=20, num_channels=1, horizon=40, seed=0)


@register_scenario("large-grid",
                   "8x8 service areas (64 BSs), 800m side, fast mobility")
def _large_grid() -> dict:
    return dict(grid=8, side=800.0, num_ues=40, num_channels=3, speed=20.0,
                horizon=40, seed=0)


@register_scenario("smoke",
                   "tiny regime for CI smoke sweeps (U=5, T=12)")
def _smoke() -> dict:
    return dict(num_ues=5, num_channels=2, horizon=12, seed=0)


@register_scenario("hetero-capacity",
                   "wide per-BS capacity/cost spread — placement matters")
def _hetero_capacity() -> dict:
    return dict(num_ues=15, num_channels=2, capacity_low=1, capacity_high=6,
                eps_low=0.5, eps_high=6.0, horizon=40, seed=0)
