"""Experiment layer: train/evaluate any controller, by name, and close the
paper's loop on the serving engine.

Port of ``repro.experiments``.  This is the one place benchmark and example
code goes through to (a) pick an engine (``REPRO_BENCH_ENGINE``: scalar |
vectorized | fused, and ``REPRO_BENCH_NUM_ENVS`` for the stacked width),
(b) train a D3QL variant with a correctly calibrated epsilon schedule
(``LearnGDMController.calibrate_epsilon`` over ``train_frames``), (c)
evaluate the paper comparison set (LEARN-GDM / MP / FP / GR / OPT) on one
environment point, and (d) serve a scenario, one cell or a fleet, under a
trained policy.

Entry points that build an agent or a DiT take ``device``: ``None`` means
the card (and raises without CUDA); the CPU runs pass ``device="cpu"``.
They take the port's integer ``seed`` where the reference takes a jax key,
and have no ``impl`` knob: the kernels follow the tensors' device.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.core.baselines import GreedyController, opt_upper_bound
from repro_torch.core.learn_gdm import LearnGDMController
from repro_torch.sim.env import EdgeSimulator, SimConfig

ENGINES = ("scalar", "vectorized", "fused")
VARIANTS = ("learn-gdm", "mp", "fp")


def bench_engine(default: str = "fused") -> str:
    """Training/eval engine knob (``REPRO_BENCH_ENGINE``)."""
    engine = os.environ.get("REPRO_BENCH_ENGINE", default)
    assert engine in ENGINES, f"REPRO_BENCH_ENGINE={engine!r} not in {ENGINES}"
    return engine


def bench_num_envs(default: int = 8) -> int:
    """Stacked-env width knob (``REPRO_BENCH_NUM_ENVS``)."""
    return int(os.environ.get("REPRO_BENCH_NUM_ENVS", str(default)))


def train_variant(cfg: SimConfig, variant: str, episodes: int, *,
                  seed: int = 0, engine: Optional[str] = None,
                  num_envs: Optional[int] = None,
                  epsilon_final: float = 5e-2,
                  quality: Optional[np.ndarray] = None,
                  device=None) -> LearnGDMController:
    """Train one D3QL variant on one environment through the chosen engine.

    The epsilon schedule is calibrated via ``train_frames`` for the engine's
    actual frame count (scalar runs one episode per round; batched engines
    run ``num_envs``).

    ``quality``: optional (S, B+1) Ω matrix replacing the synthetic curves —
    the serving closed loop trains against the curves MEASURED from the real
    DiT services (:mod:`repro_torch.serving.gdm_service`).  The agent lives
    on ``device`` (the card by default).
    """
    engine = engine or bench_engine()
    num_envs = num_envs or bench_num_envs()
    ctrl = LearnGDMController(EdgeSimulator(cfg, quality=quality),
                              variant=variant, seed=seed, device=device)
    ctrl.calibrate_epsilon(
        episodes, num_envs=1 if engine == "scalar" else num_envs,
        final=epsilon_final)
    if engine == "fused":
        ctrl.train_fused(episodes, num_envs=num_envs)
    elif engine == "vectorized":
        venv = None
        if quality is not None:
            from repro_torch.sim.vec_env import VecEdgeSimulator
            venv = VecEdgeSimulator(cfg, num_envs,
                                    seeds=np.full(num_envs, cfg.seed),
                                    quality=quality)
        ctrl.train_vectorized(episodes, num_envs=num_envs, venv=venv)
    else:
        ctrl.train(episodes)
    return ctrl


def run_suite(cfg: SimConfig, *, train_eps: int, eval_eps: int,
              seed: int = 0, engine: Optional[str] = None,
              num_envs: Optional[int] = None,
              eval_engine: Optional[str] = None,
              variants: Iterable[str] = VARIANTS,
              include_opt: bool = True, device=None) -> Dict[str, float]:
    """One sweep point: train the D3QL variants, evaluate everything.

    Evaluation defaults to the batched vectorized path
    (``REPRO_BENCH_EVAL_ENGINE`` overrides; "fused" runs the device eval
    round instead).  On the vectorized/scalar paths episode seeds are
    ``9000 + ep`` — the same episodes ``opt_upper_bound`` replays, so the
    OPT bound covers exactly the evaluated traffic; the fused path draws
    its episodes from generators, making OPT a statistical comparison
    there.  Returns ``{variant_or_baseline: mean reward}``.
    """
    eval_engine = eval_engine or os.environ.get(
        "REPRO_BENCH_EVAL_ENGINE", "vectorized")
    assert eval_engine in ENGINES, \
        f"REPRO_BENCH_EVAL_ENGINE={eval_engine!r} not in {ENGINES}"
    point: Dict[str, float] = {}
    for variant in variants:
        ctrl = train_variant(cfg, variant, train_eps, seed=seed,
                             engine=engine, num_envs=num_envs, device=device)
        point[variant] = ctrl.evaluate(eval_eps, engine=eval_engine)["reward"]
    env = EdgeSimulator(cfg)
    point["gr"] = GreedyController(env).evaluate(
        eval_eps, engine=eval_engine, device=device)["reward"]
    if include_opt:
        point["opt"] = float(np.mean(
            [opt_upper_bound(env, seed=9_000 + ep)["reward"]
             for ep in range(eval_eps)]))
    return point


def serve_policy(cfg: SimConfig, policy, frames: int, *,
                 services: Dict[int, object], seed: int = 0,
                 early_exit: bool = True, record: bool = False,
                 return_bridge: bool = False, workload: str = "stationary",
                 workload_params: Optional[Dict] = None,
                 scheduling: str = "quantum", sched=None,
                 tracing: bool = False, tracer=None):
    """Deploy one core policy on the serving engine for one scenario trace.

    Builds the engine from the scenario's world
    (:func:`repro_torch.serving.policy_bridge.engine_from_scenario`), wraps
    ``policy`` in the :class:`~repro_torch.serving.policy_bridge.
    ServingPolicy` decision seam, derives the workload via
    :func:`repro_torch.sim.workloads.workload_trace` (``"stationary"``
    replays ``request_trace`` exactly), and serves it.  Returns the serving
    summary (latency/quality/objective); with ``return_bridge`` the bridge
    (and its recorded trace) comes back too.

    ``scheduling`` selects the engine loop (``"quantum"`` is the lockstep
    reference, ``"continuous"`` the iteration-level scheduler) and
    ``sched`` is the :class:`repro_torch.serving.scheduler.SchedulerConfig`
    for the continuous path.  ``tracing`` (or an explicit ``tracer``) opts
    into request-level span recording (:mod:`repro_torch.serving.tracing`)
    and instruments the services.
    """
    import dataclasses

    from repro_torch.serving.policy_bridge import (ServingPolicy,
                                                   engine_from_scenario,
                                                   serve_trace)
    from repro_torch.sim.workloads import workload_trace

    if tracer is None and tracing:
        from repro_torch.serving.tracing import Tracer
        tracer = Tracer()
    if tracer is not None:
        for svc in services.values():
            instrument = getattr(svc, "instrument", None)
            if instrument is not None:
                instrument(tracer.metrics)
    engine, world = engine_from_scenario(cfg, services,
                                         early_exit=early_exit,
                                         tracer=tracer)
    if scheduling != "quantum":
        engine.cfg = dataclasses.replace(engine.cfg, scheduling=scheduling)
    if sched is not None:
        from repro_torch.serving.scheduler import attach_scheduler
        attach_scheduler(engine, sched)
    bridge = ServingPolicy(policy, cfg, world=world, record=record)
    engine.placement_fn = bridge
    trace = workload_trace(cfg, frames, workload, seed=seed,
                           **(workload_params or {}))
    stats = serve_trace(engine, trace, services, seed=seed)
    if return_bridge:
        return stats, bridge
    return stats


def serve_fleet_policy(cfg: SimConfig, policy_factory, frames: int, *,
                       cells: int, services: Dict[int, object],
                       workload: str = "stationary", seed: int = 0,
                       handover_rate: float = 0.0, stacked: bool = True,
                       early_exit: bool = True, telemetry=None,
                       ledger=None, workload_params: Optional[Dict] = None,
                       fault_schedule: str = "none",
                       fault_params: Optional[Dict] = None,
                       recovery=None, scheduling: str = "quantum",
                       sched=None, tracing: bool = False, tracer=None):
    """Deploy policies on a C-cell fleet for one scenario × workload.

    ``policy_factory(cell) -> Policy`` builds each cell's placement policy
    (``None`` keeps the engine's default locality-greedy placement).
    Builds the fleet via
    :func:`repro_torch.serving.cluster.cluster_from_scenario`, derives the
    per-cell traces + handover schedule via
    :func:`repro_torch.sim.workloads.fleet_trace`, and serves the whole
    fleet under one clock.  Returns the fleet summary (per-cell summaries
    under ``"per_cell"``).

    ``fault_schedule`` names a :mod:`repro_torch.sim.faults` schedule
    injected over the run (``"none"``: no fault state is ever fed — the
    exact pre-fault driver); ``recovery`` is the per-cell
    :class:`repro_torch.serving.engine.RecoveryConfig`.  ``scheduling`` /
    ``sched`` opt the fleet into the continuous-batching engine (see
    :mod:`repro_torch.serving.scheduler`).
    """
    import dataclasses

    from repro_torch.serving.cluster import cluster_from_scenario, serve_fleet
    from repro_torch.sim.faults import fault_trace
    from repro_torch.sim.workloads import fleet_trace

    cluster = cluster_from_scenario(
        cfg, cells, services, policy_factory=policy_factory,
        early_exit=early_exit, stacked=stacked, telemetry=telemetry,
        ledger=ledger, recovery=recovery, sched=sched,
        tracing=tracing, tracer=tracer)
    if scheduling != "quantum":
        for eng in cluster.engines:
            eng.cfg = dataclasses.replace(eng.cfg, scheduling=scheduling)
    fleet = fleet_trace(cfg, frames, cells, workload=workload, seed=seed,
                        handover_rate=handover_rate,
                        **(workload_params or {}))
    faults = None
    if fault_schedule != "none":
        faults = fault_trace(cfg, frames, cells, fault_schedule, seed=seed,
                             **(fault_params or {}))
    return serve_fleet(cluster, fleet, services, seed=seed, faults=faults)


def _services_and_omega(cfg: SimConfig, services, seed: int,
                        steps_per_block: int, device):
    """The given services and their stacked Ω, or ``cfg.num_services``
    reduced DiT services built on ``device`` from ``seed``, measuring
    it."""
    if services is None:
        from repro_torch.serving.gdm_service import make_gdm_services
        return make_gdm_services(cfg.num_services, seed,
                                 num_blocks=cfg.max_blocks,
                                 steps_per_block=steps_per_block,
                                 device=device)
    return services, np.stack([services[s].omega
                               for s in range(cfg.num_services)])


def serve_fleet_variant(cfg: SimConfig, variant: str = "learn-gdm", *,
                        train_eps: int, frames: int, cells: int,
                        workload: str = "stationary", seed: int = 0,
                        handover_rate: float = 0.0,
                        engine: Optional[str] = None,
                        num_envs: Optional[int] = None,
                        services: Optional[Dict[int, object]] = None,
                        workload_params: Optional[Dict] = None,
                        fault_schedule: str = "none",
                        fault_params: Optional[Dict] = None,
                        recovery=None, scheduling: str = "quantum",
                        sched=None, tracing: bool = False, tracer=None,
                        device=None):
    """The closed loop at fleet scale: sim-train ONE placement variant
    against the measured Ω curves, then deploy it to every cell of a
    C-cell cluster and serve the fleet workload (optionally under an
    injected fault schedule + recovery policy).  The services are built on
    ``device`` from ``seed`` unless given, and the agent trains there."""
    from repro_torch.core.policy import LearnedPolicy
    services, omega = _services_and_omega(cfg, services, seed, 1, device)
    ctrl = train_variant(cfg, variant, train_eps, seed=seed, engine=engine,
                         num_envs=num_envs, quality=omega, device=device)
    stats = serve_fleet_policy(
        cfg, lambda c: LearnedPolicy(ctrl.agent, variant), frames,
        cells=cells, services=services, workload=workload, seed=seed,
        handover_rate=handover_rate, workload_params=workload_params,
        fault_schedule=fault_schedule, fault_params=fault_params,
        recovery=recovery, scheduling=scheduling, sched=sched,
        tracing=tracing, tracer=tracer)
    stats["train_episodes"] = train_eps
    return stats


def serve_variant(cfg: SimConfig, variant: str = "learn-gdm", *,
                  train_eps: int, frames: int, seed: int = 0,
                  engine: Optional[str] = None,
                  num_envs: Optional[int] = None,
                  steps_per_block: int = 1,
                  services: Optional[Dict[int, object]] = None,
                  early_exit: bool = True,
                  scheduling: str = "quantum",
                  sched=None, device=None) -> Dict[str, float]:
    """The paper's closed loop: sim-train a placement variant, deploy it on
    the real-model serving path, serve the scenario's request trace.

    (1) measure Ω(k) from the real DiT services (built on ``device`` from
    ``seed`` unless ``services`` is given), (2) train the D3QL variant in
    the simulator AGAINST those measured curves (``train_variant`` with
    ``quality=Ω``), (3) wrap the trained agent in the ServingPolicy seam and
    serve ``frames`` quanta of the scenario-derived trace.
    """
    from repro_torch.core.policy import LearnedPolicy
    services, omega = _services_and_omega(cfg, services, seed,
                                          steps_per_block, device)
    ctrl = train_variant(cfg, variant, train_eps, seed=seed, engine=engine,
                         num_envs=num_envs, quality=omega, device=device)
    stats = serve_policy(cfg, LearnedPolicy(ctrl.agent, variant), frames,
                         services=services, seed=seed, early_exit=early_exit,
                         scheduling=scheduling, sched=sched)
    stats["train_episodes"] = train_eps
    return stats


def qualitative_ordering(point: Dict[str, float],
                         tol: float = 1e-6) -> Dict[str, bool]:
    """The paper's Fig. 4 qualitative claims for one sweep point:
    LEARN-GDM >= MP, FP, GR and everything <= OPT.  With the default
    vectorized/scalar evaluation the bound is exact on the same evaluation
    episodes, so ``opt_upper`` holding is a hard correctness signal; under
    ``REPRO_BENCH_EVAL_ENGINE=fused`` the episode streams differ and both
    flags are statistical (as ``learn_gdm_top`` always is at small
    training scale)."""
    others = [k for k in ("mp", "fp", "gr") if k in point]
    out = {"learn_gdm_top": all(
        point["learn-gdm"] >= point[k] - tol for k in others)}
    if "opt" in point:
        out["opt_upper"] = all(
            point["opt"] + tol >= point[k]
            for k in ("learn-gdm", *others))
    return out
