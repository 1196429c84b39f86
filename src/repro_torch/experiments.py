"""Experiment layer: train/evaluate any controller, by name, and close the
paper's loop on the serving engine.

Port of ``repro.experiments``.  This is the one place benchmark and example
code goes through to (a) pick an engine (``REPRO_BENCH_ENGINE``: scalar |
vectorized | fused, and ``REPRO_BENCH_NUM_ENVS`` for the stacked width),
(b) train a D3QL variant with a correctly calibrated epsilon schedule
(``LearnGDMController.calibrate_epsilon`` over ``train_frames``), (c)
evaluate the paper comparison set (LEARN-GDM / MP / FP / GR / OPT) on one
environment point, and (d) serve a scenario under a trained policy.

The one deliberate difference from the reference: :func:`bench_engine`
defaults to ``"vectorized"`` (the reference's default is ``"fused"``),
because the port has no fused engine yet; ``"fused"`` raises, naming
ROADMAP Queue 1 item 8.  The fleet entry points (``serve_fleet_policy``,
``serve_fleet_variant``) and the continuous scheduler wait for item 9.

Entry points that build an agent or a DiT take ``device``: ``None`` means
the card (and raises without CUDA); the CPU runs pass ``device="cpu"``.
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


def bench_engine(default: str = "vectorized") -> str:
    """Training/eval engine knob (``REPRO_BENCH_ENGINE``).  Defaults to
    ``"vectorized"``, where the reference defaults to ``"fused"``: the
    port's fused engine is ROADMAP Queue 1 item 8, and asking for it
    raises where it would run."""
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
    (``REPRO_BENCH_EVAL_ENGINE`` overrides).  Episode seeds are
    ``9000 + ep`` — the same episodes ``opt_upper_bound`` replays, so the
    OPT bound covers exactly the evaluated traffic.  Returns
    ``{variant_or_baseline: mean reward}``.
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
        eval_eps, engine=eval_engine)["reward"]
    if include_opt:
        point["opt"] = float(np.mean(
            [opt_upper_bound(env, seed=9_000 + ep)["reward"]
             for ep in range(eval_eps)]))
    return point


def _no_continuous(scheduling: str, sched) -> None:
    if scheduling != "quantum" or sched is not None:
        raise NotImplementedError(
            "scheduling='continuous' and sched= need the iteration-level "
            "scheduler, which the port has not carried yet (ROADMAP Queue 1, "
            "item 9: fleet layer)")


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

    ``tracing`` (or an explicit ``tracer``) opts into request-level span
    recording (:mod:`repro_torch.serving.tracing`) and instruments the
    services.  Only ``scheduling="quantum"`` runs: the continuous scheduler
    (and ``sched``) raise until ROADMAP Queue 1 item 9.
    """
    from repro_torch.serving.policy_bridge import (ServingPolicy,
                                                   engine_from_scenario,
                                                   serve_trace)
    from repro_torch.sim.workloads import workload_trace

    _no_continuous(scheduling, sched)
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
    bridge = ServingPolicy(policy, cfg, world=world, record=record)
    engine.placement_fn = bridge
    trace = workload_trace(cfg, frames, workload, seed=seed,
                           **(workload_params or {}))
    stats = serve_trace(engine, trace, services, seed=seed)
    if return_bridge:
        return stats, bridge
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
    serve ``frames`` quanta of the scenario-derived trace.  The reference's
    ``impl`` knob has no counterpart: the kernels follow the tensors'
    device.
    """
    from repro_torch.core.policy import LearnedPolicy
    _no_continuous(scheduling, sched)
    if services is None:
        from repro_torch.serving.gdm_service import make_gdm_services
        services, omega = make_gdm_services(
            cfg.num_services, seed, num_blocks=cfg.max_blocks,
            steps_per_block=steps_per_block, device=device)
    else:
        omega = np.stack([services[s].omega
                          for s in range(cfg.num_services)])
    ctrl = train_variant(cfg, variant, train_eps, seed=seed, engine=engine,
                         num_envs=num_envs, quality=omega, device=device)
    stats = serve_policy(cfg, LearnedPolicy(ctrl.agent, variant), frames,
                         services=services, seed=seed, early_exit=early_exit)
    stats["train_episodes"] = train_eps
    return stats


def qualitative_ordering(point: Dict[str, float],
                         tol: float = 1e-6) -> Dict[str, bool]:
    """The paper's Fig. 4 qualitative claims for one sweep point:
    LEARN-GDM >= MP, FP, GR and everything <= OPT.  With the vectorized or
    scalar evaluation the bound is exact on the same evaluation episodes,
    so ``opt_upper`` holding is a hard correctness signal
    (``learn_gdm_top`` is statistical at small training scale)."""
    others = [k for k in ("mp", "fp", "gr") if k in point]
    out = {"learn_gdm_top": all(
        point["learn-gdm"] >= point[k] - tol for k in others)}
    if "opt" in point:
        out["opt_upper"] = all(
            point["opt"] + tol >= point[k]
            for k in ("learn-gdm", *others))
    return out
