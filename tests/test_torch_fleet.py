"""Port parity: the fleet layer — the fault registry, the continuous
scheduler, ``GDMService.SlotBatch``, the cluster and the fleet entry
points — against the JAX reference on the CPU.

The reference's fleet pins are brought over and run on the port with
reduced ``gdm-dit`` services (d=64, 2 layers, S=16):

* every fault schedule draws the reference's trace exactly;
* sync-mode continuous scheduling is frame-identical to the quantum engine
  (steps, summaries, telemetry JSON, ledger events), also under faults and
  for a single engine;
* ``SlotBatch.step`` is bit-identical to ``run_batch``;
* cluster cells equal standalone engines, and stacked execution equals
  sequential;
* handover conserves requests;
* a zero-fault run is frame-identical to one without fault plumbing;
* a traced run is frame-identical to an untraced one.

Then the port against the reference: ``serve_fleet_policy`` on the same
Ω, the same DiT weights and the same (carried) agent gives the
reference's summaries exactly (integer counts, and qualities read from the
same Ω), under quantum and continuous scheduling and under node churn
with recovery; the served latents within 1e-5 (float32 products summed in
another order).
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest

from repro import experiments as jexp
from repro.core import policy as jpol
from repro.rl import d3ql as jd3ql
from repro.serving import RecoveryConfig as JRecoveryConfig
from repro.serving import cluster as jcluster_mod
from repro.serving import gdm_service as jsvc_mod
from repro.serving import scheduler as jsched_mod
from repro.sim import faults as jfaults
from repro.sim import scenarios as jscen
from repro_torch import experiments as texp
from repro_torch.configs import get_config
from repro_torch.core import policy as tpol
from repro_torch.models.convert import service_from_jax
from repro_torch.rl import d3ql as td3ql
from repro_torch.serving import (RecoveryConfig, SchedulerConfig,
                                 TelemetryLog, TransferLedger,
                                 cluster_from_scenario, engine_from_scenario,
                                 serve_fleet, serve_trace, ServingPolicy)
from repro_torch.serving import cluster as tcluster_mod
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.gdm_service import GDMService, make_gdm_services
from repro_torch.serving.scheduler import attach_scheduler
from repro_torch.serving.tracing import Tracer
from repro_torch.sim import env as tenv
from repro_torch.sim import faults as tfaults
from repro_torch.sim.scenarios import get_scenario
from repro_torch.sim.workloads import fleet_trace, workload_trace

LAT_TOL = 1e-5
CELLS = 3
FRAMES = 12
DIT = get_config("gdm-dit").reduced()


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- the fault registry ----------------------------------------------------------------

def test_fault_registry_equals_reference():
    assert tfaults.fault_names() == jfaults.fault_names()
    assert tfaults.fault_descriptions() == jfaults.fault_descriptions()
    assert tfaults.FAULT_LEGS == jfaults.FAULT_LEGS


_FAULT_PARAMS = {"node-churn": dict(mttf=8.0, mttr=4.0),
                 "link-degrade": dict(p_degrade=0.2, factor=2.5),
                 "stragglers": dict(prob=0.3, factor=0.25),
                 "cell-outage": dict(duration=9, prob=0.5),
                 "mixed": dict(mttf=10.0, straggle_prob=0.4)}


@pytest.mark.parametrize("schedule", jfaults.fault_names())
def test_fault_trace_equals_reference(schedule):
    """Each schedule at its defaults and at other parameters, for a few
    seeds, fleet sizes and scenarios: the same arrays, exactly."""
    for name, frames, cells, seed in (("paper-fig3", 40, 4, 0),
                                      ("smoke", 12, 1, 3),
                                      ("hetero-capacity", 25, 3, 11)):
        tcfg, jcfg = get_scenario(name), jscen.get_scenario(name)
        for params in ({}, _FAULT_PARAMS.get(schedule, {})):
            got = tfaults.fault_trace(tcfg, frames, cells, schedule,
                                      seed=seed, **params)
            want = jfaults.fault_trace(jcfg, frames, cells, schedule,
                                       seed=seed, **params)
            assert (got.frames, got.num_cells, got.schedule) == \
                (want.frames, want.num_cells, want.schedule)
            for key in ("node_up", "cap_scale", "link_scale"):
                a, b = getattr(got, key), getattr(want, key)
                assert a.dtype == b.dtype, key
                np.testing.assert_array_equal(a, b, err_msg=key)
            assert got.any_fault == want.any_fault
            for t in (0, frames - 1):
                for c in range(cells):
                    for a, b in zip(got.cell_state(t, c),
                                    want.cell_state(t, c)):
                        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="unknown fault schedule"):
        tfaults.fault_trace(get_scenario("smoke"), 4, 1, "meteor")


# -- the port's fleet with reduced DiT services -----------------------------------------

@pytest.fixture(scope="module")
def dit_models():
    """Three reduced DiTs on the CPU with their measured Ω; services are
    rebuilt from them per run (fresh counters, one model each)."""
    services, omega = make_gdm_services(3, 0, num_blocks=4, device="cpu")
    return [(services[s].model, services[s].omega) for s in range(3)]


def _services(models, omega=None):
    """Fresh services on the shared models, with their measured Ω or the
    given one."""
    return {s: GDMService(model=m, omega=o if omega is None else omega,
                          num_blocks=4)
            for s, (m, o) in enumerate(models)}


def _learned_factory(cfg):
    env = tenv.EdgeSimulator(cfg)
    agent = td3ql.D3QLAgent(td3ql.D3QLConfig(
        obs_dim=env.obs_dim, num_ues=cfg.num_ues,
        num_actions=cfg.num_bs + 1, seed=0), device="cpu")
    return lambda c: tpol.LearnedPolicy(agent, "learn-gdm")


_POLICY_FACTORIES = {
    "default": lambda cfg: None,
    "greedy-bridge": lambda cfg: (lambda c: tpol.GreedyPoAPolicy()),
    "learned-bridge": _learned_factory,
}


def _engine_cfg(cfg, scheduling):
    return EngineConfig(max_blocks=cfg.max_blocks,
                        admission_slots=cfg.num_channels, alpha=cfg.alpha,
                        beta=cfg.beta, early_exit=True, seed=cfg.seed,
                        scheduling=scheduling)


def _fleet_run(models, scheduling="quantum", sched=None, *,
               policy_factory=None, workload="flash-crowd", seed=3,
               frames=FRAMES, cells=CELLS, handover_rate=0.1, faults=None,
               recovery=None, stacked=True, tracer=None, cfg=None,
               omega=None):
    cfg = cfg or get_scenario("smoke")
    services = _services(models, omega)
    telemetry, ledger = TelemetryLog(), TransferLedger()
    cluster = cluster_from_scenario(
        cfg, cells, services, policy_factory=policy_factory,
        engine_cfg=_engine_cfg(cfg, scheduling), telemetry=telemetry,
        ledger=ledger, recovery=recovery, sched=sched, stacked=stacked,
        tracer=tracer)
    fleet = fleet_trace(cfg, frames, cells, workload=workload, seed=seed,
                        handover_rate=handover_rate)
    out = serve_fleet(cluster, fleet, services, seed=0, collect_steps=True,
                      faults=faults)
    return out, telemetry, ledger, cluster


def _strip(summary):
    """Drop the tracer-only critical_path key (top level + per cell)."""
    s = copy.deepcopy(summary)
    s.pop("critical_path", None)
    for c in s.get("per_cell", ()):
        c.pop("critical_path", None)
    return s


def _assert_frame_for_frame(a, b, *, strip=False):
    (out_a, tel_a, led_a, _), (out_b, tel_b, led_b, _) = a, b
    assert len(out_a["steps"]) == len(out_b["steps"])
    for t in range(len(out_a["steps"])):
        assert out_b["steps"][t] == out_a["steps"][t], t
    if strip:
        out_a, out_b = _strip(out_a), _strip(out_b)
    assert out_b == out_a
    assert tel_b.to_json() == tel_a.to_json()
    assert [vars(e) for e in led_b.events] == [vars(e) for e in led_a.events]


@pytest.mark.parametrize("policy_name", sorted(_POLICY_FACTORIES))
def test_sync_mode_pins_quantum_engine(dit_models, policy_name):
    """continuous(join_leave=False, skew=0) == quantum, frame for frame."""
    cfg = get_scenario("smoke")
    factory = _POLICY_FACTORIES[policy_name](cfg)
    ref = _fleet_run(dit_models, policy_factory=factory)
    got = _fleet_run(dit_models, "continuous",
                     SchedulerConfig(join_leave=False),
                     policy_factory=factory)
    _assert_frame_for_frame(ref, got)
    assert ref[0]["completed"] > 0


def test_sync_mode_pins_quantum_engine_under_faults(dit_models):
    cfg = get_scenario("smoke")
    faults = tfaults.fault_trace(cfg, FRAMES, CELLS, "node-churn", seed=11,
                                 mttf=8.0, mttr=4.0)
    assert faults.any_fault
    recovery = RecoveryConfig(mode="failover", deadline_frames=10)
    kw = dict(faults=faults, recovery=recovery, workload="stationary",
              seed=11)
    ref = _fleet_run(dit_models, **kw)
    got = _fleet_run(dit_models, "continuous",
                     SchedulerConfig(join_leave=False), **kw)
    _assert_frame_for_frame(ref, got)


def test_sync_mode_pins_quantum_single_engine_trace(dit_models):
    """The standalone ``ServingEngine.step`` dispatch (continuous_step),
    through the single-cell serve_trace driver."""
    cfg = get_scenario("smoke")

    def run(scheduling):
        services = _services(dit_models)
        engine, _ = engine_from_scenario(cfg, services)
        if scheduling == "continuous":
            engine.cfg = dataclasses.replace(engine.cfg,
                                             scheduling="continuous")
            attach_scheduler(engine, SchedulerConfig(join_leave=False))
        trace = workload_trace(cfg, FRAMES, "flash-crowd", seed=4)
        return serve_trace(engine, trace, services, seed=0)

    got, want = run("continuous"), run("quantum")
    assert got == want and want["completed"] > 0


def test_slot_batch_matches_run_batch_bit_for_bit(dit_models):
    """Joins, continuing rows (resident: not restaged), a leave, a join
    into the freed row, a recycled rid with a foreign state (restaged), a
    bucket change, and ``run_batch`` interleaved: every output equals
    ``run_batch`` on the same states bit for bit."""
    svc = _services(dit_models)[0]
    rng = np.random.default_rng(0)
    states = [svc.init_state(rng) for _ in range(3)]
    ks = np.asarray([0, 1, 0])
    want, want_q = svc.run_batch([dict(s) for s in states], ks)

    sb = svc.slot_batch()
    assert sb is svc.slot_batch()            # lazily built, then cached
    got, got_q = sb.step([(rid, dict(states[rid]), int(ks[rid]))
                          for rid in range(3)])
    np.testing.assert_array_equal(want_q, got_q)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w["latent"], g["latent"])
        np.testing.assert_array_equal(w["x0"], g["x0"])

    # leave rid 1, continue 0 and 2 (resident rows: no restage), join 7
    staged0 = sb.rows_staged
    cont = [(0, got[0], 1), (2, got[2], 1), (7, svc.init_state(rng), 0)]
    got2, _ = sb.step(cont)
    assert sb.rows_staged == staged0 + 1     # only the join restaged
    assert 1 not in sb.rows and set(sb.rows) == {0, 2, 7}
    assert sb.rows[7] == 1                   # the freed row, reused
    # an interleaved run_batch must not disturb the resident rows
    want2, _ = svc.run_batch([dict(got[0]), dict(got[2]), dict(cont[2][1])],
                             np.asarray([1, 1, 0]))
    for w, g in zip(want2, got2):
        np.testing.assert_array_equal(w["latent"], g["latent"])
        np.testing.assert_array_equal(w["x0"], g["x0"])
    staged1 = sb.rows_staged
    got3, _ = sb.step([(0, got2[0], 2), (2, got2[1], 2), (7, got2[2], 1)])
    assert sb.rows_staged == staged1         # all three resident
    want3, _ = svc.run_batch([dict(g) for g in got2], np.asarray([2, 2, 1]))
    for w, g in zip(want3, got3):
        np.testing.assert_array_equal(w["latent"], g["latent"])

    # a recycled rid with a foreign state fails the residency check
    staged2 = sb.rows_staged
    foreign = svc.init_state(rng)
    got4, _ = sb.step([(0, foreign, 0)])
    want4, _ = svc.run_batch([dict(foreign)], np.asarray([0]))
    np.testing.assert_array_equal(want4[0]["latent"], got4[0]["latent"])
    assert sb.rows_staged == staged2 + 1 and sb.bucket == 1
    # a batch past 8 rows takes the multiple-of-8 bucket
    many = [(100 + i, svc.init_state(rng), i % 4) for i in range(9)]
    got5, _ = sb.step(many)
    want5, _ = svc.run_batch([dict(s) for _, s, _ in many],
                             np.asarray([k for _, _, k in many]))
    assert sb.bucket == 16
    for w, g in zip(want5, got5):
        np.testing.assert_array_equal(w["latent"], g["latent"])
        np.testing.assert_array_equal(w["x0"], g["x0"])
    assert sb.device_calls == 5
    assert sb.step([])[0] == []


def test_continuous_fleet_uses_slot_batches(dit_models):
    """The continuous fleet driver with join/leave routes the stacked step
    through the services' slot batches."""
    out, _, _, cluster = _fleet_run(dit_models, "continuous",
                                    SchedulerConfig(), cells=2, frames=8)
    assert out["completed"] > 0
    calls = sum(s.slot_batch().device_calls
                for s in cluster.services.values())
    assert calls > 0


def _record_steps(engine):
    log = []
    orig = engine.step

    def step():
        log.append(orig())
        return log[-1]

    engine.step = step
    return log


@pytest.mark.parametrize("policy_name", ["default", "greedy-bridge",
                                         "random-bridge"])
def test_cluster_cells_match_standalone_engines(dit_models, policy_name):
    """With handover off, every cell of the stacked fleet reproduces a
    standalone engine on its own trace, step for step."""
    cfg = get_scenario("smoke")
    factory = {"default": None,
               "greedy-bridge": lambda c: tpol.GreedyPoAPolicy(),
               "random-bridge": lambda c: tpol.RandomPolicy(seed=c)}[
                   policy_name]
    fleet = fleet_trace(cfg, FRAMES, CELLS, workload="stationary", seed=5)
    standalone = []
    for c in range(CELLS):
        services = _services(dit_models)
        engine, world = engine_from_scenario(cfg, services)
        if factory is not None:
            engine.placement_fn = ServingPolicy(factory(c), cfg, world=world)
        log = _record_steps(engine)
        out = serve_trace(engine, fleet.cells[c], services, seed=(0, c))
        standalone.append((out, log, engine.summary(FRAMES)))
    services = _services(dit_models)
    cluster = cluster_from_scenario(cfg, CELLS, services,
                                    policy_factory=factory)
    out = serve_fleet(cluster, fleet, services, seed=0, collect_steps=True)
    for c in range(CELLS):
        _, ref_log, ref_summary = standalone[c]
        assert cluster.engines[c].summary(FRAMES) == ref_summary
        for t in range(FRAMES):
            assert out["steps"][t][c] == ref_log[t], (c, t)
    assert out["completed"] == sum(s[0]["completed"] for s in standalone) > 0
    assert out["submitted"] == sum(s[0]["submitted"] for s in standalone)
    # one stacked device call per (service, quantum) at most
    assert sum(s.batch_calls for s in services.values()) <= 3 * FRAMES


def test_stacked_equals_sequential_execution(dit_models):
    stacked = _fleet_run(dit_models, workload="diurnal", seed=9)
    sequential = _fleet_run(dit_models, workload="diurnal", seed=9,
                            stacked=False)
    _assert_frame_for_frame(stacked, sequential)
    calls = [sum(s.batch_calls for s in run[3].services.values())
             for run in (stacked, sequential)]
    assert 0 < calls[0] < calls[1]


@pytest.mark.parametrize("scheduling", ["quantum", "continuous"])
def test_fleet_handover_conserves_requests(dit_models, scheduling):
    """A slowly rising Ω (0.12 a block) against thresholds of 0.4-0.5
    keeps chains in flight for handover to move."""
    cfg = get_scenario("smoke", arrival_prob=0.08, qbar_low=0.4,
                       qbar_high=0.5)
    sched = SchedulerConfig(skew=0.4, steps_per_quantum=1) \
        if scheduling == "continuous" else None
    out, _, ledger, cluster = _fleet_run(
        dit_models, scheduling, sched, cfg=cfg, frames=30, workload="mmpp",
        seed=2, handover_rate=0.3, omega=0.12 * np.arange(5))
    assert out["handovers"] > 0
    in_flight = sum(len(e.active) + len(e.pending) for e in cluster.engines)
    terminal = [r.rid for e in cluster.engines for r in e.completed + e.failed]
    assert len(terminal) == len(set(terminal))
    assert len(terminal) + in_flight == out["submitted"]
    assert ledger.totals()["handover"]["count"] == cluster.handovers_applied


@pytest.mark.parametrize("scheduling", ["quantum", "continuous"])
def test_zero_fault_run_identical_to_no_fault_plumbing(dit_models,
                                                       scheduling):
    cfg = get_scenario("smoke")
    sched = SchedulerConfig(skew=0.4, sub_quantum_arrivals=True,
                            backpressure_depth=2.0) \
        if scheduling == "continuous" else None
    kw = dict(policy_factory=_learned_factory(cfg), workload="diurnal",
              seed=5)
    ref = _fleet_run(dit_models, scheduling, sched, **kw)
    got = _fleet_run(dit_models, scheduling, sched,
                     faults=tfaults.fault_trace(cfg, FRAMES, CELLS, "none",
                                                seed=7), **kw)
    _assert_frame_for_frame(ref, got)
    out = got[0]
    assert out["drops"] == out["retries"] == out["failovers"] == 0
    assert out["deadline_misses"] == 0
    assert out["goodput"] == out["completed"] > 0


@pytest.mark.parametrize("scheduling", ["quantum", "continuous"])
def test_traced_run_identical_to_untraced(dit_models, scheduling):
    cfg = get_scenario("smoke")
    sched = SchedulerConfig(skew=0.3) if scheduling == "continuous" else None
    faults = tfaults.fault_trace(cfg, FRAMES, 2, "mixed", seed=3)
    kw = dict(policy_factory=_learned_factory(cfg), cells=2, faults=faults,
              recovery=RecoveryConfig(mode="failover", deadline_frames=8))
    ref = _fleet_run(dit_models, scheduling, sched, **kw)
    tracer = Tracer()
    got = _fleet_run(dit_models, scheduling, sched, tracer=tracer, **kw)
    _assert_frame_for_frame(ref, got, strip=True)
    assert "critical_path" in got[0]
    assert tracer.metrics.counters["gdm_runner_calls"].value > 0
    assert "gdm_compile_ms" in tracer.metrics.histograms


# -- the port against the reference ---------------------------------------------------

@pytest.fixture(scope="module")
def ref_fleet():
    """The reference's reduced DiT services for ``smoke`` (Ω measured by
    the reference, ``impl="xla"``) and a reference agent; the port takes
    their weights, Ω and parameters."""
    cfg = jscen.get_scenario("smoke")
    services, _ = jsvc_mod.make_gdm_services(
        cfg.num_services, jax.random.PRNGKey(0), num_blocks=cfg.max_blocks,
        steps_per_block=1, impl="xla")
    env = jexp.EdgeSimulator(cfg)
    jcfg = jd3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=cfg.num_ues,
                            num_actions=cfg.num_bs + 1, seed=4)
    jagent = jd3ql.D3QLAgent(jcfg)
    tagent = td3ql.D3QLAgent(td3ql.D3QLConfig(**dataclasses.asdict(jcfg)),
                             device="cpu", params=_np_tree(jagent.params))
    return services, jagent, tagent


def _port_services(ref_services):
    return {s: service_from_jax(
        _np_tree(svc.params), DIT, omega=svc.omega,
        num_blocks=svc.num_blocks, steps_per_block=svc.steps_per_block,
        prompt_len=svc.prompt_len, device="cpu")
        for s, svc in ref_services.items()}


def _keep_clusters(monkeypatch, mod):
    """Record the clusters ``serve_fleet_policy`` builds inside."""
    kept = []
    build = mod.cluster_from_scenario

    def keep(*a, **k):
        kept.append(build(*a, **k))
        return kept[-1]

    monkeypatch.setattr(mod, "cluster_from_scenario", keep)
    return kept


_FLEET_CASES = {
    "quantum": {},
    "continuous": dict(scheduling="continuous"),
    "continuous-skew": dict(scheduling="continuous", sched="skew"),
    "node-churn": dict(fault_schedule="node-churn",
                       fault_params=dict(mttf=3.0, mttr=6.0),
                       recovery="failover+degrade"),
}


@pytest.mark.parametrize("case", sorted(_FLEET_CASES))
def test_serve_fleet_policy_equals_reference(ref_fleet, monkeypatch, case):
    """The learned policy (carried agent) on a 3-cell ``smoke`` fleet
    under a diurnal workload with handover, traced: the same summary,
    per-cell summaries and metric counts; every served latent within
    1e-5."""
    ref_services, jagent, tagent = ref_fleet
    for svc in ref_services.values():
        # the services outlive a case: forget the shapes an earlier case
        # compiled, as the port's fresh services have none
        svc._compiled_keys = set()
    sides = {}
    for side, exp, pol, services, agent, cfg, sched_cls, cl_mod, rec_cls in (
            ("port", texp, tpol, _port_services(ref_services), tagent,
             get_scenario("smoke"), SchedulerConfig, tcluster_mod,
             RecoveryConfig),
            ("ref", jexp, jpol, ref_services, jagent,
             jscen.get_scenario("smoke"), jsched_mod.SchedulerConfig,
             jcluster_mod, JRecoveryConfig)):
        kw = dict(_FLEET_CASES[case])
        if kw.get("sched") == "skew":
            kw["sched"] = sched_cls(skew=0.5, sub_quantum_arrivals=True)
        if kw.get("recovery") == "failover+degrade":
            kw["recovery"] = rec_cls(mode="failover", deadline_frames=16,
                                     degrade=True)
        clusters = _keep_clusters(monkeypatch, cl_mod)
        before = sum(s.batch_calls for s in services.values())
        stats = exp.serve_fleet_policy(
            cfg, lambda c: pol.LearnedPolicy(agent, "learn-gdm"), 16,
            cells=CELLS, services=services, workload="diurnal", seed=1,
            handover_rate=0.1, tracing=True, **kw)
        calls = sum(s.batch_calls for s in services.values()) - before
        sides[side] = (stats, clusters[-1], calls)
    (t_stats, t_cl, t_calls), (j_stats, j_cl, j_calls) = \
        sides["port"], sides["ref"]
    assert _strip(t_stats) == _strip(j_stats)
    assert t_stats["completed"] > 0 and t_calls == j_calls > 0
    if case == "node-churn":
        assert sum(t_stats[k] for k in ("failovers", "drops", "retries",
                                        "deadline_misses")) > 0
    t_m, j_m = t_cl.tracer.metrics, j_cl.tracer.metrics
    assert {k: c.value for k, c in t_m.counters.items()} == \
        {k: c.value for k, c in j_m.counters.items()}
    for t_eng, j_eng in zip(t_cl.engines, j_cl.engines):
        assert [r.rid for r in t_eng.completed] == \
            [r.rid for r in j_eng.completed]
        for t, j in zip(t_eng.completed, j_eng.completed):
            for key in ("latent", "x0"):
                np.testing.assert_allclose(t.state[key], j.state[key],
                                           atol=LAT_TOL, rtol=LAT_TOL)


def test_serve_policy_continuous_equals_reference(ref_fleet):
    """One cell under the continuous scheduler with join/leave (the slot
    batches on the device side) gives the reference's summary."""
    ref_services, jagent, tagent = ref_fleet
    t_stats = texp.serve_policy(
        get_scenario("smoke"), tpol.LearnedPolicy(tagent, "learn-gdm"), 12,
        services=_port_services(ref_services), seed=2,
        workload="flash-crowd", scheduling="continuous",
        sched=SchedulerConfig(sub_quantum_arrivals=True))
    j_stats = jexp.serve_policy(
        jscen.get_scenario("smoke"), jpol.LearnedPolicy(jagent, "learn-gdm"),
        12, services=ref_services, seed=2, workload="flash-crowd",
        scheduling="continuous",
        sched=jsched_mod.SchedulerConfig(sub_quantum_arrivals=True))
    assert t_stats == j_stats and t_stats["completed"] > 0


@pytest.mark.parametrize("case", ["quantum", "continuous", "node-churn"])
def test_serve_fleet_variant_on_the_cpu(case):
    """The fleet closed loop end to end on the CPU: reduced DiT services
    built from the seed, LEARN-GDM trained through the fused engine (the
    default), a 2-cell fleet served."""
    cfg = get_scenario("smoke")
    kw = {"quantum": {},
          "continuous": dict(scheduling="continuous",
                             sched=SchedulerConfig(skew=0.5)),
          "node-churn": dict(fault_schedule="node-churn",
                             fault_params=dict(mttf=6.0, mttr=3.0),
                             recovery=RecoveryConfig(mode="failover",
                                                     deadline_frames=16,
                                                     degrade=True))}[case]
    stats = texp.serve_fleet_variant(
        cfg, "learn-gdm", train_eps=4, frames=10, cells=2, num_envs=2,
        workload="diurnal", handover_rate=0.1, device="cpu", **kw)
    assert stats["train_episodes"] == 4 and stats["cells"] == 2
    assert stats["completed"] > 0 and len(stats["per_cell"]) == 2
    assert stats["completed"] <= stats["submitted"]
    assert 0.0 <= stats["mean_quality"] <= 1.0
