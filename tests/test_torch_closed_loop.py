"""Port parity: the controller, the policies and the serving seam — the
paper's closed loop — against the JAX reference on the ``smoke`` scenario.

* the variant action masks (learn-gdm / MP / FP, and dead nodes), exactly;
* ``evaluate_batched`` for GR, the random policy and a learned policy whose
  Q-net holds the reference's parameters, exactly;
* ``train_vectorized`` in lockstep with the reference from the same
  parameters: every frame's actions, every episode's reward and delivered
  quality exactly, the losses within 1e-4;
* ``serve_policy`` under the bridged learned policy, frame for frame: with
  a linear stand-in for the DiT (summaries and bridge traces equal), and
  with reduced DiT services carried from the reference's (summaries and
  metrics equal, latents within 1e-5);
* ``serve_variant`` end to end on the CPU, the fused engine as the
  default and the continuous scheduler, and the mesh paths, which raise
  until they are ported.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import experiments as jexp
from repro.core import learn_gdm as jlg
from repro.core import policy as jpol
from repro.rl import d3ql as jd3ql
from repro.serving import gdm_service as jsvc_mod
from repro.serving import policy_bridge as jbridge
from repro.sim import env as jenv
from repro.sim import scenarios as jscen
from repro.sim import vec_env as jvec
from repro_torch import experiments as texp
from repro_torch.configs import get_config
from repro_torch.core import learn_gdm as tlg
from repro_torch.core import policy as tpol
from repro_torch.launch.mesh import make_env_mesh
from repro_torch.models.convert import service_from_jax
from repro_torch.rl import d3ql as td3ql
from repro_torch.serving import policy_bridge as tbridge
from repro_torch.sim import env as tenv
from repro_torch.sim import scenarios as tscen
from repro_torch.sim import vec_env as tvec

LAT_TOL = 1e-5
LOSS_TOL = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _configs(name="smoke", **kw):
    return tscen.get_scenario(name, **kw), jscen.get_scenario(name, **kw)


def _agents(cfg, seed=0):
    """A reference agent for ``cfg``'s env and a port agent holding its
    parameters (same seed: the same exploration and replay streams)."""
    env = jenv.EdgeSimulator(cfg)
    jcfg = jd3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=cfg.num_ues,
                            num_actions=cfg.num_bs + 1, seed=seed)
    jagent = jd3ql.D3QLAgent(jcfg)
    tagent = td3ql.D3QLAgent(td3ql.D3QLConfig(**dataclasses.asdict(jcfg)),
                             device="cpu", params=_np_tree(jagent.params))
    return jagent, tagent


class LinearService:
    """Deterministic stand-in for a DiT service (``tests/test_policy_bridge.
    py``'s): one block adds ``per_block`` quality."""

    def __init__(self, per_block=0.22):
        self.per_block = per_block
        self.omega = np.minimum(self.per_block * np.arange(5), 1.0)

    def block_fn(self, state, block_idx):
        states, qs = self.run_batch([state], np.asarray([block_idx]))
        return states[0], float(qs[0])

    def run_batch(self, states, block_idxs):
        return ([dict(s or {}) for s in states],
                np.minimum(self.per_block * (np.asarray(block_idxs) + 1),
                           1.0))

    def init_state(self, rng):
        return {}


# -- the variant masks ----------------------------------------------------------------

@pytest.mark.parametrize("variant", ["learn-gdm", "mp", "fp"])
def test_variant_masks_equal_reference(variant):
    """Scalar and batched masks along random episodes (chains started,
    mid-chain and finished), and with a dead node on a slot view."""
    tcfg, jcfg = _configs()
    t, j = tenv.EdgeSimulator(tcfg), jenv.EdgeSimulator(jcfg)
    tv = tvec.VecEdgeSimulator(tcfg, 3, seeds=[5, 6, 7])
    jv = jvec.VecEdgeSimulator(jcfg, 3, seeds=[5, 6, 7])
    rng = np.random.default_rng(0)
    for _ in range(tcfg.horizon):
        got, want = (tlg.variant_action_mask(t, variant),
                     jlg.variant_action_mask(j, variant))
        np.testing.assert_array_equal(got, want)
        got_v, want_v = (tlg.variant_action_mask_vec(tv, variant),
                         jlg.variant_action_mask_vec(jv, variant))
        np.testing.assert_array_equal(got_v, want_v)
        placement = rng.integers(-1, tcfg.num_bs, (3, tcfg.num_ues))
        mac = rng.integers(-1, tcfg.num_channels, (3, tcfg.num_ues))
        t.step(mac[0], placement[0])
        j.step(mac[0], placement[0])
        tv.step(mac, placement)
        jv.step(mac, placement)
    up = np.ones(tcfg.num_bs, dtype=bool)
    up[[2, 7]] = False
    views = [mod._SlotView(cfg, 1, v.chain_state[:1], v.poa[:1],
                           v.cur_node[:1], v.blocks_done[:1],
                           node_up=up[None])
             for mod, cfg, v in ((tbridge, tcfg, tv), (jbridge, jcfg, jv))]
    got, want = (tlg.variant_action_mask_vec(views[0], variant),
                 jlg.variant_action_mask_vec(views[1], variant))
    np.testing.assert_array_equal(got, want)
    assert not got[..., 1 + 2].any() and not got[..., 1 + 7].any()


# -- batched evaluation -----------------------------------------------------------------

@pytest.mark.parametrize("policy", ["gr", "random", "random-fp", "learned",
                                    "learned-mp"])
def test_evaluate_batched_equals_reference(policy):
    tcfg, jcfg = _configs()
    if policy == "gr":
        pols = tpol.GreedyPoAPolicy(), jpol.GreedyPoAPolicy()
    elif policy.startswith("random"):
        variant = "fp" if policy.endswith("fp") else "learn-gdm"
        pols = (tpol.RandomPolicy(variant, seed=3),
                jpol.RandomPolicy(variant, seed=3))
    else:
        variant = "mp" if policy.endswith("mp") else "learn-gdm"
        jagent, tagent = _agents(jcfg, seed=2)
        pols = (tpol.LearnedPolicy(tagent, variant),
                jpol.LearnedPolicy(jagent, variant))
    for num_envs in (None, 3):
        got = tpol.evaluate_batched(pols[0], tenv.EdgeSimulator(tcfg), 5,
                                    num_envs=num_envs)
        want = jpol.evaluate_batched(pols[1], jenv.EdgeSimulator(jcfg), 5,
                                     num_envs=num_envs)
        assert got == want


def test_controller_evaluate_equals_reference():
    """The controller's greedy evaluation through both engines it offers
    (the batched rollout and the scalar reference loop)."""
    tcfg, jcfg = _configs()
    jagent, tagent = _agents(jcfg, seed=1)
    tctrl = tlg.LearnGDMController(tenv.EdgeSimulator(tcfg), agent=tagent)
    jctrl = jlg.LearnGDMController(jenv.EdgeSimulator(jcfg), agent=jagent)
    for engine in ("vectorized", "scalar"):
        assert tctrl.evaluate(3, engine=engine) == \
            jctrl.evaluate(3, engine=engine)


# -- training in lockstep -----------------------------------------------------------------

def _record(agent, log):
    act_batch = agent.act_batch

    def recording(obs_hist, **kw):
        actions = act_batch(obs_hist, **kw)
        log.append((obs_hist.copy(), actions.copy(), agent.epsilon))
        return actions

    agent.act_batch = recording


def test_train_vectorized_in_lockstep_with_reference():
    """Four episodes at E = 2 from the same parameters and seeds: the
    same actions every frame (exploring and greedy), hence the same
    rewards and deliveries exactly; the losses within 1e-4."""
    tcfg, jcfg = _configs()
    jagent, tagent = _agents(jcfg)
    tctrl = tlg.LearnGDMController(tenv.EdgeSimulator(tcfg), agent=tagent)
    jctrl = jlg.LearnGDMController(jenv.EdgeSimulator(jcfg), agent=jagent)
    logs = {"port": [], "ref": []}
    _record(tagent, logs["port"])
    _record(jagent, logs["ref"])
    for ctrl in (tctrl, jctrl):
        ctrl.calibrate_epsilon(4, num_envs=2, final=5e-2)
    got = tctrl.train_vectorized(4, num_envs=2)
    want = jctrl.train_vectorized(4, num_envs=2)
    assert len(logs["port"]) == len(logs["ref"]) == 2 * tcfg.horizon
    greedy_frames = 0
    for frame, ((o_t, a_t, e_t), (o_j, a_j, e_j)) in enumerate(
            zip(logs["port"], logs["ref"])):
        np.testing.assert_array_equal(o_t, o_j)
        assert e_t == e_j
        if not np.array_equal(a_t, a_j):
            q = tagent.q_values(o_t)
            top2 = np.sort(q, axis=-1)[..., -2:]
            gap = float((top2[..., 1] - top2[..., 0]).min())
            pytest.fail(f"frame {frame}: actions differ; the port's "
                        f"smallest top-2 Q gap is {gap:.3e}")
        greedy_frames += e_t < 0.5
    assert greedy_frames > 0
    assert got["reward"] == want["reward"]
    assert got["delivered"] == want["delivered"]
    valid = [(a, b) for a, b in zip(got["loss"], want["loss"])
             if not np.isnan(b)]
    assert valid and all(abs(a - b) <= LOSS_TOL * abs(b) for a, b in valid)
    assert tagent.steps == jagent.steps > 0
    assert tagent.epsilon == jagent.epsilon


# -- serving under the bridged policy ----------------------------------------------------

def _serve(exp, pol_mod, agent, cfg, services, monkeypatch, bridge_mod,
           **kw):
    """``serve_policy`` under ``LearnedPolicy(agent)``, keeping the engine
    it built."""
    engines = []
    build = bridge_mod.engine_from_scenario

    def keep(*a, **k):
        engine, world = build(*a, **k)
        engines.append(engine)
        return engine, world

    monkeypatch.setattr(bridge_mod, "engine_from_scenario", keep)
    stats, bridge = exp.serve_policy(
        cfg, pol_mod.LearnedPolicy(agent, "learn-gdm"), 10, services=services,
        seed=1, record=True, return_bridge=True, **kw)
    return stats, bridge, engines[0]


def _same_traces(t_bridge, j_bridge):
    assert len(t_bridge.trace) == len(j_bridge.trace) > 0
    for (f_t, o_t, a_t), (f_j, o_j, a_j) in zip(t_bridge.trace,
                                                  j_bridge.trace):
        assert f_t == f_j
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(a_t, a_j)


def test_serve_policy_learned_bridge_equals_reference(monkeypatch):
    tcfg, jcfg = _configs()
    jagent, tagent = _agents(jcfg, seed=4)
    t_out = _serve(texp, tpol, tagent, tcfg,
                   {s: LinearService() for s in range(tcfg.num_services)},
                   monkeypatch, tbridge)
    j_out = _serve(jexp, jpol, jagent, jcfg,
                   {s: LinearService() for s in range(jcfg.num_services)},
                   monkeypatch, jbridge)
    assert t_out[0] == j_out[0]
    assert t_out[0]["completed"] > 0
    _same_traces(t_out[1], j_out[1])
    # the learned policy placed somewhere other than the PoA or stopped
    # early at least once: the bridge's actions steered the engine
    assert any((a != 0).any() for _, _, a in j_out[1].trace)


# the DiT case serves one service, so the reference measures one Ω
ONE_SERVICE = dict(num_services=1)


@pytest.fixture(scope="module")
def ref_services():
    """The reference's reduced DiT service for the smoke scenario cut to
    one service (Ω measured by the reference)."""
    cfg = jscen.get_scenario("smoke", **ONE_SERVICE)
    services, _ = jsvc_mod.make_gdm_services(
        cfg.num_services, jax.random.PRNGKey(0), num_blocks=cfg.max_blocks,
        steps_per_block=1, impl="xla")
    return services


def test_serve_policy_on_dit_services_equals_reference(ref_services,
                                                        monkeypatch):
    """The bridged learned policy over reduced DiT services (weights and
    Ω carried from the reference's), traced: the same summary, bridge
    trace and metric counts; the served latents within 1e-5."""
    tcfg, jcfg = _configs(**ONE_SERVICE)
    cfg = get_config("gdm-dit").reduced()
    t_services = {s: service_from_jax(
        _np_tree(svc.params), cfg, omega=svc.omega,
        num_blocks=svc.num_blocks, steps_per_block=svc.steps_per_block,
        prompt_len=svc.prompt_len, device="cpu")
        for s, svc in ref_services.items()}
    jagent, tagent = _agents(jcfg, seed=4)
    t_stats, t_bridge, t_eng = _serve(texp, tpol, tagent, tcfg, t_services,
                                      monkeypatch, tbridge, tracing=True)
    j_stats, j_bridge, j_eng = _serve(jexp, jpol, jagent, jcfg, ref_services,
                                      monkeypatch, jbridge, tracing=True)
    t_stats.pop("critical_path")
    j_stats.pop("critical_path")
    assert t_stats == j_stats
    _same_traces(t_bridge, j_bridge)
    t_m, j_m = t_eng.tracer.metrics, j_eng.tracer.metrics
    assert t_m.counters.keys() == j_m.counters.keys()
    assert {k: c.value for k, c in t_m.counters.items()} == \
        {k: c.value for k, c in j_m.counters.items()}
    assert {k: h.count for k, h in t_m.histograms.items()} == \
        {k: h.count for k, h in j_m.histograms.items()}
    assert {"gdm_compile_ms", "policy_act_batch_ms"} <= t_m.histograms.keys()
    assert len(t_eng.completed) == len(j_eng.completed) > 0
    for t, j in zip(t_eng.completed, j_eng.completed):
        assert t.rid == j.rid
        for key in ("latent", "x0"):
            np.testing.assert_allclose(t.state[key], j.state[key],
                                       atol=LAT_TOL, rtol=LAT_TOL)
    assert sum(s.batch_calls for s in t_services.values()) == \
        sum(s.batch_calls for s in ref_services.values()) > 0


# -- the experiment layer ----------------------------------------------------------------

def test_serve_variant_closed_loop_on_the_cpu():
    cfg = tscen.get_scenario("smoke")
    stats = texp.serve_variant(cfg, "learn-gdm", train_eps=4, frames=8,
                               engine="vectorized", num_envs=2, device="cpu")
    for key in ("completed", "mean_quality", "mean_latency_frames",
                "p95_latency_frames", "objective", "submitted"):
        assert key in stats
    assert stats["completed"] >= 1 and stats["train_episodes"] == 4
    assert 0.0 <= stats["mean_quality"] <= 1.0


def test_run_suite_on_the_cpu():
    """Every variant trains and evaluates; GR and OPT (no agent) equal the
    reference's values, and OPT bounds everything on the same episodes."""
    tcfg, jcfg = _configs()
    point = texp.run_suite(tcfg, train_eps=2, eval_eps=2, engine="vectorized",
                           num_envs=2, device="cpu")
    assert set(point) == {"learn-gdm", "mp", "fp", "gr", "opt"}
    want = jexp.run_suite(jcfg, train_eps=2, eval_eps=2, engine="vectorized",
                          num_envs=2, variants=())
    assert (point["gr"], point["opt"]) == (want["gr"], want["opt"])
    assert texp.qualitative_ordering(point)["opt_upper"]


def test_unported_engines_raise(monkeypatch):
    """The fused engine (ROADMAP Queue 1 item 8), the continuous
    scheduler (item 9) and the closed loop's mesh paths (item 11) run now,
    and the fused engine is the default training engine, as in the
    reference; a mesh gives the unsharded run's numbers
    (``tests/test_torch_mesh.py`` holds them bit for bit)."""
    from repro_torch.serving import cluster as tcluster
    cfg = tscen.get_scenario("smoke")
    monkeypatch.delenv("REPRO_BENCH_ENGINE", raising=False)
    assert texp.bench_engine() == jexp.bench_engine() == "fused"
    ctrl = texp.train_variant(cfg, "learn-gdm", 8, num_envs=4, device="cpu")
    assert ctrl.agent.steps > 0 and len(ctrl.agent.memory) == 0
    assert set(ctrl.evaluate(2, engine="fused")) == set(
        ctrl.evaluate(2, engine="vectorized"))
    mesh = make_env_mesh(2, devices=("cpu", "cpu"))
    assert set(ctrl.train_fused(2, num_envs=2, mesh=mesh)) == \
        {"reward", "loss", "delivered"}
    services = {s: LinearService() for s in range(cfg.num_services)}
    cluster = tcluster.cluster_from_scenario(
        cfg, 3, services, mesh=make_env_mesh(2, axis="batch",
                                             devices=("cpu", "cpu")))
    assert cluster.device_of_cell == [0, 1, 0]
    got = texp.serve_policy(cfg, tpol.GreedyPoAPolicy(), 6,
                            services=services, scheduling="continuous")
    want = jexp.serve_policy(
        jscen.get_scenario("smoke"), jpol.GreedyPoAPolicy(), 6,
        services={s: LinearService() for s in range(cfg.num_services)},
        scheduling="continuous")
    assert got == want and got["completed"] > 0
