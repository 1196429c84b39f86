"""Port parity: the carried numpy copies of the simulator, the MAC schemes,
the constraint checkers, the workload traces and the non-learned baselines
equal the JAX package's modules exactly, under the same seeds and the same
actions.

Everything here is numpy on both sides (float64 where the reference is),
so every comparison is exact: integer state, float rewards and costs, the
eq. (7) observation, the traces and the baselines' objectives.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import baselines as jbase
from repro.core import constraints as jcons
from repro.core import mac as jmac
from repro.sim import env as jenv
from repro.sim import mobility as jmob
from repro.sim import scenarios as jscen
from repro.sim import vec_env as jvec
from repro.sim import workloads as jwork
from repro_torch.core import baselines as tbase
from repro_torch.core import constraints as tcons
from repro_torch.core import mac as tmac
from repro_torch.sim import env as tenv
from repro_torch.sim import mobility as tmob
from repro_torch.sim import scenarios as tscen
from repro_torch.sim import vec_env as tvec
from repro_torch.sim import workloads as twork

STATE = ("frame", "poa", "prev_poa", "blocks_done", "chain_state",
         "cur_node", "has_request", "uploaded", "delivered_quality",
         "quality_now", "total_delivered", "num_delivered", "num_collisions")


def _equal(got, want, what=""):
    assert type(got) is type(want) or np.isscalar(want), (what, got, want)
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _equal(got[k], want[k], f"{what}.{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)
        assert np.asarray(got).dtype == np.asarray(want).dtype, what


def _same_state(t, j):
    for key in STATE:
        _equal(getattr(t, key), getattr(j, key), key)
    _equal(t.rng.bit_generator.state, j.rng.bit_generator.state, "rng")


def _configs(name, **kw):
    return (tscen.get_scenario(name, **kw), jscen.get_scenario(name, **kw))


def _random_actions(rng, cfg, shape=()):
    mac = rng.integers(-1, cfg.num_channels, size=shape + (cfg.num_ues,))
    placement = rng.integers(-1, cfg.num_bs, size=shape + (cfg.num_ues,))
    return mac, placement


# -- the scalar simulator -----------------------------------------------------------

@pytest.mark.parametrize("name,world_seed,episode_seeds", [
    ("smoke", 0, [None, 3]),
    ("smoke", 4, [11, 12]),
    ("paper-fig3", 0, [None, 1000]),
    ("hetero-capacity", 2, [7]),
])
def test_edge_simulator_episodes_equal_reference(name, world_seed,
                                                 episode_seeds):
    """Full episodes under random MAC and placement: every field of every
    step result, the observation and the whole state, exactly."""
    tcfg, jcfg = _configs(name, seed=world_seed)
    t, j = tenv.EdgeSimulator(tcfg), jenv.EdgeSimulator(jcfg)
    assert t.obs_dim == j.obs_dim
    for key in ("w_hat", "eps", "qbar", "service_of", "omega", "y_hat"):
        _equal(getattr(t, key), getattr(j, key), key)
    act_rng = np.random.default_rng(world_seed + 99)
    for seed in episode_seeds:
        if seed is not None:
            t.reset(seed=seed)
            j.reset(seed=seed)
        _same_state(t, j)
        _equal(t.observation(), j.observation(), "obs0")
        done = False
        while not done:
            mac, placement = _random_actions(act_rng, tcfg)
            # the MAC schemes read the same state: check them on the way
            _equal(tmac.greedy_mac(t), jmac.greedy_mac(j), "greedy_mac")
            rt, rj = t.step(mac, placement), j.step(mac, placement)
            _equal(rt, rj, f"step {j.frame}")
            _same_state(t, j)
            _equal(t.observation(rt["bs_load"]), j.observation(rj["bs_load"]),
                   "obs")
            _equal(t._priorities(), j._priorities(), "priorities")
            done = rj["done"]


def test_edge_simulator_takes_a_quality_matrix():
    tcfg, jcfg = _configs("smoke")
    omega = np.random.default_rng(5).random((tcfg.num_services,
                                             tcfg.max_blocks + 1))
    t = tenv.EdgeSimulator(tcfg, quality=omega)
    j = jenv.EdgeSimulator(jcfg, quality=omega)
    _equal(t.omega, j.omega)
    _same_state(t, j)


# -- mobility and the segment primitive ---------------------------------------------

@pytest.mark.parametrize("num_envs,inject", [(1, False), (8, False),
                                             (3, True)])
def test_vec_random_waypoint_equals_reference(num_envs, inject):
    kw = dict(grid=4, side=400.0, speed=10.0, pause=3.0)
    t = tmob.VecRandomWaypoint(num_envs, 6, rngs=[
        np.random.default_rng(s) for s in range(num_envs)], **kw)
    j = jmob.VecRandomWaypoint(num_envs, 6, rngs=[
        np.random.default_rng(s) for s in range(num_envs)], **kw)
    draws = np.random.default_rng(1).uniform(0, 400.0, (30, num_envs, 6, 2))
    for step in range(30):
        redraw = draws[step] if inject else None
        _equal(t.step(redraw=redraw), j.step(redraw=redraw), f"step {step}")
        for key in ("pos", "dest", "pause_left"):
            _equal(getattr(t, key), getattr(j, key), key)


def test_random_waypoint_equals_reference():
    t = tmob.RandomWaypoint(9, rng=np.random.default_rng(3))
    j = jmob.RandomWaypoint(9, rng=np.random.default_rng(3))
    for _ in range(40):
        _equal(t.step(), j.step())
    _equal(t.pos, j.pos)


@pytest.mark.parametrize("n,groups", [(0, 3), (1, 1), (17, 4), (200, 9)])
def test_segment_positions_equals_reference(n, groups):
    rng = np.random.default_rng(n)
    g = rng.integers(0, groups, size=n)
    r = rng.permutation(n)
    _equal(tvec.segment_positions(g, r), jvec.segment_positions(g, r))


# -- the vectorized simulator -------------------------------------------------------

VEC_STATE = STATE[1:] + ("w_hat", "eps", "qbar", "service_of", "omega")


@pytest.mark.parametrize("num_envs,inject,name", [
    (1, False, "smoke"), (8, False, "smoke"), (8, True, "smoke"),
    (1, True, "paper-fig3"), (8, False, "paper-fig3"),
])
def test_vec_edge_simulator_equals_reference(num_envs, inject, name):
    """E stacked envs over two episodes (the second reset with new seeds),
    with or without the injected arrival and waypoint draws: every step
    result, the batched observation, the MAC schemes and the state."""
    tcfg, jcfg = _configs(name)
    seeds = 40 + np.arange(num_envs)
    t = tvec.VecEdgeSimulator(tcfg, num_envs, seeds=seeds)
    j = jvec.VecEdgeSimulator(jcfg, num_envs, seeds=seeds)
    rng = np.random.default_rng(num_envs)
    for episode in range(2):
        if episode:
            t.reset(seeds=seeds + 100)
            j.reset(seeds=seeds + 100)
        for key in VEC_STATE:
            _equal(getattr(t, key), getattr(j, key), key)
        done = False
        while not done:
            _equal(tmac.vec_greedy_mac(t), jmac.vec_greedy_mac(j), "mac")
            mac, placement = _random_actions(rng, tcfg, (num_envs,))
            hooks = {}
            if inject:
                hooks = dict(
                    arrival_draws=rng.random((num_envs, tcfg.num_ues)),
                    waypoint_redraw=rng.uniform(
                        0, tcfg.side, (num_envs, tcfg.num_ues, 2)))
            rt = t.step(mac, placement, **hooks)
            rj = j.step(mac, placement, **hooks)
            _equal(rt, rj, f"step {j.frame}")
            _equal(t.observation(rt["bs_load"]), j.observation(rj["bs_load"]))
            for key in VEC_STATE:
                _equal(getattr(t, key), getattr(j, key), key)
            done = rj["done"]
        for e in range(num_envs):
            _equal(t.rngs[e].bit_generator.state,
                   j.rngs[e].bit_generator.state, "rng")


# -- the MAC schemes ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_access_equals_reference(seed):
    tcfg, jcfg = _configs("paper-fig3", seed=seed)
    t, j = tenv.EdgeSimulator(tcfg), jenv.EdgeSimulator(jcfg)
    tv = tvec.VecEdgeSimulator(tcfg, 4, seeds=seed + np.arange(4))
    jv = jvec.VecEdgeSimulator(jcfg, 4, seeds=seed + np.arange(4))
    act_rng = np.random.default_rng(seed)
    for _ in range(12):
        m_t, m_j = tmac.random_access(t), jmac.random_access(j)
        _equal(m_t, m_j, "random_access")
        _equal(tmac.random_access(t, attempt_prob=0.3,
                                  rng=np.random.default_rng(seed)),
               jmac.random_access(j, attempt_prob=0.3,
                                  rng=np.random.default_rng(seed)))
        _, placement = _random_actions(act_rng, tcfg)
        _equal(t.step(m_t, placement), j.step(m_j, placement))
        v_t, v_j = tmac.vec_random_access(tv), jmac.vec_random_access(jv)
        _equal(v_t, v_j, "vec_random_access")
        _, placement = _random_actions(act_rng, tcfg, (4,))
        _equal(tv.step(v_t, placement), jv.step(v_j, placement))


# -- the constraint checkers --------------------------------------------------------

def _record(cons, env, steps, rng):
    trace = cons.TraceRecorder()
    for _ in range(steps):
        mac, placement = _random_actions(rng, env.cfg)
        blocks_before = env.blocks_done.copy()
        startable = env.chain_state != jenv.IDLE
        poa = env.poa.copy()
        res = env.step(mac, placement)
        executed = env.blocks_done > blocks_before
        trace.add(frame=env.frame - 1, poa=poa, mac=mac,
                  uploaded=res["uploaded"], placement=placement,
                  executed=executed,
                  exec_node=np.where(executed, env.cur_node, -1),
                  blocks_done=env.blocks_done.copy(), bs_load=res["bs_load"],
                  chain_startable=startable)
    return trace


@pytest.mark.parametrize("corrupt", [False, True])
def test_check_all_equals_reference_on_a_recorded_trace(corrupt):
    """A trace recorded from each side's simulator under the same random
    actions; checked clean, and with violations planted in both (loads
    over capacity, a negative channel, two uploads on one channel, a
    started chain without an upload)."""
    tcfg, jcfg = _configs("paper-fig3")
    t, j = tenv.EdgeSimulator(tcfg), jenv.EdgeSimulator(jcfg)
    tt = _record(tcons, t, 40, np.random.default_rng(8))
    jt = _record(jcons, j, 40, np.random.default_rng(8))
    assert len(tt.frames) == len(jt.frames) == 40
    for ft, fj in zip(tt.frames, jt.frames):
        _equal(dataclasses.asdict(ft), dataclasses.asdict(fj))
    if corrupt:
        for trace in (tt, jt):
            fr = trace.frames[5]
            fr.bs_load[:] = 9
            fr.mac[0] = -3
            fr.uploaded[:2] = True
            fr.mac[:2] = 1
            fr.poa[:2] = 0
            fr.chain_startable[:] = False
            fr.executed[:] = True
            trace.frames[4].blocks_done[:] = 0
            fr.blocks_done[:] = 1
    got, want = tcons.check_all(tt, t.w_hat), jcons.check_all(jt, j.w_hat)
    assert got == want
    assert bool(got) == corrupt


# -- the workload traces ------------------------------------------------------------

TRACE_KEYS = ("frames", "arrivals", "poa", "qbar", "service_of", "rates",
              "qbar_t", "workload", "arrival_offset")


@pytest.mark.parametrize("workload", jwork.workload_names())
def test_workload_trace_equals_reference(workload):
    assert twork.workload_names() == jwork.workload_names()
    assert twork.workload_descriptions() == jwork.workload_descriptions()
    for name, seed in (("paper-fig3", 0), ("smoke", 5)):
        tcfg, jcfg = _configs(name)
        tt = twork.workload_trace(tcfg, 60, workload, seed=seed)
        jt = jwork.workload_trace(jcfg, 60, workload, seed=seed)
        for key in TRACE_KEYS:
            _equal(getattr(tt, key), getattr(jt, key), key)
        _equal(twork.arrival_envelope(workload, tcfg, 60, seed=seed),
               jwork.arrival_envelope(workload, jcfg, 60, seed=seed))


@pytest.mark.parametrize("cells,rate,workload", [(1, 0.0, "stationary"),
                                                 (3, 0.05, "mmpp"),
                                                 (4, 0.2, "heavy-tail")])
def test_fleet_trace_equals_reference(cells, rate, workload):
    tcfg, jcfg = _configs("smoke")
    tf = twork.fleet_trace(tcfg, 30, cells, workload=workload, seed=2,
                           handover_rate=rate)
    jf = jwork.fleet_trace(jcfg, 30, cells, workload=workload, seed=2,
                           handover_rate=rate)
    assert tf.num_cells == jf.num_cells == cells
    _equal(tf.handovers, jf.handovers, "handovers")
    assert (len(jf.handovers) > 0) == (rate > 0 and cells > 1)
    for tc, jc in zip(tf.cells, jf.cells):
        for key in TRACE_KEYS:
            _equal(getattr(tc, key), getattr(jc, key), key)


def test_stationary_workload_replays_request_trace():
    tcfg, _ = _configs("paper-fig3")
    a = twork.workload_trace(tcfg, 30, "stationary", seed=4)
    b = tscen.request_trace(tcfg, 30, seed=4)
    for key in ("arrivals", "poa", "qbar", "service_of"):
        _equal(getattr(a, key), getattr(b, key), key)


# -- the baselines ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smoke", "paper-fig3"])
def test_baselines_equal_reference(name):
    """GR through the batched and the scalar engines, and the OPT bound on
    the evaluation episodes, exactly."""
    tcfg, jcfg = _configs(name)
    t, j = tenv.EdgeSimulator(tcfg), jenv.EdgeSimulator(jcfg)
    for engine, num_envs in (("vectorized", None), ("vectorized", 3),
                             ("scalar", None)):
        _equal(tbase.GreedyController(t).evaluate(4, engine=engine,
                                                  num_envs=num_envs),
               jbase.GreedyController(j).evaluate(4, engine=engine,
                                                  num_envs=num_envs), engine)
    for seed in (9_000, 9_001):
        _equal(tbase.opt_upper_bound(t, seed=seed),
               jbase.opt_upper_bound(j, seed=seed), f"opt {seed}")
