"""The compiled call per shape: the launch records of a capture, the graph
cache (:mod:`repro_torch.graphs`) on the CPU, and its two callers on the
serving path, ``GDMService``'s block call and the agent's ``q_values``.

On the CPU no graph is captured: the cache calls its function and keeps
the keys, so what can be checked here is the bookkeeping around the
graphs.  A recorded capture replayed n times counts and charges what n
direct launches do.  The service's instrument counters equal the
reference's service's on the same sequence of calls (as
``tests/test_tracing.py`` runs it, then the slot path).  The agent keeps
its keys across an update, which writes the parameters in place, and
drops them when a parameter or the net is bound anew.  On the card,
``chip_smoke.py`` phases 6 and 11 hold replays to eager calls bit for bit.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.serving import gdm_service as jsvc_mod
from repro.serving.tracing import MetricsRegistry as JMetrics
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.distributed import op_cost
from repro_torch.graphs import Graphs
from repro_torch.models.convert import service_from_jax
from repro_torch.rl import d3ql as td3ql
from repro_torch.rl.networks import qnet_apply, qnet_init
from repro_torch.serving.tracing import MetricsRegistry as TMetrics

CFG = get_config("gdm-dit").reduced()
LAT_TOL = 1e-5


@pytest.fixture
def launches():
    """``kernels.LAUNCHES`` zeroed for the test and restored after it."""
    saved = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    yield kernels.LAUNCHES
    kernels.LAUNCHES.update(saved)


# -- recorded and replayed ------------------------------------------------------------

_CALLS = [("adaln_norm", (10.0, 40.0)), ("flash_attention", (7.0, 3.0)),
          ("adaln_norm_epilogue", (11.0, 44.0)), ("adaln_norm", (10.0, 40.0))]


def _counted(how, metered, times=3):
    """LAUNCHES and the counter's kernel charges (or None) after the
    calls ``times`` times over: launched directly, or recorded once and
    replayed ``times`` times."""
    kernels.reset_launches()
    with (op_cost.count() if metered else contextlib.nullcontext()) as meter:
        if how == "direct":
            for _ in range(times):
                for name, work in _CALLS:
                    kernels.launched(name, work)
        else:
            with kernels.recorded() as record:
                for name, work in _CALLS:
                    kernels.launched(name, work)
            assert record == _CALLS
            assert not any(kernels.LAUNCHES.values())
            if metered:
                assert meter.cost.kernels == {} and meter.cost.flops == 0
            for _ in range(times):
                kernels.replayed(record)
    charged = None if meter is None else (
        meter.cost.kernels, meter.cost.flops, meter.cost.bytes)
    return dict(kernels.LAUNCHES), charged


@pytest.mark.parametrize("metered", [False, True],
                         ids=["no-counter", "counter"])
def test_recorded_replays_count_as_direct_launches(launches, metered):
    got = _counted("replayed", metered)
    want = _counted("direct", metered)
    assert got == want
    assert got[0]["adaln_norm"] == 6 and got[0]["flash_attention"] == 3
    if metered:
        assert got[1][0]["adaln_norm"] == [6, 60.0, 240.0]
    # the record closes with its context, even on an error
    with pytest.raises(RuntimeError), kernels.recorded():
        raise RuntimeError
    assert kernels.RECORDS == []


# -- the cache on the CPU --------------------------------------------------------------

def test_graphs_key_per_shape_and_keep_no_graph_off_the_card():
    device = "cpu"
    seen = []

    def fn(x, y):
        seen.append(tuple(x.shape))
        return x * 2 + y, y

    graphs = Graphs(fn)
    for rows in (2, 2, 4):
        x = torch.arange(rows * 3.0, device=device).reshape(rows, 3)
        y = torch.ones(rows, 3, device=device)
        out, same = graphs((rows,), device, x, y)
        assert same is y and torch.equal(out, x * 2 + y)
    assert seen == [(2, 3), (2, 3), (4, 3)]
    assert (2,) in graphs and (4,) in graphs and (8,) not in graphs
    assert len(graphs) == 0                       # no graph off the card
    graphs.clear()
    assert (2,) not in graphs


# -- the service -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def service_pair():
    """The reference's service as ``tests/test_tracing.py`` builds it and
    the port's, on its weights and Omega."""
    jsvc = jsvc_mod.GDMService(jax.random.PRNGKey(0), num_blocks=2,
                               ref_prompts=2, impl="xla")
    params = jax.tree_util.tree_map(np.asarray, jsvc.params)
    tsvc = service_from_jax(params, CFG, omega=jsvc.omega, num_blocks=2,
                            steps_per_block=1, prompt_len=jsvc.prompt_len,
                            device="cpu")
    return jsvc, tsvc


def _calls(svc, metrics, sample_every):
    """``test_tracing.py``'s sequence of calls (bucket 2 twice, then 4),
    then slot steps at buckets 2 and 4, each already seen; returns the
    latents served."""
    svc.instrument(metrics, sample_every=sample_every)
    rng = np.random.default_rng(0)
    states = [svc.init_state(rng) for _ in range(3)]
    out = [svc.run_batch(states[:2], np.zeros(2, dtype=int)),
           svc.run_batch(states[:2], np.zeros(2, dtype=int)),
           svc.run_batch(states, np.asarray([0, 1, 0]))]
    slot = svc.slot_batch()
    for items in ([(0, states[0], 1), (1, states[1], 0)],
                  [(0, states[0], 1), (1, states[1], 0), (2, states[2], 1)],
                  [(0, states[0], 1), (2, states[2], 0)]):
        out.append(slot.step(items))
    return [s["latent"] for states_out, _ in out for s in states_out]


@pytest.mark.parametrize("sample_every", [1, 2])
def test_instrument_counters_equal_the_reference(service_pair, sample_every):
    jsvc, tsvc = service_pair
    # the services outlive a case: forget the buckets an earlier case saw
    jsvc._compiled_keys = set()
    tsvc._seen_buckets = set()
    jm, tm = JMetrics(), TMetrics()
    j_lat = _calls(jsvc, jm, sample_every)
    t_lat = _calls(tsvc, tm, sample_every)
    for name in ("gdm_runner_calls", "gdm_compile_events"):
        assert tm.counter(name).value == jm.counter(name).value, name
    assert tm.counter("gdm_runner_calls").value == 6
    assert tm.counter("gdm_compile_events").value == 2
    for name in ("gdm_compile_ms", "gdm_run_batch_ms"):
        assert tm.histogram(name).count == jm.histogram(name).count, name
    assert tm.gauge("gdm_last_batch_rows").value == \
        jm.gauge("gdm_last_batch_rows").value == 2
    for t, j in zip(t_lat, j_lat):
        np.testing.assert_allclose(t, j, atol=LAT_TOL, rtol=LAT_TOL)
    # one graph key per bucket and path, on the one shard; none captured
    keys = [(b, masked) for b in (1, 2, 4, 8) for masked in (False, True)]
    assert [k for k in keys if k in tsvc.graphs[0]] == [
        (2, False), (2, True), (4, False), (4, True)]
    assert len(tsvc.graphs) == 1 and len(tsvc.graphs[0]) == 0


# -- the agent ---------------------------------------------------------------------------

def _q(agent, obs):
    with torch.no_grad():
        return qnet_apply(agent.net, torch.from_numpy(obs)).numpy()


def test_q_values_follow_updates_and_rebinding():
    cfg = td3ql.D3QLConfig(obs_dim=6, num_ues=2, num_actions=3, history=3,
                           lstm_units=8, fc=(8, 4), batch_size=4)
    agent = td3ql.D3QLAgent(cfg, device="cpu")
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((8, 3, 6)).astype(np.float32)
    q0 = agent.q_values(obs)
    np.testing.assert_array_equal(agent.q_values(obs[:1]), _q(agent, obs[:1]))
    np.testing.assert_array_equal(q0, _q(agent, obs))
    shapes = [(8, 3, 6), (1, 3, 6)]
    assert all(s in agent.q_graphs for s in shapes)
    # an update writes the parameters in place: the keys stay, Q moves
    batch = {"obs": obs[:4], "next_obs": obs[4:],
             "actions": rng.integers(0, 3, (4, 2)),
             "rewards": rng.standard_normal(4), "dones": np.zeros(4)}
    agent.update(agent.device_batch(batch))
    q1 = agent.q_values(obs)
    assert all(s in agent.q_graphs for s in shapes)
    assert not np.array_equal(q1, q0)
    np.testing.assert_array_equal(q1, _q(agent, obs))
    # a parameter bound anew clears every key
    agent.net.fc0.w = torch.nn.Parameter(agent.net.fc0.w.detach() * 2)
    q2 = agent.q_values(obs[:1])
    assert shapes[0] not in agent.q_graphs and shapes[1] in agent.q_graphs
    np.testing.assert_array_equal(q2, _q(agent, obs[:1]))
    assert not np.array_equal(q2, q1[:1])
    # so does a net bound anew
    agent.net = qnet_init(6, 2, 3, lstm_units=8, fc=(8, 4), seed=1,
                          device="cpu")
    q3 = agent.q_values(obs)
    assert shapes[1] not in agent.q_graphs and shapes[0] in agent.q_graphs
    np.testing.assert_array_equal(q3, _q(agent, obs))
    # acting reaches the same call
    np.testing.assert_array_equal(agent.act_batch(obs, greedy=True),
                                  q3.argmax(-1).astype(np.int32))
