"""Port parity for the serving slice: the GDM service and the whole quantum
engine under default placement, against the JAX reference.

* ``GDMService.run_batch`` on weights carried from a reference service:
  latents to 1e-5, qualities, bucket padding, the empty batch and
  ``batch_calls`` exactly.
* ``engine_from_scenario`` + ``serve_trace`` on the ``smoke`` scenario with
  port services (weights and Omega carried from the reference's services)
  vs the reference engine with JAX services: every integer decision, step
  stat, summary, telemetry document, ledger event and trace document is
  identical; the served latents agree to 1e-5.
* The carried sim copies (world draw, Y_hat, request traces) equal the
  reference exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.serving import gdm_service as jsvc_mod
from repro.serving import policy_bridge as jbridge
from repro.serving.kv_manager import TransferLedger as JLedger
from repro.serving.telemetry import TelemetryLog as JTelemetry
from repro.serving.tracing import Tracer as JTracer
from repro.sim import env as jenv
from repro.sim import scenarios as jscen
from repro.sim.faults import FAULT_LEGS as J_FAULT_LEGS
from repro_torch.configs import get_config
from repro_torch.models.convert import service_from_jax
from repro_torch.serving import engine as tengine
from repro_torch.serving import policy_bridge as tbridge
from repro_torch.serving.kv_manager import TransferLedger as TLedger
from repro_torch.serving.telemetry import TelemetryLog as TTelemetry
from repro_torch.serving.tracing import Tracer as TTracer
from repro_torch.sim import env as tenv
from repro_torch.sim import scenarios as tscen

CFG = get_config("gdm-dit").reduced()
LAT_TOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _carry(jsvc, **kw):
    return service_from_jax(_np_tree(jsvc.params), CFG, omega=jsvc.omega,
                            num_blocks=jsvc.num_blocks,
                            steps_per_block=jsvc.steps_per_block,
                            prompt_len=jsvc.prompt_len, device="cpu", **kw)


# -- the service ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_services():
    """The reference's services for the smoke scenario (reduced gdm-dit,
    Omega measured by the reference), shared by every test here."""
    cfg = jscen.get_scenario("smoke")
    services, _ = jsvc_mod.make_gdm_services(
        cfg.num_services, jax.random.PRNGKey(0), num_blocks=cfg.max_blocks,
        steps_per_block=1, impl="xla")
    return services


@pytest.fixture(scope="module")
def service_pair(ref_services):
    return ref_services[0], _carry(ref_services[0])


def _states(svc, n, seed):
    rng = np.random.default_rng(seed)
    return [svc.init_state(rng) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 3, 9])
def test_run_batch_matches_reference_service(service_pair, n):
    """Bucketed batches (1 -> 1, 3 -> 4, 9 -> 16 rows) with mixed chain
    depths: same qualities, latents and x0 within 1e-5, one call each."""
    jsvc, tsvc = service_pair
    calls = (jsvc.batch_calls, tsvc.batch_calls)
    blocks = np.arange(n) % jsvc.num_blocks
    j_out, j_q = jsvc.run_batch(_states(jsvc, n, n), blocks)
    t_out, t_q = tsvc.run_batch(_states(tsvc, n, n), blocks)
    np.testing.assert_array_equal(t_q, j_q)
    assert (jsvc.batch_calls - calls[0], tsvc.batch_calls - calls[1]) == (1, 1)
    bucket = tsvc._bucket(n)
    assert bucket == jsvc._bucket(n) and bucket in tsvc._buffers
    for j, t in zip(j_out, t_out):
        np.testing.assert_array_equal(t["prompt"], j["prompt"])
        for key in ("latent", "x0"):
            assert t[key].dtype == np.float32 and t[key].shape == j[key].shape
            np.testing.assert_allclose(t[key], j[key], atol=LAT_TOL,
                                       rtol=LAT_TOL)


def test_run_batch_empty_and_block_fn(service_pair):
    jsvc, tsvc = service_pair
    calls = tsvc.batch_calls
    out, q = tsvc.run_batch([], np.asarray([], dtype=int))
    j_out, j_q = jsvc.run_batch([], np.asarray([], dtype=int))
    assert out == j_out == [] and tsvc.batch_calls == calls
    np.testing.assert_array_equal(q, j_q)
    state = _states(tsvc, 1, 7)[0]
    t_state, t_q = tsvc.block_fn(state, 1)
    j_state, j_q = jsvc.block_fn(_states(jsvc, 1, 7)[0], 1)
    assert t_q == j_q and tsvc.batch_calls == calls + 1
    np.testing.assert_allclose(t_state["latent"], j_state["latent"],
                               atol=LAT_TOL, rtol=LAT_TOL)


def test_service_pad_rows_are_inert(service_pair):
    """A bucket's pad rows keep whatever an earlier call staged; live rows
    must not depend on them (per-sample independence)."""
    _, tsvc = service_pair
    states = _states(tsvc, 3, 11)
    first, _ = tsvc.run_batch(states, np.array([0, 1, 0]))
    tsvc.run_batch(_states(tsvc, 4, 12), np.array([1, 1, 1, 1]))
    again, _ = tsvc.run_batch(states, np.array([0, 1, 0]))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["latent"], b["latent"])


def test_service_rejects_a_wrong_omega(service_pair):
    jsvc, _ = service_pair
    with pytest.raises(ValueError, match="omega"):
        service_from_jax(_np_tree(jsvc.params), CFG, omega=np.zeros(7),
                         num_blocks=jsvc.num_blocks, device="cpu")


# -- the whole slice: engine + services on the smoke trace ------------------------

def _serve(bridge, ledger_cls, telemetry_cls, tracer, cfg, services, frames,
           seed):
    engine, _ = bridge.engine_from_scenario(cfg, services, tracer=tracer)
    engine.ledger = ledger_cls()
    engine.telemetry = telemetry_cls()
    steps = []
    step = engine.step
    engine.step = lambda: steps.append(step()) or steps[-1]
    trace = (jscen if bridge is jbridge else tscen).request_trace(
        cfg, frames, seed=seed)
    summary = bridge.serve_trace(engine, trace, services, seed=seed)
    return engine, steps, summary


@pytest.fixture(scope="module")
def served(ref_services):
    tservices = {s: _carry(svc) for s, svc in ref_services.items()}
    calls0 = {s: svc.batch_calls for s, svc in ref_services.items()}
    frames, seed = 12, 3
    ref = _serve(jbridge, JLedger, JTelemetry, JTracer(),
                 jscen.get_scenario("smoke"), ref_services, frames, seed)
    port = _serve(tbridge, TLedger, TTelemetry, TTracer(),
                  tscen.get_scenario("smoke"), tservices, frames, seed)
    ref_calls = [svc.batch_calls - calls0[s]
                 for s, svc in ref_services.items()]
    return ref, port, ref_calls, tservices


def test_served_trace_is_frame_identical(served):
    (j_eng, j_steps, j_sum), (t_eng, t_steps, t_sum), _, _ = served
    assert t_sum["completed"] > 0
    assert t_steps == j_steps
    assert t_sum == j_sum
    assert [(r.rid, r.ue, r.service, r.blocks_done, r.node, r.quality,
             r.arrival_frame, r.delivered_frame, r.trans_cost, r.exec_cost)
            for r in t_eng.completed] == \
        [(r.rid, r.ue, r.service, r.blocks_done, r.node, r.quality,
          r.arrival_frame, r.delivered_frame, r.trans_cost, r.exec_cost)
         for r in j_eng.completed]


def test_served_telemetry_ledger_and_trace_are_identical(served):
    (j_eng, _, _), (t_eng, _, _), _, _ = served
    assert t_eng.telemetry.to_json() == j_eng.telemetry.to_json()
    assert [dataclasses.astuple(e) for e in t_eng.ledger.events] == \
        [dataclasses.astuple(e) for e in j_eng.ledger.events]
    assert t_eng.tracer.to_json() == j_eng.tracer.to_json()


def test_served_latents_match_reference(served):
    (j_eng, _, _), (t_eng, _, _), ref_calls, tservices = served
    assert [s.batch_calls for s in tservices.values()] == ref_calls
    for j, t in zip(j_eng.completed, t_eng.completed):
        for key in ("latent", "x0"):
            np.testing.assert_allclose(t.state[key], j.state[key],
                                       atol=LAT_TOL, rtol=LAT_TOL)


# -- carried copies ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["smoke", "paper-fig3", "large-grid",
                                  "hetero-capacity"])
def test_sim_copies_equal_reference(name):
    jcfg, tcfg = jscen.get_scenario(name), tscen.get_scenario(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jw = jenv.draw_static_world(jcfg, np.random.default_rng(jcfg.seed))
    tw = tenv.draw_static_world(tcfg, np.random.default_rng(tcfg.seed))
    assert jw.keys() == tw.keys()
    for key in jw:
        np.testing.assert_array_equal(tw[key], jw[key])
    np.testing.assert_array_equal(tenv.grid_trans_cost(tcfg),
                                  jenv.grid_trans_cost(jcfg))
    jt = jscen.request_trace(jcfg, 20, seed=5)
    tt = tscen.request_trace(tcfg, 20, seed=5)
    for key in ("arrivals", "poa", "qbar", "service_of"):
        np.testing.assert_array_equal(getattr(tt, key), getattr(jt, key))
    assert tscen.scenario_names() == jscen.scenario_names()


def test_engine_copy_constants_and_continuous_mode():
    """The fault-leg order is the reference's, and the continuous mode
    dispatches to the carried scheduler: idle quanta give the reference's
    stats."""
    from repro.serving import engine as jengine
    assert tengine.FAULT_LEGS == J_FAULT_LEGS
    t_eng, _ = tbridge.engine_from_scenario(
        tscen.get_scenario("smoke"), {},
        engine_cfg=tengine.EngineConfig(scheduling="continuous"))
    j_eng, _ = jbridge.engine_from_scenario(
        jscen.get_scenario("smoke"), {},
        engine_cfg=jengine.EngineConfig(scheduling="continuous"))
    for _ in range(3):
        assert t_eng.step() == j_eng.step()
    assert t_eng.frame == j_eng.frame == 3


def test_link_scale_array_follows_fault_leg_order():
    """The array form of ``set_fault_state(link_scale=...)`` reads the legs
    in the reference's column order, as the reference engine does."""
    cfg = tscen.get_scenario("smoke")
    t_eng, _ = tbridge.engine_from_scenario(cfg, {})
    j_eng, _ = jbridge.engine_from_scenario(jscen.get_scenario("smoke"), {})
    for eng in (t_eng, j_eng):
        eng.set_fault_state(link_scale=np.array([2.0, 1.0, 3.0]))
    assert t_eng._link_scale == j_eng._link_scale == {"uplink": 2.0,
                                                      "downlink": 3.0}
