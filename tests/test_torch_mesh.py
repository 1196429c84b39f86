"""Port parity: the closed loop's mesh paths on the CPU.

The reference's mesh pins (``tests/test_mesh_sharding.py``) brought over to
the port, on meshes whose device list repeats the CPU (``("cpu",) * d``
for d in {1, 2, 4}: every split and gather runs, the shards one after the
other), the counterpart of the reference's
``--xla_force_host_platform_device_count``:

* ``make_env_mesh`` degrades to a divisor and never falls back to the CPU;
* the spec rules give the reference's specs on the same mesh shapes;
* ``train_fused(mesh=)`` equals the unsharded run bit for bit (rewards,
  deliveries, losses, parameters, epsilon, steps), and
  ``evaluate_fused(mesh=)`` the unsharded summary exactly;
* ``GDMService`` under a mesh: Ω and quality exact, latents within 1e-5
  (the DiT's float32 products on B/d rows may sum in another order than
  on B rows), buckets divisible by d;
* the sharded fleet equals the unsharded one frame for frame, with one
  ``"shard"`` ledger row per handover of in-flight latents between cells
  on different mesh positions.

Then the port at d = 2 against the reference's own sharded paths, run in a
child process on four forced host devices: ``train_fused(mesh=
make_env_mesh(2))`` in float32 (the jitted round miscomputes under x64 on
XLA:CPU), held as ``tests/test_torch_fused.py`` holds the unsharded round
(rewards and deliveries within 1e-5, losses 1e-5 relative, parameters by
their movement), and the smoke fleet on a 2-device mesh, held as
``tests/test_torch_fleet.py`` holds the unsharded fleet (summaries and
ledger exactly, latents within 1e-5).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models import gdm as jgdm
from repro.rl import d3ql as jd3ql
from repro.sim import scenarios as jscen
from repro_torch.configs import MULTI_POD, SINGLE_POD, MeshConfig, get_config
from repro_torch.core import LearnGDMController
from repro_torch.core.policy import (GreedyPoAPolicy, LearnedPolicy,
                                     RandomPolicy, evaluate_fused,
                                     evaluate_policy)
from repro_torch.distributed import P, batch_shardings, gather, split
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_env_mesh
from repro_torch.models.convert import qnet_to_jax, service_from_jax
from repro_torch.rl import d3ql as td3ql
from repro_torch.rl import replay as treplay
from repro_torch.serving import (EngineConfig, HandoverEvent, Request,
                                 SchedulerConfig, TransferLedger,
                                 cluster_from_scenario, serve_fleet)
from repro_torch.serving.gdm_service import GDMService, make_gdm_services
from repro_torch.sim import EdgeSimulator, SimConfig, torch_env
from repro_torch.sim.scenarios import get_scenario
from repro_torch.sim.workloads import fleet_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEVICE_COUNTS = (1, 2, 4)
CPUS = ("cpu",) * 4
LAT_TOL = 1e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
REF_TIMEOUT = 180
CELLS, FRAMES = 3, 12
# a fleet whose chains run all B blocks (early exit off: random weights
# saturate Omega after one block) under heavy handover, so in-flight
# latents cross between cells
FLEET = dict(workload="flash-crowd", seed=5, handover_rate=0.3)
SMALL_AGENT = dict(lstm_units=16, fc=(16, 8), batch_size=8,
                   memory_capacity=64, target_sync=7, epsilon_decay=0.9,
                   epsilon_floor=0.05)


def _mesh(d, axis="env"):
    return make_env_mesh(d, axis=axis, devices=CPUS)


# -- the reference's sharded paths, in a child with four host devices -----------------

_REF_CHILD = r'''
import json, pathlib, sys
import jax
import numpy as np
from repro.core import learn_gdm as jlg
from repro.launch.mesh import make_env_mesh
from repro.rl import d3ql as jd3ql
from repro.serving import TransferLedger, cluster_from_scenario, serve_fleet
from repro.serving.gdm_service import make_gdm_services
from repro.sim import scenarios as jscen
from repro.sim.workloads import fleet_trace
out = pathlib.Path(sys.argv[1])
agent_kw, cells, frames, fleet_kw = json.loads(sys.argv[2])
cfg = jscen.get_scenario("smoke")
env = jlg.EdgeSimulator(cfg)
acfg = jd3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=cfg.num_ues,
                        num_actions=cfg.num_bs + 1, **agent_kw)
ctrl = jlg.LearnGDMController(env, agent=jd3ql.D3QLAgent(acfg))
hist = ctrl.train_fused(12, num_envs=4, seed=11, mesh=make_env_mesh(2))
a = ctrl.agent
np.savez(out / "train.npz", reward=hist["reward"], loss=hist["loss"],
         delivered=hist["delivered"], epsilon=a.epsilon, steps=a.steps)
np.savez(out / "params.npz",
         *jax.tree_util.tree_leaves((a.params, a.target_params)))
mesh = make_env_mesh(2, axis="batch")
services, omega = make_gdm_services(cfg.num_services, jax.random.PRNGKey(0),
                                    num_blocks=cfg.max_blocks, mesh=mesh,
                                    impl="xla")
ledger = TransferLedger()
cluster = cluster_from_scenario(cfg, cells, services, stacked=True,
                                ledger=ledger, mesh=mesh, early_exit=False)
stats = serve_fleet(cluster, fleet_trace(cfg, frames, cells, **fleet_kw),
                    services, seed=0, collect_steps=True)
np.savez(out / "latents.npz", omega=omega, **{
    f"{c}/{r.rid}/{k}": r.state[k] for c, e in enumerate(cluster.engines)
    for r in e.completed for k in ("latent", "x0")})
(out / "fleet.json").write_text(json.dumps(
    {"stats": stats, "ledger": [vars(e) for e in ledger.events]},
    default=lambda o: o.item()))
'''


@pytest.fixture(scope="module", autouse=True)
def ref_sharded(tmp_path_factory):
    """The child runs while the module's other tests do; the test that
    reads it waits for it."""
    out = tmp_path_factory.mktemp("ref_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    args = json.dumps([SMALL_AGENT, CELLS, FRAMES, FLEET])
    proc = subprocess.Popen([sys.executable, "-c", _REF_CHILD, str(out), args],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# -- mesh construction ----------------------------------------------------------------

@pytest.mark.parametrize("num,divides,axis,want", [
    (None, None, "env", 4), (4, 6, "env", 3), (4, 7, "env", 1),
    (2, 6, "env", 2), (2, 3, "env", 1), (1, None, "batch", 1),
    (8, 8, "batch", 4), (3, None, "env", 3)])
def test_make_env_mesh_degrades_to_a_divisor(num, divides, axis, want):
    mesh = make_env_mesh(num, divides=divides, axis=axis, devices=CPUS)
    assert mesh.axis_names == (axis,) and mesh.shape == {axis: want}
    assert list(mesh.devices) == [torch.device("cpu")] * want


def test_make_env_mesh_needs_cuda_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_env_mesh, lambda: make_env_mesh(2, divides=4),
                 tmesh.make_host_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_mesh_config_and_helpers_equal_reference():
    assert dataclasses.astuple(SINGLE_POD) == (SINGLE_POD.shape,
                                               SINGLE_POD.axes)
    for cfg in (SINGLE_POD, MULTI_POD, MeshConfig((4,), ("data",))):
        assert (cfg.num_devices, cfg.tp, cfg.dp) == {
            (16, 16): (256, 16, 16), (2, 16, 16): (512, 16, 32),
            (4,): (4, 1, 4)}[cfg.shape]
    host = tmesh.make_host_mesh((2, 2), ("data", "model"), devices=CPUS)
    assert host.shape == {"data": 2, "model": 2}
    for mesh in (host, _mesh(2), _mesh(4, "batch")):
        got, want = tmesh.mesh_config(mesh), jmesh.mesh_config(mesh)
        assert (got.shape, got.axes) == (want.shape, want.axes)
        assert tmesh.dp_axes(mesh) == jmesh.dp_axes(mesh)


# -- the spec rules against the reference's ---------------------------------------------

class FakeMesh:
    """Duck-typed mesh for spec assignment without devices."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


_DRAWS = dict.fromkeys(("explore", "q_rand", "arrival", "sample"))
_SPEC_CASES = {
    "spec_for_shape fallback": ("spec_for_shape", ((20, 128), ("data", "model"),
                                FakeMesh({"data": 16, "model": 16})), {}),
    "spec_for_shape divisible": ("spec_for_shape", ((32, 128, 64),
                                 (("pod", "data"), None, "model"),
                                 FakeMesh({"pod": 2, "data": 16,
                                           "model": 16})), {}),
    "batch_spec 256": ("batch_spec", (FakeMesh({"pod": 2, "data": 16,
                                                "model": 16}), 256, 1), {}),
    "batch_spec 16": ("batch_spec", (FakeMesh({"pod": 2, "data": 16,
                                               "model": 16}), 16, 1), {}),
    "batch_spec 1": ("batch_spec", (FakeMesh({"pod": 2, "data": 16,
                                              "model": 16}), 1, 2), {}),
    "leading_axis_spec divides": ("leading_axis_spec",
                                  (FakeMesh({"env": 4}), "env", 8, 3), {}),
    "leading_axis_spec degrades": ("leading_axis_spec",
                                   (FakeMesh({"env": 4}), "env", 6, 2), {}),
    "leading_axis_spec other axis": ("leading_axis_spec",
                                     (FakeMesh({"batch": 2}), "env", 8), {}),
    "draw_specs frame": ("draw_specs", (_DRAWS, "env"),
                         dict(replicated=("sample",))),
    "draw_specs reset": ("draw_specs", (dict.fromkeys(("pos", "req")),
                                        "env"), dict(env_dim=0)),
}


@pytest.mark.parametrize("case", sorted(_SPEC_CASES))
def test_spec_rules_equal_reference(case):
    name, args, kw = _SPEC_CASES[case]
    got = getattr(tsharding, name)(*args, **kw)
    want = getattr(jsharding, name)(*args, **kw)
    if isinstance(want, dict):
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    else:
        assert tuple(got) == tuple(want)
    # the port's spec normalises a 1-tuple to the bare name, as jax's does
    assert P(("data",), None) == ("data", None)
    data, rep = batch_shardings(_mesh(2, "batch"))
    assert (tuple(data.spec), tuple(rep.spec)) == (("batch",), ())


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_split_and_gather_round_trip(d):
    mesh = _mesh(d)
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    for spec, dim in ((P(None, "env"), 1), (P("env"), 0), (P(), None)):
        if dim == 0 and 2 % d:
            with pytest.raises(ValueError, match="does not divide"):
                split(x, mesh, spec)
            continue
        shards = split(x, mesh, spec)
        assert len(shards) == d
        if dim is None:
            assert all(torch.equal(s, x) for s in shards)
        else:
            assert all(s.shape[dim] == x.shape[dim] // d for s in shards)
        assert torch.equal(gather(shards, spec, "cpu"), x)
    with pytest.raises(ValueError, match="names no axis"):
        split(x, mesh, P(None, "batch"))


# -- fused training and evaluation ----------------------------------------------------------

def _controller(cfg, variant, mac_scheme):
    env = EdgeSimulator(cfg)
    agent = td3ql.D3QLAgent(td3ql.D3QLConfig(
        obs_dim=env.obs_dim, num_ues=cfg.num_ues,
        num_actions=cfg.num_bs + 1, seed=0, **SMALL_AGENT), device="cpu")
    return LearnGDMController(env, variant=variant, mac_scheme=mac_scheme,
                              agent=agent)


@pytest.mark.parametrize("variant,mac_scheme", [("learn-gdm", "greedy"),
                                                ("mp", "random")])
@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_train_fused_sharded_equals_unsharded(d, variant, mac_scheme):
    """Three rounds at E=4 updating every frame once the replay holds a
    batch, epsilon decaying into greedy frames: everything bit for bit."""
    cfg = SimConfig(num_ues=5, num_channels=2, horizon=10, seed=2)
    ref = _controller(cfg, variant, mac_scheme)
    got = _controller(cfg, variant, mac_scheme)
    h_ref = ref.train_fused(12, num_envs=4, seed=3)
    h_got = got.train_fused(12, num_envs=4, seed=3, mesh=_mesh(d))
    for k in ("reward", "delivered", "loss"):
        np.testing.assert_array_equal(h_got[k], h_ref[k], err_msg=k)
    assert not np.isnan(h_ref["loss"]).all()
    for net in ("net", "target_net"):
        for (name, a), b in zip(getattr(ref.agent, net).named_parameters(),
                                getattr(got.agent, net).parameters()):
            assert torch.equal(a, b), (net, name)
    assert got.agent.epsilon == ref.agent.epsilon < 0.5
    assert got.agent.steps == ref.agent.steps > 7
    with pytest.raises(AssertionError):
        got.train_fused(3, num_envs=3, mesh=_mesh(2))


@pytest.mark.parametrize("policy", ["gr", "random", "learned"])
@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_evaluate_fused_sharded_equals_unsharded(d, policy):
    cfg = SimConfig(num_ues=5, num_channels=2, horizon=12, seed=4)
    env = EdgeSimulator(cfg)
    ctrl = _controller(cfg, "learn-gdm", "greedy")
    pol = {"gr": GreedyPoAPolicy(), "random": RandomPolicy(seed=1),
           "learned": LearnedPolicy(ctrl.agent)}[policy]
    for mac_scheme in ("greedy", "random"):
        want = evaluate_fused(pol, env, 8, num_envs=4, seed=2,
                              mac_scheme=mac_scheme, device="cpu")
        got = evaluate_fused(pol, env, 8, num_envs=4, seed=2,
                             mac_scheme=mac_scheme, mesh=_mesh(d))
        assert got == want, mac_scheme
    if policy == "learned":
        # the controller's evaluate and the dispatcher carry the mesh too
        assert ctrl.evaluate(8, engine="fused", num_envs=4, seed=2,
                             mesh=_mesh(d)) == \
            ctrl.evaluate(8, engine="fused", num_envs=4, seed=2)
        assert evaluate_policy(pol, env, 8, engine="fused", num_envs=4,
                               seed=2, mesh=_mesh(d)) == \
            evaluate_fused(pol, env, 8, num_envs=4, seed=2)


# -- GDMService on a mesh ----------------------------------------------------------------

@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_gdm_service_mesh_parity_and_bucketing(d):
    mesh = _mesh(d, "batch")
    ref = GDMService(7, num_blocks=2, device="cpu")
    got = GDMService(7, num_blocks=2, mesh=mesh)
    np.testing.assert_array_equal(got.omega, ref.omega)
    rng = np.random.default_rng(3)
    for n in (3, 5, 9):
        states = [ref.init_state(rng) for _ in range(n)]
        idxs = rng.integers(0, 2, size=n)
        out_ref, q_ref = ref.run_batch([dict(s) for s in states], idxs)
        out_got, q_got = got.run_batch([dict(s) for s in states], idxs)
        np.testing.assert_array_equal(q_got, q_ref)
        for a, b in zip(out_got, out_ref):
            for key in ("latent", "x0"):
                np.testing.assert_allclose(a[key], b[key], atol=LAT_TOL,
                                           rtol=0)
        # the resident slot batch equals run_batch bit for bit on a mesh too
        items = [(i, dict(s), int(k)) for i, (s, k) in
                 enumerate(zip(states, idxs))]
        out_slot, q_slot = got.slot_batch().step(items)
        np.testing.assert_array_equal(q_slot, q_got)
        for a, b in zip(out_slot, out_got):
            for key in ("latent", "x0"):
                np.testing.assert_array_equal(a[key], b[key])
    # buckets always divide the mesh: 3 rows -> 4, 5 -> 8, 9 -> 16
    assert sorted(got._buffers) == [4, 8, 16]
    assert all(b % d == 0 for b in got._buffers)
    lat, pr, *_ = got.slot_batch()._buffers[16]
    assert [t.shape[0] for t in lat] == [16 // d] * d == \
        [t.shape[0] for t in pr]
    assert got._bucket(3) == {1: 4, 2: 4, 4: 4}[d]
    three = GDMService(7, num_blocks=2, mesh=make_env_mesh(
        3, axis="batch", devices=CPUS))
    assert [three._bucket(b) for b in (1, 3, 9)] == [3, 6, 18]
    with pytest.raises(ValueError, match="first device"):
        GDMService(7, num_blocks=2, mesh=mesh, device="meta")


# -- the sharded fleet -------------------------------------------------------------------------

def _fleet_run(cfg, services, mesh=None, scheduling="quantum"):
    ledger = TransferLedger()
    ecfg = EngineConfig(max_blocks=cfg.max_blocks,
                        admission_slots=cfg.num_channels, alpha=cfg.alpha,
                        beta=cfg.beta, early_exit=False, seed=cfg.seed,
                        scheduling=scheduling)
    cluster = cluster_from_scenario(
        cfg, CELLS, services, stacked=True, ledger=ledger, mesh=mesh,
        engine_cfg=ecfg, sched=SchedulerConfig() if scheduling ==
        "continuous" else None)
    fleet = fleet_trace(cfg, FRAMES, CELLS, **FLEET)
    out = serve_fleet(cluster, fleet, services, seed=0, collect_steps=True)
    return out, ledger, cluster


@pytest.fixture(scope="module")
def fleet_models():
    services, _ = make_gdm_services(3, 0, num_blocks=4, device="cpu")
    return [(svc.model, svc.omega) for svc in services.values()]


def _cross_device(ledger, d):
    """Handovers that shipped latents between cells on different mesh
    positions (``device_of_cell = cell % d``)."""
    return [e for e in ledger.events if e.kind == "handover"
            and e.nbytes > 0 and e.src % d != e.dst % d]


@pytest.mark.parametrize("d,scheduling", [
    (1, "quantum"), (2, "quantum"), (4, "quantum"), (2, "continuous")])
def test_cluster_sharded_equals_unsharded_frame_for_frame(fleet_models, d,
                                                          scheduling):
    """Quantum scheduling at every mesh size, and the continuous scheduler
    (its ``SlotBatch`` rows resident per shard) on a mesh of two."""
    cfg = get_scenario("smoke")
    mesh = _mesh(d, "batch")
    want, _, _ = _fleet_run(cfg, {s: GDMService(model=m, omega=o,
                                                num_blocks=4)
                                  for s, (m, o) in enumerate(fleet_models)},
                            scheduling=scheduling)
    got, ledger, cluster = _fleet_run(
        cfg, {s: GDMService(model=m, omega=o, num_blocks=4, mesh=mesh)
              for s, (m, o) in enumerate(fleet_models)}, mesh, scheduling)
    assert cluster.device_of_cell == [c % d for c in range(CELLS)]
    assert len(got["steps"]) == len(want["steps"]) == FRAMES
    for t, (a, b) in enumerate(zip(got["steps"], want["steps"])):
        assert a == b, t
    assert got == want and got["completed"] > 0
    shard = [e for e in ledger.events if e.kind == "shard"]
    cross = _cross_device(ledger, d)
    assert [(e.rid, e.src % d, e.dst % d, e.nbytes) for e in cross] == \
        [(e.rid, e.src, e.dst, e.nbytes) for e in shard]
    assert all(e.cost == 0.0 for e in shard)
    if scheduling == "quantum":
        assert got["handovers"] > 0 and (len(shard) > 0) == (d > 1)
    else:
        assert sum(svc.slot_batch().device_calls
                   for svc in cluster.services.values()) > 0


@pytest.mark.parametrize("d", [2, 4])
def test_cross_device_handover_records_shard_transfer(fleet_models, d):
    mesh = _mesh(d, "batch")
    cfg = get_scenario("smoke", capacity_low=5, capacity_high=5)
    services = {s: GDMService(model=m, omega=o, num_blocks=4, mesh=mesh)
                for s, (m, o) in enumerate(fleet_models)}
    ledger = TransferLedger()
    cluster = cluster_from_scenario(cfg, CELLS, services, stacked=True,
                                    ledger=ledger, mesh=mesh, tracing=True)
    # put one request in flight in cell 0, then hand it to cell 1; an
    # unreachable threshold keeps the chain alive past the first block
    rng = np.random.default_rng(0)
    req = Request(rid=0, service=0, arrival_frame=0, quality_threshold=1.5,
                  ue=2, origin=0, state=services[0].init_state(rng))
    cluster.submit(0, req)
    cluster.step()                               # admit + first block
    assert req.blocks_done >= 1 and not req.done
    applied = cluster.apply_handovers(
        [HandoverEvent(ue=2, src_cell=0, dst_cell=1, dst_origin=1)])
    assert applied, "handover candidate was feasible but not applied"
    (ev,) = [e for e in ledger.events if e.kind == "shard"]
    assert (ev.src, ev.dst) == (0, 1 % d)
    assert ev.nbytes > 0 and ev.cost == 0.0
    (span,) = [t for t in cluster.tracer.transfers if t.kind == "shard"]
    assert (span.rid, span.src, span.dst, span.nbytes, span.cost,
            span.cell) == (0, 0, 1 % d, ev.nbytes, 0.0, 1)


# -- the port at d = 2 against the reference's own sharded paths ------------------------------

def _ref_round_draws(key, cfg, acfg, e, fdtype):
    """The draws the reference's ``round_fn`` makes from ``round_key``, as
    numpy arrays (as ``tests/test_torch_fused.py`` takes them)."""
    keys = jax.random.split(key, 11)
    t, u = cfg.horizon, acfg.num_ues
    reset = {
        "pos": jax.random.uniform(keys[8], (e, u, 2), fdtype, 0.0, cfg.side),
        "dest": jax.random.uniform(keys[9], (e, u, 2), fdtype, 0.0, cfg.side),
        "req": jax.random.uniform(keys[10], (e, u), fdtype),
    }
    draws = {
        "explore": jax.random.uniform(keys[1], (t, e)),
        "q_rand": jax.random.uniform(keys[2], (t, e, u, acfg.num_actions)),
        "arrival": jax.random.uniform(keys[3], (t, e, u)),
        "waypoint": jax.random.uniform(keys[4], (t, e, u, 2), jnp.float32,
                                       0.0, cfg.side),
        "sample": jax.random.uniform(keys[5], (t, acfg.batch_size)),
        "mac_attempt": jax.random.uniform(keys[6], (t, e, u)),
        "mac_channel": jax.random.uniform(keys[7], (t, e, u)),
    }
    return ({k: torch.from_numpy(np.array(v)) for k, v in reset.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})


def _wait(ref_sharded):
    proc, out = ref_sharded
    try:
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the reference's sharded run took over {REF_TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]
    return out


def test_port_matches_the_reference_sharded_paths(ref_sharded):
    """At d = 2: the port's sharded round on the reference's draws against
    the reference's ``train_fused(mesh=make_env_mesh(2))``, then the smoke
    fleet on the reference's weights and Ω against its sharded fleet."""
    tcfg, jcfg = get_scenario("smoke"), jscen.get_scenario("smoke")
    env = EdgeSimulator(tcfg)
    acfg = td3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=tcfg.num_ues,
                            num_actions=tcfg.num_bs + 1, **SMALL_AGENT)
    start = jax.tree_util.tree_map(np.asarray, jd3ql.D3QLAgent(
        jd3ql.D3QLConfig(**dataclasses.asdict(acfg))).params)
    tagent = td3ql.D3QLAgent(acfg, device="cpu", params=start)
    ctrl = LearnGDMController(env, agent=tagent)
    world = torch_env.world_from_sim(env, 4, device="cpu")
    replay = treplay.DeviceReplay(acfg.memory_capacity,
                                  obs_shape=(acfg.history, env.obs_dim),
                                  action_shape=(acfg.num_ues,), device="cpu")
    fused = ctrl._build_fused_round(world, 4, replay, _mesh(2), "env")
    carry = fused.init_carry()
    reward, loss, delivered = [], [], []
    for rd in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(11), rd)
        carry, (rew, losses, dlv) = fused.run_round(
            carry, *_ref_round_draws(key, tcfg, acfg, 4, jnp.float32))
        valid = losses.numpy()[~np.isnan(losses.numpy())]
        reward.extend(rew.tolist())
        loss.extend([float(valid.mean())] * 4)
        delivered.extend(dlv.tolist())
    fused.write_back(carry)

    out = _wait(ref_sharded)
    ref = np.load(out / "train.npz")
    np.testing.assert_allclose(reward, ref["reward"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(delivered, ref["delivered"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_TOL)
    assert tagent.steps == int(ref["steps"]) > 7
    assert tagent.epsilon == float(np.float32(ref["epsilon"]))
    ref_params = np.load(out / "params.npz")
    got = jax.tree_util.tree_leaves((qnet_to_jax(tagent.net),
                                     qnet_to_jax(tagent.target_net)))
    lr = acfg.learning_rate
    for i, (g, s0) in enumerate(zip(got, jax.tree_util.tree_leaves(
            (start, start)))):
        w = ref_params[f"arr_{i}"]
        moved = np.linalg.norm(w - s0)
        assert moved > 0, i
        assert np.linalg.norm(g - w) <= PARAM_TOL * moved, i
        assert np.abs(g - w).max() <= 0.1 * lr, i

    # the fleet: the reference's weights (drawn as its make_gdm_services
    # draws them) and its measured Omega, on a port mesh of two
    lat = np.load(out / "latents.npz")
    dit = jget_config("gdm-dit").reduced()
    mesh = _mesh(2, "batch")
    services = {}
    for s, k in enumerate(jax.random.split(jax.random.PRNGKey(0),
                                           tcfg.num_services)):
        params = jgdm.init_gdm(jax.random.split(k)[0], dit)
        services[s] = service_from_jax(
            jax.tree_util.tree_map(np.asarray, params),
            get_config("gdm-dit").reduced(), omega=lat["omega"][s],
            num_blocks=tcfg.max_blocks, device="cpu", mesh=mesh)
    stats, ledger, cluster = _fleet_run(tcfg, services, mesh)
    want = json.loads((out / "fleet.json").read_text())
    got = json.loads(json.dumps(
        {"stats": stats, "ledger": [vars(e) for e in ledger.events]},
        default=lambda o: o.item()))
    assert got["stats"] == want["stats"]
    assert got["ledger"] == want["ledger"]
    assert stats["completed"] > 0
    assert any(e["kind"] == "shard" for e in got["ledger"])
    n = 0
    for c, eng in enumerate(cluster.engines):
        for r in eng.completed:
            for key in ("latent", "x0"):
                np.testing.assert_allclose(r.state[key],
                                           lat[f"{c}/{r.rid}/{key}"],
                                           atol=LAT_TOL, rtol=LAT_TOL)
            n += 1
    assert n == stats["completed"]
    assert jcfg.num_services == tcfg.num_services
