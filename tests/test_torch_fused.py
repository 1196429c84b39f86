"""Port parity: the fused engine — the tensor env, the device replay,
in-round acting, the training round and the fused evaluation — against the
JAX reference (``repro.sim.jax_env``, ``repro.rl``, ``repro.core``) and the
numpy ``VecEdgeSimulator`` on the CPU.

Tolerances: the env pins run in float64 (``jax.enable_x64``, the port's
world in ``torch.float64``) under injected draws, with integer state
exact, the float32 observations exact and the reward components within
1e-9 (sums of the same terms in another order).  The device replay,
``fused_act`` and a training round with its updates gated off are exact.
With updates on, each loss is held within 1e-5 relative and the trained
parameters by how far training moved them, as in ``tests/test_torch_rl.py``
(Adam steps an element whose gradient is rounding noise differently on
each side); the actions must agree frame by frame, and a disagreement is
named with its frame and Q gap.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import learn_gdm as jlg
from repro.core import policy as jpol
from repro.rl import d3ql as jd3ql
from repro.rl import replay as jreplay
from repro.sim import jax_env
from repro.sim import scenarios as jscen
from repro_torch import experiments as texp
from repro_torch.core import learn_gdm as tlg
from repro_torch.core import policy as tpol
from repro_torch.core.mac import vec_greedy_mac
from repro_torch.launch.mesh import make_env_mesh
from repro_torch.models.convert import qnet_to_jax
from repro_torch.rl import d3ql as td3ql
from repro_torch.rl import replay as treplay
from repro_torch.sim import env as tenv
from repro_torch.sim import scenarios as tscen
from repro_torch.sim import torch_env
from repro_torch.sim import vec_env as tvec

REWARD_TOL = 1e-9
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
SMALL = dict(lstm_units=16, fc=(16, 8))
CPU = "cpu"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(x):
    """A jax or numpy array as a CPU tensor of the same dtype."""
    return torch.from_numpy(np.array(x))


def _configs(name, **kw):
    return tscen.get_scenario(name, **kw), jscen.get_scenario(name, **kw)


# -- the tensor env against jax_env and the numpy engine ------------------------------

def _drive_three(name, ep_seeds, *, mac_scheme, rng, placement_high=None):
    """Step the numpy, jax and tensor engines in lockstep from one reset
    state under the same injected draws; assert equivalence each frame."""
    tcfg, jcfg = _configs(name)
    e, u = len(ep_seeds), tcfg.num_ues
    venv = tvec.VecEdgeSimulator(tcfg, e)
    venv.reset(seeds=ep_seeds)
    jworld = jax_env.world_from_sim(venv)
    jstate = jax_env.state_from_numpy(venv)
    tworld = torch_env.world_from_sim(venv, dtype=torch.float64, device=CPU)
    tstate = torch_env.state_from_numpy(venv, dtype=torch.float64, device=CPU)
    assert tworld.qbar.dtype == torch.float64 == tstate.pos.dtype
    jstep = jax.jit(functools.partial(jax_env.env_step, jcfg, jworld))
    jmac = jax.jit(functools.partial(jax_env.greedy_mac, jcfg, jworld))
    high = placement_high or tcfg.num_bs
    for t in range(tcfg.horizon):
        if mac_scheme == "greedy":
            mac = vec_greedy_mac(venv)
            np.testing.assert_array_equal(mac, np.asarray(jmac(jstate)))
            got = torch_env.greedy_mac(tcfg, tworld, tstate)
        else:
            attempt, channel = rng.random((2, e, u))
            mac = np.asarray(jax_env.random_access(
                jcfg, jstate, attempt_draws=jnp.asarray(attempt),
                channel_draws=jnp.asarray(channel)))
            got = torch_env.random_access(tcfg, tstate,
                                          attempt_draws=_t(attempt),
                                          channel_draws=_t(channel))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), mac, err_msg=f"frame {t}")
        pl = rng.integers(-1, high, size=(e, u))
        arrival = rng.random((e, u))
        redraw = rng.uniform(0, tcfg.side, size=(e, u, 2))
        res = venv.step(mac, pl, arrival_draws=arrival, waypoint_redraw=redraw)
        jstate, jinfo = jstep(jstate, jnp.asarray(mac), jnp.asarray(pl),
                              arrival_draws=jnp.asarray(arrival),
                              waypoint_draws=jnp.asarray(redraw))
        tstate, tinfo = torch_env.env_step(
            tcfg, tworld, tstate, _t(mac), _t(pl),
            arrival_draws=_t(arrival), waypoint_draws=_t(redraw))
        for field in ("poa", "prev_poa", "blocks_done", "chain_state",
                      "cur_node", "has_request", "uploaded", "num_delivered",
                      "num_collisions"):
            got = getattr(tstate, field)
            if field not in ("has_request", "uploaded"):
                assert got.dtype == torch.int32, field
            np.testing.assert_array_equal(got.numpy(), getattr(venv, field),
                                          err_msg=f"frame {t}: {field}")
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jstate, field)),
                err_msg=f"frame {t}: {field}")
        for k in ("bs_load", "delivered", "executed", "uploaded"):
            np.testing.assert_array_equal(tinfo[k].numpy(), res[k],
                                          err_msg=f"frame {t}: {k}")
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(jinfo[k]))
        for k in ("rewards", "quality_gain", "exec_cost", "trans_cost"):
            np.testing.assert_allclose(tinfo[k].numpy(), res[k],
                                       atol=REWARD_TOL, rtol=0,
                                       err_msg=f"frame {t}: {k}")
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                       atol=REWARD_TOL, rtol=0)
        for key in ("pos", "dest", "pause_left"):
            np.testing.assert_array_equal(getattr(tstate, key).numpy(),
                                          getattr(venv.mobility, key))
        np.testing.assert_array_equal(
            torch_env.observe(tcfg, tworld, tstate, tinfo["bs_load"]).numpy(),
            venv.observation(res["bs_load"]))
        assert tinfo["done"] == bool(res["done"]) == bool(jinfo["done"])
        assert tstate.frame == venv.frame
    np.testing.assert_allclose(tstate.total_delivered.numpy(),
                               venv.total_delivered, atol=REWARD_TOL, rtol=0)
    np.testing.assert_allclose(tstate.delivered_quality.numpy(),
                               venv.delivered_quality, atol=REWARD_TOL, rtol=0)
    return venv


@pytest.mark.parametrize("mac_scheme", ["greedy", "random"])
@pytest.mark.parametrize("name", ["paper-fig3", "smoke", "hetero-capacity"])
def test_torch_env_matches_jax_env_and_numpy(name, mac_scheme):
    with jax.enable_x64(True):
        rng = np.random.default_rng(len(name))
        venv = _drive_three(name, [101, 102, 103], mac_scheme=mac_scheme,
                            rng=rng)
    assert venv.num_delivered.sum() > 0


def test_torch_env_capacity_blocking_matches():
    """Hotspot load (only BS 0..2) forces C3 capacity blocking, the rank
    and tie-break sensitive path."""
    with jax.enable_x64(True):
        _drive_three("paper-fig3", [55, 56], mac_scheme="greedy",
                     rng=np.random.default_rng(5), placement_high=3)


def test_segment_positions_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    for m, groups_n in ((64, 7), (33, 1), (1, 3), (50, 50)):
        groups = rng.integers(0, groups_n, size=m)
        ranks = rng.permutation(m)
        sel_np, pos_np = tvec.segment_positions(groups, ranks)
        sel_jx, pos_jx = jax_env.segment_positions(jnp.asarray(groups),
                                                   jnp.asarray(ranks))
        sel_t, pos_t = torch_env.segment_positions(torch.from_numpy(groups),
                                                   torch.from_numpy(ranks))
        for got in (sel_t, pos_t):
            assert got.dtype == torch.int64
        np.testing.assert_array_equal(sel_t.numpy(), sel_np)
        np.testing.assert_array_equal(pos_t.numpy(), pos_np)
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_jx))
        np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_jx))


@pytest.mark.parametrize("variant", ["learn-gdm", "mp", "fp"])
def test_action_mask_matches_controller_and_jax(variant):
    """The device masks against the controller's batched masks and
    jax_env's along random episodes (chains started and mid-chain)."""
    tcfg, jcfg = _configs("smoke", num_ues=8)
    venv = tvec.VecEdgeSimulator(tcfg, 3, seeds=np.full(3, tcfg.seed))
    venv.reset(seeds=[3, 9, 4])
    rng = np.random.default_rng(7)
    saw_mid = False
    for t in range(tcfg.horizon):
        state = torch_env.state_from_numpy(venv, device=CPU)
        got = torch_env.action_mask(tcfg, state, variant).numpy()
        np.testing.assert_array_equal(
            got, tlg.variant_action_mask_vec(venv, variant))
        np.testing.assert_array_equal(got, np.asarray(jax_env.action_mask(
            jcfg, jax_env.state_from_numpy(venv), variant)))
        saw_mid |= bool(((venv.blocks_done > 0)
                         & (venv.blocks_done < tcfg.max_blocks)).any())
        venv.step(vec_greedy_mac(venv),
                  rng.integers(-1, tcfg.num_bs, size=(3, tcfg.num_ues)))
    assert saw_mid
    with pytest.raises(ValueError, match="unknown variant"):
        torch_env.action_mask(tcfg, state, "opt")


def test_reset_env_is_well_formed():
    tcfg, _ = _configs("paper-fig3")
    world = torch_env.world_from_sim(tenv.EdgeSimulator(tcfg), 16, device=CPU)
    state = torch_env.reset_env(tcfg, world,
                                generator=torch.Generator().manual_seed(0))
    poa = state.poa.numpy()
    assert poa.shape == (16, tcfg.num_ues) and state.poa.dtype == torch.int32
    assert poa.min() >= 0 and poa.max() < tcfg.num_bs
    assert not state.blocks_done.any() and state.frame == 0
    assert (state.chain_state == tenv.IDLE).all()
    # request probability 0.9 at reset, as in the numpy engines
    assert 0.75 < state.has_request.float().mean() < 1.0
    # injected draws are taken as given
    pos = torch.full((16, tcfg.num_ues, 2), 150.0)
    state = torch_env.reset_env(tcfg, world, pos_draws=pos, dest_draws=pos,
                                req_draws=torch.zeros(16, tcfg.num_ues))
    assert (state.poa == 5).all() and state.has_request.all()


def test_world_from_sim_copies_the_world():
    tcfg, _ = _configs("smoke")
    venv = tvec.VecEdgeSimulator(tcfg, 2, seeds=[1, 2])
    world = torch_env.world_from_sim(venv, dtype=torch.float64, device=CPU)
    qbar = world.qbar.clone()
    venv.qbar[:] = -1.0
    assert torch.equal(world.qbar, qbar)
    np.testing.assert_array_equal(
        world.omega_ue.numpy(),
        venv.omega[np.arange(2)[:, None], venv.service_of])
    scalar = tenv.EdgeSimulator(tcfg)
    tiled = torch_env.world_from_sim(scalar, 3, device=CPU)
    assert tiled.w_hat.shape == (3, tcfg.num_bs)
    assert tiled.qbar.dtype == torch.float32


def test_float32_rollout_respects_capacity_and_ranges():
    """The training dtype: C3 capacity and state ranges over a whole
    episode with every UE placed on BS 0."""
    tcfg, _ = _configs("paper-fig3", seed=1)
    e = 8
    world = torch_env.world_from_sim(tenv.EdgeSimulator(tcfg), e, device=CPU)
    gen = torch.Generator().manual_seed(1)
    state = torch_env.reset_env(tcfg, world, generator=gen)
    w_hat = world.w_hat.numpy()
    for _ in range(tcfg.horizon):
        mac = torch_env.greedy_mac(tcfg, world, state)
        state, info = torch_env.env_step(
            tcfg, world, state, mac,
            torch.zeros((e, tcfg.num_ues), dtype=torch.int32), generator=gen)
        assert (info["bs_load"].numpy() <= w_hat).all()
        blocks = state.blocks_done.numpy()
        assert blocks.min() >= 0 and blocks.max() <= tcfg.max_blocks
        assert torch.isfinite(info["rewards"]).all()
        assert info["rewards"].dtype == torch.float32
    assert state.frame == tcfg.horizon and info["done"]


# -- the device replay ----------------------------------------------------------------

@pytest.mark.parametrize("capacity,pushes", [(16, [3, 1, 7, 2, 5]),
                                             (8, [5, 11, 1, 9]),
                                             (64, [8] * 5)])
def test_device_replay_equals_both_references(capacity, pushes):
    """Pushes that wrap the ring, and a push larger than the ring (its
    older rows dropped before the write), slot for slot against
    ``ReplayMemory.push_batch`` and the reference's DeviceReplay; samples
    from the same uniforms pick the same slots, inside the filled range."""
    dev = treplay.DeviceReplay(capacity, (3, 4), (2,), device=CPU)
    jdev = jreplay.DeviceReplay(capacity, (3, 4), (2,))
    host = treplay.ReplayMemory(capacity, (3, 4), (2,), seed=7)
    state, jstate = dev.init(), jdev.init()
    rng = np.random.default_rng(capacity)
    for n in pushes:
        obs = rng.standard_normal((n, 3, 4)).astype(np.float32)
        nxt = rng.standard_normal((n, 3, 4)).astype(np.float32)
        act = rng.integers(0, 5, (n, 2)).astype(np.int32)
        rew = rng.standard_normal(n)                  # float64, stored f32
        done = (rng.random(n) < 0.3).astype(np.float32)
        state = dev.push(state, _t(obs), _t(act), _t(rew), _t(nxt), _t(done))
        jstate = jdev.push(jstate, jnp.asarray(obs), jnp.asarray(act),
                           jnp.asarray(rew), jnp.asarray(nxt),
                           jnp.asarray(done))
        host.push_batch(obs, act, rew, nxt, done)
        assert (state.idx, state.size) == (host.idx, host.size) == \
            (int(jstate.idx), int(jstate.size))
        for key in ("obs", "actions", "rewards", "next_obs", "dones"):
            got = getattr(state, key)
            assert got.dtype == _t(getattr(host, key)).dtype, key
            np.testing.assert_array_equal(got.numpy(), getattr(host, key))
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jstate, key)))
        u01 = np.array(jax.random.uniform(
            jax.random.PRNGKey(n + capacity), (64,)))
        u01[:2] = (0.0, np.nextafter(np.float32(1), np.float32(0)))
        got = dev.sample_from_uniforms(state, _t(u01))
        want = jdev.sample_from_uniforms(jstate, jnp.asarray(u01))
        ids = np.floor(u01 * np.float32(max(state.size, 1))).astype(int)
        assert ids.min() >= 0 and ids.max() < state.size
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
            np.testing.assert_array_equal(
                got[key].numpy(), getattr(state, key)[ids].numpy())


# -- acting ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_agents():
    """A reference agent for the smoke scenario at small widths and the
    same config for the port."""
    tcfg, jcfg = _configs("smoke")
    env = tenv.EdgeSimulator(tcfg)
    acfg = td3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=tcfg.num_ues,
                            num_actions=tcfg.num_bs + 1, **SMALL)
    jagent = jd3ql.D3QLAgent(jd3ql.D3QLConfig(**dataclasses.asdict(acfg)))
    return tcfg, jcfg, acfg, _np_tree(jagent.params)


def test_fused_act_equals_reference(small_agents):
    """Carried weights, the reference's draws: every env exploring (the
    mask then picks among the allowed uniforms), some, none."""
    tcfg, jcfg, acfg, params = small_agents
    tagent = td3ql.D3QLAgent(acfg, device=CPU, params=params)
    e, u, a = 6, acfg.num_ues, acfg.num_actions
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((e, acfg.history, acfg.obs_dim)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(3)
    for epsilon in (1.0, 0.5, 0.0):
        key, k1, k2 = jax.random.split(key, 3)
        explore = jax.random.uniform(k1, (e,))
        q_rand = jax.random.uniform(k2, (e, u, a))
        mask = rng.random((e, u, a)) < 0.4
        mask[..., 0] = True
        for m in (None, mask):
            want = jd3ql.fused_act(
                params, jnp.asarray(obs), epsilon=jnp.float32(epsilon),
                mask=None if m is None else jnp.asarray(m), num_ues=u,
                num_actions=a, explore_draw=explore, q_rand=q_rand)
            got = td3ql.fused_act(
                tagent.net, _t(obs), epsilon=epsilon,
                mask=None if m is None else torch.from_numpy(m),
                explore_draw=_t(explore), q_rand=_t(q_rand))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            if m is not None and epsilon == 1.0:
                # full exploration: the argmax of the allowed uniforms
                drawn = np.where(m, np.asarray(q_rand), -np.inf)
                np.testing.assert_array_equal(got.numpy(),
                                              drawn.argmax(-1))
                assert m[np.arange(e)[:, None], np.arange(u),
                         got.numpy()].all()


# -- one training round ---------------------------------------------------------------

def _ref_round_draws(key, cfg, acfg, e, fdtype):
    """The draws the reference's ``round_fn`` makes from ``round_key``
    (``repro/core/learn_gdm.py:419-449``), as numpy arrays."""
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
    return ({k: np.asarray(v) for k, v in reset.items()},
            {k: np.asarray(v) for k, v in draws.items()})


def _rounds(acfg_kw, *, rounds, num_envs=4, epsilon=1.0, mac_scheme="greedy",
            variant="learn-gdm", dtype=torch.float64):
    """``rounds`` fused rounds on both sides from carried parameters and
    the reference's own draws.  Returns per-round outputs, the final
    carries, the agents and the starting parameters.

    In float64 the reference's round runs with jit disabled: jax 0.9.0's
    XLA:CPU compiles the whole jitted round wrongly under x64 (env 2 of 4
    observes its UEs' thresholds permuted, while its rewards stay right);
    the same round eager, and jitted in float32, agree with the port."""
    import contextlib
    x64 = dtype == torch.float64
    tcfg, jcfg = _configs("smoke")
    env = tenv.EdgeSimulator(tcfg)
    acfg = td3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=tcfg.num_ues,
                            num_actions=tcfg.num_bs + 1, **SMALL, **acfg_kw)
    # the reference agent is built outside x64: its Q-net stays float32
    jagent = jd3ql.D3QLAgent(jd3ql.D3QLConfig(**dataclasses.asdict(acfg)))
    start = _np_tree(jagent.params)
    tagent = td3ql.D3QLAgent(acfg, device=CPU, params=start)
    jagent.epsilon = tagent.epsilon = epsilon
    jctrl = jlg.LearnGDMController(jlg.EdgeSimulator(jcfg), agent=jagent,
                                   variant=variant, mac_scheme=mac_scheme)
    tctrl = tlg.LearnGDMController(env, agent=tagent, variant=variant,
                                   mac_scheme=mac_scheme)
    outs = []
    with jax.enable_x64(x64):
        jworld = jax_env.world_from_sim(jctrl.env, num_envs)
        jrep = jreplay.DeviceReplay(acfg.memory_capacity,
                                    obs_shape=(acfg.history, env.obs_dim),
                                    action_shape=(acfg.num_ues,))
        round_fn = jctrl._build_fused_round(jworld, num_envs, jrep)
        jcarry = (jagent.params, jagent.target_params, jagent.opt_state,
                  jrep.init(), jnp.asarray(jagent.epsilon, jnp.float32),
                  jnp.asarray(jagent.steps, jnp.int32))
        tworld = torch_env.world_from_sim(env, num_envs, dtype=dtype,
                                          device=CPU)
        trep = treplay.DeviceReplay(acfg.memory_capacity,
                                    obs_shape=(acfg.history, env.obs_dim),
                                    action_shape=(acfg.num_ues,), device=CPU)
        fused = tctrl._build_fused_round(tworld, num_envs, trep)
        tcarry = fused.init_carry()
        for rd in range(rounds):
            key = jax.random.fold_in(jax.random.PRNGKey(11), rd)
            reset, draws = _ref_round_draws(key, tcfg, acfg, num_envs,
                                            jworld.qbar.dtype)
            with jax.disable_jit() if x64 else contextlib.nullcontext():
                jcarry, jout = round_fn(jcarry, key)
            tcarry, tout = fused.run_round(
                tcarry, {k: _t(v) for k, v in reset.items()},
                {k: _t(v) for k, v in draws.items()})
            outs.append((tuple(np.asarray(x) for x in jout),
                         tuple(x.numpy() for x in tout)))
    fused.write_back(tcarry)
    return outs, jcarry, tcarry, jagent, tagent, start


def _same_replay(jcarry, tcarry, tagent, reward_tol=0.0):
    """The rings slot for slot: observations and dones exactly, rewards
    within ``reward_tol``; the actions exactly, a disagreement named with
    its slot and the port's top-2 Q gap."""
    jr, tr = jcarry[3], tcarry.replay
    assert (int(jr.idx), int(jr.size)) == (tr.idx, tr.size)
    for key in ("obs", "next_obs", "dones"):
        np.testing.assert_array_equal(getattr(tr, key).numpy(),
                                      np.asarray(getattr(jr, key)),
                                      err_msg=key)
    np.testing.assert_allclose(tr.rewards.numpy(), np.asarray(jr.rewards),
                               atol=reward_tol, rtol=0)
    got, want = tr.actions.numpy(), np.asarray(jr.actions)
    for slot in np.flatnonzero((got != want).any(axis=-1)):
        with torch.no_grad():
            q = tagent.q_values(tr.obs[slot:slot + 1].numpy())[0]
        top2 = np.sort(q, axis=-1)[:, -2:]
        gap = float((top2[:, 1] - top2[:, 0]).min())
        pytest.fail(f"replay slot {slot}: actions differ; the port's "
                    f"smallest top-2 Q gap there is {gap:.3e} "
                    f"(max|Q| {np.abs(q).max():.3e})")


@pytest.mark.parametrize("mac_scheme,variant,epsilon", [
    ("greedy", "learn-gdm", 1.0), ("random", "mp", 0.6),
    ("greedy", "fp", 0.3)])
def test_round_with_updates_gated_off_equals_reference(mac_scheme, variant,
                                                      epsilon):
    """Two rounds in float64 whose replay never reaches the batch size (so
    no update runs), the ring wrapping: every action (exploring and
    greedy), reward, observation and replay slot exactly; the episode
    rewards and deliveries within 1e-9."""
    outs, jcarry, tcarry, jagent, tagent, start = _rounds(
        dict(batch_size=200, memory_capacity=40), rounds=2, epsilon=epsilon,
        mac_scheme=mac_scheme, variant=variant)
    for (jrew, jloss, jdel), (trew, tloss, tdel) in outs:
        np.testing.assert_allclose(trew, jrew, atol=REWARD_TOL, rtol=0)
        np.testing.assert_allclose(tdel, jdel, atol=REWARD_TOL, rtol=0)
        assert np.isnan(jloss).all() and np.isnan(tloss).all()
    _same_replay(jcarry, tcarry, tagent)
    assert tcarry.steps == int(jcarry[5]) == 0
    assert tcarry.epsilon == float(jcarry[4])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jcarry[0]),
                            jax.tree_util.tree_leaves(
                                qnet_to_jax(tcarry.net))):
        np.testing.assert_array_equal(g, np.asarray(w))


def _moved_close(got, want, start, tol, lr):
    for (path, w), g, s0 in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(start)):
        w, s0 = np.asarray(w), np.asarray(s0)
        name = jax.tree_util.keystr(path)
        moved = np.linalg.norm(w - s0)
        assert moved > 0, name
        assert np.linalg.norm(g - w) <= tol * moved, name
        assert np.abs(g - w).max() <= 0.1 * lr, name


def test_round_with_updates_equals_reference():
    """Three rounds in float32, the training dtype (the reference's round
    jitted, as it trains), updating every frame once the replay holds a
    batch, the target synced every 7 updates, epsilon decaying into greedy
    frames: the same actions and observations, the rewards within 1e-6
    (float32 sums in another order), the losses within 1e-5 relative, the
    parameters held by their movement, the same steps and epsilon."""
    outs, jcarry, tcarry, jagent, tagent, start = _rounds(
        dict(batch_size=8, memory_capacity=64, target_sync=7,
             epsilon_decay=0.9, epsilon_floor=0.05), rounds=3, epsilon=1.0,
        dtype=torch.float32)
    n_loss = 0
    for (jrew, jloss, jdel), (trew, tloss, tdel) in outs:
        np.testing.assert_allclose(trew, jrew, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tdel, jdel, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.isnan(tloss), np.isnan(jloss))
        ok = ~np.isnan(jloss)
        n_loss += int(ok.sum())
        np.testing.assert_allclose(tloss[ok], jloss[ok], rtol=LOSS_TOL)
    _same_replay(jcarry, tcarry, tagent, reward_tol=1e-6)
    assert tcarry.steps == int(jcarry[5]) == n_loss > 7
    assert tcarry.epsilon == float(jcarry[4]) < 0.5
    lr = tagent.cfg.learning_rate
    _moved_close(qnet_to_jax(tcarry.net), jcarry[0], start, PARAM_TOL, lr)
    _moved_close(qnet_to_jax(tcarry.target_net), jcarry[1], start,
                 PARAM_TOL, lr)
    assert tcarry.opt_state.step == int(jcarry[2].step) == n_loss
    # written back to the agent, as the reference's train_fused does
    assert tagent.steps == n_loss and tagent.epsilon == tcarry.epsilon
    assert tagent.net is tcarry.net


def test_draw_round_matches_the_reference_draws():
    """The port's round draws carry the reference's keys, shapes and
    dtypes (float32, with the reset draws in the world's dtype), uniform
    in [0, 1) or [0, side)."""
    tcfg, jcfg = _configs("smoke")
    env = tenv.EdgeSimulator(tcfg)
    acfg = td3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=tcfg.num_ues,
                            num_actions=tcfg.num_bs + 1, **SMALL)
    ctrl = tlg.LearnGDMController(
        env, agent=td3ql.D3QLAgent(acfg, device=CPU))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        world = torch_env.world_from_sim(env, 3, dtype=dtype, device=CPU)
        replay = treplay.DeviceReplay(8, (acfg.history, env.obs_dim),
                                      (acfg.num_ues,), device=CPU)
        fused = ctrl._build_fused_round(world, 3, replay)
        reset, draws = fused.draw_round(torch.Generator().manual_seed(0))
        with jax.enable_x64(dtype == torch.float64):
            jreset, jdraws = _ref_round_draws(jax.random.PRNGKey(0), jcfg,
                                              acfg, 3, jdtype)
        for got, want in ((reset, jreset), (draws, jdraws)):
            assert got.keys() == want.keys()
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, k
                if dtype == torch.float32 or k in reset:
                    assert got[k].dtype == _t(want[k]).dtype, k
                high = tcfg.side if k in ("pos", "dest", "waypoint") else 1
                assert 0 <= got[k].min() and got[k].max() < high, k
    # on a mesh the round keeps its whole draws and splits the world
    mesh = make_env_mesh(3, devices=(CPU,) * 3)
    fused = ctrl._build_fused_round(world, 3, replay, mesh=mesh)
    assert [w.qbar.shape[0] for w in fused.worlds] == [1, 1, 1]
    assert all(torch.equal(w.y_hat, world.y_hat) for w in fused.worlds)
    reset, draws = fused.draw_round(torch.Generator().manual_seed(0))
    assert draws["q_rand"].shape[1] == reset["pos"].shape[0] == 3
    with pytest.raises(AssertionError):
        ctrl._build_fused_round(world, 3, replay, mesh=make_env_mesh(
            2, devices=(CPU,) * 2))


def test_train_fused_writes_back_params_epsilon_and_steps():
    """``train_fused`` on the CPU: one history entry per episode, and the
    agent's parameters, optimizer state, epsilon and steps written back —
    epsilon and steps equal to the reference's, which the count of frames
    and pushes fixes whatever the draws."""
    tcfg, jcfg = _configs("smoke")
    env = tenv.EdgeSimulator(tcfg)
    acfg = td3ql.D3QLConfig(obs_dim=env.obs_dim, num_ues=tcfg.num_ues,
                            num_actions=tcfg.num_bs + 1, batch_size=16,
                            target_sync=10, **SMALL)
    ctrl = tlg.LearnGDMController(env, agent=td3ql.D3QLAgent(acfg,
                                                             device=CPU))
    jctrl = jlg.LearnGDMController(
        jlg.EdgeSimulator(jcfg),
        agent=jd3ql.D3QLAgent(jd3ql.D3QLConfig(**dataclasses.asdict(acfg))))
    for c in (ctrl, jctrl):
        c.calibrate_epsilon(10, num_envs=4, final=5e-2)
    start = {k: p.detach().clone() for k, p in ctrl.agent.params.items()}
    hist = ctrl.train_fused(10, num_envs=4, seed=3)
    jctrl.train_fused(10, num_envs=4, seed=3)
    assert {k: len(v) for k, v in hist.items()} == dict.fromkeys(
        ("reward", "loss", "delivered"), 10)
    assert np.isfinite(hist["reward"]).all()
    assert np.isfinite(hist["loss"][-1])
    agent = ctrl.agent
    assert agent.steps == jctrl.agent.steps == agent.opt_state.step > 0
    assert agent.epsilon == jctrl.agent.epsilon
    assert all(not torch.equal(start[k], p) for k, p in agent.params.items())
    assert len(agent.memory) == 0               # the device replay is internal
    # the same seed trains the same agent
    again = tlg.LearnGDMController(
        env, agent=td3ql.D3QLAgent(dataclasses.replace(
            acfg, epsilon_decay=agent.cfg.epsilon_decay), device=CPU))
    assert again.train_fused(10, num_envs=4, seed=3)["reward"] == \
        hist["reward"]
    # a mesh changes where the env math runs, not what is computed
    sharded = tlg.LearnGDMController(
        env, agent=td3ql.D3QLAgent(dataclasses.replace(
            acfg, epsilon_decay=agent.cfg.epsilon_decay), device=CPU))
    assert sharded.train_fused(10, num_envs=4, seed=3, mesh=make_env_mesh(
        2, devices=(CPU,) * 2))["reward"] == hist["reward"]
    assert sharded.agent.steps == agent.steps


# -- the fused evaluation -------------------------------------------------------------

def _policies(tcfg, jcfg, params):
    acfg = td3ql.D3QLConfig(
        obs_dim=tenv.EdgeSimulator(tcfg).obs_dim, num_ues=tcfg.num_ues,
        num_actions=tcfg.num_bs + 1, **SMALL)
    jagent = jd3ql.D3QLAgent(jd3ql.D3QLConfig(**dataclasses.asdict(acfg)))
    jagent.params = jax.tree_util.tree_map(jnp.asarray, params)
    tagent = td3ql.D3QLAgent(acfg, device=CPU, params=params)
    return [(tpol.LearnedPolicy(tagent, "mp"), jpol.LearnedPolicy(jagent, "mp")),
            (tpol.LearnedPolicy(tagent, "learn-gdm"),
             jpol.LearnedPolicy(jagent, "learn-gdm")),
            (tpol.GreedyPoAPolicy(), jpol.GreedyPoAPolicy()),
            (tpol.RandomPolicy("fp", seed=1), jpol.RandomPolicy("fp", seed=1))]


def test_eval_round_equals_reference_and_numpy(small_agents):
    """The eval round of each policy against the reference's and the numpy
    rollout under the same state and draws (float64): counters exactly,
    the float totals within 1e-9."""
    tcfg, jcfg, _, params = small_agents
    e, u, t = 3, tcfg.num_ues, tcfg.horizon
    rng = np.random.default_rng(5)
    policies = _policies(tcfg, jcfg, params)     # float32 Q-nets
    with jax.enable_x64(True):
        for tpolicy, jpolicy in policies:
            venv = tvec.VecEdgeSimulator(tcfg, e, seeds=np.full(e, tcfg.seed))
            venv.reset(seeds=[11, 12, 13])
            jworld = jax_env.world_from_sim(venv)
            jstate0 = jax_env.state_from_numpy(venv)
            tworld = torch_env.world_from_sim(venv, dtype=torch.float64,
                                              device=CPU)
            tstate0 = torch_env.state_from_numpy(venv, dtype=torch.float64,
                                                 device=CPU)
            draws = {"arrival": rng.random((t, e, u)),
                     "waypoint": rng.uniform(0, tcfg.side, (t, e, u, 2))}
            if tpolicy.needs_draws:
                draws["policy"] = rng.random((t, e, u, tcfg.num_bs + 1))
            stats_np = tpol.rollout_round(
                tpolicy, venv, arrival_draws=draws["arrival"],
                waypoint_draws=draws["waypoint"],
                policy_draws=draws.get("policy"))
            jparams, jact = jpolicy.fused_spec(jcfg)
            _, want = jax_env.build_eval_round(
                jcfg, jact, history=jpolicy.history,
                needs_obs=jpolicy.needs_obs)(
                    jparams, jworld, jstate0,
                    {k: jnp.asarray(v) for k, v in draws.items()})
            tparams, tact = tpolicy.fused_spec(tcfg)
            _, got = torch_env.build_eval_round(
                tcfg, tact, history=tpolicy.history,
                needs_obs=tpolicy.needs_obs)(
                    tparams, tworld, tstate0,
                    {k: _t(v) for k, v in draws.items()})
            for k in ("num_delivered", "collisions"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
                np.testing.assert_array_equal(
                    got[k].numpy(), [getattr(s, k) for s in stats_np])
            for k, attr in (("reward", "reward"),
                            ("quality_gain", "quality_gain"),
                            ("exec_cost", "exec_cost"),
                            ("trans_cost", "trans_cost"),
                            ("delivered_quality", "delivered_quality")):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]),
                                           atol=REWARD_TOL, rtol=0,
                                           err_msg=f"{tpolicy.name} {k}")
                np.testing.assert_allclose(
                    got[k].numpy(), [getattr(s, attr) for s in stats_np],
                    atol=REWARD_TOL, rtol=0, err_msg=f"{tpolicy.name} {k}")


def test_make_eval_draws_matches_the_reference_keys_shapes_dtypes():
    tcfg, jcfg = _configs("smoke")
    for mac_random, policy_draws in ((False, False), (True, True)):
        got = tpol.make_eval_draws(tcfg, 3, torch.Generator().manual_seed(1),
                                   mac_random=mac_random,
                                   policy_draws=policy_draws)
        want = jpol.make_eval_draws(jcfg, 3, jax.random.PRNGKey(1),
                                    mac_random=mac_random,
                                    policy_draws=policy_draws)
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == _t(want[k]).dtype
            high = tcfg.side if k == "waypoint" else 1
            assert 0 <= got[k].min() and got[k].max() < high


def test_evaluate_fused_through_the_controllers():
    """``evaluate(engine="fused")`` for a learned policy and GR, and
    ``evaluate_policy`` for the random policy: the summary keys of the
    other engines, finite, reproducible from the seed."""
    tcfg, _ = _configs("smoke")
    env = tenv.EdgeSimulator(tcfg)
    ctrl = tlg.LearnGDMController(env, seed=0, device=CPU)
    out = ctrl.evaluate(4, engine="fused", num_envs=2)
    ref = ctrl.evaluate(4, engine="vectorized")
    assert set(out) == set(ref)
    assert all(np.isfinite(v) for v in out.values())
    assert ctrl.evaluate(4, engine="fused", num_envs=2) == out
    assert ctrl.evaluate(4, engine="fused", num_envs=2, seed=1) != out
    from repro_torch.core.baselines import GreedyController
    gr = GreedyController(env).evaluate(3, engine="fused", device=CPU)
    assert set(gr) == set(ref) and gr["num_delivered"] > 0
    rnd = tpol.evaluate_policy(tpol.RandomPolicy("mp", seed=2), env, 3,
                               engine="fused", device=CPU,
                               mac_scheme="random")
    assert all(np.isfinite(v) for v in rnd.values())


def test_run_suite_through_the_fused_engines():
    """A sweep point trained and evaluated through the fused engines on
    the CPU: every variant and GR, finite."""
    tcfg, _ = _configs("smoke")
    point = texp.run_suite(tcfg, train_eps=8, eval_eps=2, engine="fused",
                           eval_engine="fused", num_envs=4, device=CPU,
                           include_opt=False)
    assert set(point) == {"learn-gdm", "mp", "fp", "gr"}
    assert all(np.isfinite(v) for v in point.values())
