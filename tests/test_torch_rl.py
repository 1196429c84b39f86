"""Port parity: the D3QL agent — the hand-written LSTM, the dueling Q-net,
the weight handoff, the port's own initialisation, the replay memory,
acting and the double-Q update — against the JAX reference on the CPU.

Weights cross by ``repro_torch.models.convert.qnet_from_jax``; inputs are
numpy arrays from seeded generators (observations from the carried
simulator, so they hold the eq. (7) vector's exact zeros and one-hots).
Tolerances, float32: the LSTM 1e-6 and Q 1e-5 of the largest magnitude;
over 20 updates the first loss 1e-5 relative and every loss 1e-4.  The
parameters after them are held leaf by leaf against how far training moved
the leaf: |port - reference| <= 1e-4 |reference - start| in norm (the
measure of ``chip_smoke.py``'s train phases, 100 times tighter), and no
element apart by a tenth of a learning rate.  Adam divides each gradient
by its own size, so an element whose gradient is rounding noise (an input
feature that cancels: one of lstm.wx's 154624 elements here, gradient
3e-10 against 1e-4) takes another step on each side, a few hundredths of
the learning rate.  Integer decisions (actions, replay indices) are
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import recurrent as jrec
from repro.rl import d3ql as jd3ql
from repro.rl import networks as jnet
from repro.rl import replay as jreplay
from repro_torch.core.learn_gdm import obs_history_window
from repro_torch.models.convert import qnet_from_jax, qnet_to_jax
from repro_torch.nn import recurrent as trec
from repro_torch.rl import d3ql as td3ql
from repro_torch.rl import networks as tnet
from repro_torch.rl import replay as treplay
from repro_torch.sim.scenarios import get_scenario
from repro_torch.sim.vec_env import VecEdgeSimulator

LSTM_TOL = 1e-6
Q_TOL = 1e-5
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _cfg(name, **kw):
    """The agent's config for a scenario (Table II widths), and the
    reference's with the same fields."""
    scen = get_scenario(name)
    cfg = td3ql.D3QLConfig(
        obs_dim=2 * scen.num_bs + 2 * scen.num_ues + scen.num_ues * scen.num_bs,
        num_ues=scen.num_ues, num_actions=scen.num_bs + 1, **kw)
    return cfg, jd3ql.D3QLConfig(**dataclasses.asdict(cfg))


SMALL = dict(lstm_units=16, fc=(16, 8), batch_size=8, memory_capacity=64)


def _observations(name, frames, seed, num_envs=4):
    """(frames * num_envs, H, obs_dim) eq. (7) windows and the (.., U, A)
    masks of the carried simulator under random actions, plus rewards."""
    scen = get_scenario(name)
    venv = VecEdgeSimulator(scen, num_envs, seeds=seed + np.arange(num_envs))
    rng = np.random.default_rng(seed)
    history, obs, nxt, rewards = [venv.observation()], [], [], []
    for _ in range(frames):
        before = obs_history_window(history, 3)
        mac = rng.integers(-1, scen.num_channels, (num_envs, scen.num_ues))
        act = rng.integers(-1, scen.num_bs, (num_envs, scen.num_ues))
        res = venv.step(mac, act)
        history.append(venv.observation(res["bs_load"]))
        obs.append(before)
        nxt.append(obs_history_window(history[-3:], 3))
        rewards.append(res["rewards"])
        if res["done"]:
            venv.reset(seeds=venv.frame + seed + np.arange(num_envs))
            history = [venv.observation()]
    return (np.concatenate(obs), np.concatenate(nxt),
            np.concatenate(rewards))


def _moved_close(got, want, start, tol, lr):
    """Leaf by leaf: the gap in norm against how far the reference moved
    the leaf, and no element a tenth of a learning rate apart."""
    for (path, w), g, s0 in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(start)):
        w, s0 = np.asarray(w), np.asarray(s0)
        name = jax.tree_util.keystr(path)
        moved = np.linalg.norm(w - s0)
        assert moved > 0, name
        assert np.linalg.norm(g - w) <= tol * moved, name
        assert np.abs(g - w).max() <= 0.1 * lr, name


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# -- the LSTM and the Q-net ---------------------------------------------------------

@pytest.mark.parametrize("b,t,d,h", [(1, 1, 5, 4), (7, 3, 302, 128),
                                     (32, 5, 40, 16)])
def test_lstm_matches_reference(b, t, d, h):
    params = jrec.lstm_init(jax.random.PRNGKey(d), d, h)
    lstm = trec.LSTM(d, h, device="cpu")
    with torch.no_grad():
        for name in ("wx", "wh", "b"):
            getattr(lstm, name).copy_(torch.from_numpy(
                np.array(params[name])))
    xs = np.random.default_rng(b).standard_normal((b, t, d)).astype(
        np.float32)
    hs_j, (h_j, c_j) = jrec.lstm_apply(params, jnp.asarray(xs))
    with torch.no_grad():
        hs_t, (h_t, c_t) = trec.lstm_apply(lstm, torch.from_numpy(xs))
    for got, want in ((hs_t, hs_j), (h_t, h_j), (c_t, c_j)):
        assert _rel(got.numpy(), want) <= LSTM_TOL


@pytest.mark.parametrize("name,kw", [("smoke", SMALL), ("paper-fig3", {})])
def test_qnet_matches_reference_on_converted_params(name, kw):
    cfg, jcfg = _cfg(name, **kw)
    params = jnet.qnet_init(jax.random.PRNGKey(3), cfg.obs_dim, cfg.num_ues,
                            cfg.num_actions, lstm_units=cfg.lstm_units,
                            fc=cfg.fc)
    net = qnet_from_jax(_np_tree(params), cfg, device="cpu")
    obs, _, _ = _observations(name, 16, 1)
    want = np.asarray(jnet.qnet_apply(params, jnp.asarray(obs),
                                      num_ues=cfg.num_ues,
                                      num_actions=cfg.num_actions))
    with torch.no_grad():
        got = tnet.qnet_apply(net, torch.from_numpy(obs)).numpy()
    assert got.shape == want.shape == (len(obs), cfg.num_ues,
                                       cfg.num_actions)
    assert _rel(got, want) <= Q_TOL
    # greedy acting on the device path picks what the reference picks
    mask = np.random.default_rng(2).random(want.shape) < 0.7
    mask[..., 0] = True
    np.testing.assert_array_equal(
        td3ql.greedy_act(net, torch.from_numpy(obs),
                         mask=torch.from_numpy(mask)).numpy(),
        np.asarray(jd3ql.greedy_act(params, jnp.asarray(obs),
                                    mask=jnp.asarray(mask),
                                    num_ues=cfg.num_ues,
                                    num_actions=cfg.num_actions)))


def test_qnet_round_trip_is_exact():
    cfg, _ = _cfg("paper-fig3")
    params = _np_tree(jnet.qnet_init(jax.random.PRNGKey(0), cfg.obs_dim,
                                     cfg.num_ues, cfg.num_actions))
    back = qnet_to_jax(qnet_from_jax(params, cfg, device="cpu"))
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, got), (_, want) in zip(flat_got, flat_want):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="shape"):
        qnet_from_jax(params, dataclasses.replace(cfg, obs_dim=10),
                      device="cpu")


# -- the port's own initialisation ----------------------------------------------------

def test_qnet_init_follows_the_reference_distributions():
    cfg, _ = _cfg("paper-fig3")
    net = tnet.qnet_init(cfg.obs_dim, cfg.num_ues, cfg.num_actions, seed=5,
                         device="cpu")
    ref = _np_tree(jnet.qnet_init(jax.random.PRNGKey(5), cfg.obs_dim,
                                  cfg.num_ues, cfg.num_actions))
    got = qnet_to_jax(net)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for (path, w), r in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(ref)):
        name = jax.tree_util.keystr(path)
        assert w.shape == r.shape and w.dtype == np.float32, name
        if path[-1].key == "b":
            assert not w.any(), name
            continue
        if path[0].key == "lstm":                  # xavier-uniform
            limit = np.sqrt(6.0 / sum(w.shape))
            assert np.abs(w).max() <= limit, name
            assert np.abs(w).max() > 0.99 * limit, name
            std = limit / np.sqrt(3.0)
        else:                                      # N(0, in_dim^-1)
            std = w.shape[0] ** -0.5
        n = w.size
        # five standard errors of the mean and of the standard deviation
        assert abs(w.mean()) <= 5 * std / np.sqrt(n), name
        assert abs(w.std() / std - 1) <= 5 / np.sqrt(2 * n), name
        # the reference's draw has the same moments
        assert abs(r.std() / std - 1) <= 5 / np.sqrt(2 * n), name


def test_qnet_init_is_bit_equal_from_one_seed():
    cfg, _ = _cfg("smoke", **SMALL)
    a, b, c = (tnet.qnet_init(cfg.obs_dim, cfg.num_ues, cfg.num_actions,
                              lstm_units=16, fc=(16, 8), seed=s,
                              device="cpu") for s in (4, 4, 5))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if not name.endswith(".b"):
            assert not torch.equal(pa, pc), name
    agent = td3ql.D3QLAgent(cfg, device="cpu")
    fresh = tnet.qnet_init(cfg.obs_dim, cfg.num_ues, cfg.num_actions,
                           lstm_units=16, fc=(16, 8), seed=cfg.seed,
                           device="cpu")
    for p, q, t in zip(agent.net.parameters(), fresh.parameters(),
                       agent.target_net.parameters()):
        assert torch.equal(p, q) and torch.equal(p, t)
    assert list(agent.params) == sorted(agent.params)


# -- action selection and the replay -------------------------------------------------

@pytest.mark.parametrize("shape,p_mask", [((6,), 1.0), ((4, 5, 7), 0.6),
                                          ((3, 15, 17), 0.2)])
def test_masked_argmax_equals_reference(shape, p_mask):
    rng = np.random.default_rng(len(shape))
    # few distinct values, so ties are common: both take the first index
    q = rng.integers(0, 4, size=shape).astype(np.float32)
    mask = rng.random(shape) < p_mask
    for m in (None, mask):
        got, want = td3ql.masked_argmax(q, m), jd3ql.masked_argmax(q, m)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity,pushes", [(16, [1, 3, 1, 7, 2]),
                                             (8, [5, 11, 1, 9]),
                                             (64, [8] * 5)])
def test_replay_memory_equals_reference(capacity, pushes):
    """push and push_batch (wrapping, and a batch larger than the ring,
    whose older rows are dropped before the write), then samples."""
    t = treplay.ReplayMemory(capacity, (3, 4), (2,), seed=7)
    j = jreplay.ReplayMemory(capacity, (3, 4), (2,), seed=7)
    rng = np.random.default_rng(capacity)
    for n in pushes:
        obs = rng.standard_normal((n, 3, 4)).astype(np.float32)
        nxt = rng.standard_normal((n, 3, 4)).astype(np.float32)
        act = rng.integers(0, 5, (n, 2))
        rew = rng.standard_normal(n)                  # float64, stored f32
        done = rng.random(n) < 0.3
        if n == 1:
            for mem in (t, j):
                mem.push(obs[0], act[0], rew[0], nxt[0], done[0])
        else:
            for mem in (t, j):
                mem.push_batch(obs, act, rew, nxt, done)
        assert (len(t), t.idx) == (len(j), j.idx)
        for _ in range(3):
            bt, bj = t.sample(5), j.sample(5)
            assert bt.keys() == bj.keys()
            for k in bj:
                assert bt[k].dtype == bj[k].dtype
                np.testing.assert_array_equal(bt[k], bj[k])
    for key in ("obs", "next_obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))


@pytest.fixture(scope="module")
def agents():
    """A reference agent and a port agent holding its parameters, at
    Table II widths (paper-fig3: U=15, A=17, obs_dim=302)."""
    cfg, jcfg = _cfg("paper-fig3")
    jagent = jd3ql.D3QLAgent(jcfg)
    return cfg, jagent, _np_tree(jagent.params)


def test_act_batch_equals_reference(agents):
    """Identical actions and rng streams: every env exploring (the forward
    skipped), some exploring, none, greedy; with and without masks."""
    cfg, _, params = agents
    jagent = jd3ql.D3QLAgent(jd3ql.D3QLConfig(**dataclasses.asdict(cfg)))
    tagent = td3ql.D3QLAgent(cfg, device="cpu", params=params)
    obs, _, _ = _observations("paper-fig3", 6, 2, num_envs=8)
    rng = np.random.default_rng(0)
    for epsilon in (1.0, 0.5, 0.2, 0.0):
        tagent.epsilon = jagent.epsilon = epsilon
        for step in range(4):
            o = obs[8 * step:8 * step + 8]
            mask = rng.random((8, cfg.num_ues, cfg.num_actions)) < 0.5
            mask[..., 0] = True
            for m in (None, mask):
                for greedy in (False, True):
                    got = tagent.act_batch(o, greedy=greedy, mask=m)
                    want = jagent.act_batch(o, greedy=greedy, mask=m)
                    assert got.dtype == want.dtype == np.int32
                    np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tagent.act(o[0], mask=mask[0]), jagent.act(o[0],
                                                           mask=mask[0]))
            assert tagent.rng.bit_generator.state == \
                jagent.rng.bit_generator.state


# -- the update -----------------------------------------------------------------------

def test_twenty_updates_match_reference(agents):
    """20 ``train_step``s from identical parameters on identical replays:
    each side samples the same batches from its own seeded replay."""
    cfg, _, params = agents
    jagent = jd3ql.D3QLAgent(jd3ql.D3QLConfig(**dataclasses.asdict(cfg)))
    tagent = td3ql.D3QLAgent(cfg, device="cpu", params=params)
    obs, nxt, rew = _observations("paper-fig3", 24, 3, num_envs=4)
    acts = np.random.default_rng(1).integers(
        0, cfg.num_actions, (len(obs), cfg.num_ues))
    dones = np.arange(len(obs)) % 40 == 39
    for agent in (jagent, tagent):
        agent.memory.push_batch(obs, acts, rew, nxt, dones)
    losses = []
    for _ in range(20):
        losses.append((tagent.train_step(), jagent.train_step()))
    rel = [abs(a - b) / abs(b) for a, b in losses]
    assert rel[0] <= 1e-5, rel
    assert max(rel) <= LOSS_TOL, rel
    assert losses[-1][1] < losses[0][1]         # the reference learns
    assert tagent.steps == jagent.steps == 20
    assert tagent.opt_state.step == int(jagent.opt_state.step) == 20
    _moved_close(qnet_to_jax(tagent.net), jagent.params, params, PARAM_TOL,
                 cfg.learning_rate)
    # the target net has not been synced (every 150 steps)
    for (path, want), leaf in zip(
            jax.tree_util.tree_leaves_with_path(jagent.target_params),
            jax.tree_util.tree_leaves(qnet_to_jax(tagent.target_net))):
        np.testing.assert_array_equal(leaf, np.asarray(want))


def test_update_clips_the_global_norm():
    """Rewards of 1e3 make the gradient norm far exceed ``grad_clip``: the
    clipped update and the norm it reports agree with the reference."""
    cfg, jcfg = _cfg("smoke", **SMALL)
    jagent = jd3ql.D3QLAgent(jcfg)
    start = _np_tree(jagent.params)
    tagent = td3ql.D3QLAgent(cfg, device="cpu", params=start)
    obs, nxt, _ = _observations("smoke", 4, 5, num_envs=2)
    rng = np.random.default_rng(3)
    batch = {"obs": obs, "next_obs": nxt,
             "actions": rng.integers(0, cfg.num_actions,
                                     (len(obs), cfg.num_ues)).astype(np.int32),
             "rewards": (1e3 * rng.standard_normal(len(obs))).astype(
                 np.float32),
             "dones": np.zeros(len(obs), np.float32)}
    jparams, _, jloss, jnorm = jagent._update(
        jagent.params, jagent.target_params, jagent.opt_state, batch)
    tloss, tnorm = tagent.update(tagent.device_batch(batch))
    assert float(jnorm) > 100 * cfg.grad_clip
    assert abs(float(tnorm) / float(jnorm) - 1) <= 1e-5
    assert abs(float(tloss) / float(jloss) - 1) <= 1e-5
    _moved_close(qnet_to_jax(tagent.net), jparams, start, PARAM_TOL,
                 cfg.learning_rate)


def test_target_sync_at_step_150_and_the_epsilon_floor():
    cfg, jcfg = _cfg("smoke", **SMALL)
    agent = td3ql.D3QLAgent(cfg, device="cpu")
    obs, nxt, rew = _observations("smoke", 8, 6, num_envs=2)
    acts = np.zeros((len(obs), cfg.num_ues), np.int64)
    agent.memory.push_batch(obs, acts, rew, nxt, np.zeros(len(obs), bool))

    def synced():
        return all(torch.equal(p, t) for p, t in zip(
            agent.net.parameters(), agent.target_net.parameters()))

    assert synced()
    for step in range(1, cfg.target_sync + 1):
        assert agent.train_step() is not None
        assert agent.steps == step
        assert synced() == (step == cfg.target_sync), step
    # the floor, reached by the reference's multiplicative schedule
    jagent = jd3ql.D3QLAgent(dataclasses.replace(jcfg, epsilon_decay=0.5))
    agent.cfg.epsilon_decay = 0.5
    for _ in range(25):
        agent.decay_epsilon()
        jagent.decay_epsilon()
        assert agent.epsilon == jagent.epsilon
    assert agent.epsilon == cfg.epsilon_floor
