"""Unified policy/engine seam: every controller runs on every engine.

Port of ``repro.core.policy``.  A :class:`Policy` is a placement decision
rule exposed twice:

* ``act_batch(venv, obs_hist, draw)`` — numpy batched acting against a
  :class:`~repro_torch.sim.vec_env.VecEdgeSimulator` (the host-loop
  engine) or the serving bridge's slot view;
* ``fused_spec(cfg)`` — a ``(params, act_fn)`` pair where
  ``act_fn(params, state, obs_hist, draw)`` acts on device tensors, for the
  evaluation round on the tensor env
  (:func:`repro_torch.sim.torch_env.build_eval_round`).

Both emit (E, U) int actions in the controller convention (0 = null, n+1 =
BS n) and apply the variant mask *after* any stochastic merge — the
invariant the training paths enforce via ``masked_argmax`` /
``fused_act``.

The shared batched rollout (:func:`evaluate_batched`) reproduces the legacy
scalar ``evaluate()`` loop exactly: at any ``num_envs`` the stacked envs
replay the scalar per-episode streams (seeds ``seed0 + episode``), obs
history padding matches ``LearnGDMController._obs_hist``, and episode
totals accumulate in the scalar frame order.  :func:`evaluate_fused` runs
the same policy through one device round per episode batch; its episode
randomness comes from a generator, and its logic is pinned to the
reference's eval round under the same draws (``tests/test_torch_fused.
py``).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.learn_gdm import (EpisodeStats, obs_history_window,
                                        summarize, variant_action_mask_vec)
from repro_torch.core.mac import vec_greedy_mac, vec_random_access
from repro_torch.distributed.sharding import mesh_devices
from repro_torch.rl.d3ql import greedy_act, masked_argmax
from repro_torch.sim import torch_env
from repro_torch.sim.env import IDLE, EdgeSimulator, SimConfig
from repro_torch.sim.vec_env import VecEdgeSimulator


class Policy:
    """Base policy: one decision rule, runnable on every engine.

    Subclasses set ``name`` and override :meth:`act_batch` +
    :meth:`fused_spec`.  ``needs_obs``/``history`` tell the rollouts
    whether (and how deep) an observation history must be maintained;
    ``needs_draws`` requests a per-frame (E, U, A) uniform block
    (stochastic policies take their randomness through it).

    :meth:`fused_spec` returns ``(params, act_fn)``: ``act_fn`` reads
    nothing but its arguments, and anything agent-derived goes through
    ``params``.
    """

    name: str = "policy"
    needs_obs: bool = False
    history: int = 1
    needs_draws: bool = False

    def act_batch(self, venv: VecEdgeSimulator,
                  obs_hist: Optional[np.ndarray],
                  draw: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError

    def fused_spec(self, cfg: SimConfig) -> Tuple:
        raise NotImplementedError


class LearnedPolicy(Policy):
    """Greedy-eval D3QL placement under the variant's action mask
    (learn-gdm / mp / fp)."""

    needs_obs = True

    def __init__(self, agent, variant: str = "learn-gdm"):
        assert variant in ("learn-gdm", "mp", "fp")
        self.agent = agent
        self.variant = variant
        self.name = variant
        self.history = agent.cfg.history

    def act_batch(self, venv, obs_hist, draw=None):
        mask = variant_action_mask_vec(venv, self.variant)
        return self.agent.act_batch(obs_hist, greedy=True, mask=mask)

    def fused_spec(self, cfg):
        variant = self.variant

        def act_fn(net, state, obs_hist, draw):
            mask = torch_env.action_mask(cfg, state, variant)
            return greedy_act(net, obs_hist, mask=mask)

        return self.agent.net, act_fn


class GreedyPoAPolicy(Policy):
    """GR baseline: every block executes at the UE's current PoA; chains
    always run to full length (never the null action while active)."""

    name = "gr"

    def act_batch(self, venv, obs_hist, draw=None):
        return np.where(venv.chain_state != IDLE, venv.poa + 1, 0)

    def fused_spec(self, cfg):
        def act_fn(params, state, obs_hist, draw):
            return torch.where(state.chain_state != IDLE, state.poa + 1,
                               0).to(torch.int32)

        return (), act_fn


class RandomPolicy(Policy):
    """Uniform over the variant's allowed actions (exploration floor
    baseline).  Randomness comes from the rollout's draw block, so any two
    engines given identical draws pick identical actions."""

    needs_draws = True

    def __init__(self, variant: str = "learn-gdm", seed: int = 0):
        self.variant = variant
        self.name = f"random-{variant}"
        self.seed = seed
        # fallback stream for direct act_batch calls; the evaluation
        # rollouts inject per-episode draw stacks instead (deterministic
        # and num_envs-independent)
        self.rng = np.random.default_rng(seed)

    def act_batch(self, venv, obs_hist, draw=None):
        cfg = venv.cfg
        if draw is None:
            draw = self.rng.random(
                (venv.num_envs, cfg.num_ues, cfg.num_bs + 1))
        mask = variant_action_mask_vec(venv, self.variant)
        return masked_argmax(draw, mask)

    def fused_spec(self, cfg):
        variant = self.variant

        def act_fn(params, state, obs_hist, draw):
            mask = torch_env.action_mask(cfg, state, variant)
            return torch.where(mask, draw, -torch.inf).argmax(
                dim=-1).to(torch.int32)

        return (), act_fn


# -- shared batched rollout (numpy vectorized engine) --------------------------

def _obs_hist(history: deque, h: int) -> np.ndarray:
    """(E, H, obs_dim) window — the controller's shared eq. (7) rule."""
    return obs_history_window(history, h)


def rollout_round(policy: Policy, venv: VecEdgeSimulator, *,
                  mac_scheme: str = "greedy",
                  arrival_draws: Optional[np.ndarray] = None,
                  waypoint_draws: Optional[np.ndarray] = None,
                  policy_draws: Optional[np.ndarray] = None,
                  ) -> List[EpisodeStats]:
    """One evaluation round: one episode per stacked env, any policy.

    ``venv`` must be freshly reset (episode counters zero).  The optional
    (T, ...) draw stacks replace the native per-env streams — the injection
    hooks an engine-equivalence harness drives both engines with.
    Returns one :class:`EpisodeStats` per env.
    """
    e = venv.num_envs
    history: deque = deque(maxlen=policy.history)
    if policy.needs_obs:
        history.append(venv.observation())
    totals = {k: np.zeros(e) for k in ("reward", "quality_gain",
                                       "exec_cost", "trans_cost")}
    done, t = False, 0
    while not done:
        obs_hist = _obs_hist(history, policy.history) \
            if policy.needs_obs else None
        mac = vec_greedy_mac(venv) if mac_scheme == "greedy" \
            else vec_random_access(venv)
        draw = None if policy_draws is None else policy_draws[t]
        actions = policy.act_batch(venv, obs_hist, draw)
        res = venv.step(
            mac, actions.astype(int) - 1,
            arrival_draws=None if arrival_draws is None else arrival_draws[t],
            waypoint_redraw=None if waypoint_draws is None
            else waypoint_draws[t])
        done = res["done"]
        if policy.needs_obs:
            history.append(venv.observation(res["bs_load"]))
        totals["reward"] += res["rewards"]
        for k in ("quality_gain", "exec_cost", "trans_cost"):
            totals[k] += res[k]
        t += 1
    return [EpisodeStats(
        reward=float(totals["reward"][i]),
        quality_gain=float(totals["quality_gain"][i]),
        exec_cost=float(totals["exec_cost"][i]),
        trans_cost=float(totals["trans_cost"][i]),
        delivered_quality=float(venv.total_delivered[i]),
        num_delivered=int(venv.num_delivered[i]),
        collisions=int(venv.num_collisions[i]),
        losses=[]) for i in range(e)]


def evaluate_batched(policy: Policy, env_or_cfg, episodes: int, *,
                     num_envs: Optional[int] = None, seed0: int = 9_000,
                     mac_scheme: str = "greedy",
                     venv: Optional[VecEdgeSimulator] = None,
                     ) -> Dict[str, float]:
    """Evaluate ``policy`` over ``episodes`` on the vectorized engine.

    Episode seeds tile ``seed0 + round * E + e``, so episode ``ep`` runs
    under seed ``seed0 + ep`` regardless of ``num_envs`` — per-episode
    results are numerically identical to the legacy scalar loop (each
    stacked env replays the scalar stream bit-exactly).  The stacked envs
    share the static world of ``env_or_cfg`` (an :class:`EdgeSimulator` or
    a :class:`SimConfig`): evaluation measures on the world that was
    trained on.
    """
    cfg = env_or_cfg.cfg if isinstance(env_or_cfg, EdgeSimulator) \
        else env_or_cfg
    if venv is None:
        e = num_envs or min(max(episodes, 1), 8)
        venv = VecEdgeSimulator(cfg, e, seeds=np.full(e, cfg.seed))
    e = venv.num_envs
    stats: List[EpisodeStats] = []
    for rd in range(-(-episodes // e)):
        ep_seeds = seed0 + rd * e + np.arange(e)
        venv.reset(seeds=ep_seeds)
        pol_draws = _policy_draw_stack(policy, cfg, ep_seeds) \
            if policy.needs_draws else None
        stats.extend(rollout_round(policy, venv, mac_scheme=mac_scheme,
                                   policy_draws=pol_draws))
    return summarize(stats[:episodes])


def _policy_draw_stack(policy: Policy, cfg: SimConfig,
                       ep_seeds) -> np.ndarray:
    """(T, E, U, A) uniforms for a ``needs_draws`` policy, one stream per
    episode keyed by (policy seed, episode seed) — results are identical at
    any ``num_envs`` and reproducible across calls, matching the rest of
    the batched-eval determinism contract."""
    t, u, a = cfg.horizon, cfg.num_ues, cfg.num_bs + 1
    seed = getattr(policy, "seed", 0)
    return np.stack([np.random.default_rng((seed, int(s))).random((t, u, a))
                     for s in ep_seeds], axis=1)


# -- fused evaluation (the tensor env on the device) -----------------------------

def make_eval_draws(cfg: SimConfig, num_envs: int,
                    generator: torch.Generator, *,
                    fdtype: torch.dtype = torch.float32,
                    mac_random: bool = False,
                    policy_draws: bool = False) -> Dict[str, torch.Tensor]:
    """A round's randomness for the eval round, on the generator's device:
    ``arrival`` (T, E, U) and ``waypoint`` (T, E, U, 2) in [0, side) in
    ``fdtype``, and in float32 ``mac_attempt`` / ``mac_channel`` (T, E, U)
    for random access and ``policy`` (T, E, U, A) for a ``needs_draws``
    policy — the reference's keys, shapes and dtypes."""
    t, e, u = cfg.horizon, num_envs, cfg.num_ues
    dev = generator.device

    def rand(shape, dtype=torch.float32):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=dev)

    draws = {"arrival": rand((t, e, u), fdtype),
             "waypoint": rand((t, e, u, 2), fdtype) * cfg.side}
    if mac_random:
        draws["mac_attempt"] = rand((t, e, u))
        draws["mac_channel"] = rand((t, e, u))
    if policy_draws:
        draws["policy"] = rand((t, e, u, cfg.num_bs + 1))
    return draws


def evaluate_fused(policy: Policy, env: EdgeSimulator, episodes: int, *,
                   num_envs: Optional[int] = None, seed: int = 0,
                   mac_scheme: str = "greedy", mesh=None,
                   mesh_axis: str = "env", device=None) -> Dict[str, float]:
    """Evaluate ``policy`` through one device round per ``num_envs``
    episodes on the tensor env, with nothing read back inside a round.

    The stacked envs share ``env``'s static world; the round's reset and
    draws come from a generator seeded by (``seed``, round), so per-episode
    trajectories are not numpy-matched.  A learned policy runs on its
    agent's device; the others on ``device``, which defaults to the mesh's
    first device under a mesh and to the card without one.

    ``mesh`` (e.g. ``repro_torch.launch.mesh.make_env_mesh``) splits the
    round over the env dim (:func:`repro_torch.sim.torch_env.
    build_eval_round`).  ``state0`` and the draws are made whole either
    way, so the sharded round consumes the same inputs as the unsharded one
    and the results are identical; ``num_envs`` must divide evenly.
    """
    cfg = env.cfg
    e = num_envs or min(max(episodes, 1), 8)
    agent = getattr(policy, "agent", None)
    if agent is not None:
        device = agent.device
    elif device is None and mesh is not None:
        device = mesh_devices(mesh)[0]
    else:
        device = resolve_device(device)
    world = torch_env.world_from_sim(env, e, device=device)
    params, act_fn = policy.fused_spec(cfg)
    round_fn = torch_env.build_eval_round(
        cfg, act_fn, mac_scheme=mac_scheme, history=policy.history,
        needs_obs=policy.needs_obs, mesh=mesh, axis=mesh_axis)
    stats: List[EpisodeStats] = []
    for rd in range(-(-episodes // e)):
        gen = torch_env.round_generator(seed, rd, device)
        state0 = torch_env.reset_env(cfg, world, generator=gen)
        draws = make_eval_draws(cfg, e, gen, fdtype=world.qbar.dtype,
                                mac_random=(mac_scheme == "random"),
                                policy_draws=policy.needs_draws)
        _, out = round_fn(params, world, state0, draws)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        stats.extend(EpisodeStats(
            reward=float(out["reward"][i]),
            quality_gain=float(out["quality_gain"][i]),
            exec_cost=float(out["exec_cost"][i]),
            trans_cost=float(out["trans_cost"][i]),
            delivered_quality=float(out["delivered_quality"][i]),
            num_delivered=int(out["num_delivered"][i]),
            collisions=int(out["collisions"][i]),
            losses=[]) for i in range(e))
    return summarize(stats[:episodes])


def evaluate_policy(policy: Policy, env: EdgeSimulator, episodes: int, *,
                    engine: str = "vectorized",
                    num_envs: Optional[int] = None, seed0: int = 9_000,
                    seed: int = 0, mac_scheme: str = "greedy",
                    mesh=None, scalar_episode=None,
                    device=None) -> Dict[str, float]:
    """The one engine dispatcher behind every controller's ``evaluate``.

    ``scalar_episode(seed) -> EpisodeStats`` is the controller's legacy
    reference loop, used when ``engine="scalar"``; "vectorized" and "fused"
    route through the shared batched rollouts above (``seed``, ``mesh`` and
    ``device`` are the fused engine's).
    """
    if engine == "scalar":
        assert scalar_episode is not None, \
            "engine='scalar' needs the controller's reference episode loop"
        return summarize([scalar_episode(seed0 + ep)
                          for ep in range(episodes)])
    if engine == "fused":
        return evaluate_fused(policy, env, episodes, num_envs=num_envs,
                              seed=seed, mac_scheme=mac_scheme, mesh=mesh,
                              device=device)
    assert engine == "vectorized", f"unknown eval engine {engine!r}"
    return evaluate_batched(policy, env, episodes, seed0=seed0,
                            num_envs=num_envs, mac_scheme=mac_scheme)
