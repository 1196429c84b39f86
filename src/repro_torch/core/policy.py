"""Unified policy/engine seam: every controller runs on every engine.

Port of ``repro.core.policy``.  A :class:`Policy` is a placement decision
rule exposed as ``act_batch(venv, obs_hist, draw)`` — numpy batched acting
against a :class:`~repro_torch.sim.vec_env.VecEdgeSimulator` (the host-loop
engine) or the serving bridge's slot view.  It emits (E, U) int actions in
the controller convention (0 = null, n+1 = BS n) and applies the variant
mask *after* any stochastic merge — the invariant the training path
enforces via ``masked_argmax``.

The shared batched rollout (:func:`evaluate_batched`) reproduces the legacy
scalar ``evaluate()`` loop exactly: at any ``num_envs`` the stacked envs
replay the scalar per-episode streams (seeds ``seed0 + episode``), obs
history padding matches ``LearnGDMController._obs_hist``, and episode
totals accumulate in the scalar frame order.  The reference's second face
of a policy, ``fused_spec`` for the jitted evaluation scan, and
``evaluate_fused`` / ``make_eval_draws`` come with the fused engine
(ROADMAP Queue 1, item 8): ``engine="fused"`` raises until then.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.learn_gdm import (EpisodeStats, obs_history_window,
                                        summarize, variant_action_mask_vec)
from repro_torch.core.mac import vec_greedy_mac, vec_random_access
from repro_torch.rl.d3ql import masked_argmax
from repro_torch.sim.env import IDLE, EdgeSimulator, SimConfig
from repro_torch.sim.vec_env import VecEdgeSimulator


class Policy:
    """Base policy: one decision rule, runnable on every engine.

    Subclasses set ``name`` and override :meth:`act_batch`.
    ``needs_obs``/``history`` tell the rollouts whether (and how deep) an
    observation history must be maintained; ``needs_draws`` requests a
    per-frame (E, U, A) uniform block (stochastic policies take their
    randomness through it).
    """

    name: str = "policy"
    needs_obs: bool = False
    history: int = 1
    needs_draws: bool = False

    def act_batch(self, venv: VecEdgeSimulator,
                  obs_hist: Optional[np.ndarray],
                  draw: Optional[np.ndarray] = None) -> np.ndarray:
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


class GreedyPoAPolicy(Policy):
    """GR baseline: every block executes at the UE's current PoA; chains
    always run to full length (never the null action while active)."""

    name = "gr"

    def act_batch(self, venv, obs_hist, draw=None):
        return np.where(venv.chain_state != IDLE, venv.poa + 1, 0)


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


def evaluate_policy(policy: Policy, env: EdgeSimulator, episodes: int, *,
                    engine: str = "vectorized",
                    num_envs: Optional[int] = None, seed0: int = 9_000,
                    seed: int = 0, mac_scheme: str = "greedy",
                    scalar_episode=None) -> Dict[str, float]:
    """The one engine dispatcher behind every controller's ``evaluate``.

    ``scalar_episode(seed) -> EpisodeStats`` is the controller's legacy
    reference loop, used when ``engine="scalar"``; "vectorized" routes
    through the shared batched rollout above.  "fused" raises: the fused
    evaluation scan comes with the fused engine (ROADMAP Queue 1, item 8).
    ``seed`` seeds only that engine's streams, so nothing reads it yet.
    """
    if engine == "scalar":
        assert scalar_episode is not None, \
            "engine='scalar' needs the controller's reference episode loop"
        return summarize([scalar_episode(seed0 + ep)
                          for ep in range(episodes)])
    if engine == "fused":
        raise NotImplementedError(
            "engine='fused' needs the fused device engine, which the port "
            "has not built yet (ROADMAP Queue 1, item 8); use "
            "engine='vectorized'")
    assert engine == "vectorized", f"unknown eval engine {engine!r}"
    return evaluate_batched(policy, env, episodes, seed0=seed0,
                            num_envs=num_envs, mac_scheme=mac_scheme)
