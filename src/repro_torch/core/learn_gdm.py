"""LEARN-GDM (Algorithm 1) and its D3QL-based variants MP / FP.

One controller class drives all three methods; the difference is purely the
*action mask* applied to the per-UE argmax:

  * LEARN-GDM  — unrestricted: any node each block (distributed chains) and
                 the null action any time (adaptive chain length).
  * MP         — monolithic: once a chain starts on node n, the mask allows
                 only {null, n} (single node per inference, variable length).
  * FP         — fixed chain: the null action is masked out while
                 0 < k < B (no early exit; nodes may still vary).

The controller owns the greedy MAC, the observation history (eq. 7), reward
bookkeeping (eq. 8 — computed by the env), the replay/train plumbing
(Algorithm 1 steps 23–28), and optional trace recording for the C1–C9
checkers.

Port of ``repro.core.learn_gdm``.  In ``train`` and ``train_vectorized``
the simulator, masks, MAC and replay stay numpy, as in the reference
(float64 where it is), and only the agent's Q-nets and updates run on
``device``, the card unless the caller asks for another.
``train_fused`` runs the whole round on that device instead: the tensor
env (:mod:`repro_torch.sim.torch_env`), the device replay, the acting and
the update, with nothing read back inside a round; with a mesh, the env
math of each env slice runs on its own device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import TraceRecorder
from repro_torch.core.mac import (greedy_mac, random_access, vec_greedy_mac,
                                  vec_random_access)
from repro_torch.distributed.sharding import P, gather, split
from repro_torch.optim import OptState
from repro_torch.rl.d3ql import D3QLAgent, D3QLConfig, d3ql_update, fused_act
from repro_torch.rl.networks import QNet
from repro_torch.rl.replay import DeviceReplay, DeviceReplayState
from repro_torch.sim import torch_env
from repro_torch.sim.env import IDLE, EdgeSimulator
from repro_torch.sim.vec_env import VecEdgeSimulator


def variant_action_mask(env: EdgeSimulator, variant: str) -> np.ndarray:
    """(U, A) bool mask for one scalar env — the variant semantics in one
    place (see module docstring); shared by the controller and the scalar
    policy path."""
    cfg = env.cfg
    u, a = cfg.num_ues, cfg.num_bs + 1
    mask = np.ones((u, a), dtype=bool)
    if variant == "mp":
        started = env.blocks_done > 0
        for i in np.where(started)[0]:
            mask[i, :] = False
            mask[i, 0] = True                       # null (stop & deliver)
            mask[i, env.cur_node[i] + 1] = True     # stay on the same node
    elif variant == "fp":
        mid_chain = (env.blocks_done > 0) & (env.blocks_done < cfg.max_blocks)
        mask[mid_chain, 0] = False                  # no early exit
    return mask


def variant_action_mask_vec(venv: VecEdgeSimulator, variant: str) -> np.ndarray:
    """Batched action masks, (E, U, A) — same semantics as
    :func:`variant_action_mask` per env, no per-UE loops."""
    cfg = venv.cfg
    e, u, a = venv.num_envs, cfg.num_ues, cfg.num_bs + 1
    mask = np.ones((e, u, a), dtype=bool)
    if variant == "mp":
        started = venv.blocks_done.ravel() > 0
        rows = mask.reshape(e * u, a)
        rows[started] = False
        rows[started, 0] = True                     # null (stop & deliver)
        rows[started, venv.cur_node.ravel()[started] + 1] = True
    elif variant == "fp":
        mid_chain = (venv.blocks_done > 0) & \
            (venv.blocks_done < cfg.max_blocks)
        mask[..., 0][mid_chain] = False             # no early exit
    # duck-typed fault hook: a view carrying (E, N) node liveness (the
    # serving bridge's _SlotView under injected failures) masks placements
    # onto dead nodes for every variant; sim envs don't have the attribute
    up = getattr(venv, "node_up", None)
    if up is not None:
        mask[..., 1:] &= np.asarray(up, dtype=bool)[:, None, :]
    return mask


def obs_history_window(history, h: int, pad=None) -> np.ndarray:
    """Eq. (7) observation window: the last ``h`` frames stacked along a new
    axis -2, padded by repeating the oldest frame (or ``pad`` when the
    history is empty).  Works for scalar ((obs,) frames → (H, obs)) and
    batched ((E, obs) frames → (E, H, obs)) histories alike — the ONE
    windowing rule shared by the training loops and the evaluation rollouts
    (the batched-eval-equals-scalar-eval pin depends on it)."""
    pads = [history[0]] * (h - len(history)) if history else [pad] * h
    items = list(pads) + list(history)
    return np.stack(items[-h:], axis=-2)


@dataclasses.dataclass
class EpisodeStats:
    reward: float
    quality_gain: float
    exec_cost: float
    trans_cost: float
    delivered_quality: float
    num_delivered: int
    collisions: int
    losses: List[float]


class LearnGDMController:
    """Algorithm 1 controller.  ``variant`` in {"learn-gdm", "mp", "fp"}."""

    def __init__(self, env: EdgeSimulator, *, variant: str = "learn-gdm",
                 agent: Optional[D3QLAgent] = None, seed: int = 0,
                 mac_scheme: str = "greedy", device=None):
        assert variant in ("learn-gdm", "mp", "fp")
        self.env = env
        self.variant = variant
        self.mac_scheme = mac_scheme
        cfg = env.cfg
        self.agent = agent or D3QLAgent(D3QLConfig(
            obs_dim=env.obs_dim,
            num_ues=cfg.num_ues,
            num_actions=cfg.num_bs + 1,
            seed=seed), device=device)
        self.history: deque = deque(maxlen=self.agent.cfg.history)

    # -- action masking ------------------------------------------------------

    def action_mask(self) -> np.ndarray:
        return variant_action_mask(self.env, self.variant)

    def action_mask_vec(self, venv: VecEdgeSimulator) -> np.ndarray:
        return variant_action_mask_vec(venv, self.variant)

    # -- episode loops ---------------------------------------------------------

    def _obs_hist(self) -> np.ndarray:
        return obs_history_window(self.history, self.agent.cfg.history,
                                  pad=np.zeros(self.env.obs_dim, np.float32))

    def run_episode(self, *, train: bool = True, seed: Optional[int] = None,
                    trace: Optional[TraceRecorder] = None) -> EpisodeStats:
        env, agent = self.env, self.agent
        env.reset(seed=seed)
        self.history.clear()
        self.history.append(env.observation())
        total = dict(reward=0.0, quality_gain=0.0, exec_cost=0.0, trans_cost=0.0)
        losses: List[float] = []
        done = False
        while not done:
            obs_hist = self._obs_hist()
            mac = greedy_mac(env) if self.mac_scheme == "greedy" \
                else random_access(env)
            blocks_before = env.blocks_done.copy()
            startable = env.chain_state != IDLE
            poa_before = env.poa.copy()
            actions = agent.act(obs_hist, greedy=not train,
                                mask=self.action_mask())
            placement = actions.astype(int) - 1          # 0 -> null (-1)
            res = env.step(mac, placement)
            done = res["done"]
            self.history.append(env.observation(res["bs_load"]))
            if train:
                agent.remember(obs_hist, actions, res["reward"],
                               self._obs_hist(), done)
                loss = agent.train_step()
                if loss is not None:
                    losses.append(loss)
                agent.decay_epsilon()
            if trace is not None:
                executed = env.blocks_done > blocks_before
                trace.add(frame=env.frame - 1, poa=poa_before, mac=mac,
                          uploaded=res["uploaded"], placement=placement,
                          executed=executed,
                          exec_node=np.where(executed, env.cur_node, -1),
                          blocks_done=env.blocks_done.copy(),
                          bs_load=res["bs_load"],
                          chain_startable=startable)
            for k in total:
                total[k] += res[k] if k != "reward" else res["reward"]
        return EpisodeStats(
            reward=total["reward"], quality_gain=total["quality_gain"],
            exec_cost=total["exec_cost"], trans_cost=total["trans_cost"],
            delivered_quality=env.total_delivered,
            num_delivered=env.num_delivered,
            collisions=env.num_collisions, losses=losses)

    def train(self, episodes: int, *, log_every: int = 0) -> Dict[str, list]:
        hist = {"reward": [], "loss": [], "delivered": []}
        for ep in range(episodes):
            stats = self.run_episode(train=True, seed=1_000 + ep)
            hist["reward"].append(stats.reward)
            hist["loss"].append(float(np.mean(stats.losses)) if stats.losses else np.nan)
            hist["delivered"].append(stats.delivered_quality)
            if log_every and (ep + 1) % log_every == 0:
                recent = np.mean(hist["reward"][-log_every:])
                print(f"  ep {ep + 1:5d}  reward(avg {log_every})={recent:8.3f}  "
                      f"eps={self.agent.epsilon:.3f}")
        return hist

    # -- vectorized training ---------------------------------------------------

    def train_frames(self, episodes: int, *, num_envs: int = 1) -> int:
        """Frames (= epsilon-decay / train steps) a :meth:`train` (E=1),
        :meth:`train_vectorized` or :meth:`train_fused` run will execute —
        callers calibrating the epsilon schedule should use this instead of
        re-deriving round math."""
        rounds = -(-episodes // max(num_envs, 1)) if num_envs > 1 else episodes
        return rounds * self.env.cfg.horizon

    def calibrate_epsilon(self, episodes: int, *, num_envs: int = 1,
                          final: float = 1e-2) -> float:
        """Set the agent's multiplicative epsilon schedule so exploration
        anneals to ``final`` over exactly the frames a run of ``episodes``
        at ``num_envs`` will execute (:meth:`train_frames`) — the one
        sanctioned way to scale the paper's 0.99995/200k-frame schedule to
        a shorter run (callers must not re-derive the round math)."""
        frames = self.train_frames(episodes, num_envs=num_envs)
        self.agent.cfg.epsilon_decay = float(
            np.exp(np.log(final) / max(frames, 1)))
        return self.agent.cfg.epsilon_decay

    def _obs_hist_vec(self, history: deque, num_envs: int) -> np.ndarray:
        return obs_history_window(                       # (E, H, obs_dim)
            history, self.agent.cfg.history,
            pad=np.zeros((num_envs, self.env.obs_dim), np.float32))

    def train_vectorized(self, episodes: int, *, num_envs: int = 8,
                         log_every: int = 0, seed0: int = 1_000,
                         venv: Optional[VecEdgeSimulator] = None) -> Dict[str, list]:
        """Algorithm 1 over E stacked envs: one batched act, one env step and
        one (amortized) train step per frame collect E transitions.

        Episode seeds tile ``seed0 + round * E + e`` so E=1 matches
        :meth:`train`'s per-episode seeding.  All stacked envs share
        ``self.env``'s static world (same ``cfg.seed`` draw) — like
        :meth:`train`, episodes differ only in mobility/request streams, and
        :meth:`evaluate` measures on the world that was trained on.  Returns
        the same history dict as :meth:`train` with one entry per episode
        (``rounds * num_envs``, trimmed to ``episodes``).
        """
        agent = self.agent
        venv = venv or VecEdgeSimulator(
            self.env.cfg, num_envs,
            seeds=np.full(num_envs, self.env.cfg.seed))
        num_envs = venv.num_envs
        rounds = -(-episodes // num_envs)
        hist = {"reward": [], "loss": [], "delivered": []}
        for rd in range(rounds):
            venv.reset(seeds=seed0 + rd * num_envs + np.arange(num_envs))
            history: deque = deque(maxlen=agent.cfg.history)
            history.append(venv.observation())
            ep_reward = np.zeros(num_envs)
            losses: List[float] = []
            done = False
            while not done:
                obs_hist = self._obs_hist_vec(history, num_envs)
                mac = vec_greedy_mac(venv) if self.mac_scheme == "greedy" \
                    else vec_random_access(venv)
                actions = agent.act_batch(obs_hist, greedy=False,
                                          mask=self.action_mask_vec(venv))
                res = venv.step(mac, actions.astype(int) - 1)
                done = res["done"]
                history.append(venv.observation(res["bs_load"]))
                agent.memory.push_batch(
                    obs_hist, actions, res["rewards"],
                    self._obs_hist_vec(history, num_envs),
                    np.full(num_envs, done))
                loss = agent.train_step()
                if loss is not None:
                    losses.append(loss)
                agent.decay_epsilon()
                ep_reward += res["rewards"]
            mean_loss = float(np.mean(losses)) if losses else np.nan
            hist["reward"].extend(ep_reward.tolist())
            hist["loss"].extend([mean_loss] * num_envs)
            hist["delivered"].extend(venv.total_delivered.tolist())
            if log_every and (rd + 1) % log_every == 0:
                recent = np.mean(hist["reward"][-num_envs * log_every:])
                print(f"  round {rd + 1:5d} ({len(hist['reward'])} eps)  "
                      f"reward(avg)={recent:8.3f}  eps={agent.epsilon:.3f}")
        return {k: v[:episodes] for k, v in hist.items()}

    # -- fused (device-resident) training --------------------------------------

    def _build_fused_round(self, world: torch_env.TorchWorld, num_envs: int,
                           replay: DeviceReplay, mesh=None,
                           axis: str = "env") -> "FusedRound":
        """One training round on the device: reset, then the episode's
        frames of act → env step → replay push → D3QL update (see
        :class:`FusedRound`); ``mesh`` splits the env math over its
        devices."""
        return FusedRound(self, world, num_envs, replay, mesh=mesh, axis=axis)

    def train_fused(self, episodes: int, *, num_envs: int = 8,
                    log_every: int = 0, seed: int = 0,
                    mesh=None, mesh_axis: str = "env") -> Dict[str, list]:
        """Algorithm 1 with each round on the agent's device: the tensor env
        reset, then every frame's epsilon-greedy act, env step, device
        replay push and D3QL update, with no read back inside the round;
        the host pulls only the round's stats (E rewards and deliveries, T
        losses).

        Like :meth:`train_vectorized`, the stacked envs share
        ``self.env``'s static world; episode randomness comes from a
        ``torch.Generator`` on the device seeded by (``seed``, round), so
        trajectories are not numpy-matched — the engine's logic is pinned
        to the numpy one under injected draws
        (``tests/test_torch_fused.py``).  The device replay is internal to
        this method (``agent.memory`` is not filled); the agent's
        parameters, target, optimizer state, epsilon and steps are written
        back, so :meth:`evaluate` and further training see the progress.
        Returns the same history dict as :meth:`train` (one entry per
        episode, trimmed to ``episodes``).

        ``mesh`` (e.g. ``repro_torch.launch.mesh.make_env_mesh``) splits the
        round's env math over the env dim, EXACTLY equal to the unsharded
        round under the same seed (see :class:`FusedRound`); ``num_envs``
        must be divisible by the mesh size.
        """
        agent = self.agent
        acfg = agent.cfg
        world = torch_env.world_from_sim(self.env, num_envs,
                                         device=agent.device)
        replay = DeviceReplay(acfg.memory_capacity,
                              obs_shape=(acfg.history, self.env.obs_dim),
                              action_shape=(acfg.num_ues,),
                              device=agent.device)
        fused = self._build_fused_round(world, num_envs, replay, mesh,
                                        mesh_axis)
        carry = fused.init_carry()
        rounds = -(-episodes // num_envs)
        hist = {"reward": [], "loss": [], "delivered": []}
        for rd in range(rounds):
            gen = torch_env.round_generator(seed, rd, agent.device)
            carry, (ep_reward, losses, delivered) = fused.run_round(
                carry, *fused.draw_round(gen))
            losses = losses.cpu().numpy()
            valid = losses[~np.isnan(losses)]
            mean_loss = float(valid.mean()) if len(valid) else np.nan
            hist["reward"].extend(ep_reward.cpu().tolist())
            hist["loss"].extend([mean_loss] * num_envs)
            hist["delivered"].extend(delivered.cpu().tolist())
            if log_every and (rd + 1) % log_every == 0:
                recent = np.mean(hist["reward"][-num_envs * log_every:])
                print(f"  round {rd + 1:5d} ({len(hist['reward'])} eps)  "
                      f"reward(avg)={recent:8.3f}  eps={carry.epsilon:.3f}")
        fused.write_back(carry)
        return {k: v[:episodes] for k, v in hist.items()}

    def evaluate(self, episodes: int, *, seed0: int = 9_000,
                 engine: str = "vectorized",
                 num_envs: Optional[int] = None,
                 seed: int = 0, mesh=None) -> Dict[str, float]:
        """Greedy-policy evaluation through the unified policy/engine seam.

        engine: "vectorized" (default — batched numpy rollout; per-episode
        results are numerically identical to the legacy scalar loop for any
        ``num_envs``, since each stacked env replays the scalar stream),
        "scalar" (the original ``run_episode`` loop, kept as the reference
        implementation) or "fused" (the eval round on the tensor env, on
        the agent's device, split over ``mesh`` when one is given; episode
        randomness from a generator seeded by ``seed``).
        """
        # policy imports learn_gdm for EpisodeStats — import at call time
        from repro_torch.core.policy import LearnedPolicy, evaluate_policy
        return evaluate_policy(
            LearnedPolicy(self.agent, self.variant), self.env, episodes,
            engine=engine, num_envs=num_envs, seed0=seed0, seed=seed,
            mac_scheme=self.mac_scheme, mesh=mesh,
            scalar_episode=lambda s: self.run_episode(train=False, seed=s))


def summarize(stats: List[EpisodeStats]) -> Dict[str, float]:
    return {
        "reward": float(np.mean([s.reward for s in stats])),
        "quality_gain": float(np.mean([s.quality_gain for s in stats])),
        "delivered_quality": float(np.mean([s.delivered_quality for s in stats])),
        "num_delivered": float(np.mean([s.num_delivered for s in stats])),
        "exec_cost": float(np.mean([s.exec_cost for s in stats])),
        "trans_cost": float(np.mean([s.trans_cost for s in stats])),
        "collisions": float(np.mean([s.collisions for s in stats])),
    }


# -- the fused engine's round ----------------------------------------------------

@dataclasses.dataclass
class FusedCarry:
    """What crosses the rounds of the fused engine: the agent's online and
    target nets with the online net's parameters by name, the optimizer
    state and the device replay on the device; epsilon (float32-valued)
    and the update count on the host, where the count of pushes fixes
    them."""
    net: QNet
    target_net: QNet
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    replay: DeviceReplayState
    epsilon: float
    steps: int


def _decay_epsilon(epsilon: float, cfg: D3QLConfig) -> float:
    """``max(floor, epsilon * decay)`` in float32, the reference's carried
    arithmetic (a float64 epsilon would flip ``draw < epsilon`` at the
    boundary)."""
    return float(max(np.float32(cfg.epsilon_floor),
                     np.float32(epsilon) * np.float32(cfg.epsilon_decay)))


class FusedRound:
    """One training round of the fused engine, split in two.

    :meth:`draw_round` draws the round's randomness from a generator: the
    reset draws ``pos``/``dest`` ((E, U, 2) in [0, side)) and ``req`` ((E,
    U)) in the world's float dtype, and the frame draws ``explore`` (T, E),
    ``q_rand`` (T, E, U, A), ``arrival`` (T, E, U), ``waypoint`` (T, E, U,
    2) in [0, side), ``sample`` (T, batch), ``mac_attempt`` and
    ``mac_channel`` (T, E, U), all float32 — the reference's keys, shapes
    and dtypes.  :meth:`run_round` is a function of its arguments alone:
    ``(carry, reset_draws, draws) -> (carry, (episode rewards (E,), losses
    (T,), delivered quality (E,)))``, the stats left on the device.  The
    carry is donated: its nets, optimizer moments and replay are updated in
    place.  Whether a frame trains, when the target syncs and each frame's
    epsilon follow from the count of pushes, on the host, so nothing is
    read back inside a round.

    With ``mesh`` (1-D, axis ``axis``) the env math runs per shard, and the
    round stays EXACTLY the unsharded one:

    * the round's draws are made whole on the world's device, and each
      shard takes its env slice of the reset and env draws, so sharded and
      unsharded rounds consume one stream;
    * the env math (reset, MAC, masks, env step, observation) is strictly
      per env, so each shard evolves its slice on its device;
    * each frame's observations, masks and rewards are gathered in global
      env order on the world's device, where the agent acts on the whole
      batch, as without a mesh (a Q-net run on E/d rows may round
      differently from one on E rows and flip an argmax on a near-tie),
      and the replay push and the D3QL update run once on the identical
      replay.
    """

    ENV_DRAWS = ("arrival", "waypoint", "mac_attempt", "mac_channel")

    def __init__(self, ctrl: LearnGDMController, world: torch_env.TorchWorld,
                 num_envs: int, replay: DeviceReplay, mesh=None,
                 axis: str = "env"):
        self.agent = ctrl.agent
        self.cfg = ctrl.env.cfg
        self.variant, self.mac_scheme = ctrl.variant, ctrl.mac_scheme
        self.world, self.num_envs, self.replay = world, num_envs, replay
        self.mesh, self.axis = mesh, axis
        if mesh is None:
            self.worlds = [world]
        else:
            shards = mesh.shape[axis]
            assert num_envs % shards == 0, (num_envs, shards)
            self.worlds = torch_env.split_world(world, mesh, axis)

    def init_carry(self) -> FusedCarry:
        agent = self.agent
        return FusedCarry(net=agent.net, target_net=agent.target_net,
                          params=agent.params, opt_state=agent.opt_state,
                          replay=self.replay.init(),
                          epsilon=float(np.float32(agent.epsilon)),
                          steps=int(agent.steps))

    def write_back(self, carry: FusedCarry) -> None:
        agent = self.agent
        agent.net, agent.target_net = carry.net, carry.target_net
        agent.params, agent.opt_state = carry.params, carry.opt_state
        agent.epsilon, agent.steps = carry.epsilon, carry.steps

    def draw_round(self, generator: torch.Generator
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        cfg, acfg = self.cfg, self.agent.cfg
        t, e, u = cfg.horizon, self.num_envs, acfg.num_ues
        fdtype, dev = self.world.qbar.dtype, self.world.qbar.device

        def rand(shape, dtype=torch.float32, scale=1.0):
            x = torch.rand(shape, generator=generator, dtype=dtype,
                           device=dev)
            return x * scale if scale != 1.0 else x

        reset_draws = {"pos": rand((e, u, 2), fdtype, cfg.side),
                       "dest": rand((e, u, 2), fdtype, cfg.side),
                       "req": rand((e, u), fdtype)}
        draws = {"explore": rand((t, e)),
                 "q_rand": rand((t, e, u, acfg.num_actions)),
                 "arrival": rand((t, e, u)),
                 "waypoint": rand((t, e, u, 2), scale=cfg.side),
                 "sample": rand((t, acfg.batch_size)),
                 "mac_attempt": rand((t, e, u)),
                 "mac_channel": rand((t, e, u))}
        return reset_draws, draws

    def _per_shard(self, draws: Dict[str, torch.Tensor],
                   env_dim: int) -> List[Dict[str, torch.Tensor]]:
        """Each shard's env slice of ``draws``."""
        if self.mesh is None:
            return [draws]
        return torch_env.split_draws(draws, self.mesh, self.axis, env_dim)

    def _whole(self, shards: List[torch.Tensor]) -> torch.Tensor:
        """Per-shard (E/d, ...) tensors in env order on the world's
        device."""
        if self.mesh is None:
            return shards[0]
        return gather(shards, P(self.axis), self.world.qbar.device)

    def _shards(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] if self.mesh is None else split(x, self.mesh, P(self.axis))

    def run_round(self, carry: FusedCarry, reset_draws: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor]):
        agent, cfg, worlds = self.agent, self.cfg, self.worlds
        acfg = agent.cfg
        e, dev = self.num_envs, self.world.qbar.device
        horizon = draws["explore"].shape[0]
        resets = self._per_shard(reset_draws, env_dim=0)
        frames = self._per_shard({k: draws[k] for k in self.ENV_DRAWS
                                  if k in draws}, env_dim=1)
        states = [torch_env.reset_env(cfg, w, pos_draws=r["pos"],
                                      dest_draws=r["dest"],
                                      req_draws=r["req"])
                  for w, r in zip(worlds, resets)]
        obs0 = self._whole([torch_env.observe(cfg, w, s)
                            for w, s in zip(worlds, states)])
        obs_hist = obs0[:, None].repeat(1, acfg.history, 1)    # (E, H, obs)
        replay, epsilon, steps = carry.replay, carry.epsilon, carry.steps
        opt_state = carry.opt_state
        losses = torch.full((horizon,), float("nan"), device=dev)
        rewards = []
        for t in range(horizon):
            if self.mac_scheme == "greedy":
                macs = [torch_env.greedy_mac(cfg, w, s)
                        for w, s in zip(worlds, states)]
            else:
                macs = [torch_env.random_access(
                    cfg, s, attempt_draws=f["mac_attempt"][t],
                    channel_draws=f["mac_channel"][t])
                    for s, f in zip(states, frames)]
            mask = self._whole([torch_env.action_mask(cfg, s, self.variant)
                                for s in states])
            actions = fused_act(carry.net, obs_hist, epsilon=epsilon,
                                mask=mask, explore_draw=draws["explore"][t],
                                q_rand=draws["q_rand"][t])
            stepped = [torch_env.env_step(
                cfg, w, s, m, a - 1, arrival_draws=f["arrival"][t],
                waypoint_draws=f["waypoint"][t])
                for w, s, m, a, f in zip(worlds, states, macs,
                                         self._shards(actions), frames)]
            states = [s for s, _ in stepped]
            next_obs = self._whole([
                torch_env.observe(cfg, w, s, info["bs_load"])
                for w, s, (_, info) in zip(worlds, states, stepped)])
            step_rewards = self._whole([info["rewards"]
                                        for _, info in stepped])
            next_hist = torch.cat([obs_hist[:, 1:], next_obs[:, None]], dim=1)
            done = torch.full((e,), float(states[0].frame >= cfg.horizon),
                              device=dev)
            replay = self.replay.push(replay, obs_hist, actions,
                                      step_rewards, next_hist, done)
            if replay.size >= acfg.batch_size:
                batch = self.replay.sample_from_uniforms(replay,
                                                         draws["sample"][t])
                batch["actions"] = batch["actions"].long()
                opt_state, loss, _ = d3ql_update(
                    carry.net, carry.target_net, carry.params, opt_state,
                    agent._opt_update, batch, acfg)
                losses[t] = loss
                steps += 1
                if steps % acfg.target_sync == 0:
                    with torch.no_grad():
                        for tp, p in zip(carry.target_net.parameters(),
                                         carry.net.parameters()):
                            tp.copy_(p)
            epsilon = _decay_epsilon(epsilon, acfg)
            rewards.append(step_rewards)
            obs_hist = next_hist
        carry = dataclasses.replace(carry, opt_state=opt_state,
                                    replay=replay, epsilon=epsilon,
                                    steps=steps)
        total_delivered = self._whole([s.total_delivered for s in states])
        return carry, (torch.stack(rewards).sum(dim=0), losses,
                       total_delivered)
