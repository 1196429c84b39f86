"""D3QL: Double + Dueling Deep Q-Learning (paper §III, eqs. 3–5, Table II).

Port of ``repro.rl.d3ql``.  Double-Q target (eq. 3): a' from the *online*
net, evaluated by the *target* net.  Dueling heads live in
:mod:`repro_torch.rl.networks` (eq. 4).  Updates follow (5) with Adam at lr
8e-4, batch 32, gamma 0.9, target sync every 150 steps, epsilon-greedy with
multiplicative decay 0.99995 to floor 1e-5; action masks restrict the
per-UE argmax (the MP/FP variants and dead nodes).

Only the Q-nets, the sampled batch and the update live on the device.
Acting keeps the reference's numpy ``rng`` stream in its order (the explore
draw per env, then the (E, U, A) uniforms only when some env explores),
computes Q on the device, copies it back once and applies the numpy
:func:`masked_argmax` last.  The fused engine acts on the device instead
(:func:`fused_act`, from injected uniforms) and updates through
:func:`d3ql_update` on nets it is handed.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.rl.networks import QNet, qnet_apply, qnet_init
from repro_torch.rl.replay import ReplayMemory


def masked_argmax(q: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """Mask-then-argmax — the ONLY action-selection path out of the agent,
    applied to exploration draws and Q-values alike, so disallowed actions
    can never be emitted regardless of how ``q`` was produced (including the
    ``explore.all()`` short-circuit that skips the forward pass)."""
    if mask is not None:
        q = np.where(mask, q, -np.inf)
    return q.argmax(axis=-1).astype(np.int32)


def fused_act(net: QNet, obs_hist: torch.Tensor, *, epsilon: float,
              mask: Optional[torch.Tensor], explore_draw: torch.Tensor,
              q_rand: torch.Tensor) -> torch.Tensor:
    """Epsilon-greedy acting on the device (the fused engine's).

    obs_hist: (E, H, obs_dim); mask: (E, U, A) bool or None; epsilon a host
    float (float32-valued).  Each env explores independently when its
    ``explore_draw`` ((E,) uniforms) falls below epsilon, taking the
    ``q_rand`` ((E, U, A) uniforms) in place of Q, as ``act_batch`` does;
    the mask is applied after that merge, the invariant of
    :func:`masked_argmax`, and ``torch.argmax`` takes the first maximum.
    """
    with torch.no_grad():
        q = qnet_apply(net, obs_hist)
        explore = explore_draw < epsilon
        q = torch.where(explore[:, None, None], q_rand.to(q.dtype), q)
        if mask is not None:
            q = torch.where(mask, q, -torch.inf)
        return q.argmax(dim=-1).to(torch.int32)


def d3ql_loss(net: QNet, target_net: QNet, batch: Dict[str, torch.Tensor],
              gamma: float) -> torch.Tensor:
    """mean(td^2) of eq. (5) over a device batch, with the VDN sum over
    UEs and the double-Q target (argmax of the online net on ``next_obs``,
    evaluated by the target net, no gradient)."""
    q = qnet_apply(net, batch["obs"])                         # (B, U, A)
    q_sel = torch.gather(q, -1, batch["actions"][..., None])[..., 0]
    q_tot = q_sel.sum(dim=-1)                                 # VDN sum
    with torch.no_grad():
        a_star = qnet_apply(net, batch["next_obs"]).argmax(dim=-1)
        q_next_target = qnet_apply(target_net, batch["next_obs"])
        q_next = torch.gather(q_next_target, -1,
                              a_star[..., None])[..., 0].sum(dim=-1)
    y = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = y - q_tot
    return torch.mean(td ** 2)


def d3ql_update(net: QNet, target_net: QNet, params: Dict[str, torch.Tensor],
                opt_state, opt_update, batch: Dict[str, torch.Tensor],
                cfg: "D3QLConfig"):
    """One D3QL step on a device batch (``actions`` int64): autograd of
    :func:`d3ql_loss`, global-norm clipping to ``cfg.grad_clip``, then
    ``opt_update``; the parameters ``params`` (``net``'s, by name) move in
    place.  Returns (opt_state, loss, gradient norm), the last two device
    scalars."""
    loss = d3ql_loss(net, target_net, batch, cfg.gamma)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    updates, opt_state = opt_update(grads, opt_state, params)
    apply_updates(params, updates)
    return opt_state, loss.detach(), gnorm


def greedy_act(net: QNet, obs_hist: torch.Tensor, *,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode acting on the device: obs_hist (E, H, obs_dim) and mask
    (E, U, A) bool or None -> (E, U) int32.  The same mask-after-Q
    invariant as :func:`masked_argmax`; ``torch.argmax`` takes the first
    index on ties, as numpy's and ``jnp.argmax`` do."""
    with torch.no_grad():
        q = qnet_apply(net, obs_hist)
        if mask is not None:
            q = torch.where(mask, q, -torch.inf)
        return q.argmax(dim=-1).to(torch.int32)


@dataclasses.dataclass
class D3QLConfig:
    obs_dim: int = 64
    num_ues: int = 15
    num_actions: int = 17            # {null} ∪ N
    history: int = 3                 # H (Table II)
    lstm_units: int = 128
    fc: tuple = (128, 64, 32)
    memory_capacity: int = 5_000
    batch_size: int = 32
    gamma: float = 0.9
    learning_rate: float = 8e-4
    epsilon_floor: float = 1e-5      # eps_tilde
    epsilon_decay: float = 0.99995   # eps'
    target_sync: int = 150
    grad_clip: float = 10.0
    seed: int = 0


class D3QLAgent:
    """The online and target Q-nets on ``device`` (the card by default),
    AdamW state beside them, and the host-side replay and rng.

    The online net is drawn by :func:`qnet_init` from ``cfg.seed``, or
    holds ``params``, a reference Q-net pytree (numpy leaves), when given.
    ``params`` here is the online net's ``{name: parameter}`` dict in the
    reference's leaf order (its pytree's sorted keys), which the gradient
    clipping sums over.
    """

    def __init__(self, cfg: D3QLConfig, *, device=None,
                 params: Optional[Dict] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            self.net = qnet_init(cfg.obs_dim, cfg.num_ues, cfg.num_actions,
                                 lstm_units=cfg.lstm_units, fc=cfg.fc,
                                 seed=cfg.seed, device=self.device)
        else:
            # convert reaches the serving stack, which reaches core, which
            # imports this module: import it only when it is needed
            from repro_torch.models.convert import qnet_from_jax
            self.net = qnet_from_jax(params, cfg, device=self.device)
        self.target_net = copy.deepcopy(self.net)
        self.params = dict(sorted(self.net.named_parameters()))
        for p in self.params.values():
            p.requires_grad_(True)
        self._opt_init, self._opt_update = adamw(cfg.learning_rate, b1=0.9,
                                                 b2=0.999, weight_decay=0.0)
        self.opt_state = self._opt_init(self.params)
        self.memory = ReplayMemory(
            cfg.memory_capacity,
            obs_shape=(cfg.history, cfg.obs_dim),
            action_shape=(cfg.num_ues,),
            seed=cfg.seed)
        self.epsilon = 1.0
        self.steps = 0
        self.rng = np.random.default_rng(cfg.seed)

    # -- acting --------------------------------------------------------------

    def act(self, obs_hist: np.ndarray, *, greedy: bool = False,
            mask: Optional[np.ndarray] = None) -> np.ndarray:
        """obs_hist: (H, obs_dim) -> per-UE actions (U,) int in [0, A).

        Action 0 is the null action; action n+1 places on BS n.
        ``mask``: (U, A) bool — False entries are disallowed.
        """
        mask_b = None if mask is None else mask[None]
        return self.act_batch(obs_hist[None], greedy=greedy, mask=mask_b)[0]

    def q_values(self, obs_hist: np.ndarray) -> np.ndarray:
        """Q (E, U, A) of the online net, computed on the device and copied
        back to the host (one synchronisation)."""
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(obs_hist, np.float32))
            return qnet_apply(self.net, x.to(self.device)).cpu().numpy()

    def act_batch(self, obs_hist: np.ndarray, *, greedy: bool = False,
                  mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched acting: obs_hist (E, H, obs_dim) -> actions (E, U).

        One forward serves all E envs; epsilon-greedy exploration is
        decided per env (each env independently explores with prob epsilon,
        mirroring the scalar per-call draw), and ``mask`` is (E, U, A).
        """
        cfg = self.cfg
        e = obs_hist.shape[0]
        explore = np.zeros(e, dtype=bool) if greedy \
            else self.rng.random(e) < self.epsilon
        q_rand = None
        if explore.any():
            q_rand = self.rng.random(
                (e, cfg.num_ues, cfg.num_actions)).astype(np.float32)
        if explore.all():
            q = q_rand                     # skip the forward entirely
        else:
            q = self.q_values(obs_hist)                           # (E, U, A)
            if q_rand is not None:
                q = np.where(explore[:, None, None], q_rand, q)
        return masked_argmax(q, mask)

    def decay_epsilon(self) -> None:
        self.epsilon = max(self.cfg.epsilon_floor,
                           self.epsilon * self.cfg.epsilon_decay)

    # -- learning ------------------------------------------------------------

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """:func:`d3ql_loss` of the agent's nets."""
        return d3ql_loss(self.net, self.target_net, batch, self.cfg.gamma)

    def update(self, batch: Dict[str, torch.Tensor]):
        """One D3QL step on a device batch (:func:`d3ql_update` with AdamW,
        b1 0.9, b2 0.999, no weight decay), all in place.  Returns (loss,
        gradient norm) as device scalars."""
        self.opt_state, loss, gnorm = d3ql_update(
            self.net, self.target_net, self.params, self.opt_state,
            self._opt_update, batch, self.cfg)
        return loss, gnorm

    def device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A replay sample on the device (actions as int64 for ``gather``)."""
        return {k: torch.from_numpy(np.asarray(
            v, np.int64 if k == "actions" else np.float32)).to(self.device)
            for k, v in batch.items()}

    @torch.no_grad()
    def sync_target(self) -> None:
        for t, p in zip(self.target_net.parameters(), self.net.parameters()):
            t.copy_(p)

    def train_step(self) -> Optional[float]:
        cfg = self.cfg
        if len(self.memory) < cfg.batch_size:
            return None
        batch = self.memory.sample(cfg.batch_size)
        loss, _ = self.update(self.device_batch(batch))
        self.steps += 1
        if self.steps % cfg.target_sync == 0:
            self.sync_target()
        return float(loss)

    def remember(self, obs, action, reward, next_obs, done) -> None:
        self.memory.push(obs, action, reward, next_obs, done)
