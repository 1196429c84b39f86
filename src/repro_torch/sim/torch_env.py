"""Device-resident functional port of the vectorized edge simulator.

Port of ``repro.sim.jax_env``, the twin of
:class:`repro_torch.sim.vec_env.VecEdgeSimulator` that the fused engine runs
on the device: the whole frame — MAC collision resolution (C4/C5),
priority-ordered placement under per-BS capacity (C1–C3), delivery (C9) and
the eq. (8) reward — is tensor arithmetic over an :class:`EnvState` of
``(E, U)`` / ``(E, N)`` tensors, so a training round runs without reading
the device back (``LearnGDMController.train_fused``).

Randomness is never drawn here unless a ``torch.Generator`` is passed:
:func:`reset_env` and :func:`env_step` take *injected* draws
(``pos/dest/req``, ``arrival_draws``, ``waypoint_draws``), the hooks the
numpy engine has too, so the two engines can be driven with identical
randomness and compared frame by frame (``tests/test_torch_fused.py``).

The segment quantities are the reference's dense O(E·U²) pairwise counts
(``rank_i = #{j: pr_j > pr_i} + #{j < i: pr_j = pr_i}``,
``pos_in_group_i = #{j in group: rank_j < rank_i}``), mathematically the
stable-sort formulation of the numpy engine; :func:`segment_positions` is
the sort-based primitive, pinned against the numpy one.  Integer state is
int32 and stays int32 through every count; the float dtype follows
``world.qbar.dtype`` (float32 to train, float64 for the exact pins).
Divisions by a constant go through a 0-dim tensor on the device: CUDA
computes ``tensor / python_float`` as a product with the reciprocal, which
can differ from numpy's quotient by an ulp and move a UE across a cell
border.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.sim.env import IDLE, PENDING, SimConfig


@dataclasses.dataclass
class TorchWorld:
    """Static world (Table II draws), stacked over E envs."""
    w_hat: torch.Tensor        # (E, N) int32 — per-BS capacity
    eps: torch.Tensor          # (E, N) — per-BS inference cost
    qbar: torch.Tensor         # (E, U) — per-UE quality threshold
    service_of: torch.Tensor   # (E, U) int32
    omega: torch.Tensor        # (E, S, B+1) — quality curves
    omega_ue: torch.Tensor     # (E, U, B+1) — omega rows pre-gathered per UE
    y_hat: torch.Tensor        # (N, N) — inter-node transmission cost


@dataclasses.dataclass
class EnvState:
    """Per-frame dynamic state.  ``frame`` (the shared episode clock) is a
    host integer: every env advances together, so the clock never needs
    the device."""
    pos: torch.Tensor          # (E, U, 2) mobility position (m)
    dest: torch.Tensor         # (E, U, 2) mobility waypoint
    pause_left: torch.Tensor   # (E, U) RWP pause countdown
    poa: torch.Tensor          # (E, U) int32 — current service area / BS
    prev_poa: torch.Tensor     # (E, U) int32
    blocks_done: torch.Tensor  # (E, U) int32 — k_i
    chain_state: torch.Tensor  # (E, U) int32 — IDLE / PENDING / 1 running
    cur_node: torch.Tensor     # (E, U) int32 — last execution BS or -1
    has_request: torch.Tensor  # (E, U) bool
    uploaded: torch.Tensor     # (E, U) bool — m_i^{t-1}
    delivered_quality: torch.Tensor  # (E, U)
    quality_now: torch.Tensor  # (E, U)
    total_delivered: torch.Tensor    # (E,)
    num_delivered: torch.Tensor      # (E,) int32
    num_collisions: torch.Tensor     # (E,) int32
    frame: int


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as numpy's and CUDA's are.  The
    CPU build's ``torch.sqrt`` goes through MKL's vector math, which may
    land an ulp off (float64 281.17595987835017 for 281.1759598783502), so
    a CPU tensor takes numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``like``'s dtype on its device (a fill,
    no copy from the host), for exact division on the card."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def round_generator(seed: int, rd: int, device) -> torch.Generator:
    """The generator of round ``rd`` of a run seeded by ``seed``, on
    ``device``: one stream per (seed, round), as the reference folds the
    round into its key."""
    state = np.random.SeedSequence((int(seed), int(rd))).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


# -- world / state construction ----------------------------------------------

def world_from_sim(sim, num_envs: Optional[int] = None, *,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> TorchWorld:
    """Copy a numpy simulator's static world onto ``device``.

    ``sim`` is either a scalar ``EdgeSimulator`` (its world is tiled
    ``num_envs`` times — the shared-world training regime) or a
    ``VecEdgeSimulator`` (its per-env stack is taken as-is).  Every tensor
    is a copy: the simulator may go on mutating its arrays.
    """
    device = resolve_device(device)
    stacked = sim.w_hat.ndim == 2
    if not stacked:
        assert num_envs is not None, "num_envs required for a scalar world"

    def lift(x, dt):
        a = np.asarray(x)
        if not stacked:
            a = np.broadcast_to(a, (num_envs, *a.shape))
        return torch.tensor(a, dtype=dt, device=device)

    omega = np.asarray(sim.omega)
    service_of = np.asarray(sim.service_of)
    if stacked:
        omega_ue = omega[np.arange(omega.shape[0])[:, None], service_of]
    else:
        omega_ue = omega[service_of]
    return TorchWorld(
        w_hat=lift(sim.w_hat, torch.int32),
        eps=lift(sim.eps, dtype),
        qbar=lift(sim.qbar, dtype),
        service_of=lift(sim.service_of, torch.int32),
        omega=lift(sim.omega, dtype),
        omega_ue=lift(omega_ue, dtype),
        y_hat=torch.tensor(np.asarray(sim.y_hat), dtype=dtype, device=device),
    )


def state_from_numpy(venv, *, dtype: torch.dtype = torch.float32,
                     device=None) -> EnvState:
    """Copy a ``VecEdgeSimulator``'s live state (equivalence harness); the
    venv goes on mutating its buffers in place, so nothing is aliased."""
    device = resolve_device(device)
    m = venv.mobility

    def t(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return EnvState(
        pos=t(m.pos), dest=t(m.dest), pause_left=t(m.pause_left),
        poa=t(venv.poa, torch.int32), prev_poa=t(venv.prev_poa, torch.int32),
        blocks_done=t(venv.blocks_done, torch.int32),
        chain_state=t(venv.chain_state, torch.int32),
        cur_node=t(venv.cur_node, torch.int32),
        has_request=t(venv.has_request, torch.bool),
        uploaded=t(venv.uploaded, torch.bool),
        delivered_quality=t(venv.delivered_quality),
        quality_now=t(venv.quality_now),
        total_delivered=t(venv.total_delivered),
        num_delivered=t(venv.num_delivered, torch.int32),
        num_collisions=t(venv.num_collisions, torch.int32),
        frame=int(venv.frame),
    )


def reset_env(cfg: SimConfig, world: TorchWorld, *,
              pos_draws: Optional[torch.Tensor] = None,
              dest_draws: Optional[torch.Tensor] = None,
              req_draws: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> EnvState:
    """Fresh episode state: uniform positions and waypoints, a request with
    probability 0.9, as in the numpy reset.

    ``pos_draws`` / ``dest_draws`` ((E, U, 2) in [0, side)) and
    ``req_draws`` ((E, U) uniforms in [0, 1)) inject the randomness; what is
    not injected is drawn from ``generator`` (on the world's device).
    """
    e, u = world.qbar.shape
    fdtype, dev = world.qbar.dtype, world.qbar.device

    def draw(shape, scale=1.0):
        assert generator is not None, "reset_env needs draws or a generator"
        x = torch.rand(shape, generator=generator, dtype=fdtype, device=dev)
        return x * scale if scale != 1.0 else x

    pos = pos_draws if pos_draws is not None else draw((e, u, 2), cfg.side)
    dest = dest_draws if dest_draws is not None else draw((e, u, 2), cfg.side)
    req = req_draws if req_draws is not None else draw((e, u))
    poa = area_of(cfg, pos)
    zf = torch.zeros((e, u), dtype=fdtype, device=dev)
    zi = torch.zeros((e, u), dtype=torch.int32, device=dev)
    return EnvState(
        pos=pos, dest=dest, pause_left=zf,
        poa=poa, prev_poa=poa,
        blocks_done=zi, chain_state=torch.full_like(zi, IDLE),
        cur_node=torch.full_like(zi, -1),
        has_request=req < 0.9,
        uploaded=torch.zeros((e, u), dtype=torch.bool, device=dev),
        delivered_quality=zf, quality_now=zf,
        total_delivered=torch.zeros((e,), dtype=fdtype, device=dev),
        num_delivered=torch.zeros((e,), dtype=torch.int32, device=dev),
        num_collisions=torch.zeros((e,), dtype=torch.int32, device=dev),
        frame=0,
    )


# -- primitives ---------------------------------------------------------------

def segment_positions(groups: torch.Tensor, ranks: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of :func:`repro_torch.sim.vec_env.segment_positions`: the
    (group, rank) order as two stable argsorts (a lexsort, so no combined
    key can overflow), and each entry's position inside its group."""
    m = groups.shape[0]
    idx = torch.arange(m, device=groups.device)
    sel = torch.argsort(ranks, stable=True)
    sel = sel[torch.argsort(groups[sel], stable=True)]
    g_sorted = groups[sel]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=groups.device),
                       g_sorted[1:] != g_sorted[:-1]])
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    return sel, idx - seg_start


def area_of(cfg: SimConfig, pos: torch.Tensor) -> torch.Tensor:
    cell = torch.clamp((pos / _const(cfg.side / cfg.grid, pos))
                       .to(torch.int32), 0, cfg.grid - 1)
    return cell[..., 0] * cfg.grid + cell[..., 1]


def ue_quality(world: TorchWorld, blocks_done: torch.Tensor) -> torch.Tensor:
    """Omega_s(k) per UE: one table value picked from the per-UE curve."""
    return torch.gather(world.omega_ue, -1,
                        blocks_done.long()[..., None])[..., 0]


def needs_uplink(state: EnvState) -> torch.Tensor:
    return state.has_request & (state.chain_state == IDLE)


def _priorities(world: TorchWorld, state: EnvState) -> torch.Tensor:
    diff = world.qbar - ue_quality(world, state.blocks_done)
    pr = torch.where(diff > 0, 1.0 / torch.clamp(diff, min=1e-12), 1e-8)
    return torch.clamp(pr, min=1e-8)


def _earlier(u: int, device) -> torch.Tensor:
    """(1, U, U) bool with [0, i, j] = j < i."""
    ar = torch.arange(u, device=device)
    return (ar[None, :] < ar[:, None])[None]


def _rank(world: TorchWorld, state: EnvState) -> torch.Tensor:
    """rank[e, i] = processing position of UE i (priority-descending, ties
    stable by UE index), as pairwise counts."""
    pr = _priorities(world, state)
    pr_i, pr_j = pr[:, :, None], pr[:, None, :]
    earlier = _earlier(pr.shape[1], pr.device)
    return ((pr_j > pr_i) | ((pr_j == pr_i) & earlier)).sum(dim=-1,
                                                            dtype=torch.int32)


def _pairwise_pos(member: torch.Tensor, same_group: torch.Tensor,
                  rank: torch.Tensor) -> torch.Tensor:
    """pos_i = #{j: member_j, same_group[i, j], rank_j < rank_i}."""
    lower = rank[:, None, :] < rank[:, :, None]
    return (same_group & member[:, None, :] & lower).sum(dim=-1,
                                                         dtype=torch.int32)


# -- multiple access ----------------------------------------------------------

def greedy_mac(cfg: SimConfig, world: TorchWorld,
               state: EnvState) -> torch.Tensor:
    """Priority-greedy channel assignment, (E, U) int32 in [0, C) or -1:
    within each (env, BS) group, needy UEs in rank order take channels
    0..C-1 (``vec_greedy_mac``'s semantics)."""
    need = needs_uplink(state)
    rank = _rank(world, state)
    same_bs = state.poa[:, :, None] == state.poa[:, None, :]
    channel = _pairwise_pos(need, same_bs, rank)
    return torch.where(need & (channel < cfg.num_channels), channel,
                       -1).to(torch.int32)


def random_access(cfg: SimConfig, state: EnvState, *,
                  attempt_draws: torch.Tensor, channel_draws: torch.Tensor,
                  attempt_prob: float = 0.8) -> torch.Tensor:
    """ALOHA-style uncoordinated access (collision ablation) from pre-drawn
    (E, U) uniforms in [0, 1)."""
    attempt = needs_uplink(state) & (attempt_draws < attempt_prob)
    chans = torch.floor(channel_draws * cfg.num_channels).to(torch.int32)
    return torch.where(attempt, chans, -1).to(torch.int32)


# -- one frame ----------------------------------------------------------------

def env_step(cfg: SimConfig, world: TorchWorld, state: EnvState,
             mac: torch.Tensor, placement: torch.Tensor, *,
             arrival_draws: Optional[torch.Tensor] = None,
             waypoint_draws: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Advance one frame for all E envs.

    mac: (E, U) int — channel in [0, C) or -1 (silent).
    placement: (E, U) int — BS in [0, N) or -1 (null action).
    arrival_draws: (E, U) uniforms in [0, 1) — new-request draws.
    waypoint_draws: (E, U, 2) uniforms in [0, side) — RWP redraws.
    What is not injected is drawn from ``generator``.

    Returns ``(new_state, info)`` with the numpy engine's reward components
    (``rewards`` etc. have shape (E,)); ``info["done"]`` is a host bool.
    """
    e, u = world.qbar.shape
    n, b = cfg.num_bs, cfg.max_blocks
    fdtype, dev = world.qbar.dtype, world.qbar.device
    if arrival_draws is None or waypoint_draws is None:
        assert generator is not None, "env_step needs draws or a generator"
    if arrival_draws is None:
        arrival_draws = torch.rand((e, u), generator=generator, dtype=fdtype,
                                   device=dev)
    if waypoint_draws is None:
        waypoint_draws = torch.rand((e, u, 2), generator=generator,
                                    dtype=fdtype, device=dev) * cfg.side
    mac = mac.to(torch.int32)
    placement = placement.to(torch.int32)

    q_prev = ue_quality(world, state.blocks_done)
    pre_mac_state = state.chain_state                         # C6 snapshot
    earlier = _earlier(u, dev)

    # ---- multiple access (C4/C5 collision semantics) ----
    want = needs_uplink(state) & (mac >= 0)
    same_slot = (state.poa[:, :, None] == state.poa[:, None, :]) \
        & (mac[:, :, None] == mac[:, None, :]) & want[:, None, :]
    n_senders = same_slot.sum(dim=-1, dtype=torch.int32)
    uploaded_now = want & (n_senders == 1)
    # one collision event per (env, BS, channel) group with >1 senders,
    # counted once at its lowest-index member
    group_rep = want & ~(same_slot & earlier).any(dim=-1)
    num_collisions = state.num_collisions + (group_rep & (n_senders > 1)) \
        .sum(dim=1, dtype=torch.int32)
    chain_state = torch.where(uploaded_now, PENDING, state.chain_state)

    # ---- placement execution (C1-C3): capacity masking by rank ----
    k = state.blocks_done                                     # pre-frame
    active = pre_mac_state != IDLE
    eligible = active & (k < b) & (placement >= 0)
    rank = _rank(world, state)
    a_safe = torch.where(placement >= 0, placement, 0)
    a_long = a_safe.long()

    same_bs = a_safe[:, :, None] == a_safe[:, None, :]
    pos_in_bs = _pairwise_pos(eligible, same_bs, rank)
    cap = torch.gather(world.w_hat, 1, a_long)
    granted = eligible & (pos_in_bs < cap)

    onehot_a = a_safe[..., None] == torch.arange(n, device=dev)  # (E, U, N)
    bs_load = (onehot_a & granted[..., None]).sum(dim=1, dtype=torch.int32)

    eps_at = torch.gather(world.eps, 1, a_long)
    exec_cost = torch.where(granted, eps_at, 0.0).sum(dim=1)

    src = torch.where(k == 0, state.prev_poa, state.cur_node)
    src_safe = torch.where(src >= 0, src, 0).long()
    hop = world.y_hat[src_safe, a_long]
    trans_cost = torch.where(granted, hop, 0.0)

    new_blocks = torch.where(granted, k + 1, k)
    new_cur = torch.where(granted, placement, state.cur_node)
    chain_state = torch.where(granted, 1, chain_state)

    # ---- delivery decision (mirrors the scalar branch ladder) ----
    delivered = active & (
        (k >= b)
        | ((placement < 0) & (k > 0))
        | (eligible & ~granted & (k > 0))                     # C3 blocked
        | (granted & (new_blocks == b)))

    # ---- delivery (downlink leg of C9) ----
    deliver_q = delivered & (new_blocks > 0)
    new_cur_safe = torch.where(new_cur >= 0, new_cur, 0).long()
    trans_cost = trans_cost + torch.where(
        deliver_q, world.y_hat[new_cur_safe, state.poa.long()], 0.0)
    dq = ue_quality(world, new_blocks)
    delivered_quality = torch.where(deliver_q, dq, state.delivered_quality)
    total_delivered = state.total_delivered + \
        torch.where(deliver_q, dq, 0.0).sum(dim=1)
    num_delivered = state.num_delivered + \
        deliver_q.sum(dim=1, dtype=torch.int32)
    blocks_done = torch.where(delivered, 0, new_blocks)
    chain_state = torch.where(delivered, IDLE, chain_state)
    cur_node = torch.where(delivered, -1, new_cur)
    has_request = state.has_request & ~delivered

    # ---- reward, eq. (8) ----
    q_now = ue_quality(world, blocks_done)
    gain = (q_now - q_prev) * (q_now >= world.qbar)
    trans_sum = trans_cost.sum(dim=1)
    rewards = gain.sum(dim=1) - cfg.alpha * exec_cost - cfg.beta * trans_sum

    # ---- world evolution ----
    pos, dest, pause_left, poa = _mobility_step(
        cfg, state.pos, state.dest, state.pause_left, waypoint_draws)
    new_req = (~has_request) & (arrival_draws < cfg.arrival_prob)

    new_state = EnvState(
        pos=pos, dest=dest, pause_left=pause_left,
        poa=poa, prev_poa=state.poa,
        blocks_done=blocks_done.to(torch.int32),
        chain_state=chain_state.to(torch.int32),
        cur_node=cur_node.to(torch.int32),
        has_request=has_request | new_req, uploaded=uploaded_now,
        delivered_quality=delivered_quality, quality_now=q_now,
        total_delivered=total_delivered, num_delivered=num_delivered,
        num_collisions=num_collisions,
        frame=state.frame + 1,
    )
    info = {
        "rewards": rewards,                                   # (E,)
        "quality_gain": gain.sum(dim=1),
        "exec_cost": exec_cost,
        "trans_cost": trans_sum,
        "delivered": delivered,                               # (E, U)
        "executed": granted,                                  # (E, U)
        "bs_load": bs_load,                                   # (E, N)
        "uploaded": uploaded_now,                             # (E, U)
        "done": new_state.frame >= cfg.horizon,
    }
    return new_state, info


def _mobility_step(cfg: SimConfig, pos, dest, pause_left, redraw,
                   dt: float = 1.0):
    """RWP kinematics, formula for formula the numpy ``VecRandomWaypoint``
    (so float64 trajectories are bit-identical under identical redraws);
    the norm of a 2-vector is written out as numpy evaluates it."""
    delta = dest - pos
    sq = delta * delta
    dist = _sqrt(sq[..., 0] + sq[..., 1])
    moving = pause_left <= 0
    step_len = torch.clamp(dist, max=cfg.speed * dt)
    direction = torch.where(dist[..., None] > 1e-9,
                            delta / torch.clamp(dist[..., None], min=1e-9),
                            0.0)
    pos = torch.where(moving[..., None],
                      pos + direction * step_len[..., None], pos)
    arrived = moving & (dist <= cfg.speed * dt + 1e-9)
    pause_left = torch.where(arrived, cfg.pause, pause_left - dt)
    need_new = (pause_left <= 0) & arrived
    expired = (~moving) & (pause_left <= 0)
    pick = need_new | expired
    dest = torch.where(pick[..., None], redraw, dest)
    return pos, dest, pause_left, area_of(cfg, pos)


# -- observation (eq. 7) ------------------------------------------------------

def observe(cfg: SimConfig, world: TorchWorld, state: EnvState,
            bs_load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E, obs_dim) float32 observation, the numpy engine's parts in its
    order: load over capacity, eps over eps_high, Omega - qbar, the uplink
    flags and the one-hot PoA of every UE."""
    e, u = world.qbar.shape
    n = cfg.num_bs
    fdtype = world.qbar.dtype
    load = (bs_load.to(fdtype) if bs_load is not None
            else torch.zeros((e, n), dtype=fdtype, device=world.qbar.device))
    load = load / torch.clamp(world.w_hat, min=1).to(fdtype)
    psi = torch.nn.functional.one_hot(state.poa.long(), n).to(fdtype)
    parts = [
        load,
        world.eps / _const(cfg.eps_high, world.eps),
        ue_quality(world, state.blocks_done) - world.qbar,
        state.uploaded.to(fdtype),
        psi.reshape(e, u * n),
    ]
    return torch.cat(parts, dim=1).to(torch.float32)


# -- variant action masks -----------------------------------------------------

def action_mask(cfg: SimConfig, state: EnvState, variant: str) -> torch.Tensor:
    """(E, U, A) bool — twin of ``LearnGDMController.action_mask_vec``."""
    e, u = state.poa.shape
    a = cfg.num_bs + 1
    dev = state.poa.device
    if variant == "learn-gdm":
        return torch.ones((e, u, a), dtype=torch.bool, device=dev)
    if variant == "mp":
        started = state.blocks_done > 0
        aid = torch.arange(a, device=dev)
        allowed = (aid == 0) | (aid == (state.cur_node + 1)[..., None])
        return torch.where(started[..., None], allowed, True)
    if variant == "fp":
        mid = (state.blocks_done > 0) & (state.blocks_done < cfg.max_blocks)
        null_ok = ~mid                                       # no early exit
        return torch.cat([null_ok[..., None],
                          torch.ones((e, u, a - 1), dtype=torch.bool,
                                     device=dev)], dim=-1)
    raise ValueError(f"unknown variant {variant!r}")


# -- batched policy evaluation -------------------------------------------------

def build_eval_round(cfg: SimConfig, act_fn: Callable, *,
                     mac_scheme: str = "greedy", history: int = 1,
                     needs_obs: bool = True):
    """One evaluation round — the episode's frames running MAC → policy act
    → :func:`env_step` on the device — as one function.

    ``act_fn(params, state, obs_hist, draw)`` is the pure policy: its params,
    the :class:`EnvState`, the (E, H, obs_dim) observation history (``None``
    when ``needs_obs`` is false) and the frame's uniform block ``draw``
    (``None`` without a ``"policy"`` draw) give (E, U) int32 actions (0 =
    null, n+1 = BS n).

    Returns ``round_fn(params, world, state0, draws) -> (final_state,
    stats)`` with ``draws`` a dict of (T, ...) leading-time tensors:
    ``"arrival"`` (T, E, U), ``"waypoint"`` (T, E, U, 2) and optionally
    ``"policy"`` plus, for ``mac_scheme="random"``, ``"mac_attempt"`` /
    ``"mac_channel"`` (T, E, U).  ``state0`` must carry zeroed episode
    counters; the stats are tensors on the device (nothing is read back).
    """
    assert mac_scheme in ("greedy", "random")

    def round_fn(params, world: TorchWorld, state0: EnvState, draws):
        state = state0
        if needs_obs:
            obs0 = observe(cfg, world, state0)
            obs_hist = obs0[:, None].repeat(1, history, 1)   # (E, H, obs)
        else:
            obs_hist = None
        sums = []
        for t in range(draws["arrival"].shape[0]):
            if mac_scheme == "greedy":
                mac = greedy_mac(cfg, world, state)
            else:
                mac = random_access(cfg, state,
                                    attempt_draws=draws["mac_attempt"][t],
                                    channel_draws=draws["mac_channel"][t])
            pol = draws.get("policy")
            actions = act_fn(params, state, obs_hist,
                             None if pol is None else pol[t])
            state, info = env_step(cfg, world, state, mac, actions - 1,
                                   arrival_draws=draws["arrival"][t],
                                   waypoint_draws=draws["waypoint"][t])
            if needs_obs:
                next_obs = observe(cfg, world, state, info["bs_load"])
                obs_hist = torch.cat([obs_hist[:, 1:], next_obs[:, None]],
                                     dim=1)
            sums.append(torch.stack([info["rewards"], info["quality_gain"],
                                     info["exec_cost"], info["trans_cost"]]))
        rew, qg, ec, tc = torch.stack(sums).sum(dim=0)
        stats = {
            "reward": rew,
            "quality_gain": qg,
            "exec_cost": ec,
            "trans_cost": tc,
            "delivered_quality": state.total_delivered,
            "num_delivered": state.num_delivered,
            "collisions": state.num_collisions,
        }
        return state, stats

    return round_fn
