"""Ring-buffer experience memory (capacity 5000, Table II).

Two implementations share the ring layout, as in ``repro.rl.replay``:

* :class:`ReplayMemory` — host/numpy, a carried copy used by the scalar and
  vectorized training loops; its own seeded generator draws the sample
  indices, so a port agent and a reference agent seeded alike sample the
  same transitions.
* :class:`DeviceReplay` — the device-resident twin of the fused engine:
  ``push`` / ``sample_from_uniforms`` over a :class:`DeviceReplayState` of
  tensors, slot for slot the layout of ``ReplayMemory.push_batch``.  The
  write slot and the fill count are host integers (every push adds E
  transitions), so neither a push nor a sample reads the device back.

Observations and rewards are stored float32, as there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


class ReplayMemory:
    def __init__(self, capacity: int, obs_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...], seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, *obs_shape), np.float32)
        self.next_obs = np.zeros((capacity, *obs_shape), np.float32)
        self.actions = np.zeros((capacity, *action_shape), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self.idx = 0
        self.size = 0
        self.rng = np.random.default_rng(seed)

    def push(self, obs, action, reward, next_obs, done) -> None:
        i = self.idx
        self.obs[i] = obs
        self.actions[i] = action
        self.rewards[i] = reward
        self.next_obs[i] = next_obs
        self.dones[i] = float(done)
        self.idx = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def push_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        """Vectorized insert of E transitions (leading axis E) in one write.

        Ring semantics match E sequential ``push`` calls: slots wrap modulo
        capacity, newest overwrites oldest.  When E exceeds the capacity,
        only the last ``capacity`` transitions can survive — older ones are
        dropped *before* writing, so target slots are always unique (fancy
        assignment with duplicate indices has no defined write order).
        """
        e = len(rewards)
        start = max(0, e - self.capacity)
        ids = (self.idx + np.arange(start, e)) % self.capacity
        self.obs[ids] = np.asarray(obs)[start:]
        self.actions[ids] = np.asarray(actions)[start:]
        self.rewards[ids] = np.asarray(rewards)[start:]
        self.next_obs[ids] = np.asarray(next_obs)[start:]
        self.dones[ids] = np.asarray(dones, np.float32)[start:]
        self.idx = int((self.idx + e) % self.capacity)
        self.size = min(self.size + e, self.capacity)

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        ids = self.rng.integers(0, self.size, size=batch)
        return {
            "obs": self.obs[ids],
            "actions": self.actions[ids],
            "rewards": self.rewards[ids],
            "next_obs": self.next_obs[ids],
            "dones": self.dones[ids],
        }

    def __len__(self) -> int:
        return self.size


@dataclasses.dataclass
class DeviceReplayState:
    """A device-resident ring buffer: five tensors and the host's
    bookkeeping of the next write slot and the filled slots."""
    obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    next_obs: torch.Tensor
    dones: torch.Tensor
    idx: int
    size: int


class DeviceReplay:
    """Ring buffer on ``device``: ``state = push(state, ...)``.

    Capacity and shapes are fixed at construction.  ``push`` writes the
    buffers in place (the state is donated, as the reference donates its
    carry on the card) and returns the state with the new bookkeeping.
    """

    def __init__(self, capacity: int, obs_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...], *, device):
        self.capacity = capacity
        self.obs_shape = tuple(obs_shape)
        self.action_shape = tuple(action_shape)
        self.device = torch.device(device)

    def init(self) -> DeviceReplayState:
        c, dev = self.capacity, self.device
        return DeviceReplayState(
            obs=torch.zeros((c, *self.obs_shape), dtype=torch.float32,
                            device=dev),
            actions=torch.zeros((c, *self.action_shape), dtype=torch.int32,
                                device=dev),
            rewards=torch.zeros((c,), dtype=torch.float32, device=dev),
            next_obs=torch.zeros((c, *self.obs_shape), dtype=torch.float32,
                                 device=dev),
            dones=torch.zeros((c,), dtype=torch.float32, device=dev),
            idx=0, size=0)

    def push(self, state: DeviceReplayState, obs, actions, rewards,
             next_obs, dones) -> DeviceReplayState:
        """Insert E transitions (leading axis E).  Slot for slot the layout
        of ``ReplayMemory.push_batch``: entries older than the last
        ``capacity`` are dropped before the write, so every slot is written
        once; the ring's run of slots is written as at most two slices."""
        e = rewards.shape[0]
        start = max(0, e - self.capacity)
        first = (state.idx + start) % self.capacity
        n = e - start
        head = min(n, self.capacity - first)
        for buf, src in ((state.obs, obs), (state.actions, actions),
                         (state.rewards, rewards),
                         (state.next_obs, next_obs), (state.dones, dones)):
            src = src[start:].to(buf.dtype)
            buf[first:first + head] = src[:head]
            if head < n:
                buf[:n - head] = src[head:]
        return dataclasses.replace(
            state, idx=(state.idx + e) % self.capacity,
            size=min(state.size + e, self.capacity))

    def sample_from_uniforms(self, state: DeviceReplayState,
                             u01: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Sample via pre-drawn uniforms in [0, 1): slot ``floor(u *
        max(size, 1))``, the product in ``u01``'s dtype (float32 in
        training) as the reference computes it.  An out-of-range slot would
        fault on the card where JAX clamps it; the product of a uniform
        below 1 and the size stays below the size."""
        ids = torch.floor(u01 * max(state.size, 1)).long()
        return {
            "obs": state.obs[ids],
            "actions": state.actions[ids],
            "rewards": state.rewards[ids],
            "next_obs": state.next_obs[ids],
            "dones": state.dones[ids],
        }
