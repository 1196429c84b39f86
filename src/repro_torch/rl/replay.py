"""Ring-buffer experience memory (capacity 5000, Table II).

Carried copy of ``repro.rl.replay.ReplayMemory`` (host, numpy), used by the
scalar and vectorized training loops; its own seeded generator draws the
sample indices, so a port agent and a reference agent seeded alike sample
the same transitions.  Observations and rewards are stored float32, as
there.  The device-resident twin (``DeviceReplay``) serves only the fused
engine and comes with it (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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
