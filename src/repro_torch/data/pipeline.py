"""Deterministic synthetic data (tokens / latents), host-sharded: a copy of
``repro.data.pipeline``'s ``DataConfig``, ``TokenDataset`` and
``LatentDataset`` (numpy only), so the port trains on the reference's
batches bit for bit, and :func:`prefetch`, which moves each item onto a
device ahead of use.

Batch content is a pure function of (seed, step, host): restarts replay
identically and re-sharding changes only which slice a host reads.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 1_024
    global_batch: int = 8
    seed: int = 0
    # host sharding
    host_index: int = 0
    host_count: int = 1


class TokenDataset:
    """Synthetic LM corpus: a fixed-seed Zipf-ish token stream with structure
    (repeated n-grams) so that a real model can measurably learn on it."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError("batch must split across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host) -> host-local batch."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        # Zipf-distributed tokens with planted bigram structure
        ranks = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
        tokens = (ranks % (cfg.vocab_size - 2)) + 2
        # plant deterministic bigrams: token t follows (t*7+3) % vocab 30% of time
        follow = (tokens[:, :-1] * 7 + 3) % (cfg.vocab_size - 2) + 2
        mask = rng.random((self.local_batch, cfg.seq_len)) < 0.3
        tokens[:, 1:] = np.where(mask, follow, tokens[:, 1:])
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def batch_iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class LatentDataset:
    """Synthetic latent/prompt pairs for GDM training & quality evaluation.

    'Images' are smooth 2-D fields whose spectra depend deterministically on
    the prompt id — so denoising quality (SSIM proxy) is measurable."""

    def __init__(self, latent_hw: int = 16, channels: int = 4,
                 vocab_size: int = 49_408, prompt_len: int = 16, seed: int = 0):
        self.hw, self.ch = latent_hw, channels
        self.vocab, self.plen = vocab_size, prompt_len
        self.seed = seed

    def sample(self, batch: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        prompt = rng.integers(2, self.vocab, size=(batch, self.plen)).astype(np.int32)
        # target latent: sum of low-frequency modes keyed by prompt hash
        freqs = (prompt[:, :4].sum(-1) % 5 + 1)[:, None, None, None]
        yy, xx = np.meshgrid(np.linspace(0, 1, self.hw), np.linspace(0, 1, self.hw),
                             indexing="ij")
        base = np.sin(2 * np.pi * freqs * xx[None, ..., None]) * \
            np.cos(2 * np.pi * freqs * yy[None, ..., None])
        target = np.broadcast_to(base, (batch, self.hw, self.hw, self.ch)).copy()
        target += 0.1 * rng.standard_normal(target.shape)
        return {"prompt": prompt, "latent": target.astype(np.float32)}


def _to_device(item, device: torch.device):
    """Every array of a (nested dict / list / tuple) item as a tensor on
    ``device``; to the card through pinned memory, asynchronously."""
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_to_device(v, device) for v in item)
    t = torch.as_tensor(item)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch(iterator: Iterator, size: int = 2, *, device=None) -> Iterator:
    """Yield ``iterator``'s items in order, each moved onto ``device`` (the
    card unless given) by a background thread that keeps up to ``size``
    items ahead of use.  A copy to the card goes through pinned memory with
    ``non_blocking=True`` on the current stream, so the consumer's work on
    that stream is ordered after it.  An exception in the source is raised
    here, at its place in the order."""
    return _prefetch(iterator, size, resolve_device(device))


def _prefetch(iterator: Iterator, size: int, device: torch.device):
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = object()

    def worker():
        try:
            for item in iterator:
                q.put((True, _to_device(item, device)))
            q.put((True, stop))
        except BaseException as exc:       # handed to the consumer
            q.put((False, exc))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        ok, item = q.get()
        if not ok:
            raise item
        if item is stop:
            return
        yield item
