"""The real GDM chain behind the serving engine, on the card.

Port of ``repro.serving.gdm_service``.  One :class:`GDMService` instance is
one of the paper's S services: a DiT denoiser
(:mod:`repro_torch.models.gdm`) whose chain the engine executes block by
block across nodes.  Two contracts back the engine:

* **execution** — ``run_batch(states, block_idxs)`` advances every request
  scheduled on a node this quantum in ONE
  :func:`repro_torch.models.gdm.run_block_batched` call over the stacked
  latents (requests may sit at different chain depths).  ``batch_calls``
  counts those device calls.  Batches are padded to the reference's
  buckets, so the kernels see the same shapes the reference compiled for.
* **quality Ω(k)** — measured from the model itself via
  :func:`repro_torch.models.gdm.quality_per_block`, made monotone by running
  max; or given (the Ω a reference service measured, so both sides of a
  comparison deliver against one curve).

Payloads stay numpy dicts (``{"latent", "prompt", "x0"}``), exactly as the
reference's, so the engine, its ledger and its telemetry are unchanged.
``instrument`` attaches the tracer's metrics registry, under the
reference's metric names.  :class:`SlotBatch` keeps the continuous
scheduler's requests resident on the device between block steps.  The
reference's mesh argument is not ported (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.gdm import (LATENT_CHANNELS, DiT, init_gdm,
                                    make_schedule, quality_per_block,
                                    run_block_batched)


class GDMService:
    """One GDM denoising-chain service for the engine.

    ``seed`` draws the weights (unless ``model`` is given) and Ω's reference
    prompts and noise (unless ``omega`` is given), on ``device`` — the card
    by default.  ``model_cfg`` defaults to the reduced ``gdm-dit``, as in
    the reference.
    """

    def __init__(self, seed: int = 0, *, num_blocks: int = 4,
                 steps_per_block: int = 1,
                 model_cfg: Optional[ModelConfig] = None, prompt_len: int = 8,
                 ref_prompts: int = 4, device=None,
                 model: Optional[DiT] = None,
                 omega: Optional[np.ndarray] = None):
        init_seed, ref_seed = (int(x) for x in
                               np.random.SeedSequence(seed).generate_state(2))
        if model is None:
            self.device = resolve_device(device)
            self.cfg = model_cfg or get_config("gdm-dit").reduced()
            self.model = init_gdm(self.cfg, seed=init_seed, device=self.device)
        else:
            self.device = model.pos.device
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"model lives on {self.device}, not {device}")
            if model_cfg is not None and model_cfg != model.cfg:
                raise ValueError("model_cfg disagrees with the model's config")
            self.cfg = model.cfg
            self.model = model
        self.num_blocks = num_blocks
        self.steps_per_block = steps_per_block
        self.prompt_len = prompt_len
        self.schedule = make_schedule(num_blocks * steps_per_block,
                                      device=self.device)
        self.batch_calls = 0                       # device batch-call counter
        # persistent per-bucket host staging buffers, pinned when the model
        # is on the card so the copies in are asynchronous (see run_batch)
        self._buffers: Dict[int, Tuple[Tuple[torch.Tensor, np.ndarray], ...]] = {}
        self._slot_batch: Optional["SlotBatch"] = None
        # observability (repro_torch.serving.tracing): instrument() attaches
        # a MetricsRegistry; run_batch then wall-clocks its device calls.
        # None -> the raw call
        self.metrics = None
        self._seen_buckets: set = set()
        self._sample_every = 16
        self._steady_calls = 0

        if omega is not None:
            omega = np.asarray(omega, dtype=float).copy()
            if omega.shape != (num_blocks + 1,):
                raise ValueError(f"omega has shape {omega.shape}, expected "
                                 f"({num_blocks + 1},)")
            self.omega = omega
            return
        # Ω(k): measured SSIM-vs-final per block (Fig. 1 protocol), forced
        # monotone — measured curves are monotone in expectation only
        gen = torch.Generator(device=self.device).manual_seed(ref_seed)
        prompts = torch.randint(2, self.cfg.vocab_size,
                                (ref_prompts, prompt_len), generator=gen,
                                device=self.device)
        noise = torch.randn((ref_prompts, self.cfg.latent_hw ** 2,
                             LATENT_CHANNELS), generator=gen,
                            device=self.device)
        with torch.no_grad():
            q = quality_per_block(self.model, noise, prompts,
                                  num_blocks=num_blocks,
                                  steps_per_block=steps_per_block)
        q = q.cpu().numpy()
        self.omega = np.zeros(num_blocks + 1)
        self.omega[1:] = np.maximum.accumulate(np.clip(q, 0.0, 1.0))

    def instrument(self, metrics, sample_every: int = 16) -> None:
        """Attach a :class:`repro_torch.serving.tracing.MetricsRegistry`:
        device calls are wall-clocked into ``gdm_run_batch_ms`` (steady
        state) or ``gdm_compile_ms`` (the first call at a new bucket, which
        pays the kernels' first launch at that shape; also counted in
        ``gdm_compile_events``), as the reference names them.  Attach
        BEFORE serving traffic so the first-seen set is honest.

        The call copies its result back to the host before it returns, so
        the wall clock brackets the device work with no extra
        synchronisation.  Steady-state calls are timed every
        ``sample_every``-th call, as in the reference, so the histograms
        hold the same number of samples; ``sample_every=1`` times every
        call."""
        self.metrics = metrics
        self._sample_every = max(int(sample_every), 1)
        self._steady_calls = 0

    def _call(self, lat_t, pr_t, idx_t, keep=None):
        """The one device call both batch paths (:meth:`run_batch`,
        :meth:`SlotBatch.step`) issue, on staged tensors, results copied
        back to numpy; wall-clocked when instrumented.  With ``keep`` (a
        (bucket,) bool tensor) the new latents are also written into
        ``lat_t`` at the rows it marks, on the device (SlotBatch's masked
        write-back)."""
        if self.metrics is None:
            return self._device_call(lat_t, pr_t, idx_t, keep)
        m = self.metrics
        bucket = int(lat_t.shape[0])
        first = bucket not in self._seen_buckets
        m.counter("gdm_runner_calls").inc()
        m.gauge("gdm_last_batch_rows").set(bucket)
        if not first:
            self._steady_calls += 1
            if self._steady_calls % self._sample_every:
                return self._device_call(lat_t, pr_t, idx_t, keep)
        t0 = time.perf_counter()
        out = self._device_call(lat_t, pr_t, idx_t, keep)
        dt_ms = (time.perf_counter() - t0) * 1e3
        if first:
            self._seen_buckets.add(bucket)
            m.counter("gdm_compile_events").inc()
            m.histogram("gdm_compile_ms").observe(dt_ms)
        else:
            m.histogram("gdm_run_batch_ms").observe(dt_ms)
        return out

    def _device_call(self, lat_t, pr_t, idx_t, keep=None):
        dev = self.device
        with torch.no_grad():
            latent, x0 = run_block_batched(
                self.model, lat_t.to(dev, non_blocking=True),
                pr_t.to(dev, non_blocking=True),
                self.schedule, idx_t.to(dev, non_blocking=True),
                steps_per_block=self.steps_per_block,
                total_steps=self.num_blocks * self.steps_per_block)
            if keep is not None:
                keep = keep.to(dev, non_blocking=True)[:, None, None]
                lat_t.copy_(torch.where(keep, latent, lat_t))
            # fresh host arrays every call: the returned states keep views
            # of them, and the synchronous copy back also means the staging
            # buffers are free again when this returns
            return latent.cpu().numpy(), x0.cpu().numpy()

    # -- engine contracts -----------------------------------------------------

    @staticmethod
    def _bucket(b: int) -> int:
        """Batch-size bucket for ``b`` live rows: pow2 up to 8, then
        multiples of 8 — the reference's rule, so the kernels run at the
        shapes it compiled for, with at most 7 wasted rows on big batches."""
        assert b > 0
        return (1 << (b - 1).bit_length()) if b <= 8 else -(-b // 8) * 8

    def slot_batch(self) -> "SlotBatch":
        """The slot-resident batch view for the iteration-level scheduler
        (one per service, lazily built) — see :class:`SlotBatch`."""
        if self._slot_batch is None:
            self._slot_batch = SlotBatch(self)
        return self._slot_batch

    def _staging(self, bucket: int):
        buf = self._buffers.get(bucket)
        if buf is None:
            pin = self.device.type == "cuda"
            shapes = (((bucket, self.cfg.latent_hw ** 2, LATENT_CHANNELS),
                       torch.float32),
                      ((bucket, self.prompt_len), torch.int32),
                      ((bucket,), torch.int32))
            buf = self._buffers[bucket] = tuple(
                (t, t.numpy()) for t in (
                    torch.zeros(shape, dtype=dtype, pin_memory=pin)
                    for shape, dtype in shapes))
        return buf

    def init_state(self, rng: np.random.Generator) -> Dict:
        """Fresh request payload: noise latent + prompt token ids."""
        prompt = np.asarray(rng.integers(2, self.cfg.vocab_size,
                                         size=(self.prompt_len,)), np.int32)
        latent = np.asarray(
            rng.standard_normal((self.cfg.latent_hw ** 2, LATENT_CHANNELS)),
            np.float32)
        return {"latent": latent, "prompt": prompt, "x0": None}

    def run_batch(self, states: List[Dict],
                  block_idxs: np.ndarray) -> Tuple[List[Dict], np.ndarray]:
        """ONE device call for the whole (node, quantum) group.

        The batch is padded to its bucket before the call; the DiT is
        per-sample independent, so pad rows never change the live rows'
        results, and the pad is sliced off before the states are written
        back.  Rows are written into persistent per-bucket staging buffers
        (zeroed once per bucket size); pad rows keep whatever latents a
        previous call staged, with a valid block-0 index.
        """
        b = len(states)
        if b == 0:
            # empty-batch edge: a step where every sample vacated issues no
            # device call and leaves batch_calls alone
            return [], self.omega[np.asarray(block_idxs, dtype=int) + 1]
        (lat_t, lat_np), (pr_t, pr_np), (idx_t, idx_np) = \
            self._staging(self._bucket(b))
        for i, s in enumerate(states):
            lat_np[i] = s["latent"]
            pr_np[i] = s["prompt"]
        idx_np[:b] = np.asarray(block_idxs, np.int32)
        idx_np[b:] = 0
        latent, x0 = self._call(lat_t, pr_t, idx_t)
        self.batch_calls += 1
        out = [dict(s, latent=latent[i], x0=x0[i])
               for i, s in enumerate(states)]
        return out, self.omega[np.asarray(block_idxs) + 1]

    def block_fn(self, state: Dict, block_idx: int) -> Tuple[Dict, float]:
        """Scalar entry point (legacy per-request path): batch of one."""
        states, qs = self.run_batch([state], np.asarray([block_idx]))
        return states[0], float(qs[0])


class SlotBatch:
    """Slot-level batch mutation for the iteration-level scheduler.

    ``run_batch`` restages every row on every call — right for the quantum
    engine (one call per quantum), wasteful for the continuous scheduler,
    which calls the service every *block step* with mostly the SAME
    requests.  A :class:`SlotBatch` keeps requests *resident* in per-bucket
    buffers on the device, keyed by rid: a continuing request's latent row
    is already there (the previous step's output was written back into its
    row on the device), so each step copies in only the rows that joined
    and frees the rows that left.  The reference keeps such rows in host
    buffers; here they never leave the card.

    Correctness guards, as the reference's:

    * **Residency check by identity** — a row is trusted only if the
      request's current ``state["latent"]`` *is* the exact array this batch
      returned for that rid last step; anything else (a recycled rid, a
      state mutated elsewhere, a fresh latent) restages the row.  Handover
      keeps the state object, so residency survives cross-cell moves
      (service instances are fleet-shared).
    * **Masked write-back** — outputs are written back on the device only
      into the rows planned THIS step; pad and free rows keep what they
      held (the call computes them too, but per-sample independence makes
      them inert).
    * **Own buffers** — the resident buffers are separate from
      ``run_batch``'s staging (an interleaved ``run_batch`` call must not
      overwrite resident rows), but both use the service's buckets and the
      same device call (:meth:`GDMService._call`).

    Bucket churn compacts: when the bucket for the live count changes,
    every request restages into the new bucket's buffers.
    """

    def __init__(self, svc: GDMService):
        self.svc = svc
        self.bucket = 0
        self.rows: Dict[int, int] = {}             # rid -> resident row
        self._free: List[int] = []
        self._latent_of: Dict[int, np.ndarray] = {}   # rid -> returned view
        self._buffers: Dict[int, tuple] = {}
        self.device_calls = 0
        self.rows_staged = 0                       # rows written (joins etc.)

    def _buffers_for(self, bucket: int):
        """(latent, prompt) resident on the device, and pinned host staging
        (tensor, numpy view) for the block indices and the planned-row
        mask, copied in with each call."""
        buf = self._buffers.get(bucket)
        if buf is None:
            svc = self.svc
            dev = svc.device
            pin = dev.type == "cuda"
            idx = torch.zeros((bucket,), dtype=torch.int32, pin_memory=pin)
            keep = torch.zeros((bucket,), dtype=torch.bool, pin_memory=pin)
            buf = self._buffers[bucket] = (
                torch.zeros((bucket, svc.cfg.latent_hw ** 2,
                             LATENT_CHANNELS), dtype=torch.float32,
                            device=dev),
                torch.zeros((bucket, svc.prompt_len), dtype=torch.int32,
                            device=dev),
                (idx, idx.numpy()), (keep, keep.numpy()))
        return buf

    def step(self, items: List[Tuple[int, Dict, int]]
             ) -> Tuple[List[Dict], np.ndarray]:
        """Advance one block step: ``items`` is ``[(rid, state, block_idx)]``
        for every request planned this step.  Returns ``(states,
        qualities)`` exactly like :meth:`GDMService.run_batch`, and
        bit-identical to it."""
        svc = self.svc
        if not items:
            return [], svc.omega[np.asarray([], dtype=int) + 1]
        bucket = svc._bucket(len(items))
        if bucket != self.bucket:
            # bucket churn: compact into the new bucket's buffers (every
            # row restages below via the residency check)
            self.bucket = bucket
            self.rows = {}
            self._free = []
            self._latent_of = {}
        lat_d, pr_d, (idx_t, idx_np), (keep_t, keep_np) = \
            self._buffers_for(bucket)
        # leaves: free the rows of rids not planned this step (a request
        # skipping a step loses residency and restages when it returns)
        planned = {rid for rid, _, _ in items}
        for rid in [r for r in self.rows if r not in planned]:
            self._free.append(self.rows.pop(rid))
            self._latent_of.pop(rid, None)
        self._free.sort(reverse=True)              # reuse lowest rows first
        # joins (and residency-check failures): copy their rows in
        next_row = len(self.rows) + len(self._free)
        for rid, state, _ in items:
            row = self.rows.get(rid)
            resident = row is not None and \
                state["latent"] is self._latent_of.get(rid)
            if row is None:
                if self._free:
                    row = self._free.pop()
                else:
                    row = next_row
                    next_row += 1
                self.rows[rid] = row
            if not resident:
                lat_d[row].copy_(torch.from_numpy(
                    np.asarray(state["latent"], np.float32)))
                pr_d[row].copy_(torch.from_numpy(
                    np.asarray(state["prompt"], np.int32)))
                self.rows_staged += 1
        idx_np[:] = 0                              # pad rows: valid block 0
        keep_np[:] = False
        for rid, _, k in items:
            idx_np[self.rows[rid]] = k
            keep_np[self.rows[rid]] = True
        latent_out, x0 = svc._call(lat_d, pr_d, idx_t, keep=keep_t)
        svc.batch_calls += 1
        self.device_calls += 1
        out: List[Dict] = []
        for rid, state, _ in items:
            row = self.rows[rid]
            # the returned view is the residency token for the next step
            self._latent_of[rid] = latent_row = latent_out[row]
            out.append(dict(state, latent=latent_row, x0=x0[row]))
        ks = np.asarray([k for _, _, k in items], dtype=int)
        return out, svc.omega[ks + 1]


def make_gdm_services(num_services: int, seed: int = 0, *,
                      num_blocks: int = 4, steps_per_block: int = 1,
                      model_cfg: Optional[ModelConfig] = None, device=None,
                      ) -> Tuple[Dict[int, GDMService], np.ndarray]:
    """One independent DiT per service + the stacked (S, B+1) Ω matrix.

    Service s draws from the s-th child of ``np.random.SeedSequence(seed)``.
    The Ω matrix is what the sim trains on and what the engine delivers
    against — the single source of quality truth for the closed loop.
    """
    device = resolve_device(device)
    seeds = np.random.SeedSequence(seed).generate_state(num_services)
    services = {s: GDMService(int(seeds[s]), num_blocks=num_blocks,
                              steps_per_block=steps_per_block,
                              model_cfg=model_cfg, device=device)
                for s in range(num_services)}
    omega = np.stack([services[s].omega for s in range(num_services)])
    return services, omega
