"""Serving launcher: the paper's pipeline on real models, on the card.

Port of ``repro.launch.serve``.  Simulated heterogeneous edge nodes serve
two service kinds behind one :class:`~repro_torch.serving.ServingEngine`:

* service 0, the GDM service: the DiT denoiser, B blocks, adaptive chain
  length, quality by the SSIM proxy against the chain's final x0;
* service 1, an LM decode service: any LM of the zoo (``--lm-arch``,
  yi-6b by default; granite-moe-1b-a400m runs its experts on every decode
  step, xlstm-1.3b its recurrent cells), one block = ``tokens_per_block``
  greedy decode steps, quality the fraction of the chain done.  As in the
  reference, a decode step gets no encoder memory, so an enc-dec model
  (seamless-m4t-large-v2) decodes with its cross-attention skipped, and a
  VLM without patches.

Placement is the engine's built-in locality-greedy rule.  A request's
payload is its live state on the card (the GDM latent, or the LM's stacked
decode state), whose bytes the engine charges for every hop.

``python -m repro_torch.launch.serve --frames 24 --requests 16`` serves the
reduced models on the card; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.gdm import (LATENT_CHANNELS, DiT, init_gdm,
                                    make_schedule, run_block, ssim_proxy)
from repro_torch.models.lm import (LM, init_decode_state, init_lm,
                                   lm_decode_step)
from repro_torch.serving import (EngineConfig, NodeExecutor, NodeSpec,
                                 Request, ServingEngine)

BlockFn = Callable[[Dict, int], Tuple[Dict, float]]
InitFn = Callable[[np.random.Generator], Dict]


@dataclasses.dataclass
class Counters:
    """What the launcher's services ran, counted where they run it: LM
    tokens decoded and DiT forwards.  With ``step_events`` a list (for an
    LM on the card), every decode step also appends a (start, end) pair of
    CUDA events around itself."""
    lm_tokens: int = 0
    dit_forwards: int = 0
    step_events: Optional[List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = None


def build_gdm_block_fn(seed: int = 0, *, model: Optional[DiT] = None,
                       cfg: Optional[ModelConfig] = None,
                       steps_per_block: int = 2, num_blocks: int = 4,
                       device=None, counters: Optional[Counters] = None,
                       ) -> Tuple[BlockFn, InitFn]:
    """(block_fn, init_state) of the GDM service: the DiT given (which
    keeps its device), or one drawn from ``seed`` at ``cfg`` (the reduced
    gdm-dit by default) on ``device``."""
    if model is None:
        cfg = cfg or get_config("gdm-dit").reduced()
        model = init_gdm(cfg, seed=seed, device=device)
    elif cfg is not None and cfg != model.cfg:
        raise ValueError("cfg disagrees with the model's config")
    cfg, dev = model.cfg, model.pos.device
    counters = counters if counters is not None else Counters()
    total = num_blocks * steps_per_block
    schedule = make_schedule(total, device=dev)
    ref_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    def block(latent, prompt, b):
        counters.dit_forwards += steps_per_block
        return run_block(model, latent, prompt, schedule, block_idx=b,
                         steps_per_block=steps_per_block, total_steps=total)

    def init_state(rng: np.random.Generator) -> Dict:
        prompt = torch.from_numpy(np.asarray(
            rng.integers(2, cfg.vocab_size, size=(1, 8)), np.int32)).to(dev)
        latent = torch.from_numpy(np.asarray(
            rng.standard_normal((1, cfg.latent_hw ** 2, LATENT_CHANNELS)),
            np.float32)).to(dev)
        return {"latent": latent, "prompt": prompt, "x0": None, "final": None}

    @torch.no_grad()
    def block_fn(state: Dict, block_idx: int) -> Tuple[Dict, float]:
        latent, x0 = block(state["latent"], state["prompt"], block_idx)
        state = dict(state, latent=latent, x0=x0)
        # quality: SSIM proxy of the current x0 against the chain's final
        # x0, computed once per prompt (keyed by its first four tokens)
        key = tuple(state["prompt"][0, :4].tolist())
        if key not in ref_cache:
            lat, xf = latent, x0
            for b in range(block_idx + 1, num_blocks):
                lat, xf = block(lat, state["prompt"], b)
            ref_cache[key] = xf
        q = float(ssim_proxy(x0, ref_cache[key])[0].clamp(0.0, 1.0))
        return state, q

    return block_fn, init_state


def build_lm_block_fn(seed: int = 0, *, model: Optional[LM] = None,
                      cfg: Optional[ModelConfig] = None, arch: str = "yi-6b",
                      tokens_per_block: int = 4, num_blocks: int = 4,
                      device=None, counters: Optional[Counters] = None,
                      ) -> Tuple[BlockFn, InitFn]:
    """(block_fn, init_state) of the LM decode service: one block is
    ``tokens_per_block`` greedy decode steps, quality the fraction of the
    chain done (monotone like Omega).  The LM given (which keeps its
    device), or one drawn from ``seed`` at ``cfg`` (``arch`` reduced by
    default) on ``device``."""
    if model is None:
        cfg = cfg or get_config(arch).reduced()
        model = init_lm(cfg, seed=seed, device=device)
    elif cfg is not None and cfg != model.cfg:
        raise ValueError("cfg disagrees with the model's config")
    cfg, dev = model.cfg, model.embed.table.device
    counters = counters if counters is not None else Counters()
    max_seq = tokens_per_block * num_blocks + 8

    def init_state(rng: np.random.Generator) -> Dict:
        token = np.asarray(rng.integers(2, cfg.vocab_size, size=(1,)),
                           np.int32)
        return {"state": init_decode_state(cfg, 1, max_seq,
                                           dtype=torch.float32, device=dev),
                "token": torch.from_numpy(token).to(dev),
                "text": [int(token[0])]}

    def step(tok, st):
        events = counters.step_events
        if events is None:
            return lm_decode_step(model, tok, st)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = lm_decode_step(model, tok, st)
        pair[1].record()
        events.append(pair)
        return out

    @torch.no_grad()
    def block_fn(state: Dict, block_idx: int) -> Tuple[Dict, float]:
        st, tok = state["state"], state["token"]
        for _ in range(tokens_per_block):
            logits, st = step(tok, st)
            tok = logits[:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
            counters.lm_tokens += tok.shape[0]
            state["text"].append(int(tok[0]))
        return dict(state, state=st, token=tok), (block_idx + 1) / num_blocks

    return block_fn, init_state


def run(*, gdm: Optional[DiT] = None, lm: Optional[LM] = None,
        lm_arch: str = "yi-6b", frames: int = 24, requests: int = 16,
        nodes: int = 4, blocks: int = 4, tokens_per_block: int = 4,
        steps_per_block: int = 2, seed: int = 0, early_exit: bool = True,
        device=None, counters: Optional[Counters] = None,
        ) -> Tuple[Dict, ServingEngine]:
    """Serve ``requests`` requests, each for a service drawn at random,
    over ``nodes`` heterogeneous nodes for ``frames`` frames.  Returns the
    engine's summary plus the wall clock of the serve (``wall_s``), and the
    engine (its ``completed`` requests carry their payloads).

    The services run the models given, or models drawn on ``device`` (the
    card by default) from seeds derived from ``seed``: the reduced gdm-dit
    and the reduced ``lm_arch``.  The engine draws from
    ``np.random.default_rng(seed)`` in the reference's order: the nodes,
    then per request its service, threshold, origin and initial state.
    """
    device = resolve_device(device)
    counters = counters if counters is not None else Counters()
    gdm_seed, lm_seed = (int(s) for s in
                         np.random.SeedSequence(seed).generate_state(2))
    gdm_fn, gdm_init = build_gdm_block_fn(
        gdm_seed, model=gdm, steps_per_block=steps_per_block,
        num_blocks=blocks, device=device, counters=counters)
    lm_fn, lm_init = build_lm_block_fn(
        lm_seed, model=lm, arch=lm_arch, tokens_per_block=tokens_per_block,
        num_blocks=blocks, device=device, counters=counters)
    block_fns = {0: gdm_fn, 1: lm_fn}
    inits = {0: gdm_init, 1: lm_init}

    rng = np.random.default_rng(seed)
    # heterogeneous nodes (paper: W ~ U(1,3), eps ~ U(1,4))
    executors = [NodeExecutor(NodeSpec(i, int(rng.integers(1, 4)),
                                       float(rng.uniform(1, 4))), block_fns)
                 for i in range(nodes)]
    y = np.abs(np.arange(nodes)[:, None] - np.arange(nodes)[None, :]) * 0.2
    engine = ServingEngine(executors, EngineConfig(
        max_blocks=blocks, early_exit=early_exit, seed=seed), y)
    for rid in range(requests):
        service = int(rng.integers(0, 2))
        # requests enter scattered across the nodes (their UEs' PoAs):
        # admission is C slots per entry node
        req = Request(rid=rid, service=service, arrival_frame=0,
                      quality_threshold=float(rng.uniform(0.1, 0.5)),
                      origin=int(rng.integers(0, nodes)))
        req.state = inits[service](rng)
        engine.submit(req)
    t0 = time.time()
    stats = engine.run(frames)
    stats["wall_s"] = round(time.time() - t0, 2)
    return stats, engine


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lm-arch", default="yi-6b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-early-exit", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    stats, _ = run(lm_arch=args.lm_arch, frames=args.frames,
                   requests=args.requests, nodes=args.nodes,
                   blocks=args.blocks, seed=args.seed,
                   early_exit=not args.no_early_exit, device=args.device)
    print(f"[serve] completed={stats['completed']}/{args.requests} "
          f"mean_quality={stats['mean_quality']:.3f} "
          f"mean_latency={stats['mean_latency_frames']:.1f}f "
          f"objective={stats['objective']:.2f} wall={stats['wall_s']}s")
    return stats


if __name__ == "__main__":
    main()
