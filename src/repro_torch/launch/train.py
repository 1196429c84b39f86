"""Training launcher: the port of ``repro.launch.train``, on the card.

``python -m repro_torch.launch.train --arch yi-6b --steps 200`` trains the
reduced config on the card (``--device cpu`` on the CPU); as in the
reference, ``--reduced`` is a flag that defaults to on, so the CLI always
trains the reduced config of any arch of the zoo (``--arch
granite-moe-1b-a400m`` and ``jamba-v0.1-52b`` with their experts,
``xlstm-1.3b`` with its recurrent cells).  Its ``TokenDataset`` batches
carry no stubs, as the reference's: an enc-dec arch
(``seamless-m4t-large-v2``) cannot train through the CLI (its forward
raises for want of ``enc_frames``), and a VLM trains without patches.
:func:`run` takes any config, full width included (``chip_smoke.py``
trains one full-width Jamba period, full-width granite and full-width
xlstm-1.3b through it); ``launch.steps.make_train_step`` takes batches
with the stubs.

As the reference's trainer, :func:`run` builds a ``("data",)`` mesh
over every CUDA device (over ``devices`` when given: ``("cpu",) * n``
runs it on the CPU) and passes it with the global batch to
``make_train_step``, so the batch splits over the data shards; on one
card the mesh has one device and changes no bit.

``--ckpt-dir`` saves the model and the AdamW state every ``--ckpt-every``
steps in the background (:mod:`repro_torch.checkpoint`, the reference's
format) and resumes from the newest complete step.  ``--grad-compression``
sets the step option as the reference's CLI does; like the reference's
loop, the CLI passes the step no error-feedback state, so the option
changes no number there (``make_train_step`` compresses when given one).
As the reference's CLI, the trainer steps without remat (``opts``
defaults to ``StepOptions(remat=False)``); ``TrainConfig.remat`` is read
by nothing, there as here.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_train_state, train_state)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import StepOptions, make_train_step, trainable
from repro_torch.models.lm import LM, init_lm
from repro_torch.optim import adamw

PHASES = ("forward", "backward", "optimizer")


class _PhaseEvents:
    """CUDA events at the step's phase marks; ``ms()`` sums the device
    time between consecutive marks by the phase each one opens."""

    def __init__(self):
        self.events: List = []

    def __call__(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def ms(self) -> Dict[str, float]:
        out = dict.fromkeys(PHASES, 0.0)
        for (name, a), (_, b) in zip(self.events, self.events[1:]):
            out[name] += a.elapsed_time(b)
        out["step"] = self.events[0][1].elapsed_time(self.events[-1][1])
        return out


def run(cfg: ModelConfig, tcfg: TrainConfig, *, global_batch: int = 8,
        seq_len: int = 128, opts: StepOptions = StepOptions(remat=False),
        model: Optional[LM] = None, device=None, log_every: int = 20,
        ckpt_dir: str = "", ckpt_every: int = 50,
        on_step: Optional[Callable[[int, Dict], None]] = None,
        devices: Optional[Sequence] = None) -> Dict:
    """Train ``cfg`` up to step ``tcfg.total_steps`` on ``TokenDataset``
    batches (seed ``tcfg.seed``), from ``model`` or weights drawn from
    ``tcfg.seed``.  With ``ckpt_dir`` the model and optimizer state are
    saved there every ``ckpt_every`` steps, and a run that finds a
    complete checkpoint there resumes from its step.  Returns first/last
    loss, the steps run, every loss and MoE aux loss, the step resumed
    from (with a checkpoint directory, the seconds of the restore and of
    the last save) and, on the card, each step's device ms by phase (CUDA
    events) and the peak device memory.  ``on_step(step, metrics)`` is called
    after each step.  The step runs over a ``("data",)`` mesh of
    ``devices``: by default every CUDA device on the card, the model's
    device alone elsewhere."""
    device = model.embed.table.device if model is not None \
        else resolve_device(device)
    if model is None:
        model = init_lm(cfg, seed=tcfg.seed, device=device)
    cuda = device.type == "cuda"
    opt_init, _ = adamw(tcfg.learning_rate)
    opt_state = opt_init(trainable(model))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=seq_len, global_batch=global_batch,
                                   seed=tcfg.seed))
    start, ckpt, restore_s = 0, None, None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir, every=ckpt_every)
        if latest_step(ckpt_dir) is not None:
            t0 = time.perf_counter()
            opt_state, start = restore_train_state(ckpt_dir, model,
                                                   opt_state)
            restore_s = time.perf_counter() - t0
            print(f"[train] resumed from step {start}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(
            torch.cuda.device_count())] if cuda else [device]
    mesh = make_host_mesh((len(devices),), ("data",), devices=devices)
    step_fn = make_train_step(cfg, tcfg, opts=opts, mesh=mesh,
                              global_batch=global_batch)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    losses, auxes, phase_ms = [], [], []
    t0 = time.time()
    try:
        for step in range(start, tcfg.total_steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch_at(step).items()}
            marks = _PhaseEvents() if cuda else None
            model, opt_state, metrics = step_fn(model, opt_state, batch,
                                                mark=marks)
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux"]))
            if cuda:
                torch.cuda.synchronize(device)
                phase_ms.append(marks.ms())
            if ckpt and (step + 1) % ckpt.every == 0:
                ckpt.maybe_save(step + 1, train_state(model, opt_state))
            if on_step is not None:
                on_step(step, metrics)
            if log_every and (step + 1) % log_every == 0:
                dt = (time.time() - t0) / (step + 1 - start)
                aux = f" aux={auxes[-1]:.4f}" if cfg.is_moe else ""
                print(f"[train] step {step + 1:5d} loss={losses[-1]:.4f}"
                      f"{aux} ppl={float(metrics['perplexity']):.1f} "
                      f"{dt * 1e3:.0f} ms/step")
    finally:
        if ckpt:
            ckpt.wait()      # a checkpoint started is a checkpoint written
    result = {"first_loss": losses[0] if losses else float("nan"),
              "last_loss": losses[-1] if losses else float("nan"),
              "steps": len(losses), "losses": losses, "aux": auxes,
              "start_step": start}
    if ckpt:
        result.update(restore_s=restore_s, last_save_s=ckpt.last_seconds)
    if cuda:
        result["phase_ms"] = phase_ms
        result["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    print(f"[train] done: loss {result['first_loss']:.4f} -> "
          f"{result['last_loss']:.4f}")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5),
                       microbatch=args.microbatch, seed=args.seed)
    opts = StepOptions(microbatch=args.microbatch,
                       grad_compression=args.grad_compression, remat=False)
    return run(cfg, tcfg, global_batch=args.global_batch,
               seq_len=args.seq_len, opts=opts, device=args.device,
               log_every=args.log_every, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
