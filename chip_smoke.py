#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero before the result line):

1. the card: name and power limit from nvidia-smi, CUDA required;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time, ptxas' register report per kernel
   and the resident blocks per SM of ``adaln_norm``, ``decode_attention``,
   ``flash_attention`` (each head width), ``rmsnorm``, ``ssm_scan`` and
   ``ssm_scan_backward``;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (full-width gdm-dit at B in {1, 4, 8}, yi-6b's heads
   and widths, the trainer's rows, the reduced configs), on attention's
   masking cases, on ragged decode lengths at tile and split edges, on
   both load widths of adaLN and rmsnorm and on scans whose channels do
   not fill whole warps; tolerance 1e-5 (float32); adaLN, decode, rmsnorm
   and both scan kernels also against a second call, bit for bit;
4. time each kernel, its plain version and the PyTorch call that computes
   the same function, where there is one, at the main paths' shapes,
   beside the least time the card could take and the launch floor (a
   one-element ``zero_``); adaLN at B=1 and B=4, decode at the launcher's
   shape and rmsnorm on one decode row also with L2 flushed before each
   call;
5. one full-width ``run_block_batched`` call on the card against the same
   call on the CPU (plain versions) with the same weights;
6. serve the ``paper-fig3`` trace with three full-width gdm-dit services
   and check that the kernels' launch counts are exactly what the served
   block calls and the Omega measurement imply;
7. one yi-6b prefill and four greedy decode steps at full width (two
   layers, full vocab) on the card against the same calls on the CPU with
   the same weights;
8. serve the edge launcher (``repro_torch.launch.serve``) with the LM
   service at full yi-6b (32 layers, 24.2 GB of weights on the card) and
   the GDM service at full gdm-dit, and check that the launch counts are
   exactly what the launcher's own token and forward counts imply;
9. a full-width two-layer Jamba hybrid ([attention, Mamba], no experts)
   on the card against the CPU with the same weights: six train steps
   through the trainer on the same batches (the first batch's loss and
   gradients, the first step's gradient norm and update, every step's
   loss, the final parameters), then a prefill and four greedy decode
   steps;
10. train one full-width Jamba period (8 layers: attention + 7 Mamba,
    dense SwiGLU, 2.7 B parameters) for six steps through
    ``repro_torch.launch.train.run`` and check every loss, the exact
    launch counts of every step, the device time per phase and the peak
    memory;
11. the D3QL agent at Table II widths (paper-fig3: U=15, A=17, H=3,
    obs_dim 302, LSTM 128, FC 128/64/32, batch 32) on the card against
    the same agent on the CPU: bit-equal initial weights, Q on 256
    observations, 50 updates on the same batches (every loss, the final
    parameters), greedy actions (near-ties counted); device ms per update
    and per act at E=8, host ms per update;
12. Fig. 3 on the card: train LEARN-GDM on paper-fig3 (synthetic Omega,
    240 episodes at E=8, seed 0) as ``benchmarks/bench_convergence.py``
    does and check its criteria (late reward above early, late MSE below
    early), with the wall clock and frames per second;
13. the paper's closed loop: three full-width gdm-dit services measure
    Omega, LEARN-GDM trains against it (48 episodes at E=8), and the
    paper-fig3 trace is served under the learned policy and under GR;
    every served latent finite, the DiT kernels' launch counts exactly
    what Omega and the served block calls imply, and every recorded
    decision the CPU copy of the agent's on the same observations;
14. the fused engine: the tensor env (``sim/torch_env``) on the card in
    float64 against the numpy simulator under the same injected draws
    (integer state and observations exactly, rewards within 1e-9), one
    fused round card vs CPU from the same draws, Fig. 3 through
    ``train_fused`` with its criteria, and a round's host time, kernels
    and device time beside phase 12's vectorized engine;
15. the fleet: ``serve_fleet_variant`` on paper-fig3 with
    ``examples/serve_fleet.py``'s defaults (4 cells, diurnal, handover
    0.02, 48 training episodes through the fused engine, 40 frames) and
    three full-width gdm-dit services, under quantum scheduling, the
    continuous scheduler and node churn with failover+degrade (deadline
    16): every latent finite, the DiT kernels' launches exactly L per
    served block call, every decision the agent's CPU copy's (near-ties
    counted), sync-mode continuous equal to quantum, peak memory and wall
    clock; then the trained agent serves the continuous scheduler without
    early exit (every chain all B blocks), each ``SlotBatch`` step held
    against ``run_batch`` bit for bit, and node churn without early exit,
    which must fail over; both must keep rows resident between steps.

Phase 3 also holds the selective scan (forward and backward kernels)
against its plain version and autograd (and both against themselves: two
calls give the same bits), and the gradients that
``flash_attention`` and ``rmsnorm`` carry on the card against autograd of
their plain versions; phase 4 times both scan kernels at the training
shape.

Then it prints one JSON line describing the kernels (each kernel's
launches from the path that carries it: the DiT kernels from the fleet of
phase 15, decode and rmsnorm from phase 8, the scan kernels from phase
10), and as its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernel-times TREE`` builds the kernels of another
checkout's ``TREE/src/repro_torch`` (a parent commit unpacked with ``git
archive``) and times its adaLN, decode, rmsnorm and both scan kernels,
and the layers they serve (the DiT forward at B=4, the device time and
host enqueue of a yi-6b decode step, a full-width Jamba Mamba block's
forward at B=8, L=128) in this harness, so that two trees are compared on
one card in one run (parent, change, change, parent); it ends with a
``{"tree": ..., "kernel_times": ...}`` line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its 700 W
# limit: the least time any work can take is the larger of its bytes over
# the memory rate and its float32 operations over the CUDA-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# dense TF32 on the tensor cores; flash_attention's 3xTF32 products issue
# three TF32 products for each float32 one
PEAK_TF32_FLOPS = 495e12
# exponentials run on the special-function units: 16 results per clock per
# SM (CUDA C programming guide, compute capability 9.0) against 128 float32
# FMA lanes (256 flops), so a sixteenth of the float32 rate
PEAK_SFU_PER_S = PEAK_F32_FLOPS * 16 / 256
TOL = 1e-5            # kernel vs plain version, float32, same inputs
# whole DiT step, card vs CPU: both sides sum K up to 3072 per product in a
# different order (cuBLAS vs the CPU BLAS), through 12 layers
STEP_TOL = 1e-4
# LM steps, card vs CPU, relative to the largest |logit| (|kv|): products
# sum K up to 11008 long in a different order on each side, through two
# layers and five steps whose caches feed the next
LM_TOL = 1e-4
# scan kernels vs their plain version and autograd, and the gradients of
# flash_attention and rmsnorm vs autograd of their plain versions: relative
# to the largest magnitude of each output, float32 summed in another order
# (the scan's dB and dC over 8192 channels, dA and dD over batch and time)
SCAN_TOL = 1e-5
GRAD_TOL = 1e-5
# six train steps, card vs CPU: each step's loss, relative; the final
# parameters' gap over how far training moved them, over the model and
# for each leaf.  Adam moves an element by about lr whatever its gradient,
# so the few elements whose gradient is at rounding level can step apart,
# and those gaps carry on; a leaf the card failed to train would be 1 off
TRAIN_TOL = 1e-3
TRAIN_PARAM_TOL = 1e-2
TRAIN_LEAF_TOL = 0.1
# the D3QL agent, card vs CPU: Q relative to its largest magnitude; each
# update's loss, relative; a greedy action may differ only where the two
# best Q-values of that row lie within AGENT_TIE_TOL of max|Q| (a near-tie
# that float32 rounding can order either way)
AGENT_Q_TOL = 1e-5
AGENT_LOSS_TOL = 1e-4
AGENT_TIE_TOL = 1e-5
TIMED_RUNS = 25


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def card_info():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}")
    return smi


# -- timing -------------------------------------------------------------------

def device_ms(fn, runs: int = TIMED_RUNS, reps: int = 10,
              sleep_cycles: int = 20_000_000, before=None) -> float:
    """Device time of one ``fn()`` call, in ms: the median over ``runs``
    samples, each ``reps`` back-to-back calls between two CUDA events,
    divided by ``reps``.  Before each sample the stream sleeps
    (``sleep_cycles`` clock cycles, about 1 ms per 2e6) long enough for the
    host to enqueue all ``reps`` calls, so the events bracket device work,
    not the host's launch path; ``before()``, if given, runs after the
    sleep and outside the events (an L2 flush)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        if before is not None:
            before()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, exps: float = 0.0,
             tf32_flops: float = 0.0):
    """The least time of the work, in ms, and what bounds it: its bytes at
    the memory rate, or its operations, float32 ``flops`` on the CUDA
    cores, ``tf32_flops`` on the tensor cores and ``exps`` exponentials on
    the special-function units, which run side by side (the largest of
    the three counts)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, exps / PEAK_SFU_PER_S,
                tf32_flops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------

def _randn(gen, *shape, scale=1.0):
    import torch
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def adaln_inputs(gen, b, s, d, epilogue, offset=0):
    """Main-path operands: modulation as (B, 1, d) chunks of one (B, 1, 6d)
    projection, as the DiT layer passes them; ``offset`` floats into a
    wider projection, so that the chunks are not 16-byte aligned."""
    x = _randn(gen, b, s, d)
    mods = _randn(gen, b, 1, 6 * d + offset, scale=0.1)[..., offset:]
    sh, sc, g = mods.chunk(6, dim=-1)[:3]
    w = 1.0 + _randn(gen, d, scale=0.1)
    bias = _randn(gen, d, scale=0.1)
    extra = (g, _randn(gen, b, s, d)) if epilogue else ()
    return (x, sh, sc, w, bias) + extra


# (B, S, d, offset of the modulation chunks in floats): the DiT at B in
# {1, 4, 8}, the reduced DiT, d = 100 (16-byte loads), d = 99 (no multiple
# of 4) and the DiT's width with unaligned modulation (single floats), rows
# wider than 1024 floats (16-byte loads; single floats four and eight a
# thread)
ADALN_CASES = [(1, 256, 768, 0), (4, 256, 768, 0), (8, 256, 768, 0),
               (4, 16, 64, 0), (3, 5, 100, 0), (3, 5, 99, 0),
               (4, 256, 768, 1), (2, 8, 3000, 0), (2, 8, 2001, 0),
               (2, 7, 3001, 0)]


def check_adaln(gen):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adaln_norm import launch_shape, load_width
    worst = {"adaln_norm": 0.0, "adaln_norm_epilogue": 0.0}
    for (b, s, d, offset) in ADALN_CASES:
        for epilogue in (False, True):
            args = adaln_inputs(gen, b, s, d, epilogue, offset)
            got = ops.adaln_norm(*args)
            # no atomics: a second call gives the same bits
            again = ops.adaln_norm(*args)
            flat = [a.reshape(b, d) if a.dim() == 3 and a.shape[1] == 1
                    else a for a in args]
            want = ref.adaln_norm(*flat)
            pairs = list(zip(got, want)) if epilogue else [(got, want)]
            err = max(float((g - w).abs().max()) for g, w in pairs)
            same = all(torch.equal(g, a) for g, a in (
                zip(got, again) if epilogue else [(got, again)]))
            width = load_width(*flat)
            threads, vpt = launch_shape(d, width)
            name = "adaln_norm_epilogue" if epilogue else "adaln_norm"
            print(f"{name:20s} B={b} S={s} d={d} modulation offset "
                  f"{offset}: {4 * width}-byte loads, {threads} threads x "
                  f"{vpt}; max|kernel - plain| = {err:.3e}; a second call "
                  f"bit-identical: {same}")
            assert err <= TOL, f"{name} disagrees with its plain version"
            assert same, f"{name} is not deterministic"
            worst[name] = max(worst[name], err)
    return worst


ATTN_CASES = [
    # (B, Sq, Sk, H, KH, D, causal, window, q_offset)
    (1, 256, 256, 12, 12, 64, False, 0, 0),     # full-width gdm-dit
    (4, 256, 256, 12, 12, 64, False, 0, 0),
    (8, 256, 256, 12, 12, 64, False, 0, 0),
    (4, 16, 16, 4, 4, 16, False, 0, 0),         # reduced gdm-dit
    (2, 200, 200, 8, 8, 64, True, 0, 0),        # causal, ragged tiles
    (2, 160, 160, 8, 8, 64, True, 48, 0),       # causal sliding window
    (2, 96, 96, 4, 4, 32, False, 24, 0),        # window without causal
    (2, 64, 256, 8, 8, 64, True, 0, 192),       # chunked prefill: q_offset
    (2, 128, 128, 12, 4, 64, True, 0, 0),       # GQA, 3 query heads per kv
    (1, 100, 100, 8, 1, 64, False, 0, 0),       # multi-query
    (3, 100, 77, 6, 6, 64, False, 0, 0),        # ragged Sk != Sq
    (2, 128, 128, 8, 8, 128, True, 0, 0),       # head_dim 128
    (2, 33, 3, 4, 2, 16, False, 0, 0),          # fewer keys than one tile
    (2, 100, 77, 8, 2, 128, True, 0, 0),        # D=128, Sk no multiple of
                                                # its 32-key tile, GQA
    (2, 48, 112, 4, 2, 16, True, 24, 64),       # D=16, window + q_offset
    (1, 70, 90, 4, 4, 64, True, 0, -20),        # rows with every key masked
    (2, 40, 50, 2, 2, 32, False, 8, 30),        # window: late rows see none
]


def check_attention(gen):
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for (b, sq, sk, h, kh, d, causal, window, q_offset) in ATTN_CASES:
        q = _randn(gen, b, sq, h, d)
        k = _randn(gen, b, sk, kh, d)
        v = _randn(gen, b, sk, kh, d)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        err = float((ops.flash_attention(q, k, v, **kw)
                     - ref.attention(q, k, v, **kw)).abs().max())
        print(f"flash_attention B={b} Sq={sq} Sk={sk} H={h} KH={kh} D={d} "
              f"causal={causal} window={window} q_offset={q_offset}: "
              f"max|kernel - plain| = {err:.3e}")
        assert err <= TOL, "flash_attention disagrees with its plain version"
        worst = max(worst, err)
    return worst


DECODE_CASES = [
    # (B, S, H, KH, D, lengths)
    (1, 24, 32, 4, 128, [9]),                       # the launcher's decode
    (1, 24, 32, 4, 128, [0]),                       # every score masked
    (1, 24, 32, 4, 128, [24]),
    (1, 4096, 32, 4, 128, [1]),
    (1, 4096, 32, 4, 128, [4096]),
    (8, 24, 32, 4, 128, [0, 1, 24, 7, 23, 30, 12, 2]),
    (8, 4096, 32, 4, 128, [0, 1, 4096, 4095, 2049, 300, 5000, 64]),
    (8, 4096, 8, 8, 64, [0, 1, 4096, 1000, 17, 3000, 4097, 2]),   # G=1
    (3, 24, 4, 2, 16, [0, 1, 24]),                  # reduced yi-6b
    (2, 24, 4, 4, 16, [5, 24]),                     # reduced qwen1.5-4b
    (2, 777, 16, 4, 32, [777, 100]),                # G=4, D=32
    (2, 1, 32, 4, 128, [1, 0]),                     # S = 1
    (4, 63, 32, 4, 128, [31, 32, 33, 63]),          # tile edges, one split
    (3, 65, 32, 4, 128, [0, 64, 65]),               # a last tile of 1 key
    (4, 129, 32, 4, 128, [64, 65, 66, 129]),        # split edge at 65
    (3, 200, 8, 2, 64, [67, 134, 135]),             # 3 splits x 4 groups
]


def check_decode(gen):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for (b, s, h, kh, d, lengths) in DECODE_CASES:
        q = _randn(gen, b, h, d)
        k = _randn(gen, b, s, kh, d)
        v = _randn(gen, b, s, kh, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = ops.decode_attention(q, k, v, lens)
        same = torch.equal(got, ops.decode_attention(q, k, v, lens))
        err = float((got - ref.decode_attention(q, k, v, lens)).abs().max())
        splits, groups = decode_grid(b * kh, h // kh, s, sms)
        print(f"decode_attention B={b} S={s} H={h} KH={kh} D={d} lengths="
              f"{lengths}: {splits} splits x {groups} head groups; "
              f"max|kernel - plain| = {err:.3e}; a second call "
              f"bit-identical: {same}")
        assert err <= TOL, "decode_attention disagrees with its plain version"
        assert same, "decode_attention is not deterministic"
        worst = max(worst, err)
    return worst


# (rows, d, offset of x in floats): the decode row and the trainer's rows
# of yi-6b and Jamba (d = 4096), qwen1.5-4b's width, the widest row, rows
# of a few floats; x a view one float into its buffer (single floats, also
# four and eight a thread), and d = 99 (no multiple of 4)
RMS_CASES = [(1, 4096, 0), (8192, 4096, 0), (1024, 4096, 0), (1, 2560, 0),
             (8192, 2560, 0), (1000, 4096, 0), (24, 64, 0), (7, 8192, 0),
             (5, 100, 0), (1, 4096, 1), (1024, 4096, 1), (3, 8192, 1),
             (5, 99, 0)]


def check_rmsnorm(gen):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import launch_shape, load_width
    worst = 0.0
    for rows, d, offset in RMS_CASES:
        x = _randn(gen, rows * d + offset)[offset:].view(rows, d)
        w = 1.0 + _randn(gen, d, scale=0.1)
        got = ops.rmsnorm(x, w)
        same = torch.equal(got, ops.rmsnorm(x, w))
        err = float((got - ref.rmsnorm(x, w)).abs().max())
        width = load_width(x, w)
        threads, vpt = launch_shape(d, width)
        print(f"rmsnorm rows={rows} d={d} x offset {offset}: {4 * width}-byte "
              f"loads, {threads} threads x {vpt}; max|kernel - plain| = "
              f"{err:.3e}; a second call bit-identical: {same}")
        assert err <= TOL, "rmsnorm disagrees with its plain version"
        assert same, "rmsnorm is not deterministic"
        worst = max(worst, err)
    return worst


def _rel(got, want):
    """max|got - want| and that over max|want|."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def scan_inputs(gen, b, length, din, n):
    """Operands as a Mamba block makes them: dt a softplus, A = -exp of the
    S4D-real log (spread per channel), u, B, C, D ~ N(0, 1)."""
    import torch
    u = _randn(gen, b, length, din)
    dt = torch.nn.functional.softplus(_randn(gen, b, length, din) - 2.0)
    a = -(torch.arange(1, n + 1, dtype=torch.float32, device="cuda")
          .repeat(din, 1)
          * (0.5 + torch.rand(din, 1, generator=gen, device="cuda")))
    return [u, dt, a.contiguous(), _randn(gen, b, length, n),
            _randn(gen, b, length, n), _randn(gen, din)]


# (B, L, Din, N): the training shape (one Jamba Mamba layer at global batch
# 8, seq 128), B = 1, L = 1, an L no multiple of any tile, a Din no
# multiple of a block, the reduced Jamba mixer, a tiny ragged N; Dins
# that fill no whole warp (100 and 300 channels), Dins no multiple of 4
# (single-float copies of u and dt), and N = 1, 4, 8 and 12 (a lane's
# states mostly padding)
SCAN_CASES = [(8, 128, 8192, 16), (1, 128, 8192, 16), (8, 1, 8192, 16),
              (2, 37, 8192, 16), (2, 128, 8200, 16), (2, 16, 128, 8),
              (3, 19, 100, 5), (2, 40, 100, 16), (2, 37, 300, 1),
              (2, 20, 200, 4), (2, 33, 520, 8), (2, 21, 99, 16),
              (1, 18, 130, 12)]


def check_ssm_scan(gen):
    """Forward kernel (y and h_final) and backward kernel (all six
    gradients) against the plain scan and autograd through it, on the
    card.  Returns the largest absolute errors of the forward and of the
    backward."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward_cuda,
                                              ssm_scan_cuda)
    worst = {"ssm_scan": 0.0, "ssm_scan_backward": 0.0}
    for (b, length, din, n) in SCAN_CASES:
        ins = scan_inputs(gen, b, length, din, n)
        y, hf, states = ssm_scan_cuda(*ins, return_state=True,
                                      save_states=True)
        fwd_same = all(torch.equal(x, z) for x, z in zip(
            (y, hf, states), ssm_scan_cuda(*ins, return_state=True,
                                           save_states=True)))
        wy, wh = ref.ssm_scan(*ins)
        (ey, ry), (eh, rh) = _rel(y, wy), _rel(hf, wh)
        gy = _randn(gen, b, length, din)
        got = ssm_scan_backward_cuda(*ins, states, gy)
        leaves = [t.clone().requires_grad_() for t in ins]
        want = torch.autograd.grad(ref.ssm_scan(*leaves)[0], leaves, gy)
        gerr = [_rel(g, w) for g, w in zip(got, want)]
        # no atomics: a second call on the same inputs gives the same bits
        again = ssm_scan_backward_cuda(*ins, states, gy)
        same = all(torch.equal(x, z) for x, z in zip(got, again))
        print(f"ssm_scan B={b} L={length} Din={din} N={n}: y {ey:.3e} (rel "
              f"{ry:.3e}), h_final {eh:.3e} (rel {rh:.3e}); backward vs "
              "autograd rel " + ", ".join(
                  f"{name} {r:.2e}" for name, (_, r) in zip(
                      ("du", "ddt", "dA", "dB", "dC", "dD"), gerr))
              + f"; a second call bit-identical: forward {fwd_same}, "
              f"backward {same}")
        assert max(ry, rh) <= SCAN_TOL, \
            "ssm_scan disagrees with its plain version"
        assert max(r for _, r in gerr) <= SCAN_TOL, \
            "ssm_scan_backward disagrees with autograd of the plain scan"
        assert fwd_same, "ssm_scan is not deterministic"
        assert same, "ssm_scan_backward is not deterministic"
        worst["ssm_scan"] = max(worst["ssm_scan"], ey, eh)
        worst["ssm_scan_backward"] = max(worst["ssm_scan_backward"],
                                         *(e for e, _ in gerr))
    return worst


def check_kernel_grads(gen):
    """The gradients flash_attention and rmsnorm carry on the card (their
    autograd functions) against autograd of the plain versions, at the
    training shapes (Jamba's heads at B=8, S=128; 1024 rows of 4096)."""
    import torch
    from repro_torch.kernels import ops, ref
    q = _randn(gen, 8, 128, 32, 128).requires_grad_()
    k = _randn(gen, 8, 128, 8, 128).requires_grad_()
    v = _randn(gen, 8, 128, 8, 128).requires_grad_()
    do = _randn(gen, 8, 128, 32, 128)
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(ref.attention(q, k, v), (q, k, v), do)
    errs = [_rel(g, w)[1] for g, w in zip(got, want)]
    x = _randn(gen, 8, 128, 4096).requires_grad_()
    w = (1.0 + _randn(gen, 4096, scale=0.1)).requires_grad_()
    dy = _randn(gen, 8, 128, 4096)
    got = torch.autograd.grad(ops.rmsnorm(x, w), (x, w), dy)
    want = torch.autograd.grad(ref.rmsnorm(x, w), (x, w), dy)
    errs_rms = [_rel(g, ww)[1] for g, ww in zip(got, want)]
    print("flash_attention gradients (B=8, S=128, H=32, KH=8, D=128, causal) "
          "vs autograd of the plain version, rel: dq {:.2e}, dk {:.2e}, dv "
          "{:.2e}".format(*errs))
    print("rmsnorm gradients (1024 x 4096) vs autograd of the plain "
          "version, rel: dx {:.2e}, dscale {:.2e}".format(*errs_rms))
    assert max(errs + errs_rms) <= GRAD_TOL, \
        "a kernel's gradient disagrees with autograd of its plain version"


# -- phase 4: times -------------------------------------------------------------

def launch_floor_ms() -> float:
    """The card's launch-to-launch gap in ``device_ms``: a one-element
    ``zero_``, beside which the tiny kernels' times are read."""
    import torch
    z = torch.zeros(1, device="cuda")
    t = device_ms(z.zero_)
    print(f"launch floor: a one-element zero_ takes {t:.7f} ms in the same "
          "harness")
    return t


def time_adaln(gen, b, s, d):
    """Both adaLN variants at the DiT's shape (B, S, d), with
    ``F.layer_norm`` on the same x printed as the nearest PyTorch call (it
    leaves out the modulation and the residual, so no variant has a
    library time)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    out = {}
    for epilogue in (False, True):
        name = "adaln_norm_epilogue" if epilogue else "adaln_norm"
        args = adaln_inputs(gen, b, s, d, epilogue)
        flat = [a.reshape(b, d) if a.dim() == 3 and a.shape[1] == 1 else a
                for a in args]
        rows = b * s * d
        nbytes = 4 * ((4 if epilogue else 2) * rows
                      + (3 if epilogue else 2) * b * d + 2 * d)
        flops = (12 if epilogue else 10) * rows
        t_bound, by = bound_ms(nbytes, flops)
        out[name] = dict(
            ms=device_ms(lambda: ops.adaln_norm(*args)),
            plain_ms=device_ms(lambda: ref.adaln_norm(*flat)),
            bound_ms=t_bound, bound_by=by, library_ms=None)
        got, want = ops.adaln_norm(*args), ref.adaln_norm(*flat)
        out[name]["err"] = float(((got[0] - want[0]) if epilogue
                                  else (got - want)).abs().max())
        if not epilogue:
            ln_ms = device_ms(lambda: F.layer_norm(args[0], (d,), args[3],
                                                   args[4]))
    for name, t in out.items():
        _print_times(f"{name:20s} B={b} S={s} d={d}", t)
        print(f"  max|kernel - plain| of the timed call: {t.pop('err'):.3e}")
    print(f"F.layer_norm B={b} S={s} d={d} (the nearest PyTorch call, "
          f"without the modulation): {ln_ms:.7f} ms")
    return out


def time_kernels(gen, cfg):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b, s, d = 4, cfg.latent_hw ** 2, cfg.d_model
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    launch_floor_ms()
    time_adaln(gen, 1, s, d)
    out = time_adaln(gen, b, s, d)
    q, k, v = (_randn(gen, b, s, h, hd) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nbytes = 4 * 4 * b * s * h * hd
    t_bound, by = flash_bound(nbytes, b * h * s * s, hd,
                              f"flash_attention B={b} S={s} H={h} D={hd}")
    out["flash_attention"] = dict(
        ms=device_ms(lambda: ops.flash_attention(q, k, v, causal=False)),
        plain_ms=device_ms(lambda: ref.attention(q, k, v, causal=False)),
        bound_ms=t_bound, bound_by=by,
        library_ms=device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    _print_times(f"flash_attention      B={b} S={s} d={d}",
                 out["flash_attention"])
    return out


def flash_bound(nbytes, pairs, d, what):
    """flash_attention's least time on its route: 4 d flops per unmasked
    (query, key) pair, each a 3xTF32 product (three TF32 ones) on the
    tensor cores, one exponential per pair, or the bytes.  The bound of
    the float32 CUDA-core route (the products as float32 FMAs) is printed
    beside it."""
    flops = 4 * pairs * d
    t_bound, by = bound_ms(nbytes, 0.0, pairs, 3 * flops)
    t_old, by_old = bound_ms(nbytes, flops, pairs)
    print(f"{what}: {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB; bound "
          f"on the 3xTF32 tensor-core route {t_bound:.7f} ms ({by}), on "
          f"the float32 CUDA-core route {t_old:.7f} ms ({by_old})")
    return t_bound, by


def _print_times(what, t):
    lib = "n/a: no single PyTorch call computes it" \
        if t["library_ms"] is None else f"{t['library_ms']:.7f} ms"
    print(f"{what}: kernel {t['ms']:.7f} ms, plain {t['plain_ms']:.7f} ms, "
          f"bound {t['bound_ms']:.7f} ms ({t['bound_by']}), library {lib}")


def time_decode(gen, b, s, length, cold=False):
    """decode_attention at yi-6b's heads, every row ``length`` long, against
    ``scaled_dot_product_attention`` (GQA, boolean length mask).  The bound
    counts the cache rows these lengths read.  With ``cold``, one call is
    also timed with L2 flushed before it by a 64 MB write (the served step
    streams the weights between two layers' attention), beside one warm
    call in the same single-call harness."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    h, kh, d = 32, 4, 128
    q = _randn(gen, b, h, d)
    k = _randn(gen, b, s, kh, d)
    v = _randn(gen, b, s, kh, d)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    qt = q[:, :, None].contiguous()                       # (B, H, 1, D)
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]                         # (B, 1, 1, S)
    rows = b * min(length, s)
    nbytes = 4 * (2 * b * h * d + 2 * rows * kh * d + b)
    t_bound, by = bound_ms(nbytes, 4 * rows * h * d)
    t = dict(
        ms=device_ms(lambda: ops.decode_attention(q, k, v, lens)),
        plain_ms=device_ms(lambda: ref.decode_attention(q, k, v, lens)),
        bound_ms=t_bound, bound_by=by,
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    what = f"decode_attention B={b} S={s} lengths={length} H={h} KH={kh} " \
           f"D={d}"
    _print_times(what, t)
    err = float((ops.decode_attention(q, k, v, lens)
                 - ref.decode_attention(q, k, v, lens)).abs().max())
    print(f"  max|kernel - plain| of the timed call: {err:.3e}")
    if cold:
        t["warm1_ms"], t["cold1_ms"] = one_call_ms(
            lambda: ops.decode_attention(q, k, v, lens), what)
    return t


def one_call_ms(fn, what):
    """``fn``'s device time one call at a time (each between its own
    events, the stream idle before it): warm, and with L2 flushed by a 64
    MB write before each call, as the served decode step finds its
    operands after streaming a layer's weights."""
    import torch
    flush = torch.empty(16 << 20, device="cuda")          # 64 MB
    one = dict(reps=1, runs=2 * TIMED_RUNS, sleep_cycles=2_000_000)
    warm1 = device_ms(fn, **one)
    cold1 = device_ms(fn, before=flush.zero_, **one)
    del flush
    print(f"{what}, one call at a time: warm {warm1:.7f} ms, L2 flushed "
          f"by a 64 MB write before each call {cold1:.7f} ms")
    return warm1, cold1


def time_rmsnorm(gen, rows, d, cold=False, plain=True):
    """rmsnorm on ``rows`` rows of ``d`` against ``F.rms_norm``; with
    ``cold``, one call at a time also with L2 flushed (``one_call_ms``);
    without ``plain``, the kernel alone (``--kernel-times``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    x = _randn(gen, rows, d)
    w = 1.0 + _randn(gen, d, scale=0.1)
    t_bound, by = bound_ms(4 * (2 * rows * d + d), 4 * rows * d)
    t = dict(ms=device_ms(lambda: ops.rmsnorm(x, w)),
             plain_ms=device_ms(lambda: ref.rmsnorm(x, w)) if plain else None,
             bound_ms=t_bound, bound_by=by,
             library_ms=device_ms(lambda: F.rms_norm(x, (d,), w, eps=1e-6))
             if plain else None)
    what = f"rmsnorm rows={rows} d={d}"
    if plain:
        _print_times(what, t)
    else:
        print(f"{what}: kernel {t['ms']:.7f} ms, bound {t_bound:.7f} ms "
              f"({by})")
    if cold:
        t["warm1_ms"], t["cold1_ms"] = one_call_ms(
            lambda: ops.rmsnorm(x, w), what)
    return t


def time_ssm_scan(gen, plain=True):
    """Both scan kernels at the training shape (B=8, L=128, Din=8192,
    N=16), as the training path calls them: the forward saving its
    chunk-start states, the backward from them.  The plain versions are
    the 128-step loop and autograd's backward through it (not timed
    without ``plain``); no single PyTorch call computes a selective
    scan."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward_cuda,
                                              ssm_scan_cuda)
    b, length, din, n = SCAN_CASES[0]
    ins = scan_inputs(gen, b, length, din, n)
    _, _, states = ssm_scan_cuda(*ins, save_states=True)
    gy = _randn(gen, b, length, din)
    rows, small = b * length * din, b * length * n
    exps = rows * n                 # one exp(dt * a) per (b, t, d, n)
    # forward: u, dt read, y written, B, C, A, D read once; per (b, t, d,
    # n) one exponential and 6 flops (dt*a, da*h, the dt*u*B and the C.h
    # FMAs), 3 flops per (b, t, d)
    t_bound, by = bound_ms(4 * (3 * rows + 2 * small + din * n + din),
                           rows * (6 * n + 3), exps)
    fwd = dict(ms=device_ms(lambda: ssm_scan_cuda(*ins, save_states=True)),
               plain_ms=device_ms(lambda: ref.ssm_scan(*ins), runs=5,
                                  reps=1, sleep_cycles=2_000_000)
               if plain else None,
               bound_ms=t_bound, bound_by=by, library_ms=None)
    fwd_only = device_ms(lambda: ssm_scan_cuda(*ins))
    # backward: u, dt, dy, B, C, A, D read, du, ddt, dA, dB, dC, dD written;
    # per (b, t, d, n) the reverse scan's exponential and 16 flops (the
    # forward's recomputation not counted), 6 flops per (b, t, d)
    t_bound, by = bound_ms(4 * (5 * rows + 4 * small + 2 * (din * n + din)),
                           rows * (16 * n + 6), exps)
    bwd = dict(ms=device_ms(lambda: ssm_scan_backward_cuda(*ins, states,
                                                           gy)),
               plain_ms=None, bound_ms=t_bound, bound_by=by, library_ms=None)
    if plain:
        leaves = [t.clone().requires_grad_() for t in ins]
        y_plain = ref.ssm_scan(*leaves)[0]
        bwd["plain_ms"] = device_ms(lambda: torch.autograd.grad(
            y_plain, leaves, gy, retain_graph=True), runs=5, reps=1,
            sleep_cycles=2_000_000)
        del y_plain, leaves
    what = f"B={b} L={length} Din={din} N={n}"
    print(f"ssm_scan {what}: {exps / 1e6:.1f} M exponentials take "
          f"{exps / PEAK_SFU_PER_S * 1e3:.7f} ms on the special-function "
          f"units; the forward's bytes {4 * 3 * rows / 1e6:.1f} MB (u, dt, "
          f"y) take {4 * 3 * rows / PEAK_BYTES_PER_S * 1e3:.7f} ms, the "
          f"backward's {4 * 5 * rows / 1e6:.1f} MB (u, dt, dy, du, ddt) "
          f"{4 * 5 * rows / PEAK_BYTES_PER_S * 1e3:.7f} ms")
    if plain:
        _print_times(f"ssm_scan {what} (saving states)", fwd)
        # the same call at N = 8: what the other half of the exponentials
        # costs at the margin, against the special-function units' rate
        half = scan_inputs(gen, b, length, din, n // 2)
        t_half = device_ms(lambda: ssm_scan_cuda(*half))
        rate = (exps - exps // 2) / ((fwd_only - t_half) * 1e-3)
        print(f"ssm_scan {what[:-4]}N={n // 2} without states: "
              f"{t_half:.7f} ms; N={n}'s other {(exps - exps // 2) / 1e6:.1f}"
              f" M exponentials add {fwd_only - t_half:.7f} ms: {rate:.3e} "
              f"a second, {rate / PEAK_SFU_PER_S:.1%} of the units' "
              f"{PEAK_SFU_PER_S:.3e}")
        del half
    print(f"ssm_scan {what} saving states: {fwd['ms']:.7f} ms; without "
          f"states (the prefill's call): {fwd_only:.7f} ms")
    if plain:
        _print_times(f"ssm_scan_backward {what}", bwd)
    print(f"ssm_scan_backward {what}: {bwd['ms']:.7f} ms")
    fwd["no_states_ms"] = fwd_only
    return {"ssm_scan": fwd, "ssm_scan_backward": bwd}


def time_mamba_block():
    """Device time of one full-width Jamba Mamba block forward
    (``nn.ssm.mamba_apply``, d_model 4096, d_inner 8192, N 16) at B=8,
    L=128, the trainer's shape, with random weights: the layer the forward
    scan serves."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.nn.ssm import Mamba, mamba_apply
    cfg = get_config("jamba-v0.1-52b")
    block = Mamba(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn(8, 128, cfg.d_model, generator=gen, device="cuda")
    with torch.no_grad():
        t = device_ms(lambda: mamba_apply(block, x, cfg=cfg), runs=10,
                      reps=2, sleep_cycles=40_000_000)
    del block, x
    return t


def time_training_kernels(gen):
    """flash_attention and rmsnorm at the training shapes, forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b, s, h, kh, d = 8, 128, 32, 8, 128
    q = _randn(gen, b, s, h, d)
    k, v = _randn(gen, b, s, kh, d), _randn(gen, b, s, kh, d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = s * (s + 1) // 2                   # causal (query, key) pairs
    t_bound, by = flash_bound(4 * 2 * (b * s * h * d + b * s * kh * d),
                              b * h * pairs, d,
                              f"flash_attention B={b} S={s} H={h} KH={kh} "
                              f"D={d} causal")
    attn = dict(ms=device_ms(lambda: ops.flash_attention(q, k, v)),
                plain_ms=device_ms(lambda: ref.attention(q, k, v)),
                bound_ms=t_bound, bound_by=by,
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)))
    _print_times(f"flash_attention B={b} S={s} H={h} KH={kh} D={d} causal",
                 attn)
    return {"flash_attention": attn, "rmsnorm": time_rmsnorm(gen, b * s,
                                                              4096)}


def time_block_call(cfg, model):
    """Device time of one full-width block call at B=4 (one DDIM step of
    the whole DiT), for the breakdown against the kernels' times."""
    import torch
    from repro_torch.models.gdm import (LATENT_CHANNELS, make_schedule,
                                        run_block_batched)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lat = torch.randn(4, cfg.latent_hw ** 2, LATENT_CHANNELS, generator=gen,
                      device="cuda")
    prompt = torch.randint(2, cfg.vocab_size, (4, 8), generator=gen,
                           device="cuda")
    idx = torch.zeros(4, dtype=torch.long, device="cuda")
    sched = make_schedule(4, device="cuda")
    with torch.no_grad():
        return device_ms(lambda: run_block_batched(
            model, lat, prompt, sched, idx, steps_per_block=1, total_steps=4),
            runs=5, reps=1, sleep_cycles=60_000_000)


# -- phase 5: one block call, card vs CPU ----------------------------------------

def step_vs_cpu(cfg):
    import torch
    from repro_torch.models.gdm import (DiT, LATENT_CHANNELS, init_gdm,
                                        make_schedule, run_block_batched)
    model = init_gdm(cfg, seed=11, device="cuda")
    cpu_model = DiT(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn(1, cfg.latent_hw ** 2, LATENT_CHANNELS, generator=gen)
    prompt = torch.randint(2, cfg.vocab_size, (1, 8), generator=gen)
    idx = torch.tensor([1])
    outs = {}
    with torch.no_grad():
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            outs[dev] = [t.cpu() for t in run_block_batched(
                m, lat.to(dev), prompt.to(dev), make_schedule(4, device=dev),
                idx.to(dev), steps_per_block=1, total_steps=4)]
    for i, what in enumerate(("latent", "x0")):
        got, want = outs["cuda"][i], outs["cpu"][i]
        assert torch.isfinite(got).all(), f"non-finite {what} on the card"
        err = float((got - want).abs().max())
        print(f"run_block_batched B=1 full width, {what}: max|card - cpu| = "
              f"{err:.3e} (|{what}| max {float(want.abs().max()):.3f}, "
              f"tolerance {STEP_TOL})")
        assert err <= STEP_TOL, f"{what} on the card disagrees with the CPU"
    return model


# -- phase 6: serve ----------------------------------------------------------------

def serve(cfg, frames_min: int = 16):
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import (engine_from_scenario, make_gdm_services,
                                     serve_trace)
    from repro_torch.sim import get_scenario, request_trace
    num_services, num_blocks, spb = 3, cfg.gdm_blocks, 1
    scen = get_scenario("paper-fig3")
    frames = max(frames_min, scen.horizon)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    services, omega = make_gdm_services(num_services, 0,
                                        num_blocks=num_blocks,
                                        steps_per_block=spb, model_cfg=cfg,
                                        device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    for s, row in enumerate(omega):
        print(f"service {s}: Omega(0..{num_blocks}) = "
              + ", ".join(f"{x:.6f}" for x in row))
    engine, _ = engine_from_scenario(scen, services)
    trace = request_trace(scen, frames, seed=0)
    t0 = time.perf_counter()
    out = serve_trace(engine, trace, services, seed=0)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    calls = {s: svc.batch_calls for s, svc in services.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"paper-fig3, {frames} frames: submitted {out['submitted']}, "
          f"completed {out['completed']}, mean latency "
          f"{out['mean_latency_frames']:.3f} frames, p95 "
          f"{out['p95_latency_frames']:.3f} frames, batch_calls {calls}")
    print(f"wall clock: services + Omega {t_build:.2f} s, serving "
          f"{t_serve:.2f} s; peak device memory {peak / 2**30:.3f} GiB")
    assert out["completed"] > 0, "the served trace completed nothing"
    for req in engine.completed:
        for key in ("latent", "x0"):
            arr = req.state[key]
            assert arr.shape == (cfg.latent_hw ** 2, 4), (key, arr.shape)
            assert np.isfinite(arr).all(), f"non-finite {key} served"
    forwards = spb * (sum(calls.values()) + num_services * num_blocks)
    expected = dict.fromkeys(LAUNCHES, 0)
    expected.update(adaln_norm=cfg.num_layers * forwards,
                    adaln_norm_epilogue=cfg.num_layers * forwards,
                    flash_attention=cfg.num_layers * forwards)
    print(f"kernel launches {launches}; expected {expected} "
          f"(L={cfg.num_layers} x {forwards} DiT forwards)")
    assert launches == expected, "the main path did not run the kernels " \
        "exactly once per DiT layer"
    return launches


# -- phase 7: LM steps, card vs CPU ---------------------------------------------

def _state_tensors(state):
    """Every tensor of a decode state, slot by slot (KV caches and their
    lengths, Mamba conv tails and SSM states), on the CPU."""
    return [t.cpu() for slot in state for key in sorted(slot)
            for t in slot[key]]


def lm_vs_cpu(cfg, prompt_len: int = 16, steps: int = 4, model=None):
    """One prefill and ``steps`` greedy decode steps of ``cfg`` on the card
    and on the CPU from the same weights (``model``'s, or drawn from a
    seed): the largest gaps in logits and in the decode state, relative to
    the largest |logit| and |state value|, and the token streams."""
    import torch
    from repro_torch.models.lm import (LM, init_lm, lm_decode_step,
                                       lm_prefill)
    model = model if model is not None else init_lm(cfg, seed=11,
                                                    device="cuda")
    cpu_model = LM(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(2, cfg.vocab_size, (1, prompt_len), generator=gen,
                           dtype=torch.int32)
    runs = {}
    with torch.no_grad():
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            logits, state = lm_prefill(m, prompt.to(dev),
                                       max_seq=prompt_len + steps + 4)
            outs, tokens = [logits[:, -1]], []
            for _ in range(steps):
                tok = outs[-1][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                tokens.append(int(tok[0]))
                logits, state = lm_decode_step(m, tok, state)
                outs.append(logits)
            runs[dev] = ([o.cpu() for o in outs], tokens,
                         _state_tensors(state))
    del cpu_model
    (g_out, g_tok, g_state), (c_out, c_tok, c_state) = \
        runs["cuda"], runs["cpu"]
    for o in g_out:
        assert torch.isfinite(o).all(), "non-finite logits on the card"
    scale = max(float(o[:, :cfg.vocab_size].abs().max()) for o in c_out)
    gap = max(float((g[:, :cfg.vocab_size] - c[:, :cfg.vocab_size])
                    .abs().max()) for g, c in zip(g_out, c_out))
    floats = [(g, c) for g, c in zip(g_state, c_state) if c.is_floating_point()]
    st_scale = max(float(c.abs().max()) for _, c in floats)
    st_gap = max(float((g - c).abs().max()) for g, c in floats)
    print(f"{cfg.name}, {cfg.num_layers} layers, vocab {cfg.vocab_size}: "
          f"prefill {prompt_len} + {steps} decode steps; max|card - cpu| "
          f"logits {gap:.3e} (max|logit| {scale:.3f}, relative "
          f"{gap / scale:.3e}), decode state {st_gap:.3e} (max "
          f"{st_scale:.3f}, relative {st_gap / st_scale:.3e}); tolerance "
          f"{LM_TOL} relative")
    print(f"greedy tokens: card {g_tok}, cpu {c_tok}")
    assert gap / scale <= LM_TOL, "logits on the card disagree with the CPU"
    assert st_gap / st_scale <= LM_TOL, "decode state on the card disagrees"
    assert g_tok == c_tok, "greedy tokens differ between card and CPU"
    for g, c in zip(g_state, c_state):
        if not c.is_floating_point():
            assert torch.equal(g, c), "cache lengths differ"


# -- phase 8: serve the edge launcher at full width --------------------------------

def time_decode_step(lm):
    """The two sides of one decode step (B=1): the host's time to enqueue
    it, from an idle card (median of 5), and the card's time to run it
    with no host in the way, as a replay of a CUDA graph of the step
    (``device_ms``).  The graph is a measuring device only: the launcher
    runs the step eagerly."""
    import torch
    from repro_torch.models.lm import init_decode_state, lm_decode_step
    state = init_decode_state(lm.cfg, 1, 64, device="cuda")
    tok = torch.full((1,), 7, dtype=torch.int32, device="cuda")
    host = []
    with torch.no_grad():
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_decode_step(lm, tok, state)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            lm_decode_step(lm, tok, state)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            lm_decode_step(lm, tok, state)
        dev = device_ms(graph.replay, runs=5, reps=1, sleep_cycles=2_000_000)
    return dev, statistics.median(host[3:]) * 1e3


def serve_launcher(lm_cfg, gdm_cfg):
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models.gdm import init_gdm
    from repro_torch.models.lm import init_lm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = init_lm(lm_cfg, seed=1, device="cuda")
    dit = init_gdm(gdm_cfg, seed=2, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in lm.parameters())
    # a decode step reads every weight but the embedding table (one row)
    step_bytes = weights - lm.embed.table.numel() * 4
    counters = serve.Counters(step_events=[])
    frames, requests = 24, 16
    reset_launches()
    t0 = time.perf_counter()
    stats, engine = serve.run(gdm=dit, lm=lm, frames=frames,
                              requests=requests, nodes=4, blocks=4,
                              tokens_per_block=4, steps_per_block=2, seed=0,
                              device="cuda", counters=counters)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    step_ms = statistics.median(a.elapsed_time(b)
                                for a, b in counters.step_events)
    peak = torch.cuda.max_memory_allocated()
    done = {svc: [r for r in engine.completed if r.service == svc]
            for svc in (0, 1)}
    print(f"yi-6b: {lm_cfg.num_layers} layers, {weights / 1e9:.2f} GB of "
          f"weights on the card; gdm-dit: {gdm_cfg.num_layers} layers; "
          f"built in {t_build:.2f} s")
    print(f"served {stats['completed']} / {requests} (GDM "
          f"{len(done[0])}, LM {len(done[1])}), mean quality "
          f"{stats['mean_quality']:.6f}, mean latency "
          f"{stats['mean_latency_frames']:.6f} frames, objective "
          f"{stats['objective']:.6f}, over {frames} frames")
    print(f"LM tokens decoded {counters.lm_tokens}, DiT forwards "
          f"{counters.dit_forwards}; wall clock {t_serve:.3f} s")
    print(f"device ms per decode step (median of "
          f"{len(counters.step_events)}, CUDA events): {step_ms:.4f} ms; "
          f"weight-read bound {step_bytes / 1e9:.2f} GB / 3.35 TB/s = "
          f"{step_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (all weights "
          f"{weights / PEAK_BYTES_PER_S * 1e3:.4f} ms)")
    print(f"peak device memory {peak / 2**30:.3f} GiB")
    assert done[0] and done[1], "the launcher completed no request of a service"
    for req in done[1]:
        text = req.state["text"]
        assert len(text) == 1 + 4 * req.blocks_done
        assert all(0 <= t < lm_cfg.vocab_size for t in text)
    for req in done[0]:
        assert req.state["x0"].shape == (1, gdm_cfg.latent_hw ** 2, 4)
        assert torch.isfinite(req.state["x0"]).all(), "non-finite x0 served"
    assert len(counters.step_events) == counters.lm_tokens
    per_fwd = gdm_cfg.num_layers * counters.dit_forwards
    expected = dict.fromkeys(LAUNCHES, 0)
    expected.update(
        adaln_norm=per_fwd, adaln_norm_epilogue=per_fwd,
        flash_attention=per_fwd,
        decode_attention=lm_cfg.num_layers * counters.lm_tokens,
        rmsnorm=(2 * lm_cfg.num_layers + 1) * counters.lm_tokens)
    print(f"kernel launches {launches}; expected {expected}")
    assert launches == expected, "the launcher did not run the kernels " \
        "exactly as its tokens and forwards imply"
    dev_ms, host_ms = time_decode_step(lm)
    print(f"one decode step: {dev_ms:.4f} ms of device time (CUDA graph "
          f"replay, median of 5); the host takes {host_ms:.4f} ms to "
          f"enqueue it eagerly (median of 5)")
    del lm, dit, engine
    torch.cuda.empty_cache()
    return launches


# -- phase 9: a full-width hybrid, card vs CPU --------------------------------------

def _ratio(num: float, den: float) -> float:
    return num / max(den, 1e-30)


def train_vs_cpu(cfg, tcfg, batch_size: int = 2, seq_len: int = 64):
    """``tcfg.total_steps`` train steps of ``cfg`` through
    ``repro_torch.launch.train.run`` on the card and on the CPU, from the
    same weights on the same batches.  Checks the first batch's loss and
    every gradient (autograd of ``lm_loss``), the first step's gradient
    norm and update, every step's loss and the final parameters.  Returns
    the card's model, trained."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import trainable
    from repro_torch.models.lm import LM, init_lm, lm_loss
    from repro_torch.optim.schedules import cosine_decay
    model = init_lm(cfg, seed=11, device="cuda")
    cpu_model = LM(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    models = {"card": model, "cpu": cpu_model}
    p0 = {k: p.detach().clone() for k, p in trainable(cpu_model).items()}
    # run's first batch
    batch = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq_len, global_batch=batch_size,
                                    seed=tcfg.seed)).batch_at(0)
    loss0, grads = {}, {}
    for side, m in models.items():
        params = trainable(m)
        total, _ = lm_loss(m, {k: torch.from_numpy(v).to(m.embed.table.device)
                               for k, v in batch.items()})
        g = torch.autograd.grad(total, list(params.values()))
        loss0[side] = float(total.detach())
        grads[side] = {k: x.cpu() for k, x in zip(params, g)}
    gerr = {k: float((grads["card"][k] - gc).abs().max())
            for k, gc in grads["cpu"].items()}
    grad_rel = {k: _ratio(gerr[k], float(gc.abs().max()))
                for k, gc in grads["cpu"].items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    # the elements whose first update cannot hinge on rounding: a gradient
    # the same on both sides, or 1000 times the leaf's largest gap, so the
    # two sides' Adam directions g / (|g| + eps) agree to 1e-3 of their size
    settled = {k: (grads["card"][k] == gc) | (gc.abs() > 1e3 * gerr[k])
               for k, gc in grads["cpu"].items()}
    del grads

    after1, norm1, runs, secs = {}, {}, {}, {}
    for side, m in models.items():
        def on_step(step, metrics, side=side, m=m):
            if step == 0:
                after1[side] = {k: p.detach().to("cpu", copy=True)
                                for k, p in trainable(m).items()}
                norm1[side] = float(metrics["grad_norm"])
        print(f"train.run on the {side}:")
        t0 = time.perf_counter()
        runs[side] = train.run(cfg, tcfg, global_batch=batch_size,
                              seq_len=seq_len, model=m, log_every=1,
                              on_step=on_step)
        secs[side] = time.perf_counter() - t0

    lr1 = cosine_decay(tcfg.learning_rate, tcfg.warmup_steps,
                       tcfg.total_steps)(1)
    # first update, new minus old, where it is settled: the gap against
    # 1e-2 of the CPU's update plus a float32 rounding of each new value
    upd_worst, n_settled, n_all, n_unit, free_gap = 0.0, 0, 0, 0, 0.0
    for k, mask in settled.items():
        d_cpu = after1["cpu"][k] - p0[k]
        gap = (after1["card"][k] - after1["cpu"][k]).abs()
        slack = 1e-2 * d_cpu.abs() + 2 * torch.finfo(torch.float32).eps \
            * after1["cpu"][k].abs()
        if mask.any():
            upd_worst = max(upd_worst, float(
                (gap[mask] / slack[mask].clamp_min(1e-30)).max()))
        if (~mask).any():
            free_gap = max(free_gap, float(gap[~mask].max()))
        n_settled += int(mask.sum())
        n_all += mask.numel()
        n_unit += int(((d_cpu.abs() - lr1).abs() <= 0.1 * lr1).sum())
    del settled, after1
    finals = {side: {k: p.detach().cpu() for k, p in trainable(m).items()}
              for side, m in models.items()}
    moved_rel = {k: _ratio(float((finals["card"][k] - pc).norm()),
                           float((pc - p0[k]).norm()))
                 for k, pc in finals["cpu"].items()}
    worst_leaf = max(moved_rel, key=moved_rel.get)
    gap_all = math.sqrt(sum(float((finals["card"][k] - pc).square().sum())
                            for k, pc in finals["cpu"].items()))
    moved_all = math.sqrt(sum(float((pc - p0[k]).square().sum())
                              for k, pc in finals["cpu"].items()))
    del finals, p0
    loss_g, loss_c = runs["card"]["losses"], runs["cpu"]["losses"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c)]

    print(f"{cfg.name}, {cfg.num_layers} layers "
          f"{[s.mixer for s in step_pattern(cfg)]}, B={batch_size} "
          f"S={seq_len}: first batch's loss card {loss0['card']:.7f} cpu "
          f"{loss0['cpu']:.7f}; first step's grad norm card "
          f"{norm1['card']:.7f} cpu {norm1['cpu']:.7f}")
    print(f"gradients: worst leaf {worst_grad}, max|card - cpu| / max|cpu| "
          f"= {grad_rel[worst_grad]:.3e} (tolerance {LM_TOL})")
    print(f"first update (lr {lr1:.3e}): {n_unit} of {n_all} elements moved "
          f"by lr within 10% on the CPU; on the {n_settled} settled "
          f"elements the worst gap is {upd_worst:.3e} of its allowance "
          f"(1e-2 of the CPU's update + 2 ulp); the other "
          f"{n_all - n_settled} differ by at most {free_gap:.3e} "
          f"({free_gap / lr1:.3f} lr)")
    print("losses, card: " + ", ".join(f"{x:.6f}" for x in loss_g))
    print("losses, cpu:  " + ", ".join(f"{x:.6f}" for x in loss_c))
    print("relative gap per step: " + ", ".join(f"{x:.2e}" for x in loss_rel)
          + f" (tolerance {TRAIN_TOL})")
    print(f"final parameters: |card - cpu| / |cpu - start| = "
          f"{_ratio(gap_all, moved_all):.3e} over the model (tolerance "
          f"{TRAIN_PARAM_TOL}), worst leaf {worst_leaf} "
          f"{moved_rel[worst_leaf]:.3e} (tolerance {TRAIN_LEAF_TOL}); "
          f"{len(loss_g)} steps took {secs['card']:.2f} s on the card and "
          f"{secs['cpu']:.2f} s on the CPU")
    assert abs(loss0["card"] - loss0["cpu"]) <= LM_TOL * abs(loss0["cpu"]), \
        "losses differ"
    assert grad_rel[worst_grad] <= LM_TOL, \
        "gradients on the card disagree with the CPU"
    assert abs(norm1["card"] - norm1["cpu"]) <= LM_TOL * norm1["cpu"], \
        "gradient norms differ"
    assert upd_worst <= 1.0, "the first updates disagree"
    assert len(loss_g) == len(loss_c) == tcfg.total_steps
    assert max(loss_rel) <= TRAIN_TOL, "a step's loss differs"
    assert _ratio(gap_all, moved_all) <= TRAIN_PARAM_TOL, \
        "the trained parameters differ"
    assert moved_rel[worst_leaf] <= TRAIN_LEAF_TOL, \
        f"the trained parameters of {worst_leaf} differ"
    del cpu_model, models
    return model


def step_pattern(cfg):
    from repro_torch.models.lm import layer_pattern
    return layer_pattern(cfg) * (cfg.num_layers // len(layer_pattern(cfg)))


# -- phase 10: train one full-width Jamba period -----------------------------------

def train_period(cfg, tcfg, kernel_ms, global_batch: int = 8,
                 seq_len: int = 128):
    """``run`` trains ``cfg`` on the card; every step must launch each
    kernel exactly as the layer pattern implies."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models.lm import init_lm
    pattern = step_pattern(cfg)
    mamba = sum(s.mixer == "mamba" for s in pattern)
    attn = len(pattern) - mamba
    expected = dict.fromkeys(LAUNCHES, 0)
    expected.update(ssm_scan=mamba, ssm_scan_backward=mamba,
                    flash_attention=attn, rmsnorm=2 * len(pattern) + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=tcfg.seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers {[s.mixer for s in pattern]}, "
          f"d={cfg.d_model}, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, no "
          f"experts: {n_params / 1e9:.3f} B parameters ({n_params * 4 / 1e9:.2f} "
          f"GB), drawn in {time.perf_counter() - t0:.2f} s")
    per_step, last = [], {}
    host = []

    def on_step(step, metrics):
        nonlocal last
        now = dict(LAUNCHES)
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last = now
        host.append(time.perf_counter())

    reset_launches()
    t0 = time.perf_counter()
    out = train.run(cfg, tcfg, global_batch=global_batch, seq_len=seq_len,
                    model=model, log_every=1, on_step=on_step)
    wall = time.perf_counter() - t0
    steps = [b - a for a, b in zip([t0] + host, host)]
    print(f"expected launches per step {expected}")
    for i, (loss, ph, launches) in enumerate(zip(out["losses"],
                                                 out["phase_ms"], per_step)):
        print(f"step {i + 1}: loss {loss:.6f}; device ms forward "
              f"{ph['forward']:.3f}, backward {ph['backward']:.3f}, "
              f"optimizer {ph['optimizer']:.3f}, step {ph['step']:.3f}; "
              f"host {steps[i] * 1e3:.3f} ms; launches {launches}")
        assert math.isfinite(loss), "non-finite loss"
        assert launches == expected, "a train step did not run the kernels " \
            "exactly as the layer pattern implies"
    print(f"{out['steps']} steps in {wall:.2f} s; peak device memory "
          f"{out['peak_bytes'] / 2**30:.3f} GiB")
    step_ms = sorted(ph["step"] for ph in out["phase_ms"][1:])
    med = step_ms[len(step_ms) // 2]
    for name in ("ssm_scan", "ssm_scan_backward", "flash_attention",
                 "rmsnorm"):
        t = kernel_ms[name]
        print(f"  {name:18s} {expected[name]:3d} launches x {t['ms']:.5f} ms "
              f"= {expected[name] * t['ms']:.4f} ms a step (bound "
              f"{t['bound_ms']:.5f} ms a launch, {t['bound_by']})")
    total = sum(expected[k] * kernel_ms[k]["ms"] for k in kernel_ms)
    print(f"  the kernels take {total:.3f} ms of a {med:.3f} ms step "
          f"(median of steps 2-{out['steps']}, device time)")
    assert out["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory
    del model
    torch.cuda.empty_cache()
    return per_step


# -- phase 11: the D3QL agent, card vs CPU ----------------------------------------------

def profile_kernels(fn):
    """The kernels one ``fn()`` launches on the card and their summed
    device time in ms, from ``torch.profiler`` (CUPTI); (0, nan) where the
    profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return 0, float("nan")
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3

def agent_config():
    """The agent for paper-fig3 at Table II widths."""
    from repro_torch.rl import D3QLConfig
    from repro_torch.sim import EdgeSimulator, get_scenario
    scen = get_scenario("paper-fig3")
    return scen, D3QLConfig(obs_dim=EdgeSimulator(scen).obs_dim,
                            num_ues=scen.num_ues,
                            num_actions=scen.num_bs + 1, seed=0)


def rollout_windows(scen, frames: int, num_envs: int = 8, seed: int = 0):
    """Eq. (7) windows of a short numpy rollout under random actions:
    (obs, actions, rewards, next_obs, dones), leading axis frames * E."""
    import numpy as np
    from repro_torch.core.learn_gdm import obs_history_window
    from repro_torch.sim import VecEdgeSimulator
    venv = VecEdgeSimulator(scen, num_envs, seeds=seed + np.arange(num_envs))
    rng = np.random.default_rng(seed)
    history = [venv.observation()]
    out = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "dones")}
    for _ in range(frames):
        obs = obs_history_window(history, 3)
        acts = rng.integers(0, scen.num_bs + 1, (num_envs, scen.num_ues))
        mac = rng.integers(-1, scen.num_channels, (num_envs, scen.num_ues))
        res = venv.step(mac, acts - 1)
        history = history[-2:] + [venv.observation(res["bs_load"])]
        for k, v in (("obs", obs), ("actions", acts),
                     ("rewards", res["rewards"]),
                     ("next_obs", obs_history_window(history, 3)),
                     ("dones", np.full(num_envs, res["done"]))):
            out[k].append(v)
    return {k: np.concatenate(v) for k, v in out.items()}


def greedy_mismatches(q_ref, got, want):
    """Rows where two greedy action sets differ, and how many of them are
    near-ties of ``q_ref`` (the two actions' Q within AGENT_TIE_TOL of
    max|Q|); raises on any other mismatch."""
    import numpy as np
    diff = got != want
    if not diff.any():
        return 0, 0
    scale = float(np.abs(q_ref).max())
    qa = np.take_along_axis(q_ref, got[..., None], -1)[..., 0]
    qb = np.take_along_axis(q_ref, want[..., None], -1)[..., 0]
    gaps = np.abs(qa - qb)[diff]
    ties = int((gaps <= AGENT_TIE_TOL * scale).sum())
    assert ties == int(diff.sum()), (
        f"{int(diff.sum()) - ties} greedy actions differ beyond a near-tie "
        f"(largest Q gap {gaps.max():.3e}, max|Q| {scale:.3e})")
    return int(diff.sum()), ties


def agent_vs_cpu(card: str, updates: int = 50, act_envs: int = 8,
                 n_obs: int = 256):
    """The same agent on the card and on the CPU: initial weights, Q,
    ``updates`` train steps on the same sampled batches, greedy actions;
    then the update and act times on ``card`` (nvidia-smi's name and
    power limit)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.rl import D3QLAgent
    from repro_torch.rl.networks import qnet_apply
    scen, cfg = agent_config()
    agents = {"card": D3QLAgent(cfg, device="cuda"),
              "cpu": D3QLAgent(copy.deepcopy(cfg), device="cpu")}
    start = {k: p.detach().clone() for k, p in agents["cpu"].params.items()}
    for (name, pg), pc in zip(agents["card"].params.items(),
                              agents["cpu"].params.values()):
        assert torch.equal(pg.detach().cpu(), pc.detach()), \
            f"initial {name} differs between the card and the CPU"
    n_params = sum(p.numel() for p in start.values())
    print(f"D3QL agent, paper-fig3: U={cfg.num_ues}, A={cfg.num_actions}, "
          f"H={cfg.history}, obs_dim={cfg.obs_dim}, LSTM {cfg.lstm_units}, "
          f"FC {cfg.fc}, batch {cfg.batch_size}: {n_params} parameters, "
          "bit-equal at start on the card and the CPU")
    data = rollout_windows(scen, 40, act_envs)
    for agent in agents.values():
        agent.memory.push_batch(data["obs"], data["actions"], data["rewards"],
                                data["next_obs"], data["dones"])
    obs = data["obs"][:n_obs]

    def q_err():
        q = {side: a.q_values(obs) for side, a in agents.items()}
        return q, _ratio(float(np.abs(q["card"] - q["cpu"]).max()),
                         float(np.abs(q["cpu"]).max()))

    q0, err0 = q_err()
    losses = {side: [] for side in agents}
    for _ in range(updates):
        for side, agent in agents.items():
            losses[side].append(agent.train_step())
    q1, err1 = q_err()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                losses["cpu"])]
    final = {side: {k: p.detach().cpu() for k, p in a.params.items()}
             for side, a in agents.items()}
    moved_rel = {k: _ratio(float((final["card"][k] - pc).norm()),
                           float((pc - start[k]).norm()))
                 for k, pc in final["cpu"].items()}
    worst_leaf = max(moved_rel, key=moved_rel.get)
    gap_all = math.sqrt(sum(float((final["card"][k] - pc).square().sum())
                            for k, pc in final["cpu"].items()))
    moved_all = math.sqrt(sum(float((pc - start[k]).square().sum())
                              for k, pc in final["cpu"].items()))
    acts = {side: a.act_batch(obs, greedy=True)
            for side, a in agents.items()}
    n_diff, n_ties = greedy_mismatches(q1["cpu"], acts["card"], acts["cpu"])
    print(f"Q on {len(obs)} observations: max|card - cpu| / max|Q| = "
          f"{err0:.3e} at start, {err1:.3e} after {updates} updates "
          f"(tolerance {AGENT_Q_TOL} at start)")
    print("losses, card: " + ", ".join(f"{x:.6f}" for x in
                                         losses["card"][::10]) + " ...")
    print(f"loss, relative gap: first {rel[0]:.2e}, largest {max(rel):.2e} "
          f"(tolerance {AGENT_LOSS_TOL}); final parameters |card - cpu| / "
          f"|cpu - start| = {_ratio(gap_all, moved_all):.3e} over the net "
          f"(tolerance {TRAIN_PARAM_TOL}), worst leaf {worst_leaf} "
          f"{moved_rel[worst_leaf]:.3e} (tolerance {TRAIN_LEAF_TOL})")
    print(f"greedy actions on {len(obs)} x {cfg.num_ues} rows: {n_diff} "
          f"differ, {n_ties} of them near-ties (top-2 Q gap within "
          f"{AGENT_TIE_TOL} of max|Q|)")
    assert np.isfinite(q1["card"]).all(), "non-finite Q on the card"
    assert err0 <= AGENT_Q_TOL, "Q on the card disagrees with the CPU"
    assert max(rel) <= AGENT_LOSS_TOL, "an update's loss differs"
    assert _ratio(gap_all, moved_all) <= TRAIN_PARAM_TOL, \
        "the trained Q-net differs"
    assert moved_rel[worst_leaf] <= TRAIN_LEAF_TOL, \
        f"the trained {worst_leaf} differs"

    # times on the card: an update on a fixed batch, a forward at E=8.  An
    # update is some 650 operations, so ten back to back would fill the
    # launch queue and time the host: time one at a time, behind a sleep
    # longer than the host takes to enqueue it
    agent = agents["card"]
    batch = agent.device_batch(agent.memory.sample(cfg.batch_size))
    upd_ms = device_ms(lambda: agent.update(batch), reps=1,
                       sleep_cycles=60_000_000)
    x = torch.from_numpy(obs[:act_envs]).cuda()
    with torch.no_grad():
        act_ms = device_ms(lambda: qnet_apply(agent.net, x),
                           sleep_cycles=60_000_000)
    host_upd, host_step, host_act = [], [], []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.update(batch)
        host_upd.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.train_step()
        host_step.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        agent.act_batch(obs[:act_envs], greedy=True)
        host_act.append(time.perf_counter() - t0)
    med = {k: statistics.median(v) * 1e3 for k, v in (
        ("update", host_upd), ("step", host_step), ("act", host_act))}
    # last: the profiler may leave the host slower after it
    kernels, kernel_ms = profile_kernels(lambda: agent.update(batch))
    print(f"{card}: an update takes {upd_ms:.4f} ms of device time (batch "
          f"{cfg.batch_size}: three forwards, one backward, clipping, "
          f"AdamW; {kernels} kernels summing to {kernel_ms:.4f} ms in the "
          f"profiler); the host enqueues it in {med['update']:.4f} ms, and "
          f"a whole train_step (sample, copy in, update, loss read back) "
          f"takes {med['step']:.4f} ms; a forward at E={act_envs} takes "
          f"{act_ms:.4f} ms of device time, a greedy act_batch "
          f"{med['act']:.4f} ms on the host's clock")
    return {"update_ms": upd_ms, "act_ms": act_ms, **{
        f"host_{k}_ms": v for k, v in med.items()}}


# -- phase 12: Fig. 3 on the card -----------------------------------------------------

def fig3(card: str, episodes: int = 240, num_envs: int = 8, seed: int = 0,
         engine: str = "vectorized"):
    """``benchmarks/bench_convergence.py``'s run at its default scale, with
    the agent on the card, through ``train_vectorized`` (the numpy
    simulator) or ``train_fused`` (the whole round on the card): its
    criteria must hold."""
    import numpy as np
    import torch
    from repro_torch.core import LearnGDMController
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sim import EdgeSimulator, get_scenario
    scen = get_scenario("paper-fig3", seed=seed)
    ctrl = LearnGDMController(EdgeSimulator(scen), variant="learn-gdm",
                              seed=seed, device="cuda")
    decay = ctrl.calibrate_epsilon(episodes, num_envs=num_envs, final=1e-2)
    train = {"vectorized": ctrl.train_vectorized,
             "fused": ctrl.train_fused}[engine]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = train(episodes, num_envs=num_envs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = np.asarray(hist["reward"], dtype=float)
    loss = np.asarray(hist["loss"], dtype=float)
    w = max(len(r) // 10, 1)
    early_r, late_r = float(np.mean(r[:w])), float(np.mean(r[-w:]))
    valid = loss[~np.isnan(loss)]
    wl = max(len(valid) // 10, 1)
    early_l, late_l = float(np.mean(valid[:wl])), float(np.mean(valid[-wl:]))
    frames = ctrl.train_frames(episodes, num_envs=num_envs)
    print(f"LEARN-GDM on paper-fig3 through train_{engine}, seed {seed}: "
          f"{episodes} episodes at E={num_envs} ({frames} frames, "
          f"{ctrl.agent.steps} updates, epsilon decay {decay:.6f} to "
          f"{ctrl.agent.epsilon:.4f})")
    print(f"reward, first {w} episodes {early_r:.3f} -> last {w} "
          f"{late_r:.3f}; MSE, first {wl} {early_l:.4f} -> last {wl} "
          f"{late_l:.4f}")
    print(f"{card}: wall clock {wall:.2f} s, {frames / wall:.1f} frames a "
          f"second "
          f"({frames * num_envs / wall:.1f} env-frames); kernel launches "
          f"{dict(LAUNCHES)}")
    assert np.isfinite(r).all() and len(valid) > 0
    assert late_r > early_r, "Fig. 3: the late reward is not above the early"
    assert late_l < early_l, "Fig. 3: the late MSE is not below the early"
    assert not any(LAUNCHES.values()), "the agent path launched a DiT kernel"
    return {"early_reward": early_r, "late_reward": late_r,
            "early_mse": early_l, "late_mse": late_l, "wall_s": wall,
            "frames": frames, "ctrl": ctrl}


# -- phase 14: the fused engine on the card --------------------------------------------

def env_on_card(frames: int = 40, num_envs: int = 3, seed: int = 0):
    """The tensor env on the card in float64 against the carried numpy
    ``VecEdgeSimulator`` under the same injected draws, greedy and random
    MAC, random placements on paper-fig3 and hotspot placements (C3
    blocking): integer state and observations exactly, the reward
    components within 1e-9."""
    import numpy as np
    import torch
    from repro_torch.core.mac import vec_greedy_mac
    from repro_torch.sim import VecEdgeSimulator, get_scenario, torch_env
    scen = get_scenario("paper-fig3")
    e, u = num_envs, scen.num_ues
    worst = 0.0
    for mac_scheme, high in (("greedy", scen.num_bs), ("random", scen.num_bs),
                             ("greedy", 3)):
        rng = np.random.default_rng(seed + high)
        venv = VecEdgeSimulator(scen, e)
        venv.reset(seeds=100 + np.arange(e))
        world = torch_env.world_from_sim(venv, dtype=torch.float64,
                                         device="cuda")
        state = torch_env.state_from_numpy(venv, dtype=torch.float64,
                                           device="cuda")

        def dev(x):
            return torch.from_numpy(np.asarray(x)).cuda()

        for t in range(frames):
            if mac_scheme == "greedy":
                mac = vec_greedy_mac(venv)
                got = torch_env.greedy_mac(scen, world, state)
            else:
                attempt, channel = rng.random((2, e, u))
                got = torch_env.random_access(scen, state,
                                              attempt_draws=dev(attempt),
                                              channel_draws=dev(channel))
                need = venv.needs_uplink() & (attempt < 0.8)
                mac = np.where(need, np.floor(channel * scen.num_channels)
                               .astype(int), -1)
            assert np.array_equal(got.cpu().numpy(), mac), \
                f"{mac_scheme} MAC differs at frame {t}"
            pl = rng.integers(-1, high, size=(e, u))
            arrival = rng.random((e, u))
            redraw = rng.uniform(0, scen.side, size=(e, u, 2))
            res = venv.step(mac, pl, arrival_draws=arrival,
                            waypoint_redraw=redraw)
            state, info = torch_env.env_step(
                scen, world, state, dev(mac), dev(pl),
                arrival_draws=dev(arrival), waypoint_draws=dev(redraw))
            for field in ("poa", "prev_poa", "blocks_done", "chain_state",
                          "cur_node", "has_request", "uploaded",
                          "num_delivered", "num_collisions"):
                assert np.array_equal(getattr(state, field).cpu().numpy(),
                                      getattr(venv, field)), \
                    f"{field} differs at frame {t}"
            for k in ("bs_load", "delivered", "executed"):
                assert np.array_equal(info[k].cpu().numpy(), res[k]), k
            assert np.array_equal(
                torch_env.observe(scen, world, state, info["bs_load"])
                .cpu().numpy(), venv.observation(res["bs_load"])), \
                f"observation differs at frame {t}"
            for k in ("rewards", "quality_gain", "exec_cost", "trans_cost"):
                worst = max(worst, float(np.abs(info[k].cpu().numpy()
                                                - res[k]).max()))
        assert venv.num_delivered.sum() > 0
    print(f"tensor env on the card, float64, paper-fig3 at E={e}, {frames} "
          f"frames each under greedy MAC, random access and hotspot "
          f"placements: integer state, MAC and observations equal to the "
          f"numpy simulator's every frame; reward components within "
          f"{worst:.3e} (tolerance 1e-9)")
    assert worst <= 1e-9, "a reward component differs"


def _fused_pair(scen, cfg, num_envs: int):
    """A controller on the card and one on the CPU with bit-equal agents,
    each with a float64 world and a device replay, built for one round."""
    import copy
    import torch
    from repro_torch.core import LearnGDMController
    from repro_torch.rl import D3QLAgent, DeviceReplay
    from repro_torch.sim import EdgeSimulator, torch_env
    out = {}
    for side, device, acfg in (("card", "cuda", cfg),
                               ("cpu", "cpu", copy.deepcopy(cfg))):
        env = EdgeSimulator(scen)
        ctrl = LearnGDMController(env, agent=D3QLAgent(acfg, device=device))
        ctrl.calibrate_epsilon(240, num_envs=num_envs, final=1e-2)
        world = torch_env.world_from_sim(env, num_envs, dtype=torch.float64,
                                         device=device)
        replay = DeviceReplay(acfg.memory_capacity,
                              (acfg.history, env.obs_dim), (acfg.num_ues,),
                              device=device)
        fused = ctrl._build_fused_round(world, num_envs, replay)
        out[side] = (ctrl, fused, fused.init_carry())
    return out


def round_vs_cpu(num_envs: int = 8, seed: int = 0):
    """One fused round (reset and 40 frames of act, env step, push and
    update; 36 updates) on the card and on the CPU from bit-equal agents
    and the same draws, the env in float64: every replay slot's actions
    and observations equal up to the first near-tie (named, with its
    frame; the trajectories part there), each loss before it within
    AGENT_LOSS_TOL; with no near-tie, the trained parameters held by
    their movement as in phase 11."""
    import numpy as np
    import torch
    scen, cfg = agent_config()
    pair = _fused_pair(scen, cfg, num_envs)
    start = {k: p.detach().cpu().clone()
             for k, p in pair["cpu"][0].agent.params.items()}
    reset, draws = pair["cpu"][1].draw_round(
        torch.Generator().manual_seed(seed))
    outs, carries = {}, {}
    for side, (ctrl, fused, carry) in pair.items():
        dev = "cuda" if side == "card" else "cpu"
        carry, out = fused.run_round(
            carry, {k: v.to(dev) for k, v in reset.items()},
            {k: v.to(dev) for k, v in draws.items()})
        outs[side] = [x.cpu().numpy() for x in out]
        carries[side] = carry
        fused.write_back(carry)
    rc, rp = carries["card"].replay, carries["cpu"].replay
    e, horizon = num_envs, scen.horizon
    acts = {s: c.replay.actions.cpu().numpy() for s, c in carries.items()}
    obs = {s: c.replay.obs.cpu().numpy() for s, c in carries.items()}
    first, ties = horizon, 0
    for t in range(horizon):
        rows = slice(t * e, (t + 1) * e)
        assert np.array_equal(obs["card"][rows], obs["cpu"][rows]), \
            f"observations differ at frame {t}"
        if not np.array_equal(acts["card"][rows], acts["cpu"][rows]):
            q = pair["cpu"][0].agent.q_values(obs["cpu"][rows])
            d, ties = greedy_mismatches(q, acts["card"][rows],
                                        acts["cpu"][rows])
            first = t
            print(f"frame {t}: {d} actions differ, all near-ties of the "
                  f"CPU's Q; the trajectories part here")
            break
    losses = {s: o[1] for s, o in outs.items()}
    ok = ~np.isnan(losses["cpu"][:first])
    rel = np.abs(losses["card"][:first][ok] - losses["cpu"][:first][ok]) \
        / np.abs(losses["cpu"][:first][ok])
    steps = carries["card"].steps
    print(f"one fused round at E={e}, Table II widths, env float64: "
          f"{horizon} frames, {steps} updates; actions and observations "
          f"equal on the card and the CPU for {first} of {horizon} frames "
          f"({ties} near-ties); {int(ok.sum())} losses within "
          f"{rel.max() if len(rel) else 0.0:.3e} relative (tolerance "
          f"{AGENT_LOSS_TOL}); epsilon {carries['card'].epsilon:.6f} on "
          f"both sides")
    assert carries["card"].steps == carries["cpu"].steps > 0
    assert carries["card"].epsilon == carries["cpu"].epsilon
    assert len(rel) > 0 and rel.max() <= AGENT_LOSS_TOL, "a loss differs"
    if first == horizon:
        # float64 rewards summed over the UEs in another order, stored
        # float32: equal but where a sum lands on a rounding boundary
        assert np.abs(rc.rewards.cpu().numpy()
                      - rp.rewards.cpu().numpy()).max() <= 1e-6, \
            "a reward differs"
        final = {s: {k: p.detach().cpu() for k, p in
                     pair[s][0].agent.params.items()} for s in pair}
        gap = math.sqrt(sum(float((final["card"][k] - p).square().sum())
                            for k, p in final["cpu"].items()))
        moved = math.sqrt(sum(float((p - start[k]).square().sum())
                              for k, p in final["cpu"].items()))
        print(f"final parameters |card - cpu| / |cpu - start| = "
              f"{_ratio(gap, moved):.3e} (tolerance {TRAIN_PARAM_TOL})")
        assert _ratio(gap, moved) <= TRAIN_PARAM_TOL, \
            "the round trained the Q-net differently"


def time_fused_round(card: str, ctrl, vec: dict, rounds: int = 5,
                     num_envs: int = 8):
    """Host and device time of a fused round at Table II widths with the
    Fig. 3 agent (every frame updates): the wall clock of one round at a
    time (synchronised before and after), and the profiler's kernels and
    their summed device time over one round; beside phase 12's vectorized
    run, per frame."""
    import torch
    from repro_torch.rl import DeviceReplay
    from repro_torch.sim import torch_env
    agent = ctrl.agent
    acfg = agent.cfg
    world = torch_env.world_from_sim(ctrl.env, num_envs, device="cuda")
    replay = DeviceReplay(acfg.memory_capacity,
                          (acfg.history, ctrl.env.obs_dim), (acfg.num_ues,),
                          device="cuda")
    fused = ctrl._build_fused_round(world, num_envs, replay)
    state = {"carry": fused.init_carry(), "rd": 0}

    def one_round():
        gen = torch_env.round_generator(7, state["rd"], "cuda")
        state["rd"] += 1
        state["carry"], _ = fused.run_round(state["carry"],
                                            *fused.draw_round(gen))

    one_round()                      # fill the replay: every frame trains
    walls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    kernels, kernel_ms = profile_kernels(one_round)
    horizon = ctrl.env.cfg.horizon
    vec_frame = vec["wall_s"] * 1e3 / vec["frames"]
    print(f"{card}: a fused round (E={num_envs}, {horizon} frames, every "
          f"frame updating) takes {wall:.2f} ms on the host's clock "
          f"(median of {rounds}; {min(walls):.2f}-{max(walls):.2f}), "
          f"{wall / horizon:.3f} ms a frame; the profiler sees {kernels} "
          f"kernels ({kernels / horizon:.0f} a frame) summing to "
          f"{kernel_ms:.3f} ms of device time ({kernel_ms / horizon:.4f} "
          f"ms a frame), so the card idles "
          f"{100 * (1 - kernel_ms / wall):.1f}% of a round; phase 12's "
          f"vectorized engine took {vec_frame:.3f} ms a frame")
    return {"round_ms": wall, "frame_ms": wall / horizon,
            "kernels": kernels, "device_ms": kernel_ms}


# -- phase 13: the closed loop ------------------------------------------------------------

def closed_loop(cfg, card: str, train_eps: int = 48, num_envs: int = 8):
    """Measure Omega from full-width DiT services, train LEARN-GDM against
    it, serve paper-fig3 under the learned policy and under GR.  Returns
    the DiT kernels' launches over the whole loop."""
    import numpy as np
    import torch
    from repro_torch.core.policy import GreedyPoAPolicy, LearnedPolicy
    from repro_torch.experiments import serve_policy, train_variant
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.rl import D3QLAgent
    from repro_torch.models.convert import qnet_to_jax
    from repro_torch.serving import make_gdm_services, policy_bridge
    from repro_torch.sim import get_scenario
    scen = get_scenario("paper-fig3")
    frames = scen.horizon
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    services, omega = make_gdm_services(scen.num_services, 0,
                                        num_blocks=scen.max_blocks,
                                        model_cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    t_omega = time.perf_counter() - t0
    for s, row in enumerate(omega):
        print(f"service {s}: Omega(0..{scen.max_blocks}) = "
              + ", ".join(f"{x:.6f}" for x in row))
    t0 = time.perf_counter()
    ctrl = train_variant(scen, "learn-gdm", train_eps, engine="vectorized",
                         num_envs=num_envs, quality=omega, device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    print(f"{card}: Omega measured in {t_omega:.2f} s; LEARN-GDM trained "
          f"against it "
          f"in {t_train:.2f} s ({train_eps} episodes at E={num_envs}, "
          f"{ctrl.agent.steps} updates, epsilon {ctrl.agent.epsilon:.4f})")
    # serve_policy builds its engine inside; keep it to read the latents
    engines = []
    build = policy_bridge.engine_from_scenario

    def keep(*args, **kw):
        engine, world = build(*args, **kw)
        engines.append(engine)
        return engine, world

    results = {}
    policy_bridge.engine_from_scenario = keep
    try:
        for name, policy in (("learned", LearnedPolicy(ctrl.agent,
                                                       "learn-gdm")),
                             ("gr", GreedyPoAPolicy())):
            t0 = time.perf_counter()
            stats, bridge = serve_policy(scen, policy, frames,
                                         services=services, seed=0,
                                         record=True, return_bridge=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results[name] = (stats, bridge, engines[-1])
            print(f"{name:8s} completed {stats['completed']}/"
                  f"{stats['submitted']}, mean quality "
                  f"{stats['mean_quality']:.6f}, latency mean "
                  f"{stats['mean_latency_frames']:.3f} p95 "
                  f"{stats['p95_latency_frames']:.3f} frames, objective "
                  f"{stats['objective']:.4f}, wall clock {wall:.2f} s")
    finally:
        policy_bridge.engine_from_scenario = build
    launches = dict(LAUNCHES)
    calls = {s: svc.batch_calls for s, svc in services.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory {peak / 2**30:.3f} GiB; batch_calls {calls}")
    for name, (stats, _, engine) in results.items():
        assert stats["completed"] == len(engine.completed) > 0, \
            f"{name} completed nothing"
        for req in engine.completed:
            for key in ("latent", "x0"):
                arr = req.state[key]
                assert arr.shape == (cfg.latent_hw ** 2, 4), (key, arr.shape)
                assert np.isfinite(arr).all(), f"non-finite {key} served"
    forwards = sum(calls.values()) + scen.num_services * scen.max_blocks
    expected = dict.fromkeys(LAUNCHES, 0)
    expected.update(adaln_norm=cfg.num_layers * forwards,
                    adaln_norm_epilogue=cfg.num_layers * forwards,
                    flash_attention=cfg.num_layers * forwards)
    print(f"kernel launches {launches}; expected {expected} (L="
          f"{cfg.num_layers} x {forwards} DiT forwards: Omega's "
          f"{scen.num_services * scen.max_blocks} and the two serves' "
          f"{sum(calls.values())} block calls)")
    assert launches == expected, "the closed loop did not run the kernels " \
        "exactly once per DiT layer"

    # the learned serve's decisions, against the CPU copy of the agent
    cpu = D3QLAgent(ctrl.agent.cfg, device="cpu",
                    params=qnet_to_jax(ctrl.agent.net))
    n_rows = n_diff = n_ties = 0
    for _, obs_hist, actions in results["learned"][1].trace:
        want = cpu.act_batch(obs_hist, greedy=True)[0]
        d, t = greedy_mismatches(cpu.q_values(obs_hist)[0], actions, want)
        n_rows += len(actions)
        n_diff += d
        n_ties += t
    print(f"learned decisions: {len(results['learned'][1].trace)} quanta, "
          f"{n_rows} UE rows; {n_diff} differ from the CPU copy of the "
          f"agent, {n_ties} of them near-ties")
    return launches, results


# -- phase 15: the fleet --------------------------------------------------------------

def fleet(cfg, card: str, cells: int = 4, train_eps: int = 48,
          frames: int = 40, seed: int = 0):
    """``serve_fleet_variant`` on paper-fig3 with ``examples/serve_fleet.
    py``'s defaults (4 cells, diurnal, handover rate 0.02, 48 training
    episodes through the fused engine, 40 frames) and three full-width DiT
    services, three ways: quantum scheduling, continuous scheduling (the
    example's scheduler: join/leave, sub-quantum arrivals) and node churn
    with failover+degrade and deadline 16.  Then sync-mode continuous
    serving against the quantum run, and two runs of the quantum run's
    agent through ``serve_fleet_policy`` with ``early_exit=False``, so
    that every chain runs all B blocks (with random weights Omega(1) is
    about 0.999, and early exit ends every chain after one block): the
    continuous scheduler with each ``SlotBatch`` step held bit for bit
    against ``run_batch`` on the same states, and the continuous scheduler
    under node churn with failover+degrade; both must reuse resident rows
    (fewer rows staged than stepped), and node churn must fail over.  Each
    run: every served latent finite, the DiT kernels' launches exactly L
    per block call, and every decision the agent recorded equal to its CPU
    copy's (near-ties counted).  Returns the DiT kernels' launches over
    the phase (Omega included)."""
    import numpy as np
    import torch
    from repro_torch import experiments
    from repro_torch.core.policy import LearnedPolicy
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.convert import qnet_to_jax
    from repro_torch.rl import D3QLAgent
    from repro_torch.serving import (RecoveryConfig, SchedulerConfig,
                                     cluster as cluster_mod,
                                     make_gdm_services)
    from repro_torch.serving.gdm_service import SlotBatch
    from repro_torch.sim import get_scenario
    scen = get_scenario("paper-fig3")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    services, omega = make_gdm_services(scen.num_services, seed,
                                        num_blocks=scen.max_blocks,
                                        model_cfg=cfg, device="cuda")
    omega_forwards = scen.num_services * scen.max_blocks
    # keep what the entry point builds inside: the trained controller (its
    # agent records every decision) and the cluster (its served latents)
    kept = {"ctrl": [], "cluster": []}
    train, build = experiments.train_variant, cluster_mod.cluster_from_scenario

    def record(agent):
        """Log every decision ``agent`` makes from now on."""
        log, act_batch = [], agent.act_batch

        def recording(obs_hist, **kw):
            actions = act_batch(obs_hist, **kw)
            log.append((obs_hist.copy(), kw.get("mask"), actions.copy()))
            return actions

        agent.act_batch = recording
        return log

    def keep_ctrl(*a, **k):
        t0 = time.perf_counter()
        ctrl = train(*a, **k)
        torch.cuda.synchronize()
        kept["train_s"] = time.perf_counter() - t0
        kept["ctrl"].append((ctrl, record(ctrl.agent)))
        return ctrl

    def keep_cluster(*a, **k):
        kept["cluster"].append(build(*a, **k))
        return kept["cluster"][-1]

    runs = {
        "quantum": {},
        "continuous": dict(scheduling="continuous",
                           sched=SchedulerConfig(sub_quantum_arrivals=True)),
        "node-churn": dict(fault_schedule="node-churn",
                           recovery=RecoveryConfig(mode="failover",
                                                   deadline_frames=16,
                                                   degrade=True)),
    }
    results = {}
    slot_step = SlotBatch.step
    experiments.train_variant = keep_ctrl
    cluster_mod.cluster_from_scenario = keep_cluster
    try:
        for name, kw in runs.items():
            calls0 = sum(s.batch_calls for s in services.values())
            launches0 = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = experiments.serve_fleet_variant(
                scen, "learn-gdm", train_eps=train_eps, frames=frames,
                cells=cells, workload="diurnal", seed=seed,
                handover_rate=0.02, services=services, device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls = sum(s.batch_calls for s in services.values()) - calls0
            launched = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}
            results[name] = (stats, kept["cluster"][-1],
                             kept["ctrl"][-1], calls, launched, wall)
            print(f"{name:11s} {stats['completed']}/{stats['submitted']} "
                  f"completed ({stats['satisfied']} satisfied), quality "
                  f"{stats['mean_quality']:.6f}, latency mean "
                  f"{stats['mean_latency_frames']:.3f} p95 "
                  f"{stats['p95_latency_frames']:.3f} frames, objective "
                  f"{stats['objective']:.4f}, handovers "
                  f"{stats['handovers']}, goodput {stats['goodput']} drops "
                  f"{stats['drops']} failovers {stats['failovers']} "
                  f"deadline misses {stats['deadline_misses']}; {calls} "
                  f"block calls; {wall:.2f} s on {card}: training "
                  f"{kept['train_s']:.2f} s, serving "
                  f"{wall - kept['train_s']:.2f} s")
        # sync-mode continuous serving equals the quantum run, on the card
        # (the quantum run's agent, its recorder removed: greedy acting
        # draws nothing, so it decides as it did)
        q_stats, _, (q_ctrl, _), *_ = results["quantum"]
        del q_ctrl.agent.act_batch
        sync = experiments.serve_fleet_policy(
            scen, lambda c: LearnedPolicy(q_ctrl.agent, "learn-gdm"),
            frames, cells=cells,
            services=services, workload="diurnal", seed=seed,
            handover_rate=0.02, scheduling="continuous",
            sched=SchedulerConfig(join_leave=False))
        assert sync == {k: v for k, v in q_stats.items()
                        if k != "train_episodes"}, \
            "sync-mode continuous serving differs from the quantum engine"
        print("sync-mode continuous serving (join/leave off) equals the "
              "quantum run's summary on the card")
        slot = full_chains(q_ctrl, record, kept, results, scen, services,
                           cells, frames, seed, card)
    finally:
        experiments.train_variant = train
        cluster_mod.cluster_from_scenario = build
        SlotBatch.step = slot_step
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total_calls = sum(s.batch_calls for s in services.values())
    print(f"SlotBatch on the card: {slot['steps']} steps of the continuous "
          f"full-chain run held against run_batch on the same states, "
          f"{slot['rows']} rows, max |diff| {slot['err']:.3e} (tolerance "
          f"0: bit for bit); peak device memory {peak / 2**30:.3f} GiB")
    for name, (stats, cluster, (ctrl, log), calls, launched, _) in \
            results.items():
        assert stats["completed"] > 0, f"{name} completed nothing"
        n_lat = 0
        for eng in cluster.engines:
            for req in eng.completed:
                for key in ("latent", "x0"):
                    arr = req.state[key]
                    assert arr.shape == (cfg.latent_hw ** 2, 4), (key,
                                                                  arr.shape)
                    assert np.isfinite(arr).all(), f"non-finite {key}"
                n_lat += 1
        want = {k: 0 for k in LAUNCHES}
        want.update(adaln_norm=cfg.num_layers * calls,
                    adaln_norm_epilogue=cfg.num_layers * calls,
                    flash_attention=cfg.num_layers * calls)
        assert launched == want, (name, launched, want)
        cpu = D3QLAgent(ctrl.agent.cfg, device="cpu",
                        params=qnet_to_jax(ctrl.agent.net))
        n_rows = n_diff = n_ties = 0
        for obs_hist, mask, actions in log:
            q = cpu.q_values(obs_hist)
            want_a = cpu.act_batch(obs_hist, greedy=True, mask=mask)
            d, t = greedy_mismatches(q, actions, want_a)
            n_rows += actions.size
            n_diff += d
            n_ties += t
        print(f"{name:11s} {n_lat} served latents finite; launches "
              f"{launched} = {cfg.num_layers} x {calls} block calls; "
              f"{len(log)} placement passes, {n_rows} UE decisions, "
              f"{n_diff} differ from the agent's CPU copy, {n_ties} of "
              f"them near-ties")
    expected = {k: 0 for k in LAUNCHES}
    forwards = omega_forwards + total_calls
    expected.update(adaln_norm=cfg.num_layers * forwards,
                    adaln_norm_epilogue=cfg.num_layers * forwards,
                    flash_attention=cfg.num_layers * forwards)
    print(f"kernel launches over the phase {launches}; expected {expected} "
          f"(L={cfg.num_layers} x {forwards} DiT forwards: Omega's "
          f"{omega_forwards} and {total_calls} block calls over the "
          f"phase's serves)")
    assert launches == expected
    return launches, {name: r[0] for name, r in results.items()}


def full_chains(ctrl, record, kept, results, scen, services, cells, frames,
                seed, card):
    """Phase 15's two runs without early exit (see :func:`fleet`): the
    trained agent of ``ctrl`` serves the fleet under the continuous
    scheduler, then under node churn with failover+degrade; each run goes
    into ``results`` as the served runs do.  Every ``SlotBatch`` step of
    the first run is held against ``run_batch`` on the same states (its
    calls are block calls too, and launch the same kernels).  Returns that
    comparison's steps, rows and largest difference."""
    import numpy as np
    import torch
    from repro_torch import experiments
    from repro_torch.core.policy import LearnedPolicy
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serving import RecoveryConfig, SchedulerConfig
    from repro_torch.serving.gdm_service import SlotBatch
    step = SlotBatch.step
    seen = {"stepped": 0, "check": False, "steps": 0, "rows": 0, "err": 0.0}

    def checked(self, items):
        seen["stepped"] += len(items)
        if not seen["check"]:
            return step(self, items)
        want, want_q = self.svc.run_batch(
            [st for _, st, _ in items], np.asarray([k for *_, k in items]))
        got, got_q = step(self, items)
        for g, w in zip(got, want):
            for key in ("latent", "x0"):
                seen["err"] = max(seen["err"], float(
                    np.abs(g[key] - w[key]).max()))
        assert np.array_equal(got_q, want_q)
        seen["steps"] += 1
        seen["rows"] += len(items)
        return got, got_q

    SlotBatch.step = checked
    runs = {
        "continuous, full chains": dict(
            sched=SchedulerConfig(sub_quantum_arrivals=True)),
        "node-churn, full chains": dict(
            sched=SchedulerConfig(sub_quantum_arrivals=True),
            fault_schedule="node-churn",
            recovery=RecoveryConfig(mode="failover", deadline_frames=16,
                                    degrade=True)),
    }
    for name, kw in runs.items():
        seen["check"] = name.startswith("continuous")
        stepped0, checks0 = seen["stepped"], seen["steps"]
        staged0 = sum(s.slot_batch().rows_staged for s in services.values())
        calls0 = sum(s.batch_calls for s in services.values())
        launches0 = dict(LAUNCHES)
        log = record(ctrl.agent)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = experiments.serve_fleet_policy(
            scen, lambda c: LearnedPolicy(ctrl.agent, "learn-gdm"), frames,
            cells=cells, services=services, workload="diurnal", seed=seed,
            handover_rate=0.02, early_exit=False, scheduling="continuous",
            **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del ctrl.agent.act_batch
        calls = sum(s.batch_calls for s in services.values()) - calls0
        launched = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}
        stepped = seen["stepped"] - stepped0
        staged = sum(s.slot_batch().rows_staged
                     for s in services.values()) - staged0
        results[name] = (stats, kept["cluster"][-1], (ctrl, log), calls,
                         launched, wall)
        print(f"{name}: {stats['completed']}/{stats['submitted']} "
              f"completed ({stats['satisfied']} satisfied), latency mean "
              f"{stats['mean_latency_frames']:.3f} p95 "
              f"{stats['p95_latency_frames']:.3f} frames, objective "
              f"{stats['objective']:.4f}, handovers {stats['handovers']}, "
              f"failovers {stats['failovers']}, deadline misses "
              f"{stats['deadline_misses']}; {calls} block calls "
              f"({seen['steps'] - checks0} of them run_batch's, for the "
              f"comparison); SlotBatch "
              f"rows stepped {stepped}, staged {staged} (resident "
              f"{stepped - staged}); {wall:.2f} s on {card}")
        assert 0 < staged < stepped, (name, staged, stepped)
    assert results["node-churn, full chains"][0]["failovers"] > 0, \
        "node churn never failed over"
    assert seen["steps"] > 0 and seen["err"] == 0.0, seen
    return seen


def print_occupancy(lib):
    """Resident blocks per SM of the kernels redesigned for Hopper
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at the blocks their
    main paths launch."""
    from repro_torch.kernels.adaln_norm import launch_shape
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    threads, vpt = launch_shape(768, 4)
    for epilogue in (0, 1):
        blocks = lib.adaln_norm_occupancy(4, vpt, threads, epilogue)
        warps = blocks * threads // 32
        print(f"adaln_norm{'_epilogue' if epilogue else ''} d=768: {blocks} "
              f"blocks of {threads} threads per SM ({warps} warps; a row a "
              f"block, two float4 a thread; the first port held one block "
              f"of 8 warps an SM at B=4)")
        assert warps > 8, "adaln_norm holds no more warps than before"
    # the launcher's block (one head, one copy stage) and that of B=8,
    # S=4096 (eight heads, two a warp, a two-stage ring)
    for hpw, stages in ((1, 1), (2, 2)):
        blocks = lib.decode_attention_occupancy(128, hpw, 4, stages)
        print(f"decode_attention D=128, {hpw} head(s) a warp, {stages} "
              f"copy stage(s): {blocks} blocks of 4 warps per SM")
        assert blocks >= 1, "decode_attention cannot be resident"
    for d in HEAD_DIMS:
        blocks = lib.flash_attention_occupancy(d)
        print(f"flash_attention D={d}: {blocks} blocks of 128 threads per "
              f"SM ({4 * blocks} warps)")
        assert blocks >= 1, "flash_attention cannot be resident"
    import torch
    from repro_torch.kernels.rmsnorm import launch_shape as rms_shape
    threads, vpt = rms_shape(4096, 4)
    for rpb in (1, 2):
        blocks = lib.rmsnorm_occupancy(4, vpt, threads, rpb)
        print(f"rmsnorm d=4096, {rpb} row(s) a block: {blocks} blocks of "
              f"{threads} threads per SM ({blocks * rpb} rows; x and scale "
              f"in registers, {vpt} float4 of each a thread; the first port "
              f"held 8 rows, x alone)")
    assert blocks * 2 >= 8, "rmsnorm holds fewer rows an SM than before"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, _, din, n = SCAN_CASES[0]
    blocks = lib.ssm_scan_occupancy(n)
    print(f"ssm_scan N={n}: {blocks} blocks of 128 threads per SM "
          f"({4 * blocks} warps; a thread a channel, its states in "
          f"registers): the training shape's {b * din // 128} blocks take "
          f"{-(-b * din // 128 // (blocks * sms))} wave(s) on {sms} SMs")
    assert blocks * sms >= b * din // 128, \
        "the scan's training shape takes more than one wave"
    blocks = lib.ssm_scan_backward_occupancy()
    print(f"ssm_scan_backward: {blocks} blocks of 512 threads per SM "
          f"({16 * blocks} warps; a design that keeps each channel's "
          "history in 64 kB of shared memory holds 3 blocks of 64 "
          "threads, 6 warps)")
    assert 16 * blocks > 6, "ssm_scan_backward holds no more warps than before"


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({build.last_build['path'] or build.library_path()})")
    for line in build.last_build["log"].splitlines():
        if "Compiling entry function" in line:
            print("  " + line.split("'")[1])      # the mangled kernel name
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    return build.library()


def kernel_times(tree: str) -> int:
    """``--kernel-times TREE``: build the kernels of the ``repro_torch``
    package under ``TREE/src`` (another checkout, such as a parent commit
    unpacked with ``git archive``) and time the adaLN, decode, rmsnorm and
    scan kernels at phase 4's shapes in this script's harness, and the
    layers they serve: phase 5's DiT forward at B=4, phase 8's decode step
    of full yi-6b (device time and host enqueue) and one full-width Jamba
    Mamba block forward at the trainer's shape, so that two trees are
    compared within one run on one card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.gdm import init_gdm
    from repro_torch.models.lm import init_lm
    phase("1. card")
    card_info()
    phase(f"2. build the kernels of {tree}")
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase(f"4. times of {tree}'s adaLN, decode, rmsnorm and scan kernels")
    out = {"launch_floor_ms": launch_floor_ms()}
    for b in (1, 4):
        for name, t in time_adaln(gen, b, 256, 768).items():
            out[f"{name} B={b}"] = t["ms"]
    out["decode_attention B=8 S=4096"] = time_decode(gen, 8, 4096,
                                                     4096)["ms"]
    t = time_decode(gen, 1, 24, 24, cold=True)
    out.update({"decode_attention B=1 S=24": t["ms"],
                "decode_attention B=1 S=24, one call, warm": t["warm1_ms"],
                "decode_attention B=1 S=24, one call, L2 flushed":
                    t["cold1_ms"]})
    t = time_rmsnorm(gen, 1, 4096, cold=True, plain=False)
    out.update({"rmsnorm 1x4096": t["ms"],
                "rmsnorm 1x4096, one call, warm": t["warm1_ms"],
                "rmsnorm 1x4096, one call, L2 flushed": t["cold1_ms"]})
    for rows in (1024, 8192):
        out[f"rmsnorm {rows}x4096"] = time_rmsnorm(gen, rows, 4096,
                                                   plain=False)["ms"]
    scan = time_ssm_scan(gen, plain=False)
    out["ssm_scan B=8 L=128 saving states"] = scan["ssm_scan"]["ms"]
    out["ssm_scan B=8 L=128 without states"] = \
        scan["ssm_scan"]["no_states_ms"]
    out["ssm_scan_backward B=8 L=128"] = scan["ssm_scan_backward"]["ms"]
    phase(f"5, 8, 10. {tree}'s DiT forward at B=4, yi-6b decode step and "
          "Jamba Mamba block forward")
    full = get_config("gdm-dit")
    out["DiT forward B=4"] = time_block_call(full, init_gdm(
        full, seed=11, device="cuda"))
    dev_ms, host_ms = time_decode_step(init_lm(get_config("yi-6b"), seed=1,
                                               device="cuda"))
    out["yi-6b decode step, device"] = dev_ms
    out["yi-6b decode step, host enqueue"] = host_ms
    torch.cuda.empty_cache()
    out["Mamba block forward B=8 L=128"] = time_mamba_block()
    for name in ("DiT forward B=4", "yi-6b decode step, device",
                 "yi-6b decode step, host enqueue",
                 "Mamba block forward B=8 L=128"):
        print(f"{name}: {out[name]:.4f} ms")
    print(json.dumps({"tree": tree, "kernel_times": out}))
    return 0


def main(argv) -> int:
    if argv[:1] == ["--kernel-times"] and len(argv) == 2:
        sys.path.insert(0, os.path.join(os.path.abspath(argv[1]), "src"))
        return kernel_times(argv[1])
    if argv:
        print("usage: chip_smoke.py [--kernel-times TREE]", file=sys.stderr)
        return 2
    phase("1. card")
    card = card_info()
    import torch
    from repro_torch.configs import TrainConfig, get_config

    phase("2. build")
    print_occupancy(build_kernels())

    full = get_config("gdm-dit")
    yi = get_config("yi-6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase("3. kernels vs plain versions on the card")
    errs = check_adaln(gen)
    errs["flash_attention"] = check_attention(gen)
    errs["decode_attention"] = check_decode(gen)
    errs["rmsnorm"] = check_rmsnorm(gen)
    errs.update(check_ssm_scan(gen))
    check_kernel_grads(gen)

    phase("4. times (median of "
          f"{TIMED_RUNS} device-timed samples of 10 back-to-back calls)")
    times = time_kernels(gen, full)
    # the JSON line carries each kernel at the launcher's shapes: decode
    # at B=1 against a full 24-row cache, rmsnorm on one decode row
    time_decode(gen, 8, 4096, 4096)
    decode = time_decode(gen, 1, 24, 24, cold=True)
    times["decode_attention"] = {k: decode[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    time_rmsnorm(gen, 8192, yi.d_model)
    times["rmsnorm"] = time_rmsnorm(gen, 1, yi.d_model, cold=True)
    train_ms = time_ssm_scan(gen)
    times.update(train_ms)
    train_ms.update(time_training_kernels(gen))

    phase("5. one block call, card vs CPU")
    model = step_vs_cpu(full)
    block_ms = time_block_call(full, model)
    per_forward = full.num_layers * sum(times[k]["ms"] for k in (
        "adaln_norm", "adaln_norm_epilogue", "flash_attention"))
    print(f"run_block_batched B=4 full width: {block_ms:.4f} ms per DiT "
          f"forward; the kernels take {per_forward:.4f} ms of it "
          f"({full.num_layers} x (adaLN + adaLN epilogue + attention))")
    del model

    phase("6. serve paper-fig3 with full-width gdm-dit services")
    launches = serve(full)

    phase("7. yi-6b prefill + decode at full width, card vs CPU")
    lm_vs_cpu(dataclasses.replace(yi, num_layers=2))

    phase("8. serve the edge launcher: full yi-6b + full gdm-dit")
    lm_launches = serve_launcher(yi, full)
    # each kernel's launches come from the path that carries it: the DiT
    # kernels from phase 6, the LM kernels from phase 8
    launches.update(decode_attention=lm_launches["decode_attention"],
                    rmsnorm=lm_launches["rmsnorm"])

    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), num_experts=0)
    # the trainer's CLI settings (repro.launch.train): AdamW at 3e-4 on the
    # cosine schedule, warmup max(steps // 20, 5)
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=6, warmup_steps=5)
    phase("9. full-width hybrid [attention, Mamba], card vs CPU: six train "
          "steps, then prefill + 4 decode steps")
    pair = dataclasses.replace(jamba, attn_every=2, num_layers=2)
    model = train_vs_cpu(pair, tcfg)
    lm_vs_cpu(pair, model=model)
    del model
    torch.cuda.empty_cache()

    phase("10. train one full-width Jamba period (8 layers, no experts), "
          "global batch 8, seq 128, six steps")
    per_step = train_period(dataclasses.replace(jamba, num_layers=8), tcfg,
                            train_ms)
    # the scan kernels' launches come from the training path
    for name in ("ssm_scan", "ssm_scan_backward"):
        launches[name] = sum(s[name] for s in per_step)
    torch.cuda.empty_cache()

    phase("11. the D3QL agent at Table II widths, card vs CPU: Q, 50 "
          "updates, greedy actions; update and act times")
    agent_vs_cpu(card)

    phase("12. Fig. 3 on the card: LEARN-GDM on paper-fig3, 240 episodes "
          "at E=8, seed 0")
    vec = fig3(card)

    phase("13. the closed loop: Omega from three full-width gdm-dit "
          "services, LEARN-GDM trained against it, paper-fig3 served under "
          "the learned policy and under GR")
    closed_loop(full, card)

    phase("14. the fused engine on the card: the tensor env vs the numpy "
          "simulator (float64), one round card vs CPU, Fig. 3 through "
          "train_fused, round times")
    env_on_card()
    round_vs_cpu()
    fused = fig3(card, engine="fused")
    time_fused_round(card, fused["ctrl"], vec)
    print(f"Fig. 3 wall clock: train_fused {fused['wall_s']:.2f} s, "
          f"train_vectorized (phase 12) {vec['wall_s']:.2f} s")
    del vec, fused
    torch.cuda.empty_cache()

    phase("15. the fleet: serve_fleet_variant on paper-fig3, 4 cells, "
          "diurnal, three full-width gdm-dit services; quantum, continuous, "
          "node churn")
    fleet_launches, _ = fleet(full, card)
    # the DiT kernels' launches come from the fleet closed loop, the main
    # path (phases 6 and 13 checked their own counts)
    for name in ("adaln_norm", "adaln_norm_epilogue", "flash_attention"):
        launches[name] = fleet_launches[name]

    replaces = {
        "adaln_norm": "src/repro/kernels/adaln_norm.py:76",
        "adaln_norm_epilogue": "src/repro/kernels/adaln_norm.py:86",
        "flash_attention": "src/repro/kernels/flash_attention.py:100",
        "decode_attention": "src/repro/kernels/decode_attention.py:86",
        "rmsnorm": "src/repro/kernels/rmsnorm.py:32",
        "ssm_scan": "src/repro/kernels/ssm_scan.py:74",
        "ssm_scan_backward": "none: no Pallas backward; the reference "
                             "differentiates src/repro/kernels/ref.py:91 "
                             "with XLA",
    }
    sources = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
               for name in replaces}
    sources["adaln_norm_epilogue"] = sources["adaln_norm"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], **{k: times[name][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name in replaces
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
