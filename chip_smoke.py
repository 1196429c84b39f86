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
    memory.

Phase 3 also holds the selective scan (forward and backward kernels)
against its plain version and autograd (and both against themselves: two
calls give the same bits), and the gradients that
``flash_attention`` and ``rmsnorm`` carry on the card against autograd of
their plain versions; phase 4 times both scan kernels at the training
shape.

Then it prints one JSON line describing the kernels, and as its last line
``{"ok": true, "device": {...}}``.

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
    card_info()
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
