#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero before the result line):

1. the card: name and power limit from nvidia-smi, CUDA required;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time, ptxas' register report per kernel
   and the resident blocks per SM of ``adaln_norm``, ``decode_attention``,
   ``flash_attention`` (each head width), ``rmsnorm`` (both of its
   kernels, in float32 and bfloat16, at the plans its shapes take),
   ``ssm_scan`` (one lane a channel, and the prefill's lanes) and
   ``ssm_scan_backward``;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (full-width gdm-dit at B in {1, 4, 8}, yi-6b's heads
   and widths, the trainer's rows, the reduced configs), on attention's
   masking cases, on ragged decode lengths at warp-slice, tile and split
   edges (G=7 and G=8 among them), on
   both load widths of adaLN and rmsnorm and on scans whose channels do
   not fill whole warps, in both layouts of the forward scan (each case
   prints its lanes a channel); tolerance 1e-5 (float32); adaLN, decode,
   rmsnorm and both scan kernels also against a second call, bit for
   bit;
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
    which must fail over; both must keep rows resident between steps;
16. granite-moe-1b-a400m at full width, card vs CPU: ``moe_apply`` alone
    on the train shape (B=8, S=128: 1024 tokens, 32 experts top-8,
    capacity 320, with drops) from the same input, then two full-width
    layers carried from JAX-layout numpy (``lm_from_jax``): a prefill,
    four greedy decode steps and six train steps through the trainer on
    the same batches.  Every MoE call's routing is recorded on both
    sides; an expert set that differs must be a near-tie (the k-th and
    (k+1)-th probabilities within ROUTE_TIE_TOL of the row's largest),
    outputs are held at phase 7's tolerance where the routing agreed, and
    a call with a differing token is re-run on the CPU from the card's
    input;
17. serve the edge launcher with full-width granite (24 layers, 5.34 GB)
    and full-width gdm-dit: launch counts exactly what the launcher's
    token and forward counts imply, the decode step's device and host ms
    beside its byte bound, peak memory; and granite's shapes of
    ``flash_attention``, ``decode_attention`` and ``rmsnorm`` timed;
18. train full-width granite six steps through
    ``repro_torch.launch.train.run`` (batch 8, seq 128, AdamW 3e-4): every
    loss, the exact launches of every step, device ms per phase, host ms
    per step, peak memory; then a two-layer full-width granite trained
    six steps straight and again with checkpoints at 3 and 6, the step-6
    checkpoint removed and the run resumed from step 3 (steps 4-6 must
    equal the straight run's, bit for bit where two straight runs are),
    with the bytes and seconds of the save and the restore; and
    ``compress_grads`` on one step's gradients card vs CPU;
19. the zoo's last three families at full width, depth cut, card vs CPU
    from the same weights: seamless-m4t-large-v2 with 2 encoder and 2
    decoder layers over 1024 audio frames, one xlstm-1.3b period (1 sLSTM
    + 7 mLSTM), llava-next-34b with 2 layers and 8 patches; a prefill (B=2,
    16 tokens) and four greedy decode steps (seamless cross-attending to
    its memory) held as phase 7 holds them, then six train steps with the
    stubs (``make_train_step``) held as phase 9 holds them, the xLSTM's
    step by step from a shared state, each step's gradients within what
    one ulp on every weight moves them on the card, beside six free steps
    card vs CPU and the card's own drift from one ulp;
20. seamless-m4t-large-v2 whole (24 + 24 layers, 2.04 B parameters):
    ``make_prefill_step`` over 1024 frames and 32 steps of
    ``make_serve_step`` with the memory, launches exact (72
    ``flash_attention`` a prefill, 48 ``decode_attention`` a step), the
    decode step's device ms (CUDA graph), served ms and bound; six train
    steps at B=8, S=128 with frame stubs: launches, device ms per phase,
    peak memory;
21. xlstm-1.3b whole (48 layers): served by the edge launcher beside full
    gdm-dit (49 ``rmsnorm`` a decode step, no attention kernel), six train
    steps at B=8, S=128 and one more profiled (kernels and device time
    against the host's); llava-next-34b at full width, 2 of 60 layers: a
    prefill of 2880 patches and 128 tokens and 16 served decode steps,
    launches exact, the step's device ms against its bound;
22. the closed loop on a mesh: ``make_env_mesh`` over ``cuda:0`` repeated
    1, 2 and 4 times (the number of distinct devices printed beside each
    size) and its degrade-to-divisor rule; ``train_fused`` on paper-fig3
    at E=8 for two rounds and the trained agent's ``evaluate_fused`` at
    each size, bit for bit and exactly equal to the unsharded run of the
    same seed; a 4-cell paper-fig3 fleet with three full-width gdm-dit
    services built on a mesh of 2, served quantum by ``serve_fleet``
    under the trained agent, equal to the unsharded fleet frame for
    frame, latents within 1e-5, one ``"shard"`` ledger row per handover
    of latents between mesh positions, the DiT kernels launched block
    calls x shards x L times; ``SlotBatch``'s per-shard resident rows
    against ``run_batch`` bit for bit; the phase's seconds;
23. the LM on ("data", "model") meshes over ``cuda:0``: full yi-6b's
    prefill and 32 serve steps at B=8 into a 512-row cache on (2, 8),
    whose model axis does not divide the 4 kv heads (the split-K decode:
    no ``decode_attention`` launch), and on (1, 4), whose does (32
    launches a step), each against the unsharded serve step (logits
    within LM_TOL of the largest, the first layer's cache bit for bit,
    the rest within LM_TOL); granite-moe's all-to-all MoE (two layers)
    card vs CPU on (1, 4) and (2, 4): loss, aux, every gradient and one
    step's update, routing differences near-ties; three whole train steps
    on (2, 4) twice, bit for bit, with exact launches, beside the
    unsharded step; two layers data parallel on (2, 1) within LM_TOL and
    on (1, 1) bit for bit with no mesh; ms per step and peak memory;
24. the DiT's training path at full width (gdm-dit: 12 layers, d=768,
    S=256, 166 M parameters): ``gdm_loss`` on the card against the CPU
    from one set of weights and the same injected timesteps and noise at
    B=2 (the loss within STEP_TOL, every gradient leaf within 1e-4 of its
    largest magnitude, three AdamW steps' losses within TRAIN_TOL); 300
    AdamW steps on the card from ``LatentDataset`` through ``prefetch`` at
    B=8, each launching exactly 12 of each adaLN form, of each adaLN
    backward and of ``flash_attention``, the loss falling (the reference
    test's criterion), with ms per step, one profiled step's device time
    and the card's idle share, peak memory, and Omega(k) of the random and
    the trained DiT (the reference's properties asserted); then
    ``from_gdm_model`` on the card and ``python -m
    repro_torch.examples.serve_gdm`` at small flags;
25. the cost counter (``repro_torch.distributed.op_cost``) on the card:
    full-width granite-moe-1b-a400m's train step (B=8, S=128) and full
    yi-6b's decode step (B=8, a 4096-row cache, every row in use), each
    counted on the card and on the meta device: the two ``Cost``s equal,
    every kernel charged exactly as often as it launched, the step's
    profiled device time at least the roofline's largest term on the H100
    (the fraction printed), the tracker's peak beside
    ``torch.cuda.max_memory_allocated``; ``repro_torch.launch.dryrun``'s
    ``run_cell`` on meta for yi-6b train_4k / prefill_32k / decode_32k and
    xlstm-1.3b long_500k on the single pod (each record and its seconds);
    a 2048-token request moved between two ``KVPagePool``s on the card at
    yi-6b's geometry with ``ServeConfig``'s page size (pages bit for bit,
    ``migration_bytes``, GB/s against 3.35 TB/s).
26. the reference's bfloat16 configuration of the LM: (a) the bfloat16
    variants of flash, decode, rmsnorm and the scan against their plain
    versions on bfloat16 inputs at the main paths' shapes (the DiT's,
    yi-6b's, granite's, llava's G=7, deepseek's G=8, the Jamba scan's in
    both layouts of the forward scan; a float32 query over the bfloat16
    cache; rmsnorm also with a float32 scale, its cases taking both of its
    kernels; flash at the edges of the
    wgmma kernel's 64-row warpgroups and 128-key tiles, decode at those of
    the tensor cores' 16-key warp slices and 64-key tiles), at the
    reference's bfloat16 bars, a second call bit for bit, then timed beside
    the float32 kernel from the same call, their bfloat16 bound and the
    library call in bfloat16 (the scan at Jamba's prefill and at the
    training shape, returning the state and saving its checkpoints); (b)
    full yi-6b in bfloat16 (12.1 GB of weights): a 128-token prefill and
    32 served decode steps through ``make_prefill_step`` /
    ``make_serve_step`` with the bfloat16 state,
    every launch exact (65 ``rmsnorm_bf16`` and 32
    ``decode_attention_bf16`` a step), the decode step's device ms against
    its bound from its ``Cost``, peak memory; two layers card vs CPU in
    bfloat16; (c) float32 yi-6b (two layers) over a bfloat16 state card vs
    CPU; (d) one full-width Jamba period in bfloat16, prefill and decode
    card vs CPU, the prefill through ``ssm_scan_bf16``; (e) yi-6b's decode
    step and granite's prefill in bfloat16 counted on the card equal to
    meta, and phase 25's dry-run cells in bfloat16 beside their float32
    argument bytes.
27. the DiT in bfloat16 (the reference's ``init_gdm(dtype=)``): (a) both
    adaLN forms on bfloat16 operands, with float32 and with bfloat16
    weights, against their plain versions at the DiT's shapes (B in {1,
    4}), the reference test's and the single-value widths, at the
    reference's 3e-2 and by row (``ADALN_ROW_TOL`` on the row's mean gap,
    ``BF16_ROW_TOL`` on its largest), a second call bit for bit, with
    controls that must fail the row bar (a row normalised with its
    neighbour's statistics; the epilogue's residual normalised after
    rounding); the float32 kernel reading bfloat16 weights at 1e-5; (b)
    full-width gdm-dit built in bfloat16 (seed 17), one ``gdm_denoise``
    at B=4 on a bfloat16 latent card vs CPU with exactly 12 launches of
    each bfloat16 adaLN form and of ``flash_attention_bf16``; (c) its
    device ms from a CUDA graph beside the float32 forward's in the same
    call, each with its profiled kernels, against the products' floor,
    and the bfloat16 adaLN kernels timed at B=1 and B=4 beside the
    float32 kernel; (d) ``quality_per_block`` over the bfloat16 weights
    with a float32 latent, card vs CPU, with exact float32 launches.
28. the reference's ``remat`` lever (``StepOptions().remat``, on by
    default in the train step; every earlier phase's train steps pass
    ``remat=False``, as the trainer does) and its bfloat16 train step:
    (a) ``ssm_scan_backward_bf16`` against autograd of the plain scan at
    the training shape and two ragged ones, at the reference's 5e-2 and
    by row (``SCAN_ROW_TOL`` on the row's mean gap), dA and dD at the
    float32 backward's 1e-5, a second call bit for bit, with controls
    that must fail the row bar (dB and dC from rounded partials, states
    recomputed from rounded checkpoints), timed beside the float32
    kernel with its profiled split between the reverse scan and the
    combine; (b) the full-width Jamba period built in bfloat16 trained
    with remat: two steps card vs CPU in lockstep (B=1, S=16; the leaves
    that bfloat16 rounding alone moves past 5e-2 held to twice the CPU's
    distance from float32), then five steps at B=8, S=128 with remat and
    five without from the same state,
    each forward kernel launched twice a period with remat, the two runs
    bit for bit, device ms and peaks both ways; (c) its train step and
    granite's (bfloat16, B=8, S=512) with remat counted on the card equal
    to meta, granite's counted peak falling with remat.

Phase 3 also holds the selective scan (forward and backward kernels)
against its plain version and autograd (and both against themselves: two
calls give the same bits), and the gradients that
``flash_attention`` (causal, non-causal with 128 queries against 1024
keys, and the DiT's training shape) and ``rmsnorm`` carry on the card
against autograd of their plain versions, and the adaLN backward kernel in
both forms (through ``ops.adaln_norm`` under autograd, at the adaLN
shapes and the backward's own: B=16, S=17, d=4096; r used and unused)
against autograd of the plain version, a second call bit for bit; phase 4
times both scan kernels at the training shape, the adaLN backward at B=4
and B=8 beside its forward (one clustered launch, profiled), and the
attention and norm kernels at the shapes of phases 19–21 (seamless's
encoder and cross-attention, llava's prefill and G=7 decode, deepseek's
G=8 decode, rows of 2048, 7168 and 8192).

Then it prints one JSON line describing the kernels (each kernel's
launches from the path that carries it: the DiT kernels from the fleet of
phase 15, decode and rmsnorm from phase 8, the scan kernels from phase
10, the adaLN backward from phase 24's training run, the bfloat16
variants from phase 26's yi-6b and Jamba runs, the bfloat16 adaLN forms
from phase 27's bfloat16 DiT forward, the bfloat16 scan backward from
phase 28's remat steps), and as its last
line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernel-times TREE`` builds the kernels of another
checkout's ``TREE/src/repro_torch`` (a parent commit unpacked with ``git
archive``) and times its adaLN, adaLN backward (B=8 and B=4, with its
profiled split by kernel and its residency), decode, rmsnorm and both
scan kernels, and the layers they serve (the DiT forward at B=4, the
device time and host enqueue of a yi-6b decode step, a full-width Jamba
Mamba block's forward at B=8, L=128), the bfloat16 scan at Jamba's
prefill and at the training shape and the bfloat16 backward at the
training shape (each with its profiled split by kernel), then decode in
bfloat16 and float32 at phase 26's six shapes (each with its profiled
split between the split kernel and the merge), bfloat16 flash at four
shapes (SDPA beside each) and yi-6b's bfloat16 decode step at B=1 and
at B=8 over 4096 rows, and the bfloat16 rmsnorm at seven shapes beside a
bfloat16 ``copy_`` of the same rows (``RMS_BF16_SHAPES``; the decode row
also one call at a time, warm and with L2 flushed), in this harness, so
that two trees are compared on one card in one run (parent, change,
change, parent); it ends with a ``{"tree": ..., "kernel_times": ...}``
line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
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
# dense bfloat16 on the tensor cores
PEAK_BF16_FLOPS = 989e12
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
# granite's routing, card vs CPU: a token's expert set may differ only
# where its k-th and (k+1)-th router probabilities lie within
# ROUTE_TIE_TOL of its largest, a near-tie that the float32 rounding of
# the router's input and product orders either way; the two sides' layer
# inputs may drift apart up to phase 7's LM_TOL (1e-4 relative), and a
# probability moves by about as much, relative
ROUTE_TIE_TOL = 1e-4
TIMED_RUNS = 25


def release() -> None:
    """Collect the heap and hand the allocator's free blocks back to the
    card: a model that only a reference cycle holds stays on the card
    until Python's collector happens to run, and the heaviest phase
    (phase 21's xlstm-1.3b training, 74.8 of the card's 79.2 GiB) has no
    room for one."""
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def phase(title: str) -> None:
    release()
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
             tf32_flops: float = 0.0, bf16_flops: float = 0.0):
    """The least time of the work, in ms, and what bounds it: its bytes at
    the memory rate, or its operations, float32 ``flops`` on the CUDA
    cores, ``tf32_flops`` and ``bf16_flops`` on the tensor cores and
    ``exps`` exponentials on the special-function units, which run side
    by side (the largest of the counts)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, exps / PEAK_SFU_PER_S,
                tf32_flops / PEAK_TF32_FLOPS,
                bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------

def _randn(gen, *shape, scale=1.0):
    import torch
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def adaln_inputs(gen, b, s, d, epilogue, offset=0, dtype=None,
                 params_dtype=None):
    """Main-path operands: modulation as (B, 1, d) chunks of one (B, 1, 6d)
    projection, as the DiT layer passes them; ``offset`` values into a
    wider projection, so that the chunks are not 16-byte aligned.  The
    draws are float32, rounded to ``dtype`` (x, the projection, the
    residual) and ``params_dtype`` (weight, bias) where given."""
    def cast(t, to):
        return t if to is None else t.to(to)
    x = cast(_randn(gen, b, s, d), dtype)
    mods = cast(_randn(gen, b, 1, 6 * d + offset, scale=0.1),
                dtype)[..., offset:]
    sh, sc, g = mods.chunk(6, dim=-1)[:3]
    w = cast(1.0 + _randn(gen, d, scale=0.1), params_dtype)
    bias = cast(_randn(gen, d, scale=0.1), params_dtype)
    extra = (g, cast(_randn(gen, b, s, d), dtype)) if epilogue else ()
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


# the backward's own shapes beside ADALN_CASES (whose B=1 at S=256 has 32
# clusters a batch row): B=16 (32 blocks, four clusters a batch row, 16
# batch rows drawing the second ticket), S=17 (17 blocks padded to 24),
# B=1 at S=17 unaligned, and d=4096 (the epilogue's 48 kB of shared sums)
ADALN_BACKWARD_CASES = [(16, 256, 768, 0), (3, 17, 768, 0), (1, 17, 768, 1),
                        (2, 8, 4096, 0)]


def adaln_launch_text(b, s, d, width, itemsize, epilogue):
    """Which adaLN kernel a call takes (``adaln_norm.launch_plan``) and
    its shape, as text."""
    import torch
    from repro_torch.kernels.adaln_norm import launch_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp_rows, threads, vpt = launch_plan(b, s, d, width, itemsize,
                                          epilogue, sms)
    if warp_rows:
        return (f"a warp a row, {vpt} vector(s) a lane, {threads // 32} "
                "warps a block")
    return f"a block a row of {threads} threads x {vpt}"


def check_adaln(gen):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adaln_norm import load_width
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
            name = "adaln_norm_epilogue" if epilogue else "adaln_norm"
            print(f"{name:20s} B={b} S={s} d={d} modulation offset "
                  f"{offset}: {4 * width}-byte loads, "
                  f"{adaln_launch_text(b, s, d, width, 4, epilogue)}; "
                  f"max|kernel - plain| = {err:.3e}; a second call "
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
    (8, 128, 128, 16, 8, 64, True, 0, 0),       # granite train / prefill
    (8, 1024, 1024, 16, 16, 64, False, 0, 0),   # seamless encoder
    (8, 128, 1024, 16, 16, 64, False, 0, 0),    # seamless cross, Sq < Sk
    (8, 128, 1000, 16, 16, 64, False, 0, 0),    # cross, ragged Sk
    (2, 16, 1024, 16, 16, 64, False, 0, 0),     # cross at phase 19's prompt
    (1, 3008, 3008, 56, 8, 128, True, 0, 0),    # llava prefill, G=7
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
    (1, 24, 16, 8, 64, [9]),                        # granite's decode
    (1, 24, 16, 8, 64, [24]),
    (1, 1024, 16, 16, 64, [1024]),                  # seamless cross decode
    (2, 1024, 16, 16, 64, [1024, 1024]),
    (1, 48, 16, 16, 64, [17]),                      # seamless self decode
    (1, 3024, 56, 8, 128, [3009]),                  # llava, G=7
    (1, 3024, 56, 8, 128, [3024]),
    (1, 4096, 64, 8, 128, [4096]),                  # deepseek, G=8
    (2, 4096, 64, 8, 128, [1, 3000]),
    # G=7 and G=8 at the edges of the 8-key warp slices, the 32-key tiles
    # and the 96-key splits (3 splits at S=200)
    (4, 200, 14, 2, 128, [8, 9, 33, 96]),
    (4, 200, 16, 2, 128, [0, 1, 31, 97]),
    (3, 200, 14, 2, 128, [95, 192, 193]),
    (3, 200, 16, 2, 64, [191, 200, 201]),
]


def check_decode(gen):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_grid, tile_keys
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
        splits, groups = decode_grid(b * kh, h // kh, s, sms,
                                     tile_keys(q.dtype, k.dtype))
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
# four and eight a thread), and d = 99 (no multiple of 4); granite's decode
# row and trainer's rows (d = 1024); xlstm-1.3b's (d = 2048), llava's
# (d = 7168: its prefill's 3008 rows) and deepseek's (d = 8192)
RMS_CASES = [(1, 4096, 0), (8192, 4096, 0), (1024, 4096, 0), (1, 2560, 0),
             (8192, 2560, 0), (1000, 4096, 0), (24, 64, 0), (7, 8192, 0),
             (5, 100, 0), (1, 4096, 1), (1024, 4096, 1), (3, 8192, 1),
             (5, 99, 0), (1, 1024, 0), (1024, 1024, 0), (1, 2048, 0),
             (1024, 2048, 0), (1, 7168, 0), (3008, 7168, 0), (1, 8192, 0),
             (1024, 8192, 0)]


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


def scan_layout(b, din, n):
    """Threads a channel the forward scan takes at (B, Din, N) on this card
    (``kernels.ssm_scan.scan_lanes``; 1 in a tree without that rule)."""
    import torch
    from repro_torch.kernels import ssm_scan
    rule = getattr(ssm_scan, "scan_lanes", None)
    if rule is None:
        return 1
    return rule(b, din, n,
                torch.cuda.get_device_properties(0).multi_processor_count)


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
    layouts = set()
    for (b, length, din, n) in SCAN_CASES:
        lanes = scan_layout(b, din, n)
        layouts.add(lanes > 1)
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
        print(f"ssm_scan B={b} L={length} Din={din} N={n} ({lanes} "
              f"lane(s) a channel): y {ey:.3e} (rel "
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
    assert layouts == {False, True}, \
        "SCAN_CASES do not reach both layouts of the forward scan"
    return worst


def check_adaln_backward(gen):
    """The adaLN backward kernel in both forms, through ``ops.adaln_norm``
    under autograd (``AdaLNNormFn``, the training path), against autograd
    of the plain version at phase 3's adaLN shapes and
    ``ADALN_BACKWARD_CASES``: the modulation a
    (B, 1, 6d) projection's chunks (a leaf whose gradient gathers shift,
    scale and gate), aligned and one float off; the epilogue with r used
    (dr given) and unused.  Relative to each gradient's largest magnitude,
    within GRAD_TOL; the wrapper called twice gives the same bits.
    Returns the largest absolute errors per form."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adaln_norm import adaln_norm_backward_cuda
    worst = {"adaln_norm_backward": 0.0, "adaln_norm_epilogue_backward": 0.0}
    t0 = time.perf_counter()
    for (b, s, d, offset) in ADALN_CASES + ADALN_BACKWARD_CASES:
        for epilogue, with_dr in ((False, False), (True, True),
                                  (True, False)):
            x = _randn(gen, b, s, d)
            mods = _randn(gen, b, 1, 6 * d + offset, scale=0.1)
            w = 1.0 + _randn(gen, d, scale=0.1)
            bias = _randn(gen, d, scale=0.1)
            res = _randn(gen, b, s, d) if epilogue else None
            dy = _randn(gen, b, s, d)
            dr = _randn(gen, b, s, d) if with_dr else None
            leaves = [t.requires_grad_() for t in (x, mods, w, bias) + (
                (res,) if epilogue else ())]

            def operands():
                """The forward's operands: shift, scale and gate as (B, d)
                views of the projection, row stride 6d + offset."""
                sh, sc, g = (t.reshape(b, d) for t in
                             mods[..., offset:].chunk(6, dim=-1)[:3])
                return (x, sh, sc, w, bias) + ((g, res) if epilogue else ())

            def grads(fn):
                out = fn(*operands())
                outs = (out[0], out[1]) if epilogue else (out,)
                cots = (dy, dr) if epilogue else (dy,)
                if epilogue and dr is None:
                    outs, cots = outs[:1], cots[:1]
                return torch.autograd.grad(outs, leaves, cots)

            got = grads(ops.adaln_norm)
            want = grads(ref.adaln_norm)
            rels = [_rel(g_, w_) for g_, w_ in zip(got, want)]
            with torch.no_grad():
                ins = operands()
                call = lambda: adaln_norm_backward_cuda(  # noqa: E731
                    *ins[:5], dy, *ins[5:], dr=dr)
                same = all(torch.equal(p, q) for p, q in zip(call(), call()))
            name = ("adaln_norm_epilogue_backward" if epilogue
                    else "adaln_norm_backward")
            names = ("dx", "dmods", "dw", "db") + (("dres",) if epilogue
                                                  else ())
            print(f"{name:28s} B={b} S={s} d={d} modulation offset {offset}"
                  f"{', dr given' if with_dr else ''}: vs autograd of the "
                  "plain version rel " + ", ".join(
                      f"{n} {r:.2e}" for n, (_, r) in zip(names, rels))
                  + f"; a second call bit-identical: {same}")
            assert max(r for _, r in rels) <= GRAD_TOL, \
                f"{name} disagrees with autograd of the plain version"
            assert same, f"{name} is not deterministic"
            worst[name] = max(worst[name], *(e for e, _ in rels))
    print(f"the adaLN backward's checks took {time.perf_counter() - t0:.1f} "
          "s")
    return worst


def check_kernel_grads(gen):
    """The gradients flash_attention and rmsnorm carry on the card (their
    autograd functions) against autograd of the plain versions, at the
    training shapes (Jamba's heads at B=8, S=128; the DiT's at B=8, S=256,
    non-causal; 1024 rows of 4096), and the adaLN backward kernel
    (``check_adaln_backward``, whose errors it returns)."""
    import torch
    from repro_torch.kernels import ops, ref
    q = _randn(gen, 8, 128, 32, 128).requires_grad_()
    k = _randn(gen, 8, 128, 8, 128).requires_grad_()
    v = _randn(gen, 8, 128, 8, 128).requires_grad_()
    do = _randn(gen, 8, 128, 32, 128)
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(ref.attention(q, k, v), (q, k, v), do)
    errs = [_rel(g, w)[1] for g, w in zip(got, want)]
    # seamless's cross-attention in training: 128 queries, 1024 memory rows
    q = _randn(gen, 8, 128, 16, 64).requires_grad_()
    k = _randn(gen, 8, 1024, 16, 64).requires_grad_()
    v = _randn(gen, 8, 1024, 16, 64).requires_grad_()
    do = _randn(gen, 8, 128, 16, 64)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False),
                              (q, k, v), do)
    want = torch.autograd.grad(ref.attention(q, k, v, causal=False),
                               (q, k, v), do)
    errs_x = [_rel(g, w)[1] for g, w in zip(got, want)]
    # the DiT's training shape: B=8, S=256, 12 heads of 64, non-causal
    q, k, v = (_randn(gen, 8, 256, 12, 64).requires_grad_()
               for _ in range(3))
    do = _randn(gen, 8, 256, 12, 64)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False),
                              (q, k, v), do)
    want = torch.autograd.grad(ref.attention(q, k, v, causal=False),
                               (q, k, v), do)
    errs_dit = [_rel(g, w)[1] for g, w in zip(got, want)]
    x = _randn(gen, 8, 128, 4096).requires_grad_()
    w = (1.0 + _randn(gen, 4096, scale=0.1)).requires_grad_()
    dy = _randn(gen, 8, 128, 4096)
    got = torch.autograd.grad(ops.rmsnorm(x, w), (x, w), dy)
    want = torch.autograd.grad(ref.rmsnorm(x, w), (x, w), dy)
    errs_rms = [_rel(g, ww)[1] for g, ww in zip(got, want)]
    print("flash_attention gradients (B=8, S=128, H=32, KH=8, D=128, causal) "
          "vs autograd of the plain version, rel: dq {:.2e}, dk {:.2e}, dv "
          "{:.2e}".format(*errs))
    print("flash_attention gradients (B=8, Sq=128, Sk=1024, H=16, D=64, "
          "non-causal: seamless's cross-attention) vs autograd of the plain "
          "version, rel: dq {:.2e}, dk {:.2e}, dv {:.2e}".format(*errs_x))
    print("flash_attention gradients (B=8, S=256, H=12, D=64, non-causal: "
          "the DiT's training shape) vs autograd of the plain version, rel: "
          "dq {:.2e}, dk {:.2e}, dv {:.2e}".format(*errs_dit))
    print("rmsnorm gradients (1024 x 4096) vs autograd of the plain "
          "version, rel: dx {:.2e}, dscale {:.2e}".format(*errs_rms))
    assert max(errs + errs_x + errs_dit + errs_rms) <= GRAD_TOL, \
        "a kernel's gradient disagrees with autograd of its plain version"
    return check_adaln_backward(gen)


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


def time_adaln_backward(gen, b, s, d):
    """The adaLN backward kernel in both forms at (B, S, d), the epilogue
    with dr (as the DiT's training step gives it), beside its plain
    version and, from the same call, the forward kernel.  The bound counts
    the rows it must move (x and dy read, dx written; the epilogue also
    residual and dr read, dresidual written) and the d- and (B, d)-sized
    operands and gradients once each."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adaln_norm import adaln_norm_backward_cuda
    out = {}
    for epilogue in (False, True):
        name = ("adaln_norm_epilogue_backward" if epilogue
                else "adaln_norm_backward")
        args = adaln_inputs(gen, b, s, d, epilogue)
        flat = [a.reshape(b, d) if a.dim() == 3 and a.shape[1] == 1 else a
                for a in args]
        dy = _randn(gen, b, s, d)
        dr = _randn(gen, b, s, d) if epilogue else None
        rows = b * s * d
        nbytes = 4 * ((6 if epilogue else 3) * rows
                      + (5 if epilogue else 3) * b * d + 4 * d)
        flops = (25 if epilogue else 20) * rows
        t_bound, by = bound_ms(nbytes, flops)
        out[name] = dict(
            ms=device_ms(lambda: adaln_norm_backward_cuda(
                *flat[:5], dy, *flat[5:], dr=dr)),
            plain_ms=device_ms(lambda: ref.adaln_norm_backward(
                *flat[:5], dy, *flat[5:], dr=dr)),
            bound_ms=t_bound, bound_by=by, library_ms=None,
            forward_ms=device_ms(lambda: ops.adaln_norm(*args)))
        got = adaln_norm_backward_cuda(*flat[:5], dy, *flat[5:], dr=dr)
        want = ref.adaln_norm_backward(*flat[:5], dy, *flat[5:], dr=dr)
        out[name]["err"] = max(_rel(g, w)[0] for g, w in zip(got, want))
        out[name]["mb"] = nbytes / 1e6
        out[name]["split"] = kernel_split(lambda: adaln_norm_backward_cuda(
            *flat[:5], dy, *flat[5:], dr=dr))
    for name, t in out.items():
        _print_times(f"{name:28s} B={b} S={s} d={d}", t)
        print(f"  {t.pop('mb'):.2f} MB to move; the forward kernel of the "
              f"same form {t.pop('forward_ms'):.7f} ms in this call; "
              f"max|kernel - plain| of the timed call {t.pop('err'):.3e}; "
              "profiled device ms by kernel (mean of 5 calls): " + ", ".join(
                  f"{k} {v:.7f}" for k, v in t["split"].items()))
    return out


def kernel_split(fn, calls: int = 5, tries: int = 3):
    """Device ms that one ``fn()`` spends in each kernel, by kernel name
    (the part before its template arguments), summed over its launches
    and averaged over ``calls`` calls under ``torch.profiler``.  A session
    that records no device event (seen now and then on the card) is run
    again, up to ``tries`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("<")[0].split("::")[-1].split("(")[0]
                times[name] = (times.get(name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / calls)
        if times:
            break
    return times


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


def time_decode(gen, b, s, length, cold=False, heads=(32, 4, 128)):
    """decode_attention at ``heads`` (H, KH, D; yi-6b's by default), every
    row ``length`` long, against
    ``scaled_dot_product_attention`` (GQA, boolean length mask).  The bound
    counts the cache rows these lengths read.  With ``cold``, one call is
    also timed with L2 flushed before it by a 64 MB write (the served step
    streams the weights between two layers' attention), beside one warm
    call in the same single-call harness."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    h, kh, d = heads
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


def time_training_kernels(gen, shape=(8, 128, 32, 8, 128), d_model=4096):
    """flash_attention and rmsnorm at a training shape (B, S, H, KH, D;
    Jamba's by default) and width, forward."""
    b, s, h, kh, d = shape
    return {"flash_attention": time_flash(gen, b, s, s, h, kh, d, True),
            "rmsnorm": time_rmsnorm(gen, b * s, d_model)}


def time_flash(gen, b, sq, sk, h, kh, d, causal, runs=TIMED_RUNS, reps=10):
    """flash_attention at (B, Sq, Sk, H over KH, D), causal or not,
    against its plain version and ``scaled_dot_product_attention``, with
    its bound from the unmasked (query, key) pairs this call computes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q = _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, kh, d), _randn(gen, b, sk, kh, d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    what = (f"flash_attention B={b} Sq={sq} Sk={sk} H={h} KH={kh} D={d} "
            f"{'causal' if causal else 'non-causal'}")
    t_bound, by = flash_bound(4 * 2 * (b * sq * h * d + b * sk * kh * d),
                              b * h * pairs, d, what)
    kw = dict(runs=runs, reps=reps)
    t = dict(ms=device_ms(lambda: ops.flash_attention(q, k, v,
                                                      causal=causal), **kw),
             plain_ms=device_ms(lambda: ref.attention(q, k, v,
                                                      causal=causal), **kw),
             bound_ms=t_bound, bound_by=by,
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True), **kw))
    _print_times(what, t)
    return t


def zoo_kernels(gen):
    """The three kernels at the shapes the zoo's last families give them:
    seamless's encoder (B=8, 1024 frames) and cross-attention (128 queries
    against 1024 memory rows; one decode token against them), llava's
    prefill (S=3008, 56 heads over 8, D=128) and decode (G=7), deepseek's
    decode (G=8), and rmsnorm on xlstm-1.3b's, llava's and deepseek's
    rows."""
    out = {
        "flash_attention encoder": time_flash(gen, 8, 1024, 1024, 16, 16,
                                              64, False),
        "flash_attention cross": time_flash(gen, 8, 128, 1024, 16, 16, 64,
                                            False),
        "flash_attention llava prefill": time_flash(
            gen, 1, 3008, 3008, 56, 8, 128, True, runs=10, reps=2),
        "decode_attention cross": time_decode(gen, 1, 1024, 1024, cold=True,
                                              heads=(16, 16, 64)),
        "decode_attention llava": time_decode(gen, 1, 3024, 3009,
                                              heads=(56, 8, 128)),
        "decode_attention deepseek": time_decode(gen, 1, 4096, 4096,
                                                 heads=(64, 8, 128)),
    }
    for rows, d in ((1, 2048), (1024, 2048), (1, 7168), (3008, 7168),
                    (1, 8192)):
        out[f"rmsnorm {rows}x{d}"] = time_rmsnorm(gen, rows, d)
    return out


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
    served_graphs(services, cfg)
    return launches


def graphs_held(services) -> int:
    """The block-call graphs ``services`` hold, over their shards."""
    return sum(len(g) for svc in services.values() for g in svc.graphs)


def own_kernel(name: str):
    """The ``LAUNCHES`` name of a profiled kernel of the DiT's sources
    (either adaLN form, attention), from its demangled or mangled name
    (adaLN's last template argument is its epilogue flag); else None."""
    if "flash_kernel" in name or "flash_wgmma_kernel" in name:
        return "flash_attention"
    if "adaln_kernel" not in name and "adaln_rows_kernel" not in name:
        return None
    args = re.search(r"adaln(?:_rows)?_kernel<([^>]*)>", name)
    if args is not None:
        epilogue = args.group(1).split(",")[-1].strip() in ("true", "1")
    else:
        flags = re.findall(r"Lb([01])E", name)
        if not flags:
            return "adaln_norm (form unread)"
        epilogue = flags[-1] == "1"
    return "adaln_norm_epilogue" if epilogue else "adaln_norm"


def kernel_counts(fn, tries: int = 3):
    """The kernels one ``fn()`` launches on the card, by name with their
    count, from ``torch.profiler``; a session that records no device
    event (seen now and then on the card) is run again, up to ``tries``
    sessions."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = collections.Counter()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if names:
            break
    return names


def _short(name: str) -> str:
    return name.split("<")[0].split("(")[0].split()[-1].split("::")[-1] \
        if "<" in name or "(" in name else name


def served_graphs(services, cfg, host_runs: int = 20):
    """Phase 6's graphs: for every (service, bucket) the trace served,
    ``run_batch`` by replay against ``run_block_batched`` called eagerly
    on the same staged rows (bit for bit; else the kernels of both sides
    are printed and the gap held to STEP_TOL), the launches the replay
    added against its capture's record and against the kernels the
    profiler sees in one replay; then for each bucket the host ms of one
    block call eagerly and by replay (rows copied in, the call, both
    outputs copied back, synchronously, as ``run_batch`` does; and the
    host's enqueue alone) and the device ms of one call both ways."""
    import collections
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.gdm import run_block_batched
    rng = np.random.default_rng(11)
    timed = {}
    n_graphs = graphs_held(services)
    for s, svc in services.items():
        graphs = svc.graphs[0]
        buckets = sorted(b for b, masked in graphs.keys() if not masked)
        assert buckets and len(graphs) == len(graphs.keys()), \
            (s, graphs.keys(), len(graphs))
        for bucket in buckets:
            entry = graphs.entry((bucket, False))
            assert entry is not None, f"no graph at bucket {bucket}"
            record = collections.Counter(name for name, _ in entry.record)
            states = [svc.init_state(rng) for _ in range(bucket)]
            blocks = np.arange(bucket) % svc.num_blocks
            before = dict(LAUNCHES)
            got, _ = svc.run_batch(states, blocks)
            added = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                     if LAUNCHES[k] != before[k]}
            assert added == dict(record) == {
                k: cfg.num_layers for k in ("adaln_norm",
                                            "adaln_norm_epilogue",
                                            "flash_attention")}, \
                (bucket, added, record)
            staged = [t.cuda() for t, _ in svc._staging(bucket)]
            with torch.no_grad():
                want = [w.cpu().numpy() for w in run_block_batched(
                    svc.model, *staged[:2], svc.schedule, staged[2],
                    steps_per_block=svc.steps_per_block,
                    total_steps=svc.num_blocks * svc.steps_per_block)]
            err = max(float(np.abs(g[key] - w[i]).max())
                      for i, g in enumerate(got)
                      for key, w in zip(("latent", "x0"), want))
            # the profiler now and then loses a replay's last kernels
            # (seen on the card): a session short of the record is run
            # again, up to three
            for sessions in range(1, 4):
                replay = kernel_counts(entry.graph.replay)
                own = collections.Counter()
                for name, n in replay.items():
                    if own_kernel(name) is not None:
                        own[own_kernel(name)] += n
                if own == record or any(own[k] > record[k] for k in own):
                    break
            if err != 0.0 or own != record:
                with torch.no_grad():
                    eager = kernel_counts(lambda: graphs.fn(*staged))
                for side, names in (("replay", replay), ("eager", eager)):
                    print(f"  service {s} bucket {bucket}, {side}: "
                          + ", ".join(f"{_short(k)} x{n}"
                                      for k, n in sorted(names.items())))
            print(f"service {s} bucket {bucket}: run_batch by replay vs "
                  f"run_block_batched eagerly on the staged rows, max|diff| "
                  f"{err:.3e} ({'bit for bit' if err == 0 else 'NOT bit for bit, tolerance ' + str(STEP_TOL)}); "
                  f"the replay added {sum(added.values())} launches = its "
                  f"record; the profiler sees {sum(replay.values())} "
                  f"kernels in one replay, {dict(own)} of them the port's "
                  f"(profiler sessions: {sessions})")
            assert own == record, (s, bucket, dict(own), dict(record))
            assert err <= STEP_TOL, (s, bucket, err)
            if bucket not in timed:
                timed[bucket] = block_call_times(svc, bucket, host_runs)
    for bucket, t in sorted(timed.items()):
        print(f"block call at bucket {bucket}, full width: host "
              f"{t['eager_host_ms']:.4f} ms eagerly, "
              f"{t['replay_host_ms']:.4f} ms by replay (rows in, call, "
              f"outputs back; median of {host_runs}); enqueue alone "
              f"{t['eager_enqueue_ms']:.4f} ms eagerly, "
              f"{t['replay_enqueue_ms']:.4f} ms by replay; device "
              f"{t['eager_device_ms']:.4f} ms eagerly, "
              f"{t['replay_device_ms']:.4f} ms by replay")
    print(f"graphs captured over phase 6: {n_graphs} (one per service and "
          f"bucket served); peak device memory after the checks "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return timed


def failed_capture_raises() -> None:
    """A capture that fails (a read back to the host inside it) raises and
    keeps no graph.  Run last: PyTorch skips the caching allocator's end
    of the capture when the capture's end fails, so the allocator goes on
    taking the capture stream's allocations into the graph's pool and no
    longer empties its cache (seen on the card: run in phase 6, it left
    phase 19 out of memory with most of the card reserved and free)."""
    import torch
    from repro_torch.graphs import Graphs
    failing = Graphs(lambda x: x * float(x.sum().item()))
    try:
        failing("read back", "cuda", torch.ones(4))
        raised = None
    except RuntimeError as err:             # torch.AcceleratorError
        raised = err
    assert raised is not None and not failing.keys(), \
        "a capture that reads back did not raise"
    print(f"a capture that reads back raised {type(raised).__name__} and "
          f"kept no graph")


def block_call_times(svc, bucket: int, host_runs: int):
    """Host and device ms of ``svc``'s block call at ``bucket`` on its
    staged rows, eagerly and by replay (see :func:`served_graphs`)."""
    import torch
    key, dev = (bucket, False), svc.device
    graphs = svc.graphs[0]
    entry = graphs.entry(key)
    staged = [t for t, _ in svc._staging(bucket)]
    on_card = [t.to(dev) for t in staged]
    ways = {"eager": lambda: graphs.fn(*(t.to(dev, non_blocking=True)
                                         for t in staged)),
            "replay": lambda: graphs(key, dev, *staged)}
    out = {}
    with torch.no_grad():
        for way, call in ways.items():
            walls, enqueues = [], []
            for _ in range(host_runs + 3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = call()
                t1 = time.perf_counter()
                for o in outs:
                    o.cpu()
                walls.append(time.perf_counter() - t0)
                enqueues.append(t1 - t0)
            out[f"{way}_host_ms"] = statistics.median(walls[3:]) * 1e3
            out[f"{way}_enqueue_ms"] = statistics.median(enqueues[3:]) * 1e3
        out["eager_device_ms"] = device_ms(lambda: graphs.fn(*on_card),
                                           runs=5, reps=1,
                                           sleep_cycles=60_000_000)
        out["replay_device_ms"] = device_ms(entry.graph.replay, runs=10,
                                            reps=5)
    return out


# -- phase 7: LM steps, card vs CPU ---------------------------------------------

def _state_tensors(state):
    """Every tensor of a decode state, slot by slot (KV caches and their
    lengths, Mamba conv tails and SSM states, mLSTM and sLSTM states and
    conv tails), on the CPU."""
    return [t.cpu() for slot in state for key in sorted(slot)
            for t in (slot[key] if isinstance(slot[key], tuple)
                      else (slot[key],))]


def lm_vs_cpu(cfg, prompt_len: int = 16, steps: int = 4, model=None,
              route=None, batch: int = 1, stubs=None, state_dtype=None,
              tol: float = LM_TOL, teacher: bool = False):
    """One prefill and ``steps`` greedy decode steps of ``cfg`` on the card
    and on the CPU from the same weights (``model``'s, or drawn from a
    seed): the largest gaps in logits and in the decode state (and in the
    enc-dec encoder's memory), relative to the largest |logit| and |state
    value|, and the token streams.  ``stubs`` (CPU tensors) are the
    family's "patch_embeds" or "enc_frames"; decode cross-attends to the
    prefill's memory.  With ``route`` (a ``RouteCheck`` in force), the MoE
    calls are held as it holds them; a token routed to another expert set
    at a near-tie changes everything after it, so the logits, state and
    tokens are then left to the per-layer comparison.  The state in
    ``state_dtype`` (float32 unless given), the CPU's model in the card
    model's dtype; gaps are taken in float32 and held to ``tol``.  With
    ``teacher`` (bfloat16, where the two sides' rounding can order a
    near-tie of the greedy choice either way) the CPU runs first and the
    card decodes the CPU's tokens, the greedy streams printed, not held."""
    import torch
    from repro_torch.models.lm import (LM, init_lm, lm_decode_step,
                                       lm_prefill)
    model = model if model is not None else init_lm(cfg, seed=11,
                                                    device="cuda")
    state_dtype = state_dtype or torch.float32
    cpu_model = LM(cfg, device="cpu", dtype=model.embed.table.dtype)
    cpu_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(2, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, dtype=torch.int32)
    runs = {}
    sides = [("card", "cuda", model), ("cpu", "cpu", cpu_model)]
    with torch.no_grad():
        for side, dev, m in sides[::-1] if teacher else sides:
            kw = {k: v.to(dev) for k, v in (stubs or {}).items()}
            logits, state, memory = lm_prefill(
                m, prompt.to(dev), max_seq=prompt_len + steps + 4,
                state_dtype=state_dtype, **kw)
            outs, tokens = [logits[:, -1]], []
            for i in range(steps):
                tok = outs[-1][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                tokens.append(tok.tolist())
                if teacher and side == "card":
                    tok = torch.tensor(runs["cpu"][1][i], dtype=torch.int32,
                                       device=dev)
                logits, state = lm_decode_step(m, tok, state, memory=memory)
                outs.append(logits)
            runs[side] = ([o.float().cpu() for o in outs], tokens,
                         [t.float() if t.is_floating_point() else t
                          for t in _state_tensors(state)],
                         None if memory is None else memory.float().cpu())
    del cpu_model
    (g_out, g_tok, g_state, g_mem), (c_out, c_tok, c_state, c_mem) = \
        runs["card"], runs["cpu"]
    if c_mem is not None:
        assert torch.isfinite(g_mem).all(), "non-finite memory on the card"
        mem_rel = _rel(g_mem, c_mem)[1]
        print(f"encoder memory {tuple(c_mem.shape)}: max|card - cpu| / "
              f"max|cpu| = {mem_rel:.3e} (tolerance {tol})")
        assert mem_rel <= tol, "the encoder's memory differs"
    for o in g_out:
        assert torch.isfinite(o).all(), "non-finite logits on the card"
    scale = max(float(o[:, :cfg.vocab_size].abs().max()) for o in c_out)
    gap = max(float((g[:, :cfg.vocab_size] - c[:, :cfg.vocab_size])
                    .abs().max()) for g, c in zip(g_out, c_out))
    floats = [(g, c) for g, c in zip(g_state, c_state) if c.is_floating_point()]
    st_scale = max(float(c.abs().max()) for _, c in floats)
    st_gap = max(float((g - c).abs().max()) for g, c in floats)
    print(f"{cfg.name}, {cfg.num_layers} layers, vocab {cfg.vocab_size}: "
          f"B={batch}, prefill {prompt_len} + {steps} decode steps"
          f"{' with ' + ', '.join(stubs) if stubs else ''}; max|card - cpu| "
          f"logits {gap:.3e} (max|logit| {scale:.3f}, relative "
          f"{gap / scale:.3e}), decode state {st_gap:.3e} (max "
          f"{st_scale:.3f}, relative {st_gap / st_scale:.3e}); tolerance "
          f"{tol} relative")
    print(f"greedy tokens: card {g_tok}, cpu {c_tok}"
          + (" (the card decoded the CPU's)" if teacher else ""))
    if route is not None:
        route.report(f"{cfg.name} prefill + decode")
        if route.swaps:
            print("a near-tie routed a token to another expert set: the "
                  "logits, state and tokens after it are held by the "
                  "per-layer comparison above")
            return
    assert gap / scale <= tol, "logits on the card disagree with the CPU"
    assert st_gap / st_scale <= tol, "decode state on the card disagrees"
    assert teacher or g_tok == c_tok, \
        "greedy tokens differ between card and CPU"
    for g, c in zip(g_state, c_state):
        if not c.is_floating_point():
            assert torch.equal(g, c), "cache lengths differ"


# -- phase 8: serve the edge launcher at full width --------------------------------

def time_decode_step(lm, state=None, memory=None):
    """The two sides of one decode step (B=1; from ``state``, an empty
    64-row state by default, cross-attending to ``memory`` where given):
    the host's time to enqueue it, from an idle card (median of 5), and
    the card's time to run it with no host in the way, as a replay of a
    CUDA graph of the step (``device_ms``).  The graph is a measuring
    device only: the launcher and the serve step run eagerly."""
    import torch
    from repro_torch.models.lm import init_decode_state, lm_decode_step
    if state is None:
        state = init_decode_state(lm.cfg, 1, 64, dtype=torch.float32,
                                  device="cuda")
    tok = torch.full((1,), 7, dtype=torch.int32, device="cuda")

    def step():
        lm_decode_step(lm, tok, state, memory=memory)

    host = []
    with torch.no_grad():
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
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
    # an MoE layer computes every expert on its mostly empty (E, C, d)
    # buffer, as the reference does, so a step reads them all
    step_bytes = _decode_weight_bytes(lm)
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
    print(f"{lm_cfg.name}: {lm_cfg.num_layers} layers, {weights / 1e9:.2f} GB of "
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
    assert step_ms > 0
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
    # the launcher decodes without an encoder memory, as the reference's
    per_step = decode_launches(lm_cfg)
    expected = dict.fromkeys(LAUNCHES, 0)
    expected.update(
        adaln_norm=per_fwd, adaln_norm_epilogue=per_fwd,
        flash_attention=per_fwd,
        decode_attention=per_step["decode_attention"] * counters.lm_tokens,
        rmsnorm=per_step["rmsnorm"] * counters.lm_tokens)
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


def train_vs_cpu(cfg, tcfg, batch_size: int = 2, seq_len: int = 64,
                 model=None, route=None, stubs_fn=None):
    """``tcfg.total_steps`` train steps of ``cfg`` through
    ``repro_torch.launch.train.run`` on the card and on the CPU, from the
    same weights (``model``'s, or drawn from a seed) on the same batches.
    Checks the first batch's loss and every gradient (autograd of
    ``lm_loss``), the first step's gradient norm and update, every step's
    loss and the final parameters.  With ``route`` (a ``RouteCheck`` in
    force) the MoE calls are held as it holds them, and if the first
    batch routed a token to another expert set at a near-tie, the expert
    leaves' first gradients and updates are left out.  With ``stubs_fn``
    the batches carry the family's stubs (``train_run``).  Returns the
    card's model, trained."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch.steps import trainable
    from repro_torch.models.lm import LM, init_lm, lm_loss
    from repro_torch.optim.schedules import cosine_decay
    model = model if model is not None else init_lm(cfg, seed=11,
                                                    device="cuda")
    cpu_model = LM(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    models = {"card": model, "cpu": cpu_model}
    # the comparisons run on the card, where the bulk arithmetic is cheap
    cmp = model.embed.table.device
    p0 = {k: p.detach().clone() for k, p in trainable(model).items()}
    # run's first batch
    batch = {k: torch.from_numpy(v) for k, v in TokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch_size,
        seed=tcfg.seed)).batch_at(0).items()}
    if stubs_fn is not None:
        batch.update(stubs_fn(0))
    loss0, grads = {}, {}
    for side, m in models.items():
        params = trainable(m)
        total, _ = lm_loss(m, {k: v.to(m.embed.table.device)
                               for k, v in batch.items()})
        g = torch.autograd.grad(total, list(params.values()))
        loss0[side] = float(total.detach())
        grads[side] = {k: x.to(cmp) for k, x in zip(params, g)}
    if route is not None and route.swaps:
        print(f"the first batch routed {route.swaps} token(s) to another "
              "expert set at a near-tie: its expert leaves' gradients and "
              "first updates are left out")
        for side in grads:
            grads[side] = {k: x for k, x in grads[side].items()
                           if ".moe." not in k}
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
                after1[side] = {k: p.detach().to(cmp, copy=True)
                                for k, p in trainable(m).items()}
                norm1[side] = float(metrics["grad_norm"])
        print(f"train.run on the {side}:" if stubs_fn is None else
              f"make_train_step with stubs on the {side}:")
        t0 = time.perf_counter()
        runs[side] = train_run(cfg, tcfg, m, batch_size, seq_len,
                               stubs_fn=stubs_fn, on_step=on_step)
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
    finals = {side: {k: p.detach().to(cmp) for k, p in trainable(m).items()}
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
    if route is not None:
        route.report(f"{cfg.name} train steps")
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


def train_lockstep_vs_cpu(cfg, tcfg, model, batch_size: int = 2,
                          seq_len: int = 16, nudge: str = ""):
    """``tcfg.total_steps`` train steps card vs CPU in lockstep: before
    each step the CPU copy takes the card's parameters and AdamW state, so
    both sides take every step from the same state on the same batch.
    For a model whose training amplifies rounding (the xLSTM at full
    width: two float32 runs apart by one ulp drift past phase 9's loss
    tolerance within six steps), this holds every step to phase 9's
    tolerances for one step: the loss within TRAIN_TOL, the gradient norm
    within LM_TOL, and the update, on the elements whose update cannot
    hinge on rounding (a new first moment the same on both sides, or 1000
    times the leaf's largest gap), within 1e-2 of the CPU's plus 2 ulp.
    Every leaf's clipped gradient (as ``make_train_step`` hands it to
    AdamW) is held within LM_TOL of the leaf's largest at step 1, as phase
    9 holds the first batch's, and at every step within the larger of
    LM_TOL and the gap that one ulp up on every weight opens on the card
    itself: the CPU may be no farther from the card than rounding moves
    the card.  Then six free steps from the initial weights on the card,
    on the CPU, and on the card with leaf ``nudge`` one ulp up: the free
    card-vs-CPU loss gap is printed beside the card's own one-ulp gap,
    and the card's own gap has to pass TRAIN_TOL, or the model does not
    amplify rounding and the lockstep stands in for the free check
    without cause."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch import steps
    from repro_torch.launch.steps import make_train_step, trainable
    from repro_torch.models.lm import LM, lm_loss
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import cosine_decay
    start = {k: p.detach().clone() for k, p in trainable(model).items()}
    assert nudge in start, f"no parameter {nudge!r} to nudge"
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    models = {"card": model, "cpu": cpu}
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                   global_batch=batch_size, seed=tcfg.seed))
    step_fn = make_train_step(cfg, tcfg,
                              opts=steps.StepOptions(remat=False))
    init = adamw(tcfg.learning_rate)[0]
    opt = {side: init(trainable(m)) for side, m in models.items()}
    lr_fn = cosine_decay(tcfg.learning_rate, tcfg.warmup_steps,
                         tcfg.total_steps)
    eps = torch.finfo(torch.float32).eps
    # the clipped gradients as the step hands them to AdamW, which only
    # reads them
    clip, clipped = steps.clip_by_global_norm, []

    def clip_and_keep(grads, max_norm):
        out = clip(grads, max_norm)
        clipped.append(dict(out[0]))
        return out

    steps.clip_by_global_norm = clip_and_keep
    t0 = time.perf_counter()
    card_params, cpu_params = trainable(model), trainable(cpu)

    def nudged_grads(batch, before):
        # the step's clipped gradients on the card from its weights, every
        # one one ulp up
        with torch.no_grad():
            for p in card_params.values():
                p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        total, _ = lm_loss(model, batch)
        g = torch.autograd.grad(total, list(card_params.values()))
        with torch.no_grad():
            for k, p in card_params.items():
                p.copy_(before[k])
        return clip(dict(zip(card_params, g)), tcfg.grad_clip)[0]

    worst = []
    for step in range(tcfg.total_steps):
        with torch.no_grad():
            for k, p in card_params.items():
                cpu_params[k].copy_(p)
            for f in ("mu", "nu"):
                for k, t in getattr(opt["card"], f).items():
                    getattr(opt["cpu"], f)[k].copy_(t)
        opt["cpu"] = opt["cpu"]._replace(step=opt["card"].step)
        # the step's start, kept on the card, where the sides are compared
        before = {k: p.detach().clone() for k, p in card_params.items()}
        batch = {k: torch.from_numpy(v) for k, v in
                 data.batch_at(step).items()}
        g_wit = nudged_grads({k: v.to(model.embed.table.device)
                              for k, v in batch.items()}, before)
        met = {}
        for side, m in models.items():
            dev = m.embed.table.device
            _, opt[side], met[side] = step_fn(
                m, opt[side], {k: v.to(dev) for k, v in batch.items()})
        lr = lr_fn(step + 1)
        loss = {side: float(x["loss"]) for side, x in met.items()}
        norm = {side: float(x["grad_norm"]) for side, x in met.items()}
        g = dict(zip(models, clipped))
        grad_rel, upd_worst, free_gap = {}, 0.0, 0.0
        wit_rel = 0.0
        n_settled = n_all = 0
        with torch.no_grad():
            for k, old in before.items():
                wit_rel = max(wit_rel, _ratio(
                    float((g["card"][k] - g_wit[k]).abs().max()),
                    float(g["card"][k].abs().max())))
                g_cpu = g["cpu"][k].to(old.device)
                grad_rel[k] = _ratio(
                    float((g["card"][k] - g_cpu).abs().max()),
                    float(g_cpu.abs().max()))
                del g_cpu
                # Adam steps along mu / sqrt(nu): an element is settled
                # where its new first moment is the same on both sides or
                # 1000 times the leaf's largest gap (at step 1, mu = 0.1 g)
                mu = {"card": opt["card"].mu[k],
                      "cpu": opt["cpu"].mu[k].to(old.device)}
                gap = float((mu["card"] - mu["cpu"]).abs().max())
                settled = (mu["card"] == mu["cpu"]) | \
                    (mu["cpu"].abs() > 1e3 * gap)
                new_cpu = cpu_params[k].detach().to(old.device)
                d_cpu = new_cpu - old
                upd = (card_params[k].detach() - new_cpu).abs()
                slack = 1e-2 * d_cpu.abs() + 2 * eps * new_cpu.abs()
                if settled.any():
                    upd_worst = max(upd_worst, float(
                        (upd[settled] / slack[settled].clamp_min(1e-30))
                        .max()))
                if (~settled).any():
                    free_gap = max(free_gap, float(upd[~settled].max()))
                n_settled += int(settled.sum())
                n_all += settled.numel()
        clipped.clear()
        del g, g_wit
        leaf = max(grad_rel, key=grad_rel.get)
        loss_rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
        norm_rel = abs(norm["card"] - norm["cpu"]) / norm["cpu"]
        worst.append((loss_rel, norm_rel, grad_rel[leaf], upd_worst,
                      max(LM_TOL, wit_rel)))
        print(f"lockstep step {step + 1} (lr {lr:.3e}): loss card "
              f"{loss['card']:.7f} cpu {loss['cpu']:.7f} (relative "
              f"{loss_rel:.2e}, tolerance {TRAIN_TOL}); grad norm relative "
              f"{norm_rel:.2e} (tolerance {LM_TOL}); clipped gradients' worst "
              f"leaf {leaf} max|card - cpu| / max|cpu| = {grad_rel[leaf]:.2e}, "
              f"the card's own with every weight one ulp up {wit_rel:.2e} "
              f"(tolerance the larger with {LM_TOL}, and {LM_TOL} at step "
              f"1); on the {n_settled} of {n_all} "
              f"settled elements the update's worst gap is {upd_worst:.3e} of "
              f"its allowance, the others differ by at most {free_gap:.3e} "
              f"({free_gap / lr:.3f} lr)", flush=True)
        del before
    steps.clip_by_global_norm = clip
    print(f"{cfg.name}, {cfg.num_layers} layers, B={batch_size} "
          f"S={seq_len}: {tcfg.total_steps} lockstep steps card vs CPU in "
          f"{time.perf_counter() - t0:.2f} s")
    del opt
    curves = {}
    for side, bump in (("card", False), ("cpu", False), ("card", True)):
        with torch.no_grad():
            for k, p in trainable(models[side]).items():
                p.copy_(start[k])
                if bump and k == nudge:
                    p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        curves[side, bump] = train_run(cfg, tcfg, models[side], batch_size,
                                       seq_len, log_every=0)["losses"]
    del cpu, models

    def gaps(other):
        return [abs(a - b) / abs(a)
                for a, b in zip(curves["card", False], curves[other])]

    print("six free steps from the same weights, loss gap per step, "
          "relative: card vs CPU "
          + ", ".join(f"{x:.2e}" for x in gaps(("cpu", False)))
          + f"; the card vs the card from {nudge} one ulp up "
          + ", ".join(f"{x:.2e}" for x in gaps(("card", True))))
    assert all(x[0] <= TRAIN_TOL for x in worst), \
        "a lockstep step's loss differs"
    assert all(x[1] <= LM_TOL for x in worst), \
        "a lockstep step's gradient norm differs"
    assert worst[0][2] <= LM_TOL, \
        "the first step's gradients differ (phase 9's first-batch check)"
    assert all(x[2] <= x[4] for x in worst), \
        "a lockstep step's gradients differ by more than rounding moves them"
    assert all(x[3] <= 1.0 for x in worst), "a lockstep step's update differs"
    assert max(gaps(("card", True))) > TRAIN_TOL, \
        "one ulp does not move the card's own run past TRAIN_TOL: hold " \
        "this model free-running"
    return model


def step_pattern(cfg):
    from repro_torch.models.lm import layer_pattern
    return layer_pattern(cfg) * (cfg.num_layers // len(layer_pattern(cfg)))


def _rmsnorms(cfg) -> int:
    """RMSNorm launches of one forward or decode step: a norm before each
    mixer and each MLP, and the final norm (none in an enc-dec model, which
    takes LayerNorm)."""
    if cfg.is_encdec:
        return 0
    return sum(1 + (s.mlp != "none") for s in step_pattern(cfg)) + 1


def forward_launches(cfg):
    """Each kernel's launches in one full-sequence forward (a prefill, or a
    train step's forward; the backward of attention and rmsnorm is torch
    ops, the scan's its own kernel): ``flash_attention`` once per decoder
    attention layer, encoder layer and cross-attention, ``ssm_scan`` once
    per Mamba layer, ``rmsnorm`` once per norm."""
    from repro_torch.kernels import LAUNCHES
    pattern = step_pattern(cfg)
    out = dict.fromkeys(LAUNCHES, 0)
    out.update(
        flash_attention=sum(s.mixer == "attn" for s in pattern)
        + sum(s.cross for s in pattern) + cfg.encoder_layers,
        ssm_scan=sum(s.mixer == "mamba" for s in pattern),
        rmsnorm=_rmsnorms(cfg))
    return out


def decode_launches(cfg, memory: bool = False):
    """Each kernel's launches in one decode step: ``decode_attention``
    once per attention layer, and per cross-attention when the step has
    an encoder memory; ``rmsnorm`` once per norm."""
    from repro_torch.kernels import LAUNCHES
    pattern = step_pattern(cfg)
    out = dict.fromkeys(LAUNCHES, 0)
    out.update(decode_attention=sum(s.mixer == "attn" for s in pattern)
               + (sum(s.cross for s in pattern) if memory else 0),
               rmsnorm=_rmsnorms(cfg))
    return out


def zoo_stubs(cfg, batch: int, seed: int, patches: int = 8):
    """A family's stub inputs on the CPU, N(0, 1) from ``seed``:
    ``patches`` patch embeddings (VLM) or ``encoder_seq_len`` audio frames
    (enc-dec); none for another family."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.num_patch_tokens:
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, patches, cfg.d_model), dtype=np.float32))
    if cfg.is_encdec:
        out["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32))
    return out


def train_run(cfg, tcfg, model, global_batch: int, seq_len: int,
              stubs_fn=None, on_step=None, log_every: int = 1):
    """``tcfg.total_steps`` train steps of ``model``: through
    ``repro_torch.launch.train.run`` (the trainer's ``TokenDataset``
    batches), or, with ``stubs_fn(step)`` (CPU tensors of the family's
    stubs), through ``make_train_step`` on the same batches with the stubs
    added, as the trainer's CLI cannot (its batches carry none).  Returns
    run's keys: the losses, and on the card each step's device ms by phase
    and the peak memory."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import (StepOptions, make_train_step,
                                          trainable)
    from repro_torch.optim import adamw
    if stubs_fn is None:
        return train.run(cfg, tcfg, global_batch=global_batch,
                         seq_len=seq_len, model=model, log_every=log_every,
                         on_step=on_step)
    dev = model.embed.table.device
    cuda = dev.type == "cuda"
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=seq_len, global_batch=global_batch,
                                   seed=tcfg.seed))
    opt_state = adamw(tcfg.learning_rate)[0](trainable(model))
    step_fn = make_train_step(cfg, tcfg, opts=StepOptions(remat=False))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, phase_ms = [], []
    for step in range(tcfg.total_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        batch.update({k: v.to(dev) for k, v in stubs_fn(step).items()})
        marks = train._PhaseEvents() if cuda else None
        model, opt_state, metrics = step_fn(model, opt_state, batch,
                                            mark=marks)
        losses.append(float(metrics["loss"]))
        if cuda:
            torch.cuda.synchronize(dev)
            phase_ms.append(marks.ms())
        if on_step is not None:
            on_step(step, metrics)
        if log_every and (step + 1) % log_every == 0:
            print(f"[train] step {step + 1:5d} loss={losses[-1]:.4f} (with "
                  f"{', '.join(stubs_fn(step))})")
    out = {"losses": losses, "steps": len(losses),
           "first_loss": losses[0], "last_loss": losses[-1]}
    if cuda:
        out.update(phase_ms=phase_ms,
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
    return out


# -- phase 10: train one full-width Jamba period -----------------------------------

def train_period(cfg, tcfg, kernel_ms, global_batch: int = 8,
                 seq_len: int = 128, stubs_fn=None, profile: bool = False):
    """``run`` trains ``cfg`` on the card (``train_run``: with the family's
    stubs where ``stubs_fn`` gives them); every step must launch each
    kernel exactly as the layer pattern implies.  With ``profile``, one
    more step is profiled (``torch.profiler``): its kernels and their
    summed device time against the step's host time, the card's idle
    share of a step whose launches outnumber what a sleep can cover."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.lm import init_lm
    pattern = step_pattern(cfg)
    expected = forward_launches(cfg)
    expected["ssm_scan_backward"] = expected["ssm_scan"]
    release()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=tcfg.seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    experts = (f"{cfg.num_experts} experts top-{cfg.experts_per_token} of "
               f"width {cfg.moe_d_ff} every {cfg.moe_every}" if cfg.is_moe
               else "no experts")
    enc = (f" + {cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_seq_len} frames" if cfg.is_encdec else "")
    print(f"{cfg.name}: {cfg.num_layers} layers {[s.mixer for s in pattern]}"
          f"{enc}, d={cfg.d_model}, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{experts}: {n_params / 1e9:.3f} B parameters ({n_params * 4 / 1e9:.2f} "
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
    out = train_run(cfg, tcfg, model, global_batch, seq_len,
                    stubs_fn=stubs_fn, on_step=on_step)
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
    for name in kernel_ms:
        t = kernel_ms[name]
        print(f"  {name:18s} {expected[name]:3d} launches x {t['ms']:.5f} ms "
              f"= {expected[name] * t['ms']:.4f} ms a step (bound "
              f"{t['bound_ms']:.5f} ms a launch, {t['bound_by']})")
    total = sum(expected[k] * kernel_ms[k]["ms"] for k in kernel_ms)
    print(f"  the timed kernels take {total:.3f} ms of a {med:.3f} ms step "
          f"(median of steps 2-{out['steps']}, device time between the "
          f"step's CUDA events)")
    if profile:
        profile_train_step(cfg, tcfg, model, global_batch, seq_len, stubs_fn)
    assert out["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory
    del model
    torch.cuda.empty_cache()
    return per_step, out


def profile_train_step(cfg, tcfg, model, global_batch, seq_len, stubs_fn):
    """One more train step of ``model`` (a fresh AdamW state) under
    ``torch.profiler``: the kernels it launches and their summed device
    time, beside the step's host time (median of three unprofiled steps,
    each from an idle card)."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch.steps import (StepOptions, make_train_step,
                                          trainable)
    from repro_torch.optim import adamw
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenDataset(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                   global_batch=global_batch, seed=tcfg.seed)).batch_at(
        0).items()}
    if stubs_fn is not None:
        batch.update({k: v.cuda() for k, v in stubs_fn(0).items()})
    step_fn = make_train_step(cfg, tcfg, opts=StepOptions(remat=False))
    state = [adamw(tcfg.learning_rate)[0](trainable(model))]

    def step():
        _, state[0], _ = step_fn(model, state[0], batch)

    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    kernels, dev = profile_kernels(step)
    wall = statistics.median(host) * 1e3
    print(f"one train step profiled: {kernels} kernels summing to "
          f"{dev:.3f} ms of device time; the host enqueues the step in "
          f"{wall:.3f} ms (median of 3, from an idle card), so the card "
          f"idles {100 * (1 - dev / wall):.1f}% of it")


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
    q_graph_vs_eager(agents["card"], obs, "at start")
    losses = {side: [] for side in agents}
    for _ in range(updates):
        for side, agent in agents.items():
            losses[side].append(agent.train_step())
    q1, err1 = q_err()
    q_graph_vs_eager(agents["card"], obs, f"after {updates} updates")
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
    acts = act_host_ms(agent, obs)
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
    for e, (eager, replay) in acts.items():
        print(f"{card}: a greedy act at E={e} takes {eager:.4f} ms on the "
              f"host's clock with Q eagerly, {replay:.4f} ms with Q by "
              f"replay (act_batch; median of {TIMED_RUNS})")
    return {"update_ms": upd_ms, "act_ms": act_ms, **{
        f"host_{k}_ms": v for k, v in med.items()}}


def q_graph_vs_eager(agent, obs, when: str, sizes=(1, 8)):
    """The agent's Q from its graph (``q_values``, a replay from the second
    call at a batch size on) against ``qnet_apply`` called eagerly on the
    same observations: bit for bit at each E of ``sizes``."""
    import numpy as np
    import torch
    from repro_torch.rl.networks import qnet_apply
    for e in sizes:
        x = obs[:e]
        agent.q_values(x)
        got = agent.q_values(x)
        assert agent.q_graphs.entry(x.shape) is not None, e
        with torch.no_grad():
            want = qnet_apply(agent.net, torch.from_numpy(x).cuda()).cpu()
        err = float(np.abs(got - want.numpy()).max())
        print(f"Q at E={e} {when}: by replay vs eagerly, max|diff| "
              f"{err:.3e} (bit for bit)")
        assert np.array_equal(got, want.numpy()), (e, when, err)


def act_host_ms(agent, obs, sizes=(1, 8)):
    """{E: (host ms of a greedy act with Q computed eagerly, with Q by
    replay)}, medians of TIMED_RUNS, each ending with the actions on the
    host."""
    import torch
    from repro_torch.rl.d3ql import masked_argmax
    from repro_torch.rl.networks import qnet_apply

    def eager(x):
        with torch.no_grad():
            q = qnet_apply(agent.net, torch.from_numpy(x).to(agent.device))
        return masked_argmax(q.cpu().numpy(), None)

    out = {}
    for e in sizes:
        x = obs[:e]
        times = {}
        for way, act in (("eager", eager),
                         ("replay", lambda x: agent.act_batch(x,
                                                              greedy=True))):
            act(x)
            walls = []
            for _ in range(TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                act(x)
                walls.append(time.perf_counter() - t0)
            times[way] = statistics.median(walls) * 1e3
        out[e] = (times["eager"], times["replay"])
    return out


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
    print(f"peak device memory {peak / 2**30:.3f} GiB; batch_calls {calls}; "
          f"{graphs_held(services)} block-call graphs held (per service "
          f"and bucket), the learned agent's Q graphs "
          f"{len(ctrl.agent.q_graphs)}")
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
          f"0: bit for bit); peak device memory {peak / 2**30:.3f} GiB with "
          f"{graphs_held(services)} block-call graphs held (per service, "
          f"bucket and path: run_batch's or SlotBatch's)")
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


# -- phase 22: the closed loop on a mesh ------------------------------------------

def _same_history(got, want, what):
    import numpy as np
    for k in ("reward", "delivered", "loss"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True), \
            f"{what}: {k} differs from the unsharded run"


def mesh_loop(cfg, card: str, sizes=(1, 2, 4), train_eps: int = 16,
              num_envs: int = 8, cells: int = 4, frames: int = 40,
              seed: int = 0):
    """The closed loop's mesh paths on meshes over the card's devices
    (``cuda:0`` repeated on a one-card host), each held to the
    unsharded run of the same seed: ``make_env_mesh`` and its degrade rule;
    ``train_fused`` on paper-fig3 at E=8, two rounds, epsilon calibrated to
    reach 1e-2 (so the second round acts mostly greedily), bit for bit
    (rewards, deliveries, losses, both nets, epsilon, steps); the trained
    agent's ``evaluate_fused`` summary exactly; then a 4-cell paper-fig3
    fleet (diurnal, handover 0.1, early exit off so chains run all B blocks
    and in-flight latents change cells) with three full-width gdm-dit
    services built on a mesh of 2, served quantum by ``serve_fleet`` under
    the trained agent: the same Omega, every frame's step stats and the
    summary equal to the unsharded fleet's, latents within TOL, one
    ``"shard"`` row per handover of latents between cells on different
    mesh positions, the DiT kernels launched exactly (block calls x
    shards x L) times; and ``SlotBatch`` on the mesh against ``run_batch``
    bit for bit.  Returns the phase's seconds."""
    import numpy as np
    import torch
    from repro_torch.core import LearnGDMController
    from repro_torch.core.policy import LearnedPolicy, evaluate_fused
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_env_mesh
    from repro_torch.serving import (TransferLedger, cluster_from_scenario,
                                     make_gdm_services, serve_fleet)
    from repro_torch.sim import EdgeSimulator, get_scenario
    from repro_torch.sim.workloads import fleet_trace
    t_phase = time.perf_counter()
    scen = get_scenario("paper-fig3")
    count = torch.cuda.device_count()

    def on_card(d, axis="env"):
        return make_env_mesh(d, axis=axis, devices=("cuda:0",) * d)

    for d in sizes:
        mesh = on_card(d)
        assert mesh.shape == {"env": d}
        print(f"mesh of {d}: {len(set(mesh.devices))} distinct device(s) "
              f"({', '.join(str(x) for x in mesh.devices)})")
    cards = make_env_mesh()
    assert cards.shape == {"env": count} and len(set(cards.devices)) == count
    assert make_env_mesh(4, divides=6, devices=("cuda:0",) * 4).shape == \
        {"env": 3}
    assert make_env_mesh(4, divides=7, devices=("cuda:0",) * 4).shape == \
        {"env": 1}
    print(f"make_env_mesh() takes the {count} card(s); over cuda:0 x 4 it "
          f"degrades to 3 for divides=6 and to 1 for divides=7")

    def controller():
        ctrl = LearnGDMController(EdgeSimulator(scen), seed=seed,
                                  device="cuda")
        ctrl.calibrate_epsilon(train_eps, num_envs=num_envs, final=1e-2)
        return ctrl

    walls = {}
    ref = controller()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.train_fused(train_eps, num_envs=num_envs, seed=seed)
    torch.cuda.synchronize()
    walls["none"] = time.perf_counter() - t0
    ev_want = evaluate_fused(LearnedPolicy(ref.agent), ref.env, 16,
                             num_envs=num_envs, seed=seed + 1)
    for d in sizes:
        got = controller()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = got.train_fused(train_eps, num_envs=num_envs, seed=seed,
                               mesh=on_card(d))
        torch.cuda.synchronize()
        walls[d] = time.perf_counter() - t0
        _same_history(hist, want, f"train_fused on a mesh of {d}")
        for net in ("net", "target_net"):
            for (name, a), b in zip(
                    getattr(ref.agent, net).named_parameters(),
                    getattr(got.agent, net).parameters()):
                assert torch.equal(a, b), (d, net, name)
        assert (got.agent.epsilon, got.agent.steps) == \
            (ref.agent.epsilon, ref.agent.steps), d
        ev = evaluate_fused(LearnedPolicy(got.agent), got.env, 16,
                            num_envs=num_envs, seed=seed + 1,
                            mesh=on_card(d))
        assert ev == ev_want, (d, ev, ev_want)
    print(f"train_fused, {train_eps} episodes at E={num_envs}: "
          f"{ref.agent.steps} updates, epsilon {ref.agent.epsilon:.6f}, "
          f"rewards {np.round(want['reward'], 4).tolist()}; bit for bit at "
          f"mesh sizes {list(sizes)}; evaluate_fused (16 episodes, "
          f"learned) equal: reward {ev_want['reward']:.6f}, delivered "
          f"{ev_want['delivered_quality']:.6f}")
    # the unsharded run again, warm, for the wall clocks' comparison (the
    # first run pays the first calls of every op)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _same_history(controller().train_fused(train_eps, num_envs=num_envs,
                                           seed=seed), want, "train_fused")
    torch.cuda.synchronize()
    walls["warm"] = time.perf_counter() - t0
    print(f"{card}: train_fused wall clock unsharded {walls['none']:.2f} s "
          f"(first) and {walls['warm']:.2f} s (last), "
          + ", ".join(f"mesh of {d} {walls[d]:.2f} s" for d in sizes))

    # the fleet, on services built on a mesh of two, against the same
    # services without one
    mesh2 = on_card(2, "batch")
    plain, omega = make_gdm_services(scen.num_services, seed,
                                     num_blocks=scen.max_blocks,
                                     model_cfg=cfg, device="cuda")
    sharded, omega2 = make_gdm_services(scen.num_services, seed,
                                        num_blocks=scen.max_blocks,
                                        model_cfg=cfg, mesh=mesh2)
    assert np.array_equal(omega, omega2), "Omega differs under a mesh"
    fleet = fleet_trace(scen, frames, cells, workload="diurnal", seed=seed,
                        handover_rate=0.1)
    runs = {}
    for name, services, mesh in (("unsharded", plain, None),
                                 ("mesh of 2", sharded, mesh2)):
        ledger = TransferLedger()
        cluster = cluster_from_scenario(
            scen, cells, services, ledger=ledger, mesh=mesh,
            early_exit=False,
            policy_factory=lambda c: LearnedPolicy(ref.agent, "learn-gdm"))
        calls0 = sum(s.batch_calls for s in services.values())
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = serve_fleet(cluster, fleet, services, seed=seed,
                            collect_steps=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(LAUNCHES)
        calls = sum(s.batch_calls for s in services.values()) - calls0
        shards = 1 if mesh is None else 2
        expect = dict.fromkeys(LAUNCHES, 0)
        expect.update(adaln_norm=calls * shards * cfg.num_layers,
                      adaln_norm_epilogue=calls * shards * cfg.num_layers,
                      flash_attention=calls * shards * cfg.num_layers)
        assert launched == expect, (name, launched, expect)
        runs[name] = (stats, ledger, cluster)
        print(f"fleet {name}: {stats['completed']}/{stats['submitted']} "
              f"completed, quality {stats['mean_quality']:.6f}, latency "
              f"mean {stats['mean_latency_frames']:.3f} p95 "
              f"{stats['p95_latency_frames']:.3f} frames, objective "
              f"{stats['objective']:.4f}, handovers {stats['handovers']}; "
              f"{calls} block calls, launches {launched} = {calls} x "
              f"{shards} x {cfg.num_layers}; {wall:.2f} s on {card}")
    (want_s, _, want_c), (got_s, ledger, got_c) = \
        runs["unsharded"], runs["mesh of 2"]
    assert len(got_s["steps"]) == frames
    for t, (a, b) in enumerate(zip(got_s["steps"], want_s["steps"])):
        assert a == b, f"fleet frame {t} differs on the mesh"
    assert got_s == want_s, "the sharded fleet's summary differs"
    assert got_s["completed"] > 0
    err, n = 0.0, 0
    for e_got, e_want in zip(got_c.engines, want_c.engines):
        assert [r.rid for r in e_got.completed] == \
            [r.rid for r in e_want.completed]
        for a, b in zip(e_got.completed, e_want.completed):
            for key in ("latent", "x0"):
                assert np.isfinite(a.state[key]).all()
                err = max(err, float(np.abs(a.state[key]
                                            - b.state[key]).max()))
            n += 1
    assert err <= TOL, err
    shard = [e for e in ledger.events if e.kind == "shard"]
    cross = [e for e in ledger.events if e.kind == "handover"
             and e.nbytes > 0 and e.src % 2 != e.dst % 2]
    assert [(e.rid, e.src % 2, e.dst % 2, e.nbytes) for e in cross] == \
        [(e.rid, e.src, e.dst, e.nbytes) for e in shard]
    assert got_c.device_of_cell == [c % 2 for c in range(cells)]
    print(f"sharded fleet equal to the unsharded frame for frame over "
          f"{frames} frames; {n} served latents, max |diff| {err:.3e} "
          f"(tolerance {TOL}); {len(shard)} shard rows = handovers of "
          f"latents between mesh positions ({len(cross)})")

    # SlotBatch's per-shard resident rows against run_batch, bit for bit
    svc = sharded[0]
    rng = np.random.default_rng(seed)
    states = [svc.init_state(rng) for _ in range(7)]
    items = [(i, st, i % scen.max_blocks) for i, st in enumerate(states)]
    for _ in range(3):
        want_b, want_q = svc.run_batch([st for _, st, _ in items],
                                       np.asarray([k for *_, k in items]))
        got_b, got_q = svc.slot_batch().step(items)
        assert np.array_equal(got_q, want_q)
        for a, b in zip(got_b, want_b):
            for key in ("latent", "x0"):
                assert np.array_equal(a[key], b[key]), "SlotBatch differs"
        items = [(rid, st, k) for (rid, _, k), st in zip(items, got_b)]
    lat, *_ = svc.slot_batch()._buffers[8]
    assert [t.shape[0] for t in lat] == [4, 4]
    seconds = time.perf_counter() - t_phase
    print(f"SlotBatch on the mesh of 2 (two resident shards of 4 rows) "
          f"equals run_batch bit for bit over 3 steps; phase 22 took "
          f"{seconds:.1f} s")
    return seconds


# -- phase 23: the LM on a mesh --------------------------------------------------------

def _lm_mesh(shape, dev):
    """A ("data", "model") mesh of ``shape`` over ``dev`` (the first card
    for "cuda") repeated."""
    from repro_torch.launch.mesh import make_host_mesh
    dev = "cuda:0" if dev == "cuda" else dev
    return make_host_mesh(shape, ("data", "model"),
                          devices=(dev,) * math.prod(shape))


def _clone_state(state):
    return tuple({k: type(v)(*(t.clone() for t in v)) if isinstance(v, tuple)
                  else v.clone() for k, v in slot.items()} for slot in state)


class _Clock:
    """Device ms between ``start()`` and ``stop()`` (CUDA events on the
    card, the host's clock elsewhere) and the peak device memory."""

    def __init__(self, dev: str):
        import torch
        self.cuda = dev.startswith("cuda")
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        wall = (time.perf_counter() - self.t0) * 1e3
        if not self.cuda:
            return wall, wall, 0
        self.b.record()
        self.b.synchronize()
        return (self.a.elapsed_time(self.b), (time.perf_counter() - self.t0)
                * 1e3, torch.cuda.max_memory_allocated())


def split_k_decode(cfg, card: str, dev: str = "cuda", batch: int = 8,
                   prompt: int = 16, cache: int = 512, steps: int = 32):
    """``cfg``'s prefill at B=``batch`` into a cache of ``cache`` rows,
    then ``steps`` serve steps on the same tokens: unsharded, on a (2, 8)
    ("data", "model") mesh whose model axis does not divide the kv heads
    (the split-K decode, no ``decode_attention`` launch) and on (1, 4),
    whose does (the kernel, once per layer and step).  The logits within
    LM_TOL of the unsharded step's, relative to the largest; the first
    layer's cache bit for bit (its rows come from the same embeddings; the
    insert is a copy), every cache within LM_TOL; launches exact; ms per
    step and peak memory."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import (StepOptions, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models.lm import init_lm
    model = init_lm(cfg, seed=11, device=dev)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(2, cfg.vocab_size, (steps + 1, batch, prompt),
                         generator=gen, dtype=torch.int32).to(dev)
    pre = make_prefill_step(cfg, max_seq=cache, state_dtype=torch.float32)(
        model, {"tokens": toks[0]})
    per_step = decode_launches(cfg)
    runs = {}
    for name, shape in (("unsharded", None), ("(2, 8)", (2, 8)),
                        ("(1, 4)", (1, 4))):
        mesh = None if shape is None else _lm_mesh(shape, dev)
        serve = make_serve_step(cfg, opts=StepOptions(sharded_decode=True),
                                mesh=mesh, global_batch=batch if mesh else 0)
        state = _clone_state(pre["state"])
        reset_launches()
        clock = _Clock(dev)
        logits = [serve(model, toks[1 + t, :, 0], state)[0]
                  for t in range(steps)]
        ms, wall, peak = clock.stop()
        launched = dict(LAUNCHES)
        split_k = shape is not None and cfg.num_kv_heads % shape[1] != 0
        shards = 1 if shape is None else shape[0]
        expect = dict.fromkeys(LAUNCHES, 0)
        expect.update(rmsnorm=per_step["rmsnorm"] * shards * steps,
                      decode_attention=0 if split_k else
                      per_step["decode_attention"] * shards * steps)
        assert launched == expect, (name, launched, expect)
        runs[name] = (logits, state)
        print(f"{card}: {cfg.name} serve step {name}"
              f"{' split-K' if split_k else ''}: {ms / steps:.3f} ms a step "
              f"(device, {wall / steps:.3f} ms host), peak "
              f"{peak / 2**30:.3f} GiB; launches over {steps} steps "
              f"{ {k: v for k, v in launched.items() if v} }")
    want, want_state = runs.pop("unsharded")
    scale = max(float(lg[:, :cfg.vocab_size].abs().max()) for lg in want)
    for name, (logits, state) in runs.items():
        gap = max(float((a - b)[:, :cfg.vocab_size].abs().max())
                  for a, b in zip(logits, want))
        leaves = list(zip(_state_tensors(state), _state_tensors(want_state)))
        first = all(torch.equal(a[0], b[0]) for a, b in leaves)
        st_gap = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                     for a, b in leaves if b.is_floating_point())
        lengths = all(torch.equal(a, b) for a, b in leaves
                      if not b.is_floating_point())
        print(f"{card}: {name} vs unsharded over {steps} steps: logits max "
              f"gap {gap:.3e} (max|logit| {scale:.3f}, relative "
              f"{gap / scale:.3e}, tolerance {LM_TOL}); first layer's cache "
              f"bit for bit: {first}; caches relative gap {st_gap:.3e}; "
              f"lengths equal: {lengths}")
        assert gap / scale <= LM_TOL, f"{name}: logits differ"
        assert first and lengths and st_gap <= LM_TOL, \
            f"{name}: the caches differ"
    del model, pre, runs
    if dev == "cuda":
        torch.cuda.empty_cache()


def _record_routing(log):
    """``nn.moe_sharded``'s router wrapped: each call's probabilities and
    top-k ids appended to ``log`` (on the CPU); returns the undo."""
    from repro_torch.nn import moe_sharded
    real = moe_sharded.top_k_gates

    def top_k_gates(router, xf, k):
        out = real(router, xf, k)
        log.append((out[0].detach().cpu(), out[2].cpu()))
        return out

    moe_sharded.top_k_gates = top_k_gates
    return lambda: setattr(moe_sharded, "top_k_gates", real)


def _near_ties(card_log, cpu_log, k):
    """Tokens routed to another expert set, card vs CPU (in call order),
    each of which must be a near-tie; returns (swaps, worst tie)."""
    assert len(card_log) == len(cpu_log) > 0
    swaps, worst = 0, 0.0
    for (_, ids_g), (probs_c, ids_c) in zip(card_log, cpu_log):
        swapped = (ids_g.sort(1).values != ids_c.sort(1).values).any(1)
        if swapped.any():
            top = probs_c[swapped].sort(dim=1, descending=True).values
            tie = float(((top[:, k - 1] - top[:, k]) / top[:, 0]).max())
            worst = max(worst, tie)
            swaps += int(swapped.sum())
            assert tie <= ROUTE_TIE_TOL, \
                "an all-to-all routing difference is not a near-tie"
    return swaps, worst


def a2a_vs_cpu(cfg, tcfg, card: str, dev: str = "cuda",
               shapes=((1, 4), (2, 4)), batch: int = 4, seq: int = 64):
    """``cfg`` (two layers at full width) through the all-to-all MoE
    dispatch on the card and on the CPU, on the same meshes: the loss,
    ``aux`` and every gradient of ``lm_loss(moe_sharded_ctx=)`` per leaf,
    then one ``make_train_step(moe_a2a)`` step's loss, aux, gradient norm
    and update; every routing difference a near-tie (the expert leaves
    are left out where one occurred)."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.distributed.sharding import _axes, batch_spec
    from repro_torch.launch.steps import StepOptions, make_train_step, \
        trainable
    from repro_torch.models.lm import LM, init_lm, lm_loss
    from repro_torch.optim import adamw
    host = {k: torch.from_numpy(v) for k, v in TokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=tcfg.seed)).batch_at(0).items()}
    k = cfg.experts_per_token
    for shape in shapes:
        out, logs = {}, {}
        for side, d in (("card", dev), ("cpu", "cpu")):
            m = init_lm(cfg, seed=11, device="cpu")
            if side == "card":
                m = m.to(d)
            mesh = _lm_mesh(shape, d)
            axes = _axes(batch_spec(mesh, batch, 0)[0])
            b = {kk: v.to(d) for kk, v in host.items()}
            logs[side] = []
            undo = _record_routing(logs[side])
            try:
                params = trainable(m)
                total, met = lm_loss(m, b, moe_sharded_ctx=(mesh, axes))
                grads = torch.autograd.grad(total, list(params.values()))
                step = make_train_step(cfg, tcfg, opts=StepOptions(
                    moe_a2a=True, remat=False), mesh=mesh,
                    global_batch=batch)
                p0 = {kk: p.detach().clone() for kk, p in params.items()}
                _, _, smet = step(m, adamw(tcfg.learning_rate)[0](params), b)
            finally:
                undo()
            out[side] = dict(
                loss=float(met["loss"].detach()),
                aux=float(met["aux"].detach()),
                norm=float(smet["grad_norm"]),
                step_loss=float(smet["loss"]), step_aux=float(smet["aux"]),
                grads={kk: g.cpu() for kk, g in zip(params, grads)},
                upd={kk: (p.detach() - p0[kk]).cpu()
                     for kk, p in params.items()})
        g, c = out["card"], out["cpu"]
        swaps, worst = _near_ties(logs["card"], logs["cpu"], k)
        skip = (lambda n: ".moe." in n) if swaps else (lambda n: False)
        grad_rel = max(_ratio(float((g["grads"][n] - x).abs().max()),
                              float(x.abs().max()))
                       for n, x in c["grads"].items() if not skip(n))
        gap = math.sqrt(sum(float((g["upd"][n] - x).square().sum())
                            for n, x in c["upd"].items() if not skip(n)))
        moved = math.sqrt(sum(float(x.square().sum())
                              for n, x in c["upd"].items() if not skip(n)))
        rel = {key: abs(g[key] - c[key]) / abs(c[key]) for key in (
            "loss", "aux", "norm", "step_loss", "step_aux")}
        print(f"{card}: {cfg.name} {cfg.num_layers} layers, all-to-all MoE "
              f"on {shape} (B={batch} S={seq}, {len(logs['cpu'])} routing "
              f"calls): loss card {g['loss']:.7f} cpu {c['loss']:.7f}, aux "
              f"card {g['aux']:.7f} cpu {c['aux']:.7f}; relative gaps "
              + ", ".join(f"{kk} {v:.2e}" for kk, v in rel.items())
              + f"; gradients worst leaf {grad_rel:.3e} (tolerance {LM_TOL}); "
              f"the step's update |card - cpu| / |cpu| {_ratio(gap, moved):.3e}"
              f" (tolerance {TRAIN_PARAM_TOL}); {swaps} token(s) routed to "
              f"another expert set (worst near-tie {worst:.3e}, tolerance "
              f"{ROUTE_TIE_TOL})")
        assert max(rel.values()) <= LM_TOL, "a2a: the step's numbers differ"
        assert grad_rel <= LM_TOL, "a2a: the gradients differ"
        assert _ratio(gap, moved) <= TRAIN_PARAM_TOL, "a2a: the update differs"


def _train_steps(cfg, tcfg, dev, mesh, batch, seq, opts, seed=11):
    """``tcfg.total_steps`` steps of ``make_train_step`` from ``cfg``'s
    weights of ``seed``: (losses, auxes, final parameters, launches per
    step, device ms per step, peak bytes)."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_train_step, trainable
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import adamw
    model = init_lm(cfg, seed=seed, device=dev)
    state = adamw(tcfg.learning_rate)[0](trainable(model))
    step = make_train_step(cfg, tcfg, opts=opts, mesh=mesh,
                           global_batch=batch if mesh else 0)
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch, seed=tcfg.seed))
    losses, auxes, launches, ms = [], [], [], []
    peak = 0
    for s in range(tcfg.total_steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(s).items()}
        reset_launches()
        clock = _Clock(dev)
        model, state, met = step(model, state, b)
        t, _, p = clock.stop()
        ms.append(t)
        peak = max(peak, p)
        launches.append(dict(LAUNCHES))
        losses.append(float(met["loss"]))
        auxes.append(float(met["aux"]))
    params = {k: p.detach() for k, p in model.named_parameters()}
    return losses, auxes, params, launches, ms, peak


def a2a_full(cfg, tcfg, card: str, dev: str = "cuda", shape=(2, 4),
             batch: int = 8, seq: int = 128):
    """``cfg`` at full width, ``tcfg.total_steps`` train steps with
    ``moe_a2a`` on ``shape``, twice (bit for bit) and unsharded (the
    einsum dispatch) for the times: every loss finite, each step's
    launches exactly the data shards' forwards."""
    from repro_torch.launch.steps import StepOptions
    mesh = _lm_mesh(shape, dev)
    a2a = StepOptions(moe_a2a=True, remat=False)
    runs = [_train_steps(cfg, tcfg, dev, mesh, batch, seq, a2a)
            for _ in range(2)]
    plain = _train_steps(cfg, tcfg, dev, None, batch, seq,
                         StepOptions(remat=False))
    expect = {k: v * shape[0] for k, v in forward_launches(cfg).items()}
    for name, (losses, auxes, _, launches, ms, peak) in (
            (f"{shape} all-to-all", runs[0]),
            (f"{shape} all-to-all again", runs[1]),
            ("unsharded einsum", plain)):
        print(f"{card}: {cfg.name} {cfg.num_layers} layers B={batch} "
              f"S={seq} {name}: losses "
              + ", ".join(f"{x:.7f}" for x in losses) + "; aux "
              + ", ".join(f"{x:.6f}" for x in auxes)
              + f"; ms a step (device) " + ", ".join(f"{x:.2f}" for x in ms)
              + f"; peak {peak / 2**30:.3f} GiB")
        assert all(math.isfinite(x) for x in losses + auxes), name
    for launches in runs[0][3] + runs[1][3]:
        assert launches == expect, (launches, expect)
    same = runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1] and all(
        (runs[0][2][k] == v).all() for k, v in runs[1][2].items())
    print(f"{card}: two all-to-all runs bit for bit: {same}; launches a "
          f"step { {k: v for k, v in expect.items() if v} } (the forward of "
          f"{shape[0]} data shards)")
    assert same, "two all-to-all runs differ"


def dp_steps(cfg, tcfg, card: str, dev: str = "cuda", batch: int = 8,
             seq: int = 128):
    """``cfg`` (einsum MoE) on ("data", "model") meshes of (2, 1) and
    (1, 1) against no mesh: the prefill's logits and state, and
    ``tcfg.total_steps`` train steps' losses, aux and parameters: within
    LM_TOL on (2, 1) (the parameters within TRAIN_PARAM_TOL of how far
    they moved), bit for bit on (1, 1)."""
    import torch
    from repro_torch.launch.steps import StepOptions, make_prefill_step
    from repro_torch.models.lm import init_lm
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(2, cfg.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32).to(dev)
    model = init_lm(cfg, seed=11, device=dev)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    pre, train = {}, {}
    for name, shape in (("none", None), ("(2, 1)", (2, 1)),
                        ("(1, 1)", (1, 1))):
        mesh = None if shape is None else _lm_mesh(shape, dev)
        clock = _Clock(dev)
        pre[name] = make_prefill_step(cfg, mesh=mesh,
                                      state_dtype=torch.float32,
                                      global_batch=batch if mesh else 0)(
            model, {"tokens": prompt})
        ms, _, _ = clock.stop()
        train[name] = _train_steps(cfg, tcfg, dev, mesh, batch, seq,
                                   StepOptions(remat=False))
        print(f"{card}: {cfg.name} {cfg.num_layers} layers, data mesh "
              f"{name}: prefill B={batch} S={seq} {ms:.2f} ms; train ms a "
              f"step " + ", ".join(f"{x:.2f}" for x in train[name][4]))
    want = pre["none"]
    for name in ("(2, 1)", "(1, 1)"):
        got = pre[name]
        v = cfg.vocab_size                  # the padded columns hold -1e9
        scale = float(want["logits"][:, :v].abs().max())
        gap = float((got["logits"] - want["logits"])[:, :v].abs().max())
        leaves = list(zip(_state_tensors(got["state"]),
                          _state_tensors(want["state"])))
        st_gap = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                     for a, b in leaves if b.is_floating_point())
        (l1, a1, p1, *_), (l0, a0, p0f, *_) = train[name], train["none"]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(l1 + a1, l0 + a0))
        gap_p = math.sqrt(sum(float((p1[k] - v).square().sum())
                              for k, v in p0f.items()))
        moved = math.sqrt(sum(float((v - p0[k]).square().sum())
                              for k, v in p0f.items()))
        exact = gap == 0 and st_gap == 0 and loss_rel == 0 and gap_p == 0
        print(f"{card}: data mesh {name} vs none: prefill logits relative "
              f"gap {gap / scale:.3e}, state {st_gap:.3e}; train losses and "
              f"aux relative {loss_rel:.3e}; parameters |sharded - none| / "
              f"|none - start| {_ratio(gap_p, moved):.3e}; bit for bit: "
              f"{exact}")
        if name == "(1, 1)":
            assert exact, "a mesh of one differs from no mesh"
        assert gap / scale <= LM_TOL and st_gap <= LM_TOL, name
        assert loss_rel <= LM_TOL and _ratio(gap_p, moved) \
            <= TRAIN_PARAM_TOL, name
    del model, pre, train
    if dev == "cuda":
        torch.cuda.empty_cache()


def lm_mesh(card: str, dev: str = "cuda", yi=None, granite=None,
            steps: int = 32):
    """Phase 23; returns its seconds."""
    from repro_torch.configs import TrainConfig, get_config
    t0 = time.perf_counter()
    yi = yi or get_config("yi-6b")
    granite = granite or get_config("granite-moe-1b-a400m")
    split_k_decode(yi, card, dev, steps=steps)
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=3, warmup_steps=5)
    pair = dataclasses.replace(granite, num_layers=2)
    a2a_vs_cpu(pair, tcfg, card, dev)
    a2a_full(granite, tcfg, card, dev)
    dp_steps(pair, TrainConfig(learning_rate=3e-4, total_steps=1,
                               warmup_steps=5), card, dev)
    seconds = time.perf_counter() - t0
    print(f"phase 23 took {seconds:.1f} s")
    return seconds


# -- phase 16: full-width granite, card vs CPU, routing near-ties ---------------------

def _routing_sets(r, k):
    """Each token's expert ids in ascending order and whether each of them
    kept its capacity row, on the CPU."""
    import torch
    t = r.ids.shape[0]
    keep = torch.empty(t * k, dtype=torch.bool, device=r.keep.device)
    keep[r.order] = r.keep
    ids, perm = r.ids.sort(dim=1)
    return ids.cpu(), keep.reshape(t, k).gather(1, perm).cpu()


class RouteCheck:
    """Stands in for ``models.lm.moe_apply`` while ``card`` (a model or an
    MoE layer on the card) runs and then its CPU copy from the same
    weights: each call of a layer of ``card`` queues its input, output and
    routing, and the CPU's matching call (the same layer of the same step:
    both sides call in the same order) is compared with it.  A token whose expert set differs must be a near-tie: its CPU
    probabilities of rank k and k+1 within ROUTE_TIE_TOL of its largest.
    Outputs are held where the routing agreed; a call with a token routed
    otherwise is re-run on the CPU from the card's input, and its other
    tokens compared."""

    def __init__(self, card):
        from repro_torch.models import lm
        self.lm, self.apply, self.queue = lm, lm.moe_apply, []
        self.card = {id(m) for m in card.modules()}
        self.calls = self.tokens = self.swaps = self.reruns = 0
        self.dropped = 0
        self.worst_tie = self.prob_gap = self.out_gap = 0.0

    def __enter__(self):
        self.lm.moe_apply = self
        return self

    def __exit__(self, kind, *_):
        self.lm.moe_apply = self.apply
        if kind is None:
            assert not self.queue, "a card MoE call has no CPU counterpart"

    def __call__(self, module, x, **kw):
        import torch
        from repro_torch.nn.moe import capacity, route
        y, aux = self.apply(module, x, **kw)
        with torch.no_grad():
            xf = x.detach().reshape(-1, x.shape[-1])
            cap = capacity(module, xf.shape[0], kw.get("capacity_factor"))
            r = route(module, xf, cap)
            ids, keep = _routing_sets(r, module.k)
            yf = y.detach().reshape(xf.shape)
            if id(module) in self.card:
                self.queue.append((xf.cpu(), yf.cpu(), r.probs.cpu(), ids,
                                   keep))
            else:
                self.compare(module, cap, (yf, r.probs, ids, keep),
                             self.queue.pop(0))
        return y, aux

    def compare(self, module, cap, cpu, card):
        from repro_torch.nn.moe import route
        y_c, probs_c, ids_c, keep_c = cpu
        x_g, y_g, probs_g, ids_g, keep_g = card
        k = module.k
        self.calls += 1
        self.tokens += ids_c.shape[0]
        self.dropped += int((~keep_g).sum())
        self.prob_gap = max(self.prob_gap, float(
            ((probs_g - probs_c).abs().max(1).values
             / probs_c.max(1).values).max()))
        swapped = (ids_g != ids_c).any(1)
        if swapped.any():
            top = probs_c[swapped].sort(dim=1, descending=True).values
            tie = (top[:, k - 1] - top[:, k]) / top[:, 0]
            self.worst_tie = max(self.worst_tie, float(tie.max()))
            self.swaps += int(swapped.sum())
            assert float(tie.max()) <= ROUTE_TIE_TOL, \
                "a card-vs-CPU routing difference is not a near-tie"
            # the same layer on the CPU from the card's input
            self.reruns += 1
            y_c = self.apply(module, x_g[None])[0][0]
            ids_c, keep_c = _routing_sets(route(module, x_g, cap), k)
        agree = (ids_g == ids_c).all(1) & (keep_g == keep_c).all(1)
        assert agree.any(), "no token routed alike on the card and the CPU"
        gap = float((y_g - y_c).abs()[agree].max())
        self.out_gap = max(self.out_gap,
                           gap / max(float(y_c.abs().max()), 1e-30))

    def report(self, what):
        print(f"{what}: {self.calls} MoE calls, {self.tokens} tokens "
              f"routed, {self.dropped} (token, expert) pairs dropped at "
              f"capacity on the card; max|p card - p cpu| / max p = "
              f"{self.prob_gap:.3e}; {self.swaps} token(s) routed to another "
              f"expert set (each a near-tie: worst (p_k - p_k+1) / p_1 = "
              f"{self.worst_tie:.3e}, tolerance {ROUTE_TIE_TOL}), "
              f"{self.reruns} call(s) re-run from the card's input; outputs "
              f"where the routing agreed: max gap / max|y| = "
              f"{self.out_gap:.3e} (tolerance {LM_TOL})")
        assert self.out_gap <= LM_TOL, \
            "MoE outputs on the card disagree with the CPU"


def moe_alone(cfg, b: int = 8, s: int = 128):
    """One full-width MoE layer of ``cfg`` on the train shape, card vs CPU
    from the same weights and input.  The input has a common component (as
    hidden states do), so the router loads experts unevenly and the
    capacity drops pairs.  Also: a second call on the card bit-identical,
    and the layer's device time beside its bound."""
    import torch
    from repro_torch.nn.moe import MoE, capacity, moe_apply
    gen = torch.Generator(device="cpu").manual_seed(21)
    cpu = MoE(cfg, device="cpu")
    cpu.reset_parameters(gen)
    card = MoE(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(b, s, cfg.d_model, generator=gen) \
        + torch.randn(cfg.d_model, generator=gen)
    cap = capacity(card, b * s)
    route = RouteCheck(card)
    with torch.no_grad():
        route(card, x.cuda())
        y, aux = moe_apply(card, x.cuda())
        again, _ = moe_apply(card, x.cuda())
        y_c, aux_c = route(cpu, x)
    same = torch.equal(y, again)
    aux_rel = abs(float(aux) - float(aux_c)) / float(aux_c)
    print(f"moe_apply B={b} S={s} d={cfg.d_model}: {cfg.num_experts} experts "
          f"top-{cfg.experts_per_token}, width {cfg.moe_d_ff}, capacity "
          f"{cap}; aux card {float(aux):.7f} cpu {float(aux_c):.7f} "
          f"(relative {aux_rel:.3e}); a second call on the card "
          f"bit-identical: {same}")
    route.report("moe_apply alone")
    assert route.dropped > 0, "the capacity dropped nothing"
    assert aux_rel <= LM_TOL, "the aux loss differs"
    assert same, "moe_apply is not deterministic on the card"
    xg = x.cuda()
    f = cfg.moe_d_ff
    flops = 3 * 2 * cfg.num_experts * cap * cfg.d_model * f
    nbytes = 4 * (3 * cfg.num_experts * cfg.d_model * f
                  + cfg.d_model * cfg.num_experts + 2 * x.numel())
    t_bound, by = bound_ms(nbytes, flops)
    with torch.no_grad():
        ms = device_ms(lambda: moe_apply(card, xg), runs=5, reps=1,
                       sleep_cycles=20_000_000)
    print(f"moe_apply on the card: {ms:.4f} ms (bound {t_bound:.4f} ms, "
          f"{by}: the three expert products {flops / 1e9:.2f} GFLOP on the "
          f"(E, C, d) buffer at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)")


def granite_kernels(gen, cfg):
    """flash_attention, decode_attention and rmsnorm at granite's shapes:
    the train step and prefill (B=8, S=128, causal), the launcher's decode
    step (B=1 against a full 24-row cache) and rows of d=1024."""
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = time_training_kernels(gen, (8, 128, h, kh, d), cfg.d_model)
    out["decode_attention"] = time_decode(gen, 1, 24, 24, cold=True,
                                          heads=(h, kh, d))
    out["rmsnorm decode row"] = time_rmsnorm(gen, 1, cfg.d_model, cold=True)
    return out


# -- phase 18: resume from a checkpoint, and the compressed gradients ---------------

def _params_of(model):
    from repro_torch.launch.steps import trainable
    return {k: p.detach().clone() for k, p in trainable(model).items()}


def resume(cfg, tcfg, global_batch: int = 8, seq_len: int = 128):
    """``cfg`` trained ``tcfg.total_steps`` steps straight, then again
    with a checkpoint every half of them into a temporary directory under
    ``build/``; the last checkpoint removed, a fresh model resumes from the
    middle one.  The resumed steps must equal the straight run's: bit for
    bit where the two straight runs are, else within phase 9's tolerances.
    Returns the resumed model and the batches' source."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train
    from repro_torch.models.lm import init_lm
    half = tcfg.total_steps // 2
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(ROOT, "build"))
    kw = dict(global_batch=global_batch, seq_len=seq_len, log_every=0)
    start = init_lm(cfg, seed=tcfg.seed, device="cuda")
    p0 = _params_of(start)
    straight = train.run(cfg, tcfg, model=start, **kw)
    want = _params_of(start)
    del start
    m = init_lm(cfg, seed=tcfg.seed, device="cuda")
    saved = train.run(cfg, tcfg, model=m, ckpt_dir=tmp, ckpt_every=half,
                      **kw)
    again = _params_of(m)
    del m
    assert latest_step(tmp) == tcfg.total_steps
    mid = os.path.join(tmp, f"step_{half:010d}")
    nbytes = sum(os.path.getsize(os.path.join(mid, f))
                 for f in os.listdir(mid))
    shutil.rmtree(os.path.join(tmp, f"step_{tcfg.total_steps:010d}"))
    model = init_lm(cfg, seed=tcfg.seed, device="cuda")
    resumed = train.run(cfg, tcfg, model=model, ckpt_dir=tmp,
                        ckpt_every=half, **kw)
    shutil.rmtree(tmp)
    got = _params_of(model)
    deterministic = saved["losses"] == straight["losses"] and all(
        torch.equal(again[k], w) for k, w in want.items())
    exact = resumed["losses"] == straight["losses"][half:] and all(
        torch.equal(got[k], w) for k, w in want.items())
    gap = math.sqrt(sum(float((got[k] - w).square().sum())
                        for k, w in want.items()))
    moved = math.sqrt(sum(float((w - p0[k]).square().sum())
                          for k, w in want.items()))
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(resumed["losses"], straight["losses"][half:]))
    print(f"{cfg.name}, {cfg.num_layers} layers: straight losses "
          + ", ".join(f"{x:.7f}" for x in straight["losses"]))
    print(f"with checkpoints every {half} steps: the same losses and "
          f"parameters bit for bit: {deterministic}")
    print(f"resumed from step {resumed['start_step']}: losses "
          + ", ".join(f"{x:.7f}" for x in resumed["losses"])
          + f"; equal to the straight run's steps {half + 1}-"
          f"{tcfg.total_steps} and final parameters bit for bit: {exact} "
          f"(largest loss gap {loss_rel:.3e}, parameters |resumed - "
          f"straight| / |straight - start| = {_ratio(gap, moved):.3e})")
    print(f"checkpoint at step {half}: {nbytes / 1e9:.3f} GB written "
          f"(parameters and AdamW moments, float32); the save at step "
          f"{tcfg.total_steps} took {saved['last_save_s']:.2f} s in the "
          f"background, the restore {resumed['restore_s']:.2f} s")
    assert resumed["start_step"] == half and resumed["steps"] == half
    if deterministic:
        assert exact, "the resumed run differs from the straight one"
    else:
        assert loss_rel <= TRAIN_TOL and _ratio(gap, moved) \
            <= TRAIN_PARAM_TOL, "the resumed run differs from the straight one"
    return model


def compress_vs_cpu(model, batch_size: int = 8, seq_len: int = 128):
    """``compress_grads`` on one step's gradients of ``model``, card vs CPU
    on the same values: per reference leaf (the per-period tensors of a
    layer's leaf share one scale) the int8 payloads equal except where
    x / scale lies within an ulp of a .5 boundary (counted), the scales
    within 1 ulp, and the dequantized gradients and residuals equal where
    the payloads are."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch.steps import _leaf_groups, trainable
    from repro_torch.models.lm import lm_loss
    from repro_torch.optim import (compress_grads, init_error_feedback,
                                   quantize_int8)
    cfg = model.cfg
    batch = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq_len,
                                    global_batch=batch_size)).batch_at(0)
    params = trainable(model)
    total, _ = lm_loss(model, {k: torch.from_numpy(v).cuda()
                               for k, v in batch.items()})
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    cpu = {k: g.cpu() for k, g in grads.items()}
    groups = _leaf_groups(grads)
    flips, worst_ulps, elements = 0, 0, 0
    for names in groups:
        xg = torch.cat([grads[n].flatten() for n in names])
        xc = torch.cat([cpu[n].flatten() for n in names])
        qg, sg = quantize_int8(xg)
        qc, sc = quantize_int8(xc)
        ulps = abs(int(sg.cpu().view(torch.int32)) - int(sc.view(torch.int32)))
        worst_ulps = max(worst_ulps, ulps)
        differ = qg.cpu() != qc
        if differ.any():
            r = (xc / sc)[differ].abs()
            edge = ((r - r.floor()) - 0.5).abs()
            assert bool((edge <= torch.finfo(torch.float32).eps * r).all()), \
                "an int8 payload differs away from a .5 boundary"
            flips += int(differ.sum())
        elements += xc.numel()
    new_g, ef_g = compress_grads(grads, init_error_feedback(grads), groups)
    new_c, ef_c = compress_grads(cpu, init_error_feedback(cpu), groups)
    gap = max(float((new_g[k].cpu() - new_c[k]).abs().max()) for k in cpu)
    rgap = max(float((ef_g.residual[k].cpu() - ef_c.residual[k]).abs().max())
               for k in cpu)
    print(f"compress_grads on one step's gradients ({len(groups)} leaves, "
          f"{elements} elements): {flips} int8 payload(s) differ card vs "
          f"CPU, each within an ulp of a .5 boundary; scales within "
          f"{worst_ulps} ulp; dequantized gradients max|card - cpu| "
          f"{gap:.3e}, residuals {rgap:.3e}")
    assert worst_ulps <= 1, "the scales differ by more than an ulp"
    if flips == 0 and worst_ulps == 0:
        assert gap == 0.0 and rgap == 0.0, \
            "equal payloads dequantize differently"


# -- phases 19-21: the zoo's last three families ------------------------------------------

def zoo_vs_cpu(tcfg, prompt_batch: int = 2, train_batch: int = 2,
               train_seq: int = 16):
    """Each of phase 19's configurations card vs CPU from the same weights:
    a prefill of 16 tokens (B=2; seamless over 1024 frames, llava with 8
    patches in its first positions) and four greedy decode steps (seamless
    cross-attending to its memory), held as phase 7 holds them; then six
    train steps on the same batches with the stubs, held as phase 9 holds
    them (the xLSTM's in lockstep: ``train_lockstep_vs_cpu``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    for cfg in (dataclasses.replace(get_config("seamless-m4t-large-v2"),
                                    num_layers=2, encoder_layers=2),
                dataclasses.replace(get_config("xlstm-1.3b"), num_layers=8),
                dataclasses.replace(get_config("llava-next-34b"),
                                    num_layers=2)):
        t0 = time.perf_counter()
        model = init_lm(cfg, seed=11, device="cuda")
        n = sum(p.numel() for p in model.parameters())
        print(f"-- {cfg.name} cut to {cfg.num_layers} layers"
              + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec
                 else "") + f": {n / 1e9:.3f} B parameters")
        lm_vs_cpu(cfg, model=model, batch=prompt_batch,
                  stubs=zoo_stubs(cfg, prompt_batch, seed=99))
        if cfg.xlstm is not None:
            train_lockstep_vs_cpu(cfg, tcfg, model, train_batch, train_seq,
                                  nudge="layers.0.1.mlstm.wq.w")
        else:
            train_vs_cpu(cfg, tcfg, batch_size=train_batch, seq_len=train_seq,
                         model=model, stubs_fn=lambda step, cfg=cfg:
                         zoo_stubs(cfg, train_batch, seed=1000 + step))
        print(f"{cfg.name} card vs CPU took {time.perf_counter() - t0:.2f} s")
        del model
        torch.cuda.empty_cache()


def launches_as(model, state_dtype, counts):
    """``counts`` (by float32 kernel name) under the names the launches
    take for ``model``'s dtype and the state's: in a bfloat16 model every
    kernel that has a bfloat16 variant (a ``_bf16`` key of ``LAUNCHES``)
    under that variant's name; over a bfloat16 cache the decode kernel's,
    whose variant the cache picks."""
    import torch
    from repro_torch.kernels import LAUNCHES
    bf = torch.bfloat16
    rename = ({k: k + "_bf16" for k in LAUNCHES if k + "_bf16" in LAUNCHES}
              if model.embed.table.dtype == bf else {})
    if state_dtype == bf:
        rename["decode_attention"] = "decode_attention_bf16"
    out = dict.fromkeys(LAUNCHES, 0)
    for k, v in counts.items():
        out[rename.get(k, k)] += v
    return out


def serve_steps(cfg, model, batch, steps: int, what: str, state_dtype=None):
    """``make_prefill_step`` on ``batch`` and ``steps`` greedy steps of
    ``make_serve_step`` (cross-attending to the prefill's memory), on the
    card, with each kernel's launches held exactly to the layer pattern:
    the prefill's, then every step's.  Prints the prefill's and each
    step's device time (CUDA events around each, the step served eagerly)
    and returns the prefill's output, the last state, the memory, the
    served ms per step and the launches counted over the prefill and the
    steps together.  The state in ``state_dtype`` (float32 unless given),
    the launches expected under the names ``launches_as`` gives."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    s = batch["tokens"].shape[1]
    state_dtype = state_dtype or torch.float32
    prefill = make_prefill_step(cfg, max_seq=s + steps,
                                state_dtype=state_dtype)
    serve = make_serve_step(cfg)
    torch.cuda.synchronize()
    reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = prefill(model, batch)
    ev[1].record()
    torch.cuda.synchronize()
    pre_launches = dict(LAUNCHES)
    want = launches_as(model, state_dtype, forward_launches(cfg))
    print(f"{what}: prefill of {s} positions at B={batch['tokens'].shape[0]}"
          f" {ev[0].elapsed_time(ev[1]):.3f} ms of device time (CUDA "
          f"events); launches {pre_launches}, expected {want}")
    assert pre_launches == want, "the prefill did not run the kernels " \
        "exactly as the layer pattern implies"
    memory = out.get("memory")
    state, logits = out["state"], out["logits"]
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    reset_launches()
    pairs, tokens = [], []
    for _ in range(steps):
        tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        tokens.append(tok.tolist())
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        logits, state = serve(model, tok, state, memory)
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = launches_as(model, state_dtype, {
        k: steps * v for k, v in decode_launches(
            cfg, memory is not None).items()})
    served = statistics.median(a.elapsed_time(b) for a, b in pairs)
    print(f"{steps} decode steps: tokens {[t[0] for t in tokens]}; served "
          f"{served:.4f} ms a step (CUDA events around each, median); "
          f"launches {launches}, expected {want}")
    assert torch.isfinite(logits).all(), "non-finite decode logits"
    assert all(0 <= t[0] < cfg.vocab_size for t in tokens)
    assert launches == want, "the decode steps did not run the kernels " \
        "exactly as the layer pattern implies"
    return out, state, memory, served, {
        k: pre_launches[k] + launches[k] for k in launches}


def _decode_weight_bytes(model) -> int:
    """The bytes of the weights a decode step reads: every parameter but
    the embedding table (one row, unless the head is tied to it), the
    enc-dec encoder and the frontends' projections, which run only in the
    prefill."""
    skip = ("embed.", "encoder.", "frame_proj.", "patch_proj.")
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if not name.startswith(skip) or (
                   name == "embed.table" and model.cfg.tie_embeddings))


def seamless_whole(cfg, tcfg, prompt: int = 16, steps: int = 32,
                   train_batch: int = 8):
    """Phase 20: seamless-m4t-large-v2 whole (24 + 24 layers).  A prefill
    of 16 tokens over 1024 frames at B=1 and 32 served decode steps with
    the memory (exact launches: 72 ``flash_attention`` per prefill, 48
    ``decode_attention`` per step); the decode step's device time as a
    CUDA graph, its host time and its bound (the weights it reads and the
    memory's re-projection in every layer); then six train steps at B=8,
    S=128 with frame stubs: exact launches, device ms per phase, peak
    memory."""
    import torch
    from repro_torch.models.lm import init_lm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.encoder_layers} encoder + {cfg.num_layers} "
          f"decoder layers, d={cfg.d_model}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab()}): {n / 1e9:.3f} B parameters "
          f"({n * 4 / 1e9:.2f} GB), drawn in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator().manual_seed(8)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (1, prompt),
                                     generator=gen, dtype=torch.int32).cuda(),
             "enc_frames": zoo_stubs(cfg, 1, seed=8)["enc_frames"].cuda()}
    out, state, memory, served, _ = serve_steps(cfg, model, batch, steps,
                                                cfg.name)
    dev_ms, host_ms = time_decode_step(model, state=state, memory=memory)
    # the bound: the weights a step reads and the memory (S_mem x d) read
    # once, and in each of the L layers the memory projected to k and v
    # again: 2 S_mem d kv_dim multiply-adds
    s_mem, d, layers = cfg.encoder_seq_len, cfg.d_model, cfg.num_layers
    weights = _decode_weight_bytes(model)
    nbytes = weights + 4 * s_mem * d
    reproject = layers * 2 * 2 * s_mem * d * cfg.kv_dim
    flops = reproject + 2 * weights / 4
    t_bound, by = bound_ms(nbytes, flops)
    print(f"decode step (B=1, {s_mem}-row memory): {dev_ms:.4f} ms of device "
          f"time (CUDA graph replay, median of 5), {served:.4f} ms served, "
          f"{host_ms:.4f} ms to enqueue from an idle card; bound "
          f"{t_bound:.4f} ms ({by}: {weights / 1e9:.3f} GB of weights and "
          f"{flops / 1e9:.1f} GFLOP, {reproject / 1e9:.1f} GFLOP of them "
          f"the memory's re-projection)")
    print(f"serving peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del model, out, state, memory
    torch.cuda.empty_cache()
    _, run = train_period(cfg, tcfg, {}, global_batch=train_batch,
                          stubs_fn=lambda step: zoo_stubs(
                              cfg, train_batch, seed=2000 + step))
    return run


def llava_cut(cfg, steps: int = 16, text: int = 128):
    """llava-next-34b at its published widths, depth cut to ``cfg``'s
    layers: a prefill of its 2880 patch embeddings and ``text`` tokens at
    B=1 and ``steps`` served decode steps, launches exact; the decode
    step's device time (CUDA graph) against its bound."""
    import torch
    from repro_torch.models.lm import init_lm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_lm(cfg, seed=3, device="cuda")
    n = sum(p.numel() for p in model.parameters())
    p = cfg.num_patch_tokens
    print(f"{cfg.name}: {cfg.num_layers} of 60 layers, d={cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads}, D="
          f"{cfg.resolved_head_dim}: {n / 1e9:.3f} B parameters "
          f"({n * 4 / 1e9:.2f} GB)")
    gen = torch.Generator().manual_seed(9)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (1, p + text),
                                     generator=gen, dtype=torch.int32).cuda(),
             "patch_embeds": zoo_stubs(cfg, 1, seed=9,
                                       patches=p)["patch_embeds"].cuda()}
    out, state, _, served, _ = serve_steps(cfg, model, batch, steps,
                                           cfg.name)
    dev_ms, host_ms = time_decode_step(model, state=state)
    weights = _decode_weight_bytes(model)
    rows = p + text + steps
    nbytes = weights + cfg.num_layers * 2 * rows * cfg.kv_dim * 4
    t_bound, by = bound_ms(nbytes, 2 * weights / 4)
    print(f"decode step (B=1, {rows}-row cache): {dev_ms:.4f} ms of device "
          f"time (CUDA graph replay, median of 5), {served:.4f} ms served, "
          f"{host_ms:.4f} ms to enqueue; bound {t_bound:.4f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del model, out, state
    torch.cuda.empty_cache()


# -- phase 24: the DiT's training path ----------------------------------------------

DIT_TRAIN_LR = 3e-4      # AdamW for the full-width DiT (the reference's test
DIT_TRAIN_STEPS = 300    # trains the reduced one at 3e-3 for 30 steps)
DIT_TRAIN_BATCH = 8


def dit_train_flops(cfg, batch: int) -> float:
    """Float32 operations of one DiT train step, products only: per token
    the attention projections (4 d^2) and the MLP (2 d d_ff) multiply-add
    in each layer, the scores and P V (4 S d per token and layer); the
    backward takes twice the forward's.  The modulation (one row per
    sample), the embeddings and the patch projections are left out."""
    s, d = cfg.latent_hw ** 2, cfg.d_model
    per_token = cfg.num_layers * (2 * (4 * d * d + 2 * d * cfg.d_ff)
                                  + 4 * s * d)
    return 3.0 * batch * s * per_token


def dit_step_vs_cpu(cfg, batch: int = 2, steps: int = 3):
    """``gdm_loss`` on the card against the CPU from one set of weights and
    the same injected timesteps and noise: the loss within STEP_TOL
    (relative), every gradient leaf within 1e-4 of that leaf's largest
    magnitude (the products sum K up to 3072 in another order on each
    side, through 12 layers and back), then ``steps`` AdamW steps whose
    losses agree within TRAIN_TOL."""
    import torch
    from repro_torch.data import LatentDataset
    from repro_torch.launch.steps import trainable
    from repro_torch.models.gdm import DiT, gdm_loss, init_gdm
    from repro_torch.optim import adamw, apply_updates
    model = init_gdm(cfg, seed=13, device="cuda")
    cpu_model = DiT(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    sides = {"card": model, "cpu": cpu_model}
    params = {side: trainable(m) for side, m in sides.items()}
    init, update = adamw(DIT_TRAIN_LR)
    states = {side: init(p) for side, p in params.items()}
    data = LatentDataset(latent_hw=cfg.latent_hw, vocab_size=cfg.vocab_size)
    gen = torch.Generator().manual_seed(5)
    worst_leaf = 0.0
    for step in range(steps):
        raw = data.sample(batch, step)
        t = torch.randint(0, 16, (batch,), generator=gen)
        eps = torch.randn((batch, cfg.latent_hw ** 2, 4), generator=gen)
        losses, grads = {}, {}
        for side, m in sides.items():
            dev = m.pos.device
            loss, _ = gdm_loss(m, raw, t=t.to(dev), eps=eps.to(dev))
            g = torch.autograd.grad(loss, list(params[side].values()))
            losses[side] = loss.item()
            grads[side] = dict(zip(params[side], g))
            upd, states[side] = update(grads[side], states[side],
                                       params[side])
            apply_updates(params[side], upd)
        rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        print(f"step {step + 1}: loss card {losses['card']:.7f}, cpu "
              f"{losses['cpu']:.7f}, rel {rel:.2e} (tolerance "
              f"{STEP_TOL if step == 0 else TRAIN_TOL})")
        assert math.isfinite(losses["card"]), "non-finite loss on the card"
        assert rel <= (STEP_TOL if step == 0 else TRAIN_TOL), \
            "gdm_loss on the card disagrees with the CPU"
        if step == 0:
            for name, want in grads["cpu"].items():
                err = float((grads["card"][name].cpu() - want).abs().max())
                leaf = err / max(float(want.abs().max()), 1e-30)
                assert leaf <= 1e-4, f"gradient of {name} disagrees with " \
                    f"the CPU: {leaf:.2e} of its largest magnitude"
                worst_leaf = max(worst_leaf, leaf)
            print(f"  first step's gradients: {len(grads['cpu'])} leaves, "
                  f"the worst within {worst_leaf:.2e} of its largest "
                  "magnitude (tolerance 1e-4)")
    del model, cpu_model, sides, params, states
    torch.cuda.empty_cache()


def dit_omega(model, cfg, steps_per_block: int = 1, blocks: int = 4):
    """Omega(k) of ``model``: ``quality_per_block`` over 4 prompts of 8
    tokens and their noise, drawn on the card from seed 29, with the
    reference's properties asserted (Omega(B) = 1 within 1e-5, every value
    in [0, 1])."""
    import torch
    from repro_torch.models.gdm import LATENT_CHANNELS, quality_per_block
    gen = torch.Generator(device="cuda").manual_seed(29)
    prompts = torch.randint(2, cfg.vocab_size, (4, 8), generator=gen,
                            device="cuda")
    noise = torch.randn((4, cfg.latent_hw ** 2, LATENT_CHANNELS),
                        generator=gen, device="cuda")
    with torch.no_grad():
        q = quality_per_block(model, noise, prompts, num_blocks=blocks,
                              steps_per_block=steps_per_block).cpu()
    assert torch.isfinite(q).all(), "non-finite Omega"
    assert abs(float(q[-1]) - 1.0) <= 1e-5, "Omega(B) is not 1"
    assert bool(((q >= 0) & (q <= 1)).all()), "Omega outside [0, 1]"
    return [float(v) for v in q]


def dit_train(cfg, card: str, steps: int = DIT_TRAIN_STEPS,
              batch: int = DIT_TRAIN_BATCH):
    """Train the full-width DiT on the card from ``LatentDataset`` through
    ``prefetch``: ``gdm_loss`` with t and eps from a card generator, AdamW
    at DIT_TRAIN_LR.  Every step must launch 12 of each adaLN form, 12 of
    each backward and 12 ``flash_attention`` (one a layer), and the loss
    must fall (the reference test's criterion: the mean of the last 5
    losses below the first 5).  Reports the wall clock per step, one
    profiled step's kernels and device time against its host time (the
    idle share), peak memory, and Omega before and after.  Returns the
    launches of the run."""
    import numpy as np
    import torch
    from repro_torch.data import LatentDataset, prefetch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import trainable
    from repro_torch.models.gdm import gdm_loss, init_gdm
    from repro_torch.optim import adamw, apply_updates
    model = init_gdm(cfg, seed=17, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    params = trainable(model)
    names = list(params)
    init, update = adamw(DIT_TRAIN_LR)
    state = [init(params)]
    data = LatentDataset(latent_hw=cfg.latent_hw, vocab_size=cfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(23)
    omega = {"random": {spb: dit_omega(model, cfg, spb) for spb in (1, 4)}}
    layers = cfg.num_layers
    expected = dict.fromkeys(LAUNCHES, 0)
    expected.update(adaln_norm=layers, adaln_norm_epilogue=layers,
                    adaln_norm_backward=layers,
                    adaln_norm_epilogue_backward=layers,
                    flash_attention=layers)

    def step(b):
        loss, _ = gdm_loss(model, b, generator=gen)
        grads = torch.autograd.grad(loss, list(params.values()))
        upd, state[0] = update(dict(zip(names, grads)), state[0], params)
        apply_updates(params, upd)
        return loss.detach()

    losses, per_step = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for b in prefetch((data.sample(batch, i) for i in range(steps)),
                      device="cuda"):
        before = dict(LAUNCHES)
        losses.append(step(b))
        per_step.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # Omega of the trained DiT before the timed steps below train it further
    omega["trained"] = {spb: dit_omega(model, cfg, spb) for spb in (1, 4)}
    losses = torch.stack(losses).cpu().numpy()
    bad = [i for i, got in enumerate(per_step) if got != expected]
    print(f"{cfg.name}: {layers} layers, d={cfg.d_model}, {cfg.num_heads} x "
          f"{cfg.resolved_head_dim} heads, S={cfg.latent_hw ** 2}: "
          f"{n_params / 1e6:.1f} M parameters; {steps} AdamW steps at "
          f"{DIT_TRAIN_LR} on LatentDataset batches of {batch} through "
          f"prefetch in {wall:.2f} s ({wall * 1e3 / steps:.3f} ms a step on "
          f"the host's clock); peak device memory {peak / 2**30:.3f} GiB")
    print(f"expected launches per step {expected}; steps that differ: {bad}")
    print("losses, every 25th step: " + ", ".join(
        f"{i + 1}: {losses[i]:.5f}" for i in range(0, steps, 25))
        + f", {steps}: {losses[-1]:.5f}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"mean of the first 5 losses {first:.6f}, of the last 5 {last:.6f}")
    assert np.isfinite(losses).all(), "non-finite loss"
    assert not bad, "a train step did not launch the kernels exactly once a " \
        "layer"
    assert last < first, "the DiT's loss did not fall"
    # one step from an idle card: host enqueue time, then profiled (these
    # steps train the model on, on one batch)
    sample = next(prefetch(iter([data.sample(batch, steps)]), device="cuda"))
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(sample)
        host.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
    kernels, dev_ms = profile_kernels(lambda: step(sample))
    host_ms = statistics.median(host)
    split = sorted(kernel_split(lambda: step(sample), calls=1).items(),
                   key=lambda kv: -kv[1])
    print("the profiled step's device ms by kernel, the largest eight: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split[:8]))
    step_ms = wall * 1e3 / steps
    floor = dit_train_flops(cfg, batch)
    print(f"{card}: one train step launches {kernels} kernels summing to "
          f"{dev_ms:.3f} ms of device time; the host enqueues it in "
          f"{host_ms:.3f} ms (median of 3, from an idle card); over the run "
          f"a step takes {step_ms:.3f} ms, so the card idles "
          f"{100 * (1 - dev_ms / step_ms):.1f}% of it; the products take "
          f"{floor / 1e12:.3f} TFLOP a step, {floor / PEAK_F32_FLOPS * 1e3:.3f}"
          f" ms at the float32 rate (my count, dit_train_flops)")
    for spb in (1, 4):
        for what in ("random", "trained"):
            print(f"Omega(1..4) of the {what} DiT, {spb} DDIM step(s) a "
                  "block: " + " ".join(f"{q:.6f}" for q in omega[what][spb]))
    del model, params, state
    torch.cuda.empty_cache()
    return launches


def dit_helpers(card: str):
    """``from_gdm_model`` on the card at the reference's reduced config
    (three services, B=4, two DDIM steps a block), with the reference's
    properties asserted, and ``python -m repro_torch.examples.serve_gdm``
    once with small flags: it must exit 0 and print its summary line."""
    import numpy as np
    from repro_torch.sim import from_gdm_model
    curves = from_gdm_model(3, 4, seed=0, device="cuda")
    for s, row in enumerate(curves):
        print(f"from_gdm_model service {s}: Omega(0..4) = "
              + " ".join(f"{q:.6f}" for q in row))
    assert curves.shape == (3, 5) and (curves[:, 0] == 0).all()
    assert (np.diff(curves, axis=1) >= 0).all(), "Omega not monotone"
    assert np.abs(curves[:, -1] - 1.0).max() <= 1e-5, "Omega(B) is not 1"
    cmd = [sys.executable, "-m", "repro_torch.examples.serve_gdm",
           "--scenario", "smoke", "--train-eps", "4", "--frames", "8",
           "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    print(f"{' '.join(cmd[1:])}: exit {out.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    lines = out.stdout.strip().splitlines()
    for line in lines[-4:]:
        print("  " + line)
    assert out.returncode == 0, f"serve_gdm failed:\n{out.stderr[-4000:]}"
    assert lines and lines[-1].startswith("learned vs greedy objective"), \
        "serve_gdm printed no summary line"


# -- phase 25: the cost counter on the card, the dry run, the KV pool ----------------

COST_CELLS = (("granite-moe-1b-a400m", "train", 8, 128),
              ("yi-6b", "decode", 8, 4096))
DRYRUN_CELLS = (("yi-6b", "train_4k"), ("yi-6b", "prefill_32k"),
                ("yi-6b", "decode_32k"), ("xlstm-1.3b", "long_500k"))


def _cost_step(cfg, kind, b, s, device, dtype=None, remat=False):
    """One ``kind`` step (train, prefill or decode) of ``cfg`` at batch
    ``b``, length ``s`` on ``device`` (the card, or meta), as a call: a
    train step on random tokens (with ``remat`` or without), a prefill of
    them, or a decode step against an ``s``-row cache whose rows are all
    in use (every length set to s - 1 first, so the decode kernel reads
    the whole cache its formula counts).  The model and the state in
    ``dtype`` (float32 unless given)."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM, init_decode_state, init_lm
    from repro_torch.optim import adamw
    dtype = dtype or torch.float32
    meta = device == "meta"
    model = LM(cfg, device=device, dtype=dtype) if meta else init_lm(
        cfg, seed=0, device=device, dtype=dtype)
    gen = None if meta else torch.Generator(device=device).manual_seed(3)

    def tokens(*shape):
        if meta:
            return torch.empty(shape, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, shape, dtype=torch.int32,
                             device=device, generator=gen)

    if kind == "train":
        step = steps.make_train_step(
            cfg, TrainConfig(), opts=steps.StepOptions(remat=remat))
        opt = adamw(1e-3)[0](steps.trainable(model))
        batch = {"tokens": tokens(b, s), "labels": tokens(b, s)}
        return lambda: step(model, opt, batch)
    if kind == "prefill":
        step = steps.make_prefill_step(cfg, max_seq=s, state_dtype=dtype)
        batch = {"tokens": tokens(b, s)}
        return lambda: step(model, batch)
    step = steps.make_serve_step(cfg)
    state = init_decode_state(cfg, b, s, dtype=dtype, device=device)
    token = tokens(b)

    def call():
        for slot in state:
            slot["kv"].length.fill_(s - 1)
        return step(model, token, state)

    return call


def cost_on_card(cfg, kind, b, s, dtype=None, remat=False):
    """One counted step on the card against the same cell counted on the
    meta device: the Cost equal, each kernel's charges equal to its launch
    count, the step's device time (the profiled kernels' sum) at least the
    roofline's largest term (at ``dtype``'s rate), and the tracker's peak
    beside the allocator's.  The model and state in ``dtype`` (float32
    unless given); a train step with ``remat`` or without."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import op_cost, roofline
    from repro_torch.kernels import LAUNCHES
    dtype = dtype or torch.float32
    call = _cost_step(cfg, kind, b, s, "cuda", dtype, remat)
    call()                                  # warm: cuBLAS, the allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    with op_cost.count() as counted:
        call()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    allocated = torch.cuda.max_memory_allocated() - base
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    card = counted.cost
    n, dev_ms = profile_kernels(call)
    del call
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_call = _cost_step(cfg, kind, b, s, "meta", dtype, remat)
    with op_cost.count() as on_meta:
        meta_call()
    meta_s = time.perf_counter() - t0
    what = (f"{cfg.name} {kind} B={b} S={s} {str(dtype)[6:]}"
            + (" remat" if remat else ""))
    if on_meta.cost != card:
        mine, theirs = dict(counted.bytes_by_op(200)), dict(
            on_meta.bytes_by_op(200))
        for k in sorted(set(mine) | set(theirs)):
            if mine.get(k) != theirs.get(k):
                print(f"  bytes by op differ: {k} card {mine.get(k)} "
                      f"meta {theirs.get(k)}")
        raise AssertionError(f"{what}: the card's count {card} differs "
                             f"from the meta count {on_meta.cost}")
    charged = {k: int(v[0]) for k, v in card.kernels.items()}
    for name, count in launched.items():
        assert charged.get(name, 0) == count, (
            f"{what}: {name} launched {count} times, charged "
            f"{charged.get(name, 0)}")
    assert all(k in launched or k.endswith("_backward")
               for k in charged), charged
    rf = roofline.analyze(card, num_devices=1, dtype=dtype)
    bound_ms = max(rf.compute_s, rf.memory_s) * 1e3
    print(f"{what}: {card.flops / 1e9:.3f} GFLOP, {card.bytes / 1e9:.3f} GB "
          f"counted on the card in {host_s:.2f} s, equal to the meta count "
          f"({meta_s:.2f} s); kernels charged = launched: {charged}")
    print(f"  roofline on the H100 ({roofline.peak_flops(dtype) / 1e12:.0f} "
          f"TFLOP/s {str(dtype)[6:]}, 3.35 TB/s): compute "
          f"{rf.compute_s * 1e3:.4f} ms, memory {rf.memory_s * 1e3:.4f} ms "
          f"({rf.dominant}); the step's {n} kernels ran {dev_ms:.4f} ms of "
          f"device time: {bound_ms / dev_ms:.4f} of it is the bound")
    print(f"  peak: the tracker {card.peak_bytes / 2**20:.1f} MiB, "
          f"torch.cuda.max_memory_allocated above the step's start "
          f"{allocated / 2**20:.1f} MiB (gap "
          f"{(allocated - card.peak_bytes) / 2**20:+.1f} MiB: what a kernel "
          "unit allocates inside, its workspaces and the torch-op "
          "backwards' intermediates, is not tracked, and the allocator "
          "rounds each block up)")
    assert dev_ms >= bound_ms, (
        f"{what}: {dev_ms} ms of device time is below the roofline's "
        f"{bound_ms} ms; the count is wrong")
    del meta_call
    return dict(flops=card.flops, bytes=card.bytes, device_ms=dev_ms,
                bound_ms=bound_ms, peak=card.peak_bytes, allocated=allocated)


def dryrun_cells():
    """The dry run on meta for DRYRUN_CELLS on the single pod, each record
    and its seconds."""
    import torch
    from repro_torch.launch import dryrun
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=False,
                              opts=dryrun.OPT_LEVELS["baseline"],
                              dtype=torch.float32)
        secs = time.perf_counter() - t0
        assert rec["status"] == "ok", rec
        rf = rec["roofline"]
        print(f"dryrun {arch} {shape} single ({secs:.2f} s): "
              f"{rf['flops_per_device'] / 1e12:.3f} TFLOP, "
              f"{rf['bytes_per_device'] / 1e9:.3f} GB, collective "
              f"{rf['collective_bytes_per_device'] / 1e9:.3f} GB a device; "
              f"compute {rf['compute_s'] * 1e3:.2f} ms, memory "
              f"{rf['memory_s'] * 1e3:.2f} ms, collective "
              f"{rf['collective_s'] * 1e3:.2f} ms ({rf['dominant']}); "
              f"arguments {rf['argument_bytes'] / 2**30:.3f} GiB, peak "
              f"{rf['peak_memory_bytes'] / 2**30:.3f} GiB; useful "
              f"{rf['useful_ratio']:.4f}; busiest position "
              f"{rec['busiest_position']}")


def kv_pool_on_card(cfg, tokens: int = 2048):
    """A ``tokens``-long request extracted from one ``KVPagePool`` on the
    card and injected into another at ``cfg``'s geometry with
    ``ServeConfig``'s page size: the pages bit for bit, the migration
    bytes, and the move's rate against 3.35 TB/s."""
    import torch
    from repro_torch.configs import ServeConfig
    from repro_torch.serving import KVPagePool
    page = ServeConfig().page_size
    pages = -(-tokens // page)
    geo = dict(kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
               num_layers=cfg.num_layers)
    src = KVPagePool(2 * pages, page, **geo)
    dst = KVPagePool(2 * pages, page, **geo)
    assert src.data.device.type == "cuda"
    src.allocate(1)
    for _ in range(tokens):
        src.append_token(1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    src.data.normal_(generator=gen)
    dst.allocate(0)
    for _ in range(3 * page):               # another request's pages first
        dst.append_token(0)

    def move():
        blob = src.extract(1)
        dst.release(1)
        dst.inject(1, blob)
        return blob

    blob = move()
    torch.cuda.synchronize()
    assert torch.equal(dst.data[dst.tables[1].pages],
                       src.data[src.tables[1].pages])
    assert dst.tables[1].length == tokens
    assert dst.tables[1].pages != src.tables[1].pages
    per_page = geo["num_layers"] * 2 * page * geo["kv_heads"] \
        * geo["head_dim"] * 4
    nbytes = src.migration_bytes(1)
    assert nbytes == pages * per_page == blob["pages"].nbytes
    ms = device_ms(move, runs=5, reps=1, sleep_cycles=2_000_000)
    traffic = 4 * nbytes          # extract reads and writes, inject too
    print(f"KV pool at {cfg.name}'s geometry ({geo['num_layers']} layers, "
          f"{geo['kv_heads']} kv heads x {geo['head_dim']}, page {page}): "
          f"{tokens} tokens = {pages} pages, {nbytes / 1e6:.3f} MB "
          f"extracted and injected in {ms:.4f} ms: "
          f"{nbytes / ms / 1e6:.2f} GB/s of migration bytes, "
          f"{traffic / ms / 1e6:.2f} GB/s of HBM traffic against 3350 GB/s "
          f"({traffic / ms / 1e6 / 3350:.4f})")
    return dict(ms=ms, nbytes=nbytes)


def count_phase():
    """Phase 25: two counted steps on the card, the dry run, the KV pool."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = {}
    for arch, kind, b, s in COST_CELLS:
        out[arch] = cost_on_card(get_config(arch), kind, b, s)
        torch.cuda.empty_cache()
    dryrun_cells()
    out["kv_pool"] = kv_pool_on_card(get_config("yi-6b"))
    torch.cuda.empty_cache()
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 26: the reference's bfloat16 configuration of the LM ----------------------

# the reference's bfloat16 bars (tests/test_kernels.py: flash, decode and
# rmsnorm 2e-2, the scan 5e-2), applied as np.testing.assert_allclose does:
# |kernel - plain| <= bar * (1 + |plain|), compared in float32.  Kernel
# and plain version compute in float32 from the same bfloat16 inputs and
# round once; they part by the order of the sums, by flash's bfloat16 P,
# and by the one bfloat16 ulp (2^-8 relative) that a rounding at a
# different side of a boundary gives
BF16_KERNEL_TOL = 2e-2
BF16_SCAN_TOL = 5e-2
# LM steps in bfloat16, card vs CPU, relative to the largest |logit|
# (|state|): each side rounds every op's output to bfloat16 after
# products summed in another order, so a layer's output parts by a few
# bfloat16 ulps; the reduced configs against the reference part by up to
# 3.8e-2 over 8 layers (tests/test_torch_bf16.py)
BF16_LM_TOL = 5e-2
# float32 parameters over a bfloat16 state: only the cache is rounded,
# alike on both sides, but a float32 value that the two sides compute a
# rounding apart can land on neighbouring bfloat16 values: one bfloat16 ulp
# of the largest value
MIXED_TOL = 4e-3
# flash and decode in bfloat16 again, each output row (b, [query,] head)
# against its own scale: max|kernel - plain| <= BF16_ROW_TOL * max|plain|
# over the row's D values.  The 2e-2 bar above is 0.6 of a typical output
# at 3000-4000 keys (about sqrt(e / N) = 0.03 from standard normal
# inputs), so a kernel that lost a warp's or a split's keys would pass it;
# this bar is four bfloat16 ulps of the row's largest value (an ulp is
# 2^-8 to 2^-7 of it), where a rounding at another side of a boundary
# gives one.  check_bf16_controls shows it catches those faults.
BF16_ROW_TOL = 2.0 ** -5

# (B, Sq, Sk, H, KH, D, causal, window, q_offset): the DiT's shape, yi-6b's
# prefill (phase 26's), granite's train shape, llava's prefill (G=7), and
# the masking cases: a window, q_offset with a ragged Sk, cross-attention
BF16_FLASH_CASES = [
    (4, 256, 256, 12, 12, 64, False, 0, 0),
    (1, 128, 128, 32, 4, 128, True, 0, 0),
    (8, 128, 128, 16, 8, 64, True, 0, 0),
    (1, 3008, 3008, 56, 8, 128, True, 0, 0),
    (2, 100, 100, 8, 2, 32, True, 16, 0),
    (2, 17, 40, 4, 4, 16, True, 0, 23),
    (1, 5, 300, 8, 1, 128, False, 0, 0),
    # the wgmma kernel's edges: Sq of 1, 63 and 65 against its 64-row
    # warpgroups, Sk no multiple of its 128-key tile, causal with q_offset,
    # windows, rows with every key masked, D=64 and D=128 with GQA
    (2, 1, 300, 8, 2, 128, True, 0, 299),
    (2, 63, 200, 8, 2, 64, False, 0, 0),
    (2, 65, 65, 4, 4, 128, True, 0, 0),
    (1, 130, 390, 6, 3, 128, True, 0, 260),
    (2, 300, 300, 4, 2, 64, True, 100, 0),
    (2, 200, 260, 4, 4, 128, False, 64, 60),
    (1, 70, 90, 4, 4, 64, True, 0, -20),
    (1, 257, 257, 2, 1, 128, False, 0, 0),
    # enough heads x batch x 128-row query tiles to fill the SMs, so the
    # wgmma kernel takes two consumer warpgroups a block (llava's prefill
    # above is the other such case): D=64 and D=128 with GQA, ragged Sq
    # and Sk, windows, q_offset large or negative (rows with every key
    # masked), no mask at all
    (2, 777, 901, 12, 4, 64, True, 256, 123),
    (2, 600, 650, 24, 8, 64, True, 100, -50),
    (3, 390, 333, 16, 16, 64, False, 0, 0),
    (1, 1000, 1100, 40, 8, 128, True, 0, -37),
    (2, 520, 2000, 32, 4, 128, True, 300, 1400),
    (2, 333, 517, 32, 8, 128, False, 0, 0),
]
# (B, S, H, KH, D, lengths): the launcher's decode, phase 26's cache, B=8
# over 4096 rows with ragged lengths, granite's heads, llava's G=7,
# deepseek's G=8, splits over head groups, D=16 and 32
BF16_DECODE_CASES = [
    (1, 24, 32, 4, 128, [9]),
    (1, 24, 32, 4, 128, [0]),
    (1, 160, 32, 4, 128, [160]),
    (8, 4096, 32, 4, 128, [0, 1, 4096, 4095, 2049, 300, 5000, 64]),
    (1, 24, 16, 8, 64, [24]),
    (1, 3024, 56, 8, 128, [3009]),
    (1, 4096, 64, 8, 128, [4096]),
    (3, 200, 8, 2, 64, [67, 134, 135]),
    (2, 33, 4, 1, 16, [33, 5]),
    (2, 777, 16, 4, 32, [777, 100]),
    # G=7 and G=8 at the edges of the tensor cores' 16-key warp slices,
    # 64-key tiles and 192-key splits (2 splits at S=300); a float32 q
    # takes the CUDA cores' 32-key tiles and 64-key splits there
    (4, 300, 14, 2, 128, [15, 16, 17, 64]),
    (4, 300, 16, 2, 128, [0, 1, 63, 65]),
    (3, 300, 14, 2, 128, [191, 192, 193]),
    (3, 300, 16, 2, 64, [299, 300, 301]),
]
# (rows, d, offset of x in elements): yi-6b's decode row, trainer rows and
# prefill rows, granite's row, llava's prefill, deepseek's row; a view two
# bytes into its buffer and d = 100 (single values a load)
BF16_RMS_CASES = [(1, 4096, 0), (1024, 4096, 0), (8192, 4096, 0),
                  (128, 4096, 0), (1, 1024, 0), (3008, 7168, 0),
                  (1, 8192, 0), (3, 4096, 1), (7, 100, 0)]
# (B, L, Din, N): the training shape, phase 26's Jamba prefill, and the
# single-value copies (Din and N no multiple of 8)
BF16_SCAN_CASES = [(8, 128, 8192, 16), (1, 32, 8192, 16), (2, 37, 300, 5),
                   (2, 40, 100, 16), (2, 16, 128, 8)]


def _bf16(t):
    import torch
    return t.to(torch.bfloat16)


def _allclose_gap(got, want, tol):
    """max|got - want| in float32, and whether every element is within
    ``tol * (1 + |want|)``."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol * (1 + w.abs())).all())


def _row_gap(got, want):
    """The largest, over output rows (every index but the last, the head
    dimension), of max|got - want| / max|want| in the row: the gap in
    units of the row's own scale (inf where a row of zeros is missed)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1)
    ratio = torch.where(scale > 0, diff / scale.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0))
    return float(ratio.max())


def check_bf16_kernels(gen):
    """Phase 26(a): each bfloat16 kernel against its plain version on the
    card, on bfloat16 inputs (decode also with a float32 query over the
    bfloat16 cache, held at float32's TOL; the scan's final state float32,
    at SCAN_TOL), a second call bit for bit; rmsnorm also with a float32
    scale over the bfloat16 rows (the mixed form, as the reference's
    kernel takes it), its cases taking both of its kernels.  Returns
    each variant's largest absolute gap."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import bf16_route
    from repro_torch.kernels.rmsnorm import (BLOCK, ROW, launch_plan,
                                             load_width)
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    worst = dict.fromkeys(("flash_attention_bf16", "decode_attention_bf16",
                           "rmsnorm_bf16", "ssm_scan_bf16"), 0.0)
    row_worst = dict.fromkeys(("flash_attention_bf16",
                               "decode_attention_bf16"), 0.0)
    routes = set()
    for (b, sq, sk, h, kh, d, causal, window, q_offset) in BF16_FLASH_CASES:
        q = _bf16(_randn(gen, b, sq, h, d))
        k, v = _bf16(_randn(gen, b, sk, kh, d)), _bf16(_randn(gen, b, sk,
                                                              kh, d))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = ops.flash_attention(q, k, v, **kw)
        assert got.dtype == torch.bfloat16
        want = ref.attention(q, k, v, **kw)
        err, ok = _allclose_gap(got, want, BF16_KERNEL_TOL)
        row = _row_gap(got, want)
        route = bf16_route(b, sq, h, d)
        routes.add((d, route))
        print(f"flash_attention bf16 B={b} Sq={sq} Sk={sk} H={h} KH={kh} "
              f"D={d} causal={causal} window={window} q_offset={q_offset} "
              f"({route}): max|kernel - plain| = {err:.3e}; by row "
              f"{row:.3e} of max|plain|")
        assert ok, "flash_attention bf16 disagrees with its plain version"
        assert row <= BF16_ROW_TOL, \
            "flash_attention bf16 disagrees with its plain version by row"
        worst["flash_attention_bf16"] = max(worst["flash_attention_bf16"],
                                            err)
        row_worst["flash_attention_bf16"] = max(
            row_worst["flash_attention_bf16"], row)
    for d in (64, 128):
        for nc in ("1 consumer warpgroup", "2 consumer warpgroups"):
            assert (d, f"wgmma, {nc}") in routes, \
                f"no flash case took the wgmma kernel with {nc} at D={d}"
    for (b, s, h, kh, d, lengths) in BF16_DECODE_CASES:
        k, v = _bf16(_randn(gen, b, s, kh, d)), _bf16(_randn(gen, b, s, kh,
                                                             d))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for q in (_bf16(_randn(gen, b, h, d)), _randn(gen, b, h, d)):
            got = ops.decode_attention(q, k, v, lens)
            same = torch.equal(got, ops.decode_attention(q, k, v, lens))
            want = ref.decode_attention(q, k, v, lens)
            assert got.dtype == q.dtype
            row = ""
            if q.dtype == torch.bfloat16:
                err, ok = _allclose_gap(got, want, BF16_KERNEL_TOL)
                gap = _row_gap(got, want)
                ok = ok and gap <= BF16_ROW_TOL
                row_worst["decode_attention_bf16"] = max(
                    row_worst["decode_attention_bf16"], gap)
                row = f"; by row {gap:.3e} of max|plain|"
            else:
                err = float((got - want).abs().max())
                ok = err <= TOL
            print(f"decode_attention bf16 cache, q {str(q.dtype)[6:]}, B={b} "
                  f"S={s} H={h} KH={kh} D={d} lengths={lengths}: "
                  f"max|kernel - plain| = {err:.3e}{row}; a second call "
                  f"bit-identical: {same}")
            assert ok, "decode_attention bf16 disagrees with its plain version"
            assert same, "decode_attention bf16 is not deterministic"
            worst["decode_attention_bf16"] = max(
                worst["decode_attention_bf16"], err)
    kinds = set()
    for rows, d, offset in BF16_RMS_CASES:
        x = _bf16(_randn(gen, rows * d + offset))[offset:].view(rows, d)
        w32 = 1.0 + _randn(gen, d, scale=0.1)
        for w in (_bf16(w32), w32):            # the mixed form: float32 scale
            got = ops.rmsnorm(x, w)
            same = torch.equal(got, ops.rmsnorm(x, w))
            assert got.dtype == torch.bfloat16
            err, ok = _allclose_gap(got, ref.rmsnorm(x, w), BF16_KERNEL_TOL)
            width = load_width(x, w)
            plan = launch_plan(rows, d, x.dtype, width)
            kinds.add(plan.kernel)
            print(f"rmsnorm bf16 rows={rows} d={d} x offset {offset}, scale "
                  f"{str(w.dtype)[6:]}: {2 * width}-byte loads, {plan}; "
                  f"max|kernel - plain| = {err:.3e}; a second call "
                  f"bit-identical: {same}")
            assert ok, "rmsnorm bf16 disagrees with its plain version"
            assert same, "rmsnorm bf16 is not deterministic"
            worst["rmsnorm_bf16"] = max(worst["rmsnorm_bf16"], err)
    assert kinds == {BLOCK, ROW}, \
        f"the rmsnorm cases took the kernels {kinds}, not both"
    layouts = set()
    for (b, length, din, n) in BF16_SCAN_CASES:
        lanes = scan_layout(b, din, n)
        layouts.add(lanes > 1)
        ins = scan_inputs(gen, b, length, din, n)
        for i in (0, 1, 3, 4):                     # u, dt, B, C
            ins[i] = _bf16(ins[i])
        y, hf, _ = ssm_scan_cuda(*ins, return_state=True)
        y2, hf2, _ = ssm_scan_cuda(*ins, return_state=True)
        same = torch.equal(y, y2) and torch.equal(hf, hf2)
        wy, wh = ref.ssm_scan(*ins)
        assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
        err, ok = _allclose_gap(y, wy, BF16_SCAN_TOL)
        eh, rh = _rel(hf, wh)
        print(f"ssm_scan bf16 B={b} L={length} Din={din} N={n} ({lanes} "
              f"lane(s) a channel): y "
              f"max|kernel - plain| = {err:.3e}, h_final {eh:.3e} (rel "
              f"{rh:.3e}); a second call bit-identical: {same}")
        assert ok and rh <= SCAN_TOL, \
            "ssm_scan bf16 disagrees with its plain version"
        assert same, "ssm_scan bf16 is not deterministic"
        worst["ssm_scan_bf16"] = max(worst["ssm_scan_bf16"], err)
    assert layouts == {False, True}, \
        "BF16_SCAN_CASES do not reach both layouts of the forward scan"
    for name, gap in row_worst.items():
        print(f"{name}: the largest gap by row over its cases {gap:.3e} of "
              f"the row's max|plain| (bar {BF16_ROW_TOL:.3e})")
    check_bf16_controls(gen)
    return worst


def _attention_keeping(q, k, v, keep, *, causal=False, window=0,
                       q_offset=0):
    """ref.attention over only the keys that ``keep`` (broadcast to (B,
    1, Sq, Sk)) leaves, and its masks: what a kernel that lost the other
    keys computes, up to rounding."""
    import torch
    from repro_torch.kernels.ref import NEG_INF
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kf) * d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = keep & torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    scores = scores.masked_fill(~mask, NEG_INF)
    out = torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, -1), vf)
    return out.to(q.dtype)


# the controls' shapes: llava's decode (G=7, 3009 of 3024 rows),
# deepseek's (G=8, 4096), B=8 over 4096 rows with ragged lengths; llava's
# prefill and a two-consumer D=64 prefill with a window
BF16_CONTROL_DECODE = [(1, 3024, 56, 8, 128, [3009]),
                       (1, 4096, 64, 8, 128, [4096]),
                       (8, 4096, 32, 4, 128, [4096, 4095, 2049, 3000, 4096,
                                              1000, 3333, 4090])]
BF16_CONTROL_FLASH = [(1, 3008, 3008, 56, 8, 128, True, 0, 0),
                      (2, 777, 901, 12, 4, 64, True, 256, 123)]


def check_bf16_controls(gen):
    """Phase 26(a): the power of BF16_ROW_TOL.  At the headline shapes the
    kernel's gap by row stands beside the gap of outputs that a faulty
    kernel would give, each computed by the plain version on the same
    inputs: decode with one warp's keys of every tile left out, with the
    middle split left out, and with one tile's V taken from the tile a
    ring of three stages on (a stage raced); flash with one key tile left
    out for the last block's worth of rows, with one tile's V from three
    stages before, and (two consumers) with the second consumer's rows
    given the first's.  Every fault must fail the bar, and the kernel
    pass it."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import (_sm_count, decode_grid,
                                                      split_keys, tile_keys)
    from repro_torch.kernels.flash_attention import bf16_route
    sms = _sm_count(0)
    worst_fault = float("inf")
    for (b, s, h, kh, d, lengths) in BF16_CONTROL_DECODE:
        q = _bf16(_randn(gen, b, h, d))
        k, v = _bf16(_randn(gen, b, s, kh, d)), _bf16(_randn(gen, b, s, kh,
                                                             d))
        lens = torch.tensor(lengths, dtype=torch.int32, device=q.device)
        want = ref.decode_attention(q, k, v, lens)
        tile = tile_keys(q.dtype, k.dtype)
        splits, _ = decode_grid(b * kh, h // kh, s, sms, tile)
        chunk = split_keys(s, splits, tile)
        pos = torch.arange(s, device=q.device)
        live = (pos[None, :] < lens[:, None])[:, None, None, :]
        mid = splits // 2
        faults = {
            "warp 1's keys": (pos % tile) // (tile // 4) != 1,
            f"split {mid} of {splits}": (pos < mid * chunk)
            | (pos >= (mid + 1) * chunk),
        }
        gaps = {name: _row_gap(_attention_keeping(
            q[:, None], k, v, live & keep)[:, 0], want)
            for name, keep in faults.items()}
        raced = v.clone()
        raced[:, tile:2 * tile] = v[:, 4 * tile:5 * tile]
        gaps["tile 1's V raced"] = _row_gap(
            ref.decode_attention(q, k, raced, lens), want)
        kernel = _row_gap(ops.decode_attention(q, k, v, lens), want)
        print(f"control decode_attention bf16 B={b} S={s} H={h} KH={kh} "
              f"D={d} lengths={lengths} ({splits} splits of {chunk} keys): "
              f"kernel by row {kernel:.3e}; faults left out "
              + ", ".join(f"{n} {g_:.3e}" for n, g_ in gaps.items()))
        assert kernel <= BF16_ROW_TOL < min(gaps.values()), \
            "BF16_ROW_TOL does not tell decode's kernel from a fault"
        worst_fault = min(worst_fault, *gaps.values())
    for (b, sq, sk, h, kh, d, causal, window, q_offset) in \
            BF16_CONTROL_FLASH:
        q = _bf16(_randn(gen, b, sq, h, d))
        k, v = _bf16(_randn(gen, b, sk, kh, d)), _bf16(_randn(gen, b, sk,
                                                              kh, d))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        want = ref.attention(q, k, v, **kw)
        route = bf16_route(b, sq, h, d)
        rows = 128 if route.startswith("wgmma, 2") else 64
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        # a key tile that the last block's rows see: the one 128 keys
        # below the last row's position; its V raced with the tile of
        # the same stage three tiles before
        kt = max(0, (min(sk - 1, sq - 1 + q_offset) - 128) // 128 * 128)
        lost = _attention_keeping(
            q, k, v, (qpos < sq - rows) | (kpos < kt) | (kpos >= kt + 128),
            **kw)
        raced = v.clone()
        raced[:, kt:kt + 128] = v[:, kt - 384:kt - 256] if kt >= 384 \
            else -v[:, kt:kt + 128]
        gaps = {f"key tile {kt // 128} for the last {rows} rows":
                _row_gap(lost, want),
                f"tile {kt // 128}'s V raced": _row_gap(
                    ref.attention(q, k, raced, **kw), want)}
        if rows == 128:
            whole = want.clone()
            blk = whole[:, :sq // 128 * 128].view(b, sq // 128, 128, h, d)
            blk[:, :, 64:] = blk[:, :, :64].clone()
            gaps["consumer 1 given consumer 0's rows"] = _row_gap(whole,
                                                                  want)
        kernel = _row_gap(ops.flash_attention(q, k, v, **kw), want)
        print(f"control flash_attention bf16 B={b} Sq={sq} Sk={sk} H={h} "
              f"KH={kh} D={d} causal={causal} window={window} q_offset="
              f"{q_offset} ({route}): kernel by row {kernel:.3e}; faults "
              + ", ".join(f"{n} {g_:.3e}" for n, g_ in gaps.items()))
        assert kernel <= BF16_ROW_TOL < min(gaps.values()), \
            "BF16_ROW_TOL does not tell flash's kernel from a fault"
        worst_fault = min(worst_fault, *gaps.values())
        del want, lost, raced
        torch.cuda.empty_cache()
    print(f"controls: the smallest gap by row of a fault {worst_fault:.3e}, "
          f"the bar {BF16_ROW_TOL:.3e}")


def _print_bf16_times(what, t):
    _print_times(what, t)
    print(f"  the float32 kernel at the same shape in this call: "
          f"{t['f32_ms']:.7f} ms ({t['f32_ms'] / t['ms']:.2f}x the bfloat16 "
          f"kernel's time)")


def time_flash_bf16(gen, b, sq, sk, h, kh, d, causal, runs=TIMED_RUNS,
                    reps=10):
    """flash_attention in bfloat16 beside the float32 kernel on the same
    values, its plain version and SDPA in bfloat16; the bound counts
    bfloat16 bytes and the products at the bfloat16 rate."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q32 = _randn(gen, b, sq, h, d)
    k32, v32 = _randn(gen, b, sk, kh, d), _randn(gen, b, sk, kh, d)
    q, k, v = _bf16(q32), _bf16(k32), _bf16(v32)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    t_bound, by = bound_ms(2 * 2 * (b * sq * h * d + b * sk * kh * d), 0.0,
                           pairs, bf16_flops=4 * pairs * d)
    kw = dict(runs=runs, reps=reps)
    t = dict(ms=device_ms(lambda: ops.flash_attention(q, k, v,
                                                      causal=causal), **kw),
             f32_ms=device_ms(lambda: ops.flash_attention(
                 q32, k32, v32, causal=causal), **kw),
             plain_ms=device_ms(lambda: ref.attention(q, k, v,
                                                      causal=causal), **kw),
             bound_ms=t_bound, bound_by=by,
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True), **kw))
    _print_bf16_times(f"flash_attention bf16 B={b} Sq={sq} Sk={sk} H={h} "
                      f"KH={kh} D={d} {'causal' if causal else 'non-causal'}",
                      t)
    return t


def time_decode_bf16(gen, b, s, length, heads=(32, 4, 128), q_bf16=True):
    """decode_attention over a bfloat16 cache (q bfloat16, or float32 as a
    float32 model gives it) beside the float32 kernel, the plain version
    and SDPA on bfloat16 (GQA, boolean length mask); the bound counts the
    cache rows these lengths read, at 2 bytes, and q and o at q's size."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    h, kh, d = heads
    q32, k32, v32 = (_randn(gen, b, h, d), _randn(gen, b, s, kh, d),
                     _randn(gen, b, s, kh, d))
    q = _bf16(q32) if q_bf16 else q32
    k, v = _bf16(k32), _bf16(v32)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    qt = _bf16(q)[:, :, None].contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    rows = b * min(length, s)
    t_bound, by = bound_ms(q.element_size() * 2 * b * h * d
                           + 2 * 2 * rows * kh * d + 4 * b, 0.0,
                           bf16_flops=4 * rows * h * d)
    t = dict(ms=device_ms(lambda: ops.decode_attention(q, k, v, lens)),
             f32_ms=device_ms(lambda: ops.decode_attention(q32, k32, v32,
                                                           lens)),
             plain_ms=device_ms(lambda: ref.decode_attention(q, k, v, lens)),
             bound_ms=t_bound, bound_by=by,
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    _print_bf16_times(f"decode_attention bf16 cache, q "
                      f"{'bf16' if q_bf16 else 'float32'}, B={b} S={s} "
                      f"lengths={length} H={h} KH={kh} D={d}", t)
    return t


def time_rmsnorm_bf16(gen, rows, d):
    """rmsnorm on bfloat16 rows with a bfloat16 scale beside the float32
    kernel, the plain version and ``F.rms_norm`` in bfloat16, and with a
    float32 scale (the mixed form)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import launch_plan
    x32 = _randn(gen, rows, d)
    w32 = 1.0 + _randn(gen, d, scale=0.1)
    x, w = _bf16(x32), _bf16(w32)
    t_bound, by = bound_ms(2 * (2 * rows * d + d), 4 * rows * d)
    t = dict(ms=device_ms(lambda: ops.rmsnorm(x, w)),
             f32_ms=device_ms(lambda: ops.rmsnorm(x32, w32)),
             plain_ms=device_ms(lambda: ref.rmsnorm(x, w)),
             bound_ms=t_bound, bound_by=by,
             library_ms=device_ms(lambda: F.rms_norm(x, (d,), w, eps=1e-6)),
             mixed_ms=device_ms(lambda: ops.rmsnorm(x, w32)))
    plan = launch_plan(rows, d, x.dtype)
    _print_bf16_times(f"rmsnorm bf16 rows={rows} d={d} ({plan})", t)
    print(f"  with a float32 scale: {t['mixed_ms']:.7f} ms")
    return t


def time_scan_bf16(gen, b, length, din, n):
    """The forward scan in bfloat16 as the prefill calls it (the final
    state returned) beside the float32 kernel and the plain loop, and as
    training calls it (saving its checkpoints) beside the float32 kernel;
    no single PyTorch call computes a selective scan."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    ins32 = scan_inputs(gen, b, length, din, n)
    ins = [_bf16(t) if i in (0, 1, 3, 4) else t for i, t in enumerate(ins32)]
    rows, small = b * length * din, b * length * n
    t_bound, by = bound_ms(2 * (3 * rows + 2 * small)
                           + 4 * (din * n + din + b * din * n),
                           rows * (6 * n + 3), rows * n)
    t = dict(ms=device_ms(lambda: ssm_scan_cuda(*ins, return_state=True)),
             f32_ms=device_ms(lambda: ssm_scan_cuda(*ins32,
                                                    return_state=True)),
             plain_ms=device_ms(lambda: ref.ssm_scan(*ins), runs=5, reps=1,
                                sleep_cycles=2_000_000),
             bound_ms=t_bound, bound_by=by, library_ms=None,
             saving_ms=device_ms(lambda: ssm_scan_cuda(*ins,
                                                       save_states=True)),
             f32_saving_ms=device_ms(lambda: ssm_scan_cuda(
                 *ins32, save_states=True)))
    what = (f"ssm_scan bf16 B={b} L={length} Din={din} N={n} "
            f"({scan_layout(b, din, n)} lane(s) a channel)")
    _print_bf16_times(what + " (returning the state)", t)
    print(f"{what} saving its checkpoints (the training call): "
          f"{t['saving_ms']:.7f} ms; the float32 kernel "
          f"{t['f32_saving_ms']:.7f} ms")
    return t


def time_bf16_kernels(gen):
    """Phase 26(a)'s times; returns each variant at phase 26's main-path
    shape: flash at yi-6b's prefill, decode at B=1 over phase 26's 160-row
    cache, rmsnorm on one decode row, the scan at the Jamba prefill."""
    out = {}
    for case in ((4, 256, 256, 12, 12, 64, False),
                 (8, 128, 128, 16, 8, 64, True)):
        time_flash_bf16(gen, *case)
    time_flash_bf16(gen, 1, 3008, 3008, 56, 8, 128, True, runs=10, reps=2)
    out["flash_attention_bf16"] = time_flash_bf16(gen, 1, 128, 128, 32, 4,
                                                  128, True)
    time_decode_bf16(gen, 1, 24, 24)
    time_decode_bf16(gen, 1, 24, 24, q_bf16=False)
    time_decode_bf16(gen, 8, 4096, 4096)
    time_decode_bf16(gen, 1, 24, 24, heads=(16, 8, 64))
    time_decode_bf16(gen, 1, 3024, 3009, heads=(56, 8, 128))
    time_decode_bf16(gen, 1, 4096, 4096, heads=(64, 8, 128))
    out["decode_attention_bf16"] = time_decode_bf16(gen, 1, 160, 160)
    for rows, d in ((1024, 4096), (8192, 4096), (128, 4096), (1, 1024),
                    (3008, 7168), (1, 8192)):
        time_rmsnorm_bf16(gen, rows, d)
    out["rmsnorm_bf16"] = time_rmsnorm_bf16(gen, 1, 4096)
    time_scan_bf16(gen, 8, 128, 8192, 16)
    out["ssm_scan_bf16"] = time_scan_bf16(gen, 1, 32, 8192, 16)
    return out


# phase 26's decode shapes, (B, S, length, (H, KH, D)), and the bfloat16
# flash shapes, (B, Sq, Sk, H, KH, D, causal), that --kernel-times compares
# between trees
DECODE_SHAPES = {
    "launcher": (1, 24, 24, (32, 4, 128)),
    "phase 26's step": (1, 160, 160, (32, 4, 128)),
    "B=8 S=4096": (8, 4096, 4096, (32, 4, 128)),
    "granite": (1, 24, 24, (16, 8, 64)),
    "llava G=7": (1, 3024, 3009, (56, 8, 128)),
    "deepseek G=8": (1, 4096, 4096, (64, 8, 128)),
}
FLASH_BF16_SHAPES = {
    "DiT": (4, 256, 256, 12, 12, 64, False),
    "granite": (8, 128, 128, 16, 8, 64, True),
    "yi-6b prefill": (1, 128, 128, 32, 4, 128, True),
    "llava prefill": (1, 3008, 3008, 56, 8, 128, True),
}


def time_attention_kernels(gen):
    """decode_attention in both dtypes at ``DECODE_SHAPES`` (bfloat16 q
    over a bfloat16 cache, and float32), each with its profiled device
    time by kernel (the split kernel and the merge), and bfloat16
    flash_attention at ``FLASH_BF16_SHAPES``, with SDPA in bfloat16
    beside each; ms by name."""
    import torch
    from repro_torch.kernels import ops
    out = {}
    for name, (b, s, length, heads) in DECODE_SHAPES.items():
        t = time_decode_bf16(gen, b, s, length, heads=heads)
        out[f"decode_attention_bf16 {name}"] = t["ms"]
        out[f"decode_attention {name}"] = t["f32_ms"]
        out[f"SDPA bf16 decode {name}"] = t["library_ms"]
        h, kh, d = heads
        q, k, v = (_randn(gen, b, h, d), _randn(gen, b, s, kh, d),
                   _randn(gen, b, s, kh, d))
        lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
        for kname, args in (("decode_attention", (q, k, v)),
                            ("decode_attention_bf16",
                             tuple(_bf16(x) for x in (q, k, v)))):
            split = kernel_split(lambda: ops.decode_attention(*args, lens))
            print(f"  {kname} {name}: profiled device ms by kernel (mean of "
                  "5 calls): " + ", ".join(f"{k} {v:.7f}"
                                           for k, v in split.items()))
            out.update({f"{kname} {name}, profiled {k}": v
                        for k, v in split.items()})
    for name, case in FLASH_BF16_SHAPES.items():
        kw = dict(runs=10, reps=2) if case[1] > 1024 else {}
        t = time_flash_bf16(gen, *case, **kw)
        out[f"flash_attention_bf16 {name}"] = t["ms"]
        out[f"SDPA bf16 {name}"] = t["library_ms"]
    return out


def bf16_decode_steps(cfg):
    """``cfg`` (yi-6b) whole in bfloat16, its decode step as phase 26
    reads it: at B=1 over a 160-row cache (every row in use), the device
    time of the step's CUDA graph and the host's enqueue; at B=8 over a
    full 4096-row cache, the summed device time of its profiled kernels."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.lm import init_decode_state, init_lm
    bf = torch.bfloat16
    model = init_lm(cfg, seed=1, device="cuda", dtype=bf)
    state = init_decode_state(cfg, 1, 160, dtype=bf, device="cuda")
    for slot in state:
        slot["kv"].length.fill_(159)
    dev1, host1 = time_decode_step(model, state)
    del state
    state = init_decode_state(cfg, 8, 4096, dtype=bf, device="cuda")
    step = make_serve_step(cfg)
    token = torch.full((8,), 7, dtype=torch.int32, device="cuda")

    def call():
        for slot in state:
            slot["kv"].length.fill_(4095)
        step(model, token, state)

    with torch.no_grad():
        n, dev8 = profile_kernels(call)
    print(f"{cfg.name} in bfloat16, decode step: B=1 over 160 rows "
          f"{dev1:.4f} ms of device time (CUDA graph), {host1:.4f} ms to "
          f"enqueue; B=8 over 4096 rows {dev8:.4f} ms in {n} kernels")
    del model, state
    torch.cuda.empty_cache()
    return dev1, host1, dev8


def yi_bf16(cfg, prompt: int = 128, steps: int = 32):
    """Phase 26(b): ``cfg`` (yi-6b) whole in bfloat16 on the card: the
    weights' bytes, a prefill of ``prompt`` tokens and ``steps`` served
    decode steps through ``make_prefill_step`` / ``make_serve_step`` with
    the state in bfloat16 (the reference's defaults), every launch exact
    (``serve_steps``); one decode step counted on the card (its Cost's
    roofline at the bfloat16 rate is the step's bound) and its device time
    from a CUDA graph beside it; the peak memory.  Returns each bfloat16
    kernel's launches over the prefill and the steps."""
    import torch
    from repro_torch.distributed import op_cost, roofline
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.lm import init_lm
    bf = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=1, device="cuda", dtype=bf)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name} whole in bfloat16: {weights / 1e9:.3f} GB of weights "
          f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          f"parameters), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(2, cfg.vocab_size, (1, prompt), generator=gen,
                         dtype=torch.int32).cuda()
    out, state, _, served, launches = serve_steps(
        cfg, model, {"tokens": toks}, steps, f"{cfg.name} whole, bfloat16",
        state_dtype=bf)
    peak = torch.cuda.max_memory_allocated() - base
    tok = torch.full((1,), 7, dtype=torch.int32, device="cuda")
    with op_cost.count() as counted:
        make_serve_step(cfg)(model, tok, state)
    torch.cuda.synchronize()
    rf = roofline.analyze(counted.cost, num_devices=1, dtype=bf)
    bound = max(rf.compute_s, rf.memory_s) * 1e3
    dev_ms, host_ms = time_decode_step(model, state)
    print(f"decode step (B=1, a {prompt + steps}-row bfloat16 cache): "
          f"{dev_ms:.4f} ms of device time (CUDA graph), {host_ms:.4f} ms "
          f"to enqueue, {served:.4f} ms served; its count "
          f"{counted.cost.bytes / 1e9:.4f} GB, "
          f"{counted.cost.flops / 1e9:.4f} GFLOP: bound {bound:.4f} ms "
          f"({rf.dominant}, 3.35 TB/s, 989 TFLOP/s bfloat16), the step at "
          f"{bound / dev_ms:.4f} of it; peak {peak / 2**30:.3f} GiB above "
          f"the phase's start")
    assert dev_ms >= bound, "the step ran below its bound: the count is wrong"
    assert peak < 80 * 2**30
    del model, state, out
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if k.endswith("_bf16")}


def jamba_bf16(prompt: int = 32, steps: int = 2):
    """Phase 26(d): one full-width Jamba period (attention + 7 Mamba, no
    experts) in bfloat16, prefill and ``steps`` decode steps card vs CPU,
    the prefill's seven Mamba layers through ``ssm_scan_bf16``.  Returns
    its launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.lm import init_lm
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_experts=0,
                              num_layers=8)
    model = init_lm(cfg, seed=11, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    lm_vs_cpu(cfg, prompt_len=prompt, steps=steps, model=model,
              state_dtype=torch.bfloat16, tol=BF16_LM_TOL, teacher=True)
    launched = dict(LAUNCHES)
    print(f"Jamba period in bfloat16: launches {launched}")
    assert launched["ssm_scan_bf16"] == 7 and launched["ssm_scan"] == 0, \
        "the prefill's Mamba layers did not run ssm_scan_bf16"
    del model
    torch.cuda.empty_cache()
    return {"ssm_scan_bf16": launched["ssm_scan_bf16"]}


def bf16_counts_and_dryrun():
    """Phase 26(e): yi-6b's decode step (B=8, a full 4096-row cache) and
    granite's prefill (B=8, S=128) in bfloat16 counted on the card and on
    meta (``cost_on_card``), then the dry run's four cells of phase 25 on
    meta in the default bfloat16, each cell's arguments beside the float32
    cell's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    bf = torch.bfloat16
    for arch, kind, b, s in (("yi-6b", "decode", 8, 4096),
                             ("granite-moe-1b-a400m", "prefill", 8, 128)):
        cost_on_card(get_config(arch), kind, b, s, dtype=bf)
        torch.cuda.empty_cache()
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=False,
                              opts=dryrun.OPT_LEVELS["baseline"])
        secs = time.perf_counter() - t0
        assert rec["status"] == "ok" and rec["dtype"] == "bfloat16", rec
        rf = rec["roofline"]
        f32 = dryrun.cell_argument_bytes(arch, shape, multi_pod=False,
                                         dtype=torch.float32)
        print(f"dryrun {arch} {shape} single bfloat16 ({secs:.2f} s): "
              f"{rf['flops_per_device'] / 1e12:.3f} TFLOP, "
              f"{rf['bytes_per_device'] / 1e9:.3f} GB a device; compute "
              f"{rf['compute_s'] * 1e3:.2f} ms (989 TFLOP/s), memory "
              f"{rf['memory_s'] * 1e3:.2f} ms ({rf['dominant']}); arguments "
              f"{rf['argument_bytes'] / 2**30:.3f} GiB against float32's "
              f"{f32 / 2**30:.3f} GiB ({rf['argument_bytes'] / f32:.4f}), "
              f"peak {rf['peak_memory_bytes'] / 2**30:.3f} GiB")
        assert rf["argument_bytes"] < f32


def bf16_phase(gen, yi):
    """Phase 26, the reference's bfloat16 configuration of the LM: (a)
    the bfloat16 kernels against their plain versions and timed, (b)
    yi-6b whole in bfloat16 and two layers card vs CPU, (c) float32
    yi-6b (two layers) over a bfloat16 state card vs CPU, (d) a Jamba
    period in bfloat16, (e) the counts and the dry run in bfloat16.
    Returns (errors, times, launches) of the four variants."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.lm import init_lm
    t0 = time.perf_counter()
    errs = check_bf16_kernels(gen)
    times = time_bf16_kernels(gen)
    launches = yi_bf16(yi)
    pair = dataclasses.replace(yi, num_layers=2)
    lm_vs_cpu(pair, model=init_lm(pair, seed=11, device="cuda",
                                  dtype=torch.bfloat16),
              state_dtype=torch.bfloat16, tol=BF16_LM_TOL, teacher=True)
    reset_launches()
    lm_vs_cpu(pair, state_dtype=torch.bfloat16, tol=MIXED_TOL, teacher=True)
    print(f"float32 {pair.name} over a bfloat16 state: launches "
          f"{dict(LAUNCHES)}")
    assert LAUNCHES["decode_attention_bf16"] == 4 * 2 \
        and LAUNCHES["decode_attention"] == 0, \
        "the float32 model's decode over a bfloat16 cache missed its kernel"
    torch.cuda.empty_cache()
    launches.update(jamba_bf16())
    bf16_counts_and_dryrun()
    print(f"phase 26 took {time.perf_counter() - t0:.1f} s")
    return errs, times, launches


# -- phase 27: the DiT in bfloat16 -------------------------------------------------

# the adaLN kernel in bfloat16, each output row against its own scale: the
# mean of |kernel - plain| over the row's d values <= ADALN_ROW_TOL times
# the row's mean |plain|.  Both sides compute in float32 and round once,
# so an element parts only where the two float32 values straddle a
# bfloat16 rounding boundary (about 1e-5 of the elements, one ulp each:
# a row gap of 1e-5 to 5e-5 on the CPU with the statistics summed in
# float64).  A kernel that normalised the rounded residual moves about 28%
# of the elements by an ulp (a row gap of 1.6e-3 to 2.2e-3), one that took
# a neighbour's statistics 0.17 or more: check_bf16_adaln_controls holds
# both against the bar.  The max-by-row bar of flash and decode
# (BF16_ROW_TOL) holds too, and the reference's 3e-2.
ADALN_ROW_TOL = 2.0 ** -11
BF16_ADALN_TOL = 3e-2
# the full-width bfloat16 forward card vs CPU, relative to the largest
# |eps|: cuBLAS and the CPU's BLAS sum K up to 3072 in other orders and
# round at the same places, through 12 layers (the reduced DiT against the
# reference parts by 4.1e-3 to 6.7e-3, tests/test_torch_gdm_bf16.py)
BF16_DIT_TOL = 5e-2
# (B, S, d, offset of the modulation chunks in values): the DiT at B in
# {1, 4}; the reference test's shapes (S = 17, d = 96); d = 100 and 99 and
# the DiT's width with unaligned modulation (single values); rows wider
# than 1024 values (16-byte loads of 8; single values four a thread)
BF16_ADALN_CASES = [(1, 256, 768, 0), (4, 256, 768, 0), (1, 16, 64, 0),
                    (4, 16, 64, 0), (2, 64, 96, 0), (2, 17, 64, 0),
                    (2, 17, 96, 0), (3, 5, 100, 0), (3, 5, 99, 0),
                    (4, 256, 768, 1), (2, 8, 3000, 0), (2, 8, 2001, 0)]


def _mean_row_gap(got, want):
    """The largest, over rows, of mean|got - want| / mean|want| in the
    row (inf where a row of zeros is missed)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs().mean(-1)
    scale = w.abs().mean(-1)
    ratio = torch.where(scale > 0, diff / scale.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0))
    return float(ratio.max())


def _flat_mods(args, b, d):
    return [a.reshape(b, d) if a.dim() == 3 and a.shape[1] == 1 else a
            for a in args]


def check_bf16_adaln(gen):
    """Phase 27(a): both adaLN forms on bfloat16 x, modulation and
    residual, with float32 and with bfloat16 weight and bias, against the
    plain version at the reference's 3e-2, by row (ADALN_ROW_TOL, and
    BF16_ROW_TOL on the row's largest gap) and a second call bit for bit;
    the float32 kernel reading bfloat16 weights (the float32 latent over a
    bfloat16 DiT) at float32's TOL; a bfloat16 x with a float32
    modulation refused.  Returns each bfloat16 form's largest absolute
    gap."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adaln_norm import load_width
    bf = torch.bfloat16
    worst = {"adaln_norm_bf16": 0.0, "adaln_norm_epilogue_bf16": 0.0}
    row_worst = 0.0
    for (b, s, d, offset) in BF16_ADALN_CASES:
        for params in (torch.float32, bf):
            for epilogue in (False, True):
                args = adaln_inputs(gen, b, s, d, epilogue, offset,
                                    dtype=bf, params_dtype=params)
                got = ops.adaln_norm(*args)
                again = ops.adaln_norm(*args)
                flat = _flat_mods(args, b, d)
                want = ref.adaln_norm(*flat)
                pairs = list(zip(got, want)) if epilogue else [(got, want)]
                same = all(torch.equal(g_, a) for g_, a in (
                    zip(got, again) if epilogue else [(got, again)]))
                assert all(g_.dtype == bf for g_, _ in pairs)
                gaps = [_allclose_gap(g_, w_, BF16_ADALN_TOL)
                        for g_, w_ in pairs]
                err = max(e for e, _ in gaps)
                row = max(_mean_row_gap(g_, w_) for g_, w_ in pairs)
                top = max(_row_gap(g_, w_) for g_, w_ in pairs)
                width = load_width(*flat)
                shape = adaln_launch_text(b, s, d, width, 2, epilogue)
                name = ("adaln_norm_epilogue_bf16" if epilogue
                        else "adaln_norm_bf16")
                print(f"{name:24s} B={b} S={s} d={d} offset {offset} "
                      f"weights {str(params)[6:]}: {2 * width}-byte loads, "
                      f"{shape}; max|kernel - plain| = "
                      f"{err:.3e}; by row mean {row:.3e}, max {top:.3e}; "
                      f"a second call bit-identical: {same}")
                assert all(ok for _, ok in gaps), \
                    f"{name} disagrees with its plain version"
                assert row <= ADALN_ROW_TOL and top <= BF16_ROW_TOL, \
                    f"{name} disagrees with its plain version by row"
                assert same, f"{name} is not deterministic"
                worst[name] = max(worst[name], err)
                row_worst = max(row_worst, row)
    for (b, s, d, offset) in ((4, 256, 768, 0), (4, 16, 64, 0),
                              (3, 5, 99, 0)):
        for epilogue in (False, True):
            args = adaln_inputs(gen, b, s, d, epilogue, offset,
                                params_dtype=bf)
            got = ops.adaln_norm(*args)
            again = ops.adaln_norm(*args)
            want = ref.adaln_norm(*_flat_mods(args, b, d))
            pairs = list(zip(got, want)) if epilogue else [(got, want)]
            err = max(float((g_ - w_).abs().max()) for g_, w_ in pairs)
            same = all(torch.equal(g_, a) for g_, a in (
                zip(got, again) if epilogue else [(got, again)]))
            print(f"adaln_norm{'_epilogue' if epilogue else ''} float32 x, "
                  f"bfloat16 weights, B={b} S={s} d={d}: max|kernel - "
                  f"plain| = {err:.3e}; a second call bit-identical: {same}")
            assert got[0].dtype == torch.float32 if epilogue \
                else got.dtype == torch.float32
            assert err <= TOL and same, \
                "the float32 adaLN kernel misreads bfloat16 weights"
    x, sh, sc, w, bias = adaln_inputs(gen, 2, 8, 64, False, dtype=bf)
    try:
        ops.adaln_norm(x, sh.float(), sc, w, bias)
    except TypeError:
        pass
    else:
        raise AssertionError("adaln_norm took a float32 shift beside "
                             "bfloat16 x")
    print(f"adaln_norm bf16: the largest mean gap by row over its cases "
          f"{row_worst:.3e} of the row's mean|plain| (bar "
          f"{ADALN_ROW_TOL:.3e})")
    check_bf16_adaln_controls(gen)
    return worst


def check_bf16_adaln_controls(gen):
    """Phase 27(a): the power of ADALN_ROW_TOL, at the DiT's shape (B=4)
    and the reference test's (2, 17, 96).  The plain form against rows
    normalised with the statistics of the row before (a block that read
    its neighbour's sums); the epilogue against y normalised from the
    rounded residual (the parity trap: the reference normalises the
    unrounded float32 r).  Each fault, computed from the plain version on
    the same inputs, must fail the bar, and the kernel pass it."""
    import torch
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    smallest = float("inf")
    for (b, s, d) in ((4, 256, 768), (2, 17, 96)):
        x, sh, sc, w, bias = _flat_mods(adaln_inputs(
            gen, b, s, d, False, dtype=bf, params_dtype=bf), b, d)
        want = ref.adaln_norm(x, sh, sc, w, bias)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True).roll(1, 1)
        var = xf.var(-1, keepdim=True, correction=0).roll(1, 1)
        fault = ((xf - mean) * (var + 1e-5) ** -0.5 * w.float()
                 + bias.float()) * (1.0 + sc.float()[:, None]) \
            + sh.float()[:, None]
        kernel = _mean_row_gap(ops.adaln_norm(x, sh, sc, w, bias), want)
        gap = _mean_row_gap(fault.to(bf), want)
        print(f"control adaln_norm bf16 B={b} S={s} d={d}: kernel by row "
              f"{kernel:.3e}; a row normalised with its neighbour's "
              f"statistics {gap:.3e}")
        assert kernel <= ADALN_ROW_TOL < gap, \
            "ADALN_ROW_TOL does not tell the plain form from a fault"
        smallest = min(smallest, gap)
        args = _flat_mods(adaln_inputs(gen, b, s, d, True, dtype=bf,
                                       params_dtype=bf), b, d)
        want_y, want_r = ref.adaln_norm(*args)
        got_y, _ = ops.adaln_norm(*args)
        fault = ref.adaln_norm(want_r, *args[1:5])
        kernel = _mean_row_gap(got_y, want_y)
        gap = _mean_row_gap(fault, want_y)
        print(f"control adaln_norm_epilogue bf16 B={b} S={s} d={d}: kernel "
              f"by row {kernel:.3e}; the residual normalised after "
              f"rounding {gap:.3e}")
        assert kernel <= ADALN_ROW_TOL < gap, \
            "ADALN_ROW_TOL does not tell the epilogue from a fault"
        smallest = min(smallest, gap)
    print(f"adaLN controls: the smallest gap by row of a fault "
          f"{smallest:.3e}, the bar {ADALN_ROW_TOL:.3e}")


def time_adaln_bf16(gen, b, s, d):
    """Both adaLN forms on bfloat16 operands and weights beside the
    float32 kernel on the same values and the float32 kernel reading
    bfloat16 weights, all in this call, the plain version in bfloat16 and
    ``F.layer_norm`` in bfloat16 (printed as the nearest PyTorch call; it
    leaves out the modulation and the residual, so no form has a library
    time).  The bound counts 2 bytes an element (``work``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adaln_norm import work
    bf = torch.bfloat16
    out = {}
    for epilogue in (False, True):
        name = "adaln_norm_epilogue_bf16" if epilogue else "adaln_norm_bf16"
        args32 = adaln_inputs(gen, b, s, d, epilogue)
        args = [a.to(bf) for a in args32]
        mixed = list(args32[:3]) + [a.to(bf) for a in args32[3:5]] \
            + list(args32[5:])
        flat = _flat_mods(args, b, d)
        flops, nbytes = work(b, s, d, epilogue, 2)
        t_bound, by = bound_ms(nbytes, flops)
        out[name] = dict(
            ms=device_ms(lambda: ops.adaln_norm(*args)),
            f32_ms=device_ms(lambda: ops.adaln_norm(*args32)),
            mixed_ms=device_ms(lambda: ops.adaln_norm(*mixed)),
            plain_ms=device_ms(lambda: ref.adaln_norm(*flat)),
            bound_ms=t_bound, bound_by=by, library_ms=None)
        if not epilogue:
            ln_ms = device_ms(lambda: F.layer_norm(args[0], (d,), args[3],
                                                   args[4]))
    for name, t in out.items():
        _print_bf16_times(f"{name:24s} B={b} S={s} d={d}", t)
        print(f"  the float32 kernel over bfloat16 weights: "
              f"{t['mixed_ms']:.7f} ms")
    print(f"F.layer_norm bfloat16 B={b} S={s} d={d} (the nearest PyTorch "
          f"call, without the modulation): {ln_ms:.7f} ms")
    return out


def dit_bf16_vs_cpu(cfg, batch: int = 4):
    """Phase 27(b): the full-width DiT built in bfloat16 on the card
    (``init_gdm(dtype=torch.bfloat16)``, seed 17) and its copy on the CPU;
    one ``gdm_denoise`` on a bfloat16 latent at B=``batch`` on each, the
    card's launches exact (one of each bfloat16 adaLN form and of
    ``flash_attention_bf16`` a layer, nothing else), eps bfloat16, finite
    and within BF16_DIT_TOL of the CPU's largest |eps|.  Returns the model
    and the launches."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gdm import DiT, LATENT_CHANNELS, gdm_denoise, \
        init_gdm
    bf = torch.bfloat16
    model = init_gdm(cfg, seed=17, device="cuda", dtype=bf)
    cpu_model = DiT(cfg, device="cpu", dtype=bf)
    cpu_model.load_state_dict(model.state_dict())
    n = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(23)
    lat = torch.randn(batch, cfg.latent_hw ** 2, LATENT_CHANNELS,
                      generator=gen).to(bf)
    t = torch.randint(0, 16, (batch,), generator=gen)
    prompt = torch.randint(2, cfg.vocab_size, (batch, 8), generator=gen)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        got = gdm_denoise(model, lat.cuda(), t.cuda(), prompt.cuda())
        torch.cuda.synchronize()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        want = gdm_denoise(cpu_model, lat, t, prompt)
    layers = cfg.num_layers
    expect = {"adaln_norm_bf16": layers, "adaln_norm_epilogue_bf16": layers,
              "flash_attention_bf16": layers}
    gap = float((got.cpu().float() - want.float()).abs().max()) / float(
        want.float().abs().max())
    print(f"{cfg.name} in bfloat16 ({n / 1e6:.1f} M parameters, "
          f"{2 * n / 1e9:.3f} GB): gdm_denoise B={batch}, card vs CPU "
          f"{gap:.3e} of the largest |eps| ({float(want.float().abs().max()):.3f}; "
          f"bar {BF16_DIT_TOL}); launches {launched}")
    assert got.dtype == bf and torch.isfinite(got.float()).all(), \
        "the bfloat16 forward is not finite bfloat16"
    assert launched == expect, "the bfloat16 forward's launches are not " \
        f"{expect}"
    assert gap <= BF16_DIT_TOL, "the bfloat16 forward disagrees with the CPU"
    del cpu_model
    return model, launched


def forward_graph_ms(model, cfg, dtype, batch: int = 4):
    """(device ms of one ``gdm_denoise`` at B=``batch`` replayed from a CUDA
    graph, the profiled kernels' count and summed device ms of one eager
    forward) for a latent of ``dtype``."""
    import torch
    from repro_torch.models.gdm import LATENT_CHANNELS, gdm_denoise
    gen = torch.Generator(device="cuda").manual_seed(7)
    lat = torch.randn(batch, cfg.latent_hw ** 2, LATENT_CHANNELS,
                      generator=gen, device="cuda").to(dtype)
    t = torch.randint(0, 16, (batch,), generator=gen, device="cuda")
    prompt = torch.randint(2, cfg.vocab_size, (batch, 8), generator=gen,
                           device="cuda")

    def forward():
        gdm_denoise(model, lat, t, prompt)

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            forward()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            forward()
        dev = device_ms(graph.replay, runs=10, reps=5,
                        sleep_cycles=4_000_000)
        n, kernels = profile_kernels(forward)
    return dev, n, kernels


def dit_bf16_times(gen, cfg, model):
    """Phase 27(c): the bfloat16 forward's device time (CUDA graph, B=4)
    beside the float32 forward's from the same weights rounded up, in one
    call, each with its profiled kernels and idle share, against the
    products' floor; then the adaLN kernels' times at B=1 and B=4.
    Returns the B=4 kernel times."""
    import torch
    flops = dit_train_flops(cfg, 4) / 3.0      # the forward's products
    weights = sum(p.numel() for p in model.parameters())
    bf_floor, bf_by = bound_ms(2 * weights, 0.0, bf16_flops=flops)
    f32_floor, f32_by = bound_ms(4 * weights, flops)
    bf_ms, bf_n, bf_k = forward_graph_ms(model, cfg, torch.bfloat16)
    model32 = model.float()
    f32_ms, f32_n, f32_k = forward_graph_ms(model32, cfg, torch.float32)
    model.bfloat16()
    for what, ms, n, k, floor, by in (
            ("bfloat16", bf_ms, bf_n, bf_k, bf_floor, bf_by),
            ("float32", f32_ms, f32_n, f32_k, f32_floor, f32_by)):
        print(f"DiT forward B=4 in {what}: {ms:.4f} ms of device time (CUDA "
              f"graph); {n} kernels summing to {k:.4f} ms (idle "
              f"{max(0.0, 1 - k / ms):.1%} of the graph's time); floor "
              f"{floor:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP of products, "
              f"{(2 if what == 'bfloat16' else 4) * weights / 1e9:.3f} GB "
              f"of weights), the forward at {floor / ms:.3f} of it")
    print(f"DiT forward B=4: bfloat16 {bf_ms:.4f} ms against float32 "
          f"{f32_ms:.4f} ms in this call ({f32_ms / bf_ms:.2f}x)")
    time_adaln_bf16(gen, 1, 256, cfg.d_model)
    return time_adaln_bf16(gen, 4, 256, cfg.d_model)


def omega_bf16_vs_cpu(cfg, model, blocks: int = 4):
    """Phase 27(d): ``quality_per_block`` over the bfloat16 weights with a
    float32 latent (4 prompts of 8 tokens, noise from seed 29), card vs
    CPU: the stream float32, the float32 adaLN kernels reading bfloat16
    weights (launches exact: per forward one of each form and of
    ``flash_attention`` a layer, no bfloat16 variant), Omega within
    STEP_TOL, Omega(B) = 1."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.gdm import DiT, LATENT_CHANNELS, \
        quality_per_block
    cpu_model = DiT(cfg, device="cpu", dtype=torch.bfloat16)
    cpu_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(29)
    prompts = torch.randint(2, cfg.vocab_size, (4, 8), generator=gen)
    noise = torch.randn((4, cfg.latent_hw ** 2, LATENT_CHANNELS),
                        generator=gen)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        card = quality_per_block(model, noise.cuda(), prompts.cuda(),
                                 num_blocks=blocks, steps_per_block=1).cpu()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        cpu = quality_per_block(cpu_model, noise, prompts,
                                num_blocks=blocks, steps_per_block=1)
    n = blocks * cfg.num_layers
    expect = {"adaln_norm": n, "adaln_norm_epilogue": n,
              "flash_attention": n}
    err = float((card - cpu).abs().max())
    print(f"quality_per_block over bfloat16 weights, float32 latent: card "
          f"{[round(float(v), 6) for v in card]}, CPU "
          f"{[round(float(v), 6) for v in cpu]}, max gap {err:.3e} "
          f"(tolerance {STEP_TOL}); launches {launched}")
    assert card.dtype == torch.float32 and torch.isfinite(card).all()
    assert launched == expect, f"Omega's launches are not {expect}"
    assert err <= STEP_TOL, "Omega over bfloat16 weights disagrees with " \
        "the CPU"
    assert abs(float(card[-1]) - 1.0) <= 1e-5, "Omega(B) is not 1"


def dit_bf16_phase(gen, cfg):
    """Phase 27, the DiT in bfloat16: (a) both adaLN forms in bfloat16
    against their plain versions with controls, (b) the full-width
    bfloat16 forward card vs CPU with exact launches, (c) its device time
    beside the float32 forward's and the adaLN kernels' times, (d) Omega
    over the bfloat16 weights card vs CPU.  Returns (errors, times,
    launches) of the two bfloat16 adaLN forms."""
    import torch
    t0 = time.perf_counter()
    errs = check_bf16_adaln(gen)
    model, launched = dit_bf16_vs_cpu(cfg)
    times = dit_bf16_times(gen, cfg, model)
    omega_bf16_vs_cpu(cfg, model)
    del model
    torch.cuda.empty_cache()
    print(f"phase 27 took {time.perf_counter() - t0:.1f} s")
    return errs, times, {k: launched[k] for k in errs}


# -- phase 28: remat and the bfloat16 train step -----------------------------------

# ssm_scan_backward_bf16 against autograd of the plain scan, each output row
# against its own scale: the mean of |kernel - plain| over the row <=
# SCAN_ROW_TOL times the row's mean |plain|, rows (b, t) of Din values for
# du and ddt and (b, n) of L values for dB and dC (a step's N = 16 values
# are too few to average out one ulp flipped at a rounding boundary: one
# such flip moves a 16-value row's mean by about 2^-12, where the card
# gave a correct kernel 4.0e-4 by (b, t) rows).  Both sides sum in float32
# from the same widened values and round once, so an element parts by one
# ulp only where the two float32 sums straddle a rounding boundary.
# check_scan_backward_bf16's controls, computed from a plain backward on
# the same inputs, must fail it: dB and dC summed from bfloat16-rounded
# partials of 32 channels (a sum rounded twice), and the states
# recomputed from bfloat16-rounded checkpoints (which moves ddt and dC).
SCAN_ROW_TOL = 2.0 ** -11
# (B, L, Din, N): the training shape (one Jamba Mamba layer at global batch
# 8, seq 128); 16-byte copies over a block that is not whole (Din = 200)
# at a ragged L; single values (Din 100, no multiple of 8) with a small N
SCAN_BWD_BF16_CASES = [(8, 128, 8192, 16), (2, 50, 200, 16),
                       (3, 37, 100, 5)]
# phase 28(b): the card-vs-CPU steps' batch and length (the CPU's side of a
# full-width period), and the card's own at the trainer's shape
REMAT_CPU_SHAPE = (1, 16)
# phase 28(b)'s gradient bar: each leaf's ||card - f32|| at most this times
# the CPU's ||cpu - f32|| (f32: the gradient of the same weights in
# float32); the control scales the scan's ddt by DT_FAULT on the card
BF16_GRAD_RATIO = 1.5
DT_FAULT = 1.1
REMAT_SHAPE = (8, 128)
REMAT_STEPS = 5


def scan_backward_explicit(u, dt, a, bmat, cmat, d, gy, *,
                           rounded_checkpoints=False, partials=0):
    """The scan's six gradients written out step by step in float32 from
    the widened operands: the forward's states h_t for every step, then
    the reverse walk carrying g = dL/dh_t, as ``ssm_scan_backward.cu``
    computes them (in another order).  ``rounded_checkpoints``: each
    16-step chunk recomputed from its start state rounded to bfloat16 (a
    backward whose checkpoints were stored rounded).  ``partials`` > 0:
    dB and dC summed over blocks of that many channels, each block's sum
    rounded to bfloat16 before the blocks are summed (a sum rounded
    twice).  Returns (du, ddt, dA, dB, dC, dD) in float32."""
    import torch
    u, dt, bm, cm, gy = (t.float() for t in (u, dt, bmat, cmat, gy))
    b, length, din = u.shape
    h = torch.zeros(b, din, a.shape[1], device=u.device)
    hs = []
    for t in range(length):
        hs.append(h)                      # h_{t-1}
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :])
    hs.append(h)
    if rounded_checkpoints:
        redo = []
        for t in range(length):
            if t % 16 == 0:
                h = hs[t].to(torch.bfloat16).float()
            redo.append(h)
            h = (torch.exp(dt[:, t, :, None] * a) * h
                 + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :])
        hs = redo + [h]

    def over_channels(c):
        if not partials:
            return c.sum(1)
        return sum(blk.sum(1).to(torch.bfloat16).float()
                   for blk in c.split(partials, 1))

    du, ddt = torch.empty_like(u), torch.empty_like(u)
    db, dc = torch.empty_like(bm), torch.empty_like(cm)
    da_sum = torch.zeros_like(a)
    g = torch.zeros_like(h)
    for t in reversed(range(length)):
        g = g + gy[:, t, :, None] * cm[:, t, None, :]
        dc[:, t] = over_channels(gy[:, t, :, None] * hs[t + 1])
        db[:, t] = over_channels(g * (dt[:, t] * u[:, t])[..., None])
        gb = (g * bm[:, t, None, :]).sum(-1)
        da = torch.exp(dt[:, t, :, None] * a)
        q = g * hs[t] * da
        da_sum += (q * dt[:, t, :, None]).sum(0)
        ddt[:, t] = u[:, t] * gb + (q * a).sum(-1)
        du[:, t] = d * gy[:, t] + dt[:, t] * gb
        g = g * da
    return du, ddt, da_sum, db, dc, (gy * u).sum((0, 1))


def check_scan_backward_bf16(gen):
    """Phase 28(a): ``ssm_scan_backward_bf16`` at SCAN_BWD_BF16_CASES
    against autograd of the plain scan on the same bfloat16 inputs (float32
    A and D): du, ddt, dB and dC bfloat16 within BF16_SCAN_TOL and
    SCAN_ROW_TOL by row, dA and dD float32 within the float32 backward's
    SCAN_TOL; a second call bit for bit.  At the training shape and the
    ragged one the two controls must fail the row bar.  Returns the largest
    absolute error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward_cuda,
                                              ssm_scan_cuda)
    worst = 0.0
    names = ("du", "ddt", "dA", "dB", "dC", "dD")
    for i, (b, length, din, n) in enumerate(SCAN_BWD_BF16_CASES):
        ins = [_bf16(t) if j in (0, 1, 3, 4) else t
               for j, t in enumerate(scan_inputs(gen, b, length, din, n))]
        _, _, states = ssm_scan_cuda(*ins, save_states=True)
        gy = _bf16(_randn(gen, b, length, din))
        got = ssm_scan_backward_cuda(*ins, states, gy)
        again = ssm_scan_backward_cuda(*ins, states, gy)
        same = all(torch.equal(x, z) for x, z in zip(got, again))
        leaves = [t.clone().requires_grad_() for t in ins]
        want = torch.autograd.grad(ref.ssm_scan(*leaves)[0], leaves, gy)
        assert [g.dtype for g in got] == [w.dtype for w in want] == [
            torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16,
            torch.bfloat16, torch.float32], [g.dtype for g in got]
        what = f"ssm_scan_backward bf16 B={b} L={length} Din={din} N={n}"
        parts = []
        def rows(t, k):
            return t if k < 2 else t.transpose(1, 2)

        for k in (0, 1, 3, 4):
            err, ok = _allclose_gap(got[k], want[k], BF16_SCAN_TOL)
            row = _mean_row_gap(rows(got[k], k), rows(want[k], k))
            parts.append(f"{names[k]} {err:.3e} (by row {row:.3e})")
            assert ok, f"{what}: {names[k]} outside {BF16_SCAN_TOL}"
            assert row <= SCAN_ROW_TOL, \
                f"{what}: {names[k]} by row {row} > {SCAN_ROW_TOL}"
            worst = max(worst, err)
        for k in (2, 5):
            err, rel = _rel(got[k], want[k])
            parts.append(f"{names[k]} rel {rel:.3e}")
            assert rel <= SCAN_TOL, f"{what}: {names[k]} rel {rel}"
            worst = max(worst, err)
        print(f"{what}: " + ", ".join(parts)
              + f"; a second call bit-identical: {same}")
        assert same, "ssm_scan_backward_bf16 is not deterministic"
        if i == len(SCAN_BWD_BF16_CASES) - 1:
            continue
        # the controls: faults the row bar has to see
        fault = scan_backward_explicit(*ins, gy, partials=32)
        gaps = [_mean_row_gap(rows(fault[k].to(torch.bfloat16), k),
                              rows(want[k], k)) for k in (3, 4)]
        fault = scan_backward_explicit(*ins, gy, rounded_checkpoints=True)
        gaps_ck = [_mean_row_gap(rows(fault[k].to(torch.bfloat16), k),
                                 rows(want[k], k)) for k in (1, 4)]
        print(f"control {what}: dB, dC from rounded 32-channel partials by "
              f"row {gaps[0]:.3e}, {gaps[1]:.3e}; ddt, dC from rounded "
              f"checkpoints {gaps_ck[0]:.3e}, {gaps_ck[1]:.3e}; the bar "
              f"{SCAN_ROW_TOL:.3e}")
        assert min(max(gaps), max(gaps_ck)) > SCAN_ROW_TOL, \
            "SCAN_ROW_TOL does not tell the kernel from a fault"
        del fault, states
    return worst


def time_scan_backward_bf16(gen):
    """Phase 28(a): the bfloat16 backward at the training shape beside the
    float32 kernel on the same values, the plain version (autograd through
    the 128-step loop) and its bound; no single PyTorch call computes a
    selective scan's gradient."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import (backward_work,
                                              ssm_scan_backward_cuda,
                                              ssm_scan_cuda)
    b, length, din, n = SCAN_BWD_BF16_CASES[0]
    ins32 = scan_inputs(gen, b, length, din, n)
    ins = [_bf16(t) if j in (0, 1, 3, 4) else t for j, t in enumerate(ins32)]
    gy = _bf16(_randn(gen, b, length, din))
    _, _, st = ssm_scan_cuda(*ins, save_states=True)
    _, _, st32 = ssm_scan_cuda(*ins32, save_states=True)
    gy32 = gy.float()
    rows = b * length * din
    flops, nbytes = backward_work(ins[0].shape, n, itemsize=2)
    t_bound, by = bound_ms(nbytes, flops, rows * n)
    leaves = [t.clone().requires_grad_() for t in ins]
    y_plain = ref.ssm_scan(*leaves)[0]
    t = dict(ms=device_ms(lambda: ssm_scan_backward_cuda(*ins, st, gy)),
             f32_ms=device_ms(lambda: ssm_scan_backward_cuda(*ins32, st32,
                                                             gy32)),
             plain_ms=device_ms(lambda: torch.autograd.grad(
                 y_plain, leaves, gy, retain_graph=True), runs=5, reps=1,
                 sleep_cycles=2_000_000),
             bound_ms=t_bound, bound_by=by, library_ms=None)
    del y_plain, leaves
    t["ms_again"] = device_ms(lambda: ssm_scan_backward_cuda(*ins, st, gy))
    # the same values two bytes past a 16-byte boundary: the kernel stages
    # u, dt and dy and stores du and ddt one value a thread
    odd = [_off16(x) if j in (0, 1) else x for j, x in enumerate(ins)]
    odd_gy = _off16(gy)
    assert all(torch.equal(x, z) for x, z in zip(
        ssm_scan_backward_cuda(*odd, st, odd_gy),
        ssm_scan_backward_cuda(*ins, st, gy))), \
        "the two staging paths of ssm_scan_backward_bf16 differ"
    t["scalar_ms"] = device_ms(lambda: ssm_scan_backward_cuda(*odd, st,
                                                              odd_gy))
    t["split"] = kernel_split(lambda: ssm_scan_backward_cuda(*ins, st, gy))
    _print_bf16_times(f"ssm_scan_backward bf16 B={b} L={length} Din={din} "
                      f"N={n} ({nbytes / 1e6:.1f} MB)", t)
    print(f"ssm_scan_backward bf16 again {t['ms_again']:.7f} ms; float32 "
          f"{t['f32_ms']:.7f} ms ({t['ms'] / t['f32_ms']:.3f} of it); "
          f"unaligned operands (one value a thread, bit for bit the same) "
          f"{t['scalar_ms']:.7f} ms ({t['scalar_ms'] / t['ms']:.3f} of the "
          f"16-byte path)")
    print("ssm_scan_backward bf16 profiled device ms by kernel (mean of 5 "
          "calls): " + ", ".join(f"{k} {v:.7f}"
                                 for k, v in t["split"].items()))
    return t


def _off16(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _grads_kept(steps_mod):
    """Wrap ``steps_mod.clip_by_global_norm`` so that a copy of each train
    step's gradients, as autograd gives them (before clipping, which
    scales them in place), is appended to the list returned; ``undo()``
    restores it."""
    clip, kept = steps_mod.clip_by_global_norm, []

    def keep(grads, max_norm):
        kept.append({k: g.detach().clone() for k, g in grads.items()})
        return clip(grads, max_norm)

    steps_mod.clip_by_global_norm = keep

    def undo():
        steps_mod.clip_by_global_norm = clip

    return kept, undo


def _frob_gap(got, want):
    """||got - want|| / ||want|| over the whole tensor, in float64."""
    want = want.double()
    return float((got.double() - want).norm()) / max(float(want.norm()),
                                                     1e-300)


def remat_vs_cpu(cfg, tcfg, model, shape=REMAT_CPU_SHAPE):
    """Phase 28(b): two train steps with remat of the bfloat16 ``model`` on
    the card at ``shape`` against the same loss and gradients on the CPU,
    in lockstep: before each step the CPU copy and a float32 copy on the
    card (whose path phases 9 and 10 hold to the CPU at 1e-4) take the
    card's parameters; the CPU's gradients (``lm_loss(remat=True)`` under
    autograd, what the step differentiates) are held to the card's; AdamW
    runs on the card.  The loss within BF16_LM_TOL.  Each gradient leaf:
    the card's distance from the float32 gradient of the same weights at
    most BF16_GRAD_RATIO times the CPU's, both as ||bf16 - f32|| /
    ||f32||.  Two bfloat16 paths part by as much as each parts from
    float32 (up to 9% of a leaf's largest on the Mamba leaves fed by the
    dt path, 5-7% as a norm), so a bar on their gap alone has to be wide
    enough to hide a fault of that size; a fault on the card moves the
    card, not the CPU, farther from float32.  The control: the card's
    gradient again with the scan's ddt scaled by DT_FAULT must fail that
    bar.  Prints the seconds of the CPU's side.  Restores the model's
    parameters."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.kernels import ssm_scan as scan_mod
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM, lm_loss
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    b, s = shape
    params = steps.trainable(model)
    start = {k: p.detach().clone() for k, p in params.items()}
    cpu = LM(cfg, device="cpu", dtype=torch.bfloat16)
    wide = LM(cfg, device="cuda")
    copies = (steps.trainable(cpu), steps.trainable(wide))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                   global_batch=b, seed=tcfg.seed))
    step_fn = steps.make_train_step(cfg, tcfg)
    opt = adamw(tcfg.learning_rate)[0](params)
    kept, undo = _grads_kept(steps)
    worst_loss, worst_ratio, worst_gap, cpu_s = 0.0, 0.0, 0.0, 0.0

    def grads(m, batch):
        total, met = lm_loss(m, batch, remat=True)
        p = steps.trainable(m)
        return dict(zip(p, torch.autograd.grad(total, list(p.values())))), \
            float(met["loss"].detach())

    def ratios(card, g_cpu, g_f32):
        """{leaf: (card's distance from float32 over the CPU's, the CPU's
        distance, the card's gap from the CPU as a norm)}"""
        out = {}
        for k, g in g_cpu.items():
            truth = g_f32[k]
            on_cpu = _frob_gap(g.cuda(), truth)
            out[k] = (_frob_gap(card[k], truth) / max(on_cpu, 1e-300),
                      on_cpu, _frob_gap(card[k], g.cuda()))
        return out

    real_backward = scan_mod.ssm_scan_backward_cuda

    def faulty_backward(*args):
        gu, gdelta, *rest = real_backward(*args)
        return (gu, (gdelta.float() * DT_FAULT).to(gdelta.dtype), *rest)

    try:
        for step in range(2):
            with torch.no_grad():
                for k, p in params.items():
                    for c in copies:
                        c[k].copy_(p)
            batch = {k: torch.from_numpy(v) for k, v in
                     data.batch_at(step).items()}
            t_cpu = time.perf_counter()
            g_cpu, lc = grads(cpu, batch)
            cpu_s += time.perf_counter() - t_cpu
            on_card = {k: v.cuda() for k, v in batch.items()}
            g_f32, _ = grads(wide, on_card)
            if step == 0:
                scan_mod.ssm_scan_backward_cuda = faulty_backward
                try:
                    g_fault, _ = grads(model, on_card)
                finally:
                    scan_mod.ssm_scan_backward_cuda = real_backward
                fault = ratios(g_fault, g_cpu, g_f32)
                del g_fault
            model, opt, card_met = step_fn(model, opt, on_card)
            lg = float(card_met["loss"])
            rel = abs(lc - lg) / abs(lc)
            worst_loss = max(worst_loss, rel)
            assert rel <= BF16_LM_TOL, f"step {step}: loss {lg} vs {lc}"
            got = ratios(kept[-1], g_cpu, g_f32)
            rows = sorted(((r, k, own, gap) for k, (r, own, gap)
                           in got.items()), reverse=True)
            print(f"step {step + 1}: loss card {lg:.6f} cpu {lc:.6f}; "
                  "gradient leaves whose distance from float32 is largest "
                  "over the CPU's (the CPU's distance; the card's from the "
                  "CPU), as norms: " + ", ".join(
                      f"{k} {r:.3f} ({o:.3e}; {g:.3e})"
                      for r, k, o, g in rows[:8]))
            worst_ratio = max(worst_ratio, rows[0][0])
            worst_gap = max(worst_gap, max(g for *_, g in rows))
            over = [k for r, k, _, _ in rows if r > BF16_GRAD_RATIO]
            assert not over, f"step {step + 1}: leaves past the bar: {over}"
            del g_cpu, g_f32
    finally:
        undo()
    caught = sorted(((r, k) for k, (r, _, _) in fault.items()),
                    reverse=True)
    print(f"control: the card's gradient with the scan's ddt scaled by "
          f"{DT_FAULT}: {sum(r > BF16_GRAD_RATIO for r, _ in caught)} "
          f"leaves past the bar, the farthest " + ", ".join(
              f"{k} {r:.3f}" for r, k in caught[:4]))
    assert caught[0][0] > BF16_GRAD_RATIO, \
        "BF16_GRAD_RATIO does not see a ddt fault of the scan's backward"
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])
    print(f"{cfg.name} period in bfloat16 with remat, B={b} S={s}, two "
          f"steps card vs CPU in lockstep: loss within {worst_loss:.3e} "
          f"relative; every leaf's distance from float32 within "
          f"{worst_ratio:.3f} of the CPU's (bar {BF16_GRAD_RATIO}); the "
          f"card's gradients {worst_gap:.3e} from the CPU's at most, as a "
          f"norm; {time.perf_counter() - t0:.1f} s, the CPU's gradients "
          f"{cpu_s:.1f} s of it")
    del cpu, wide, copies, start, kept


def remat_steps(cfg, tcfg, model):
    """Phase 28(b): REMAT_STEPS train steps at REMAT_SHAPE with remat and
    then without, each from the model's parameters and a fresh AdamW
    state on the same batches: the launches of every step exact, every
    loss and gradient norm, the first step's gradients and the final
    parameters bit for bit between the two (where not, the first leaf
    that differs is named), each step's device ms by phase and the peak
    allocated above the start.  Returns {remat: (launches a step,
    median step ms, peak bytes)}."""
    import torch
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw
    b, s = REMAT_SHAPE
    params = steps.trainable(model)
    start = {k: p.detach().clone() for k, p in params.items()}
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                   global_batch=b, seed=tcfg.seed))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch_at(i).items()} for i in range(REMAT_STEPS)]
    fwd = forward_launches(cfg)
    runs = {}
    for remat in (True, False):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        opt = adamw(tcfg.learning_rate)[0](params)
        step_fn = steps.make_train_step(
            cfg, tcfg, opts=steps.StepOptions(remat=remat))
        kept, undo = _grads_kept(steps)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mets, ms, launched = [], [], []
        try:
            for batch in batches:
                reset_launches()
                marks = train._PhaseEvents()
                model, opt, met = step_fn(model, opt, batch, mark=marks)
                torch.cuda.synchronize()
                launched.append(dict(LAUNCHES))
                ms.append(marks.ms())
                mets.append({k: float(v) for k, v in met.items()})
                if len(kept) > 1:
                    kept.pop()
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated() - base
        # the period's forward kernels twice with remat (the final norm,
        # outside the period, once); the scan's backward once
        twice = 2 if remat else 1
        want = {"flash_attention_bf16": twice * fwd["flash_attention"],
                "rmsnorm_bf16": twice * (fwd["rmsnorm"] - 1) + 1,
                "ssm_scan_bf16": twice * fwd["ssm_scan"],
                "ssm_scan_backward_bf16": fwd["ssm_scan"]}
        for i, got in enumerate(launched):
            nonzero = {k: v for k, v in got.items() if v}
            assert nonzero == want, (
                f"remat={remat} step {i + 1}: launches {nonzero}, expected "
                f"{want}")
        runs[remat] = dict(mets=mets, ms=ms, peak=peak, launches=want,
                           grads=kept[0], params={
                               k: p.detach().clone()
                               for k, p in params.items()})
        del kept
        step_ms = statistics.median(m["step"] for m in ms[1:])
        print(f"{cfg.name} period bf16 B={b} S={s} remat={remat}: launches "
              f"a step {want}; losses "
              + ", ".join(f"{m['loss']:.6f}" for m in mets)
              + "; device ms a step " + ", ".join(
                  f"{m['step']:.3f} (forward {m['forward']:.3f}, backward "
                  f"{m['backward']:.3f}, optimizer {m['optimizer']:.3f})"
                  for m in ms)
              + f"; median of steps 2-{REMAT_STEPS} {step_ms:.3f} ms; peak "
              f"{peak / 2**30:.3f} GiB above the start")
    on, off = runs[True], runs[False]
    differ = [k for k in on["grads"]
              if not torch.equal(on["grads"][k], off["grads"][k])]
    differ += [k for k in on["params"]
               if not torch.equal(on["params"][k], off["params"][k])]
    same_metrics = on["mets"] == off["mets"]
    print(f"remat against no remat: losses, gradient norms "
          f"{'equal' if same_metrics else 'DIFFER'}; first step's gradients "
          f"and final parameters " + ("bit for bit" if not differ else
                                      f"differ first at {differ[0]}"))
    assert same_metrics and not differ, (
        "remat changed the step: the recompute is not the forward")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])
    out = {}
    for remat, run in runs.items():
        out[remat] = (run["launches"],
                      statistics.median(m["step"] for m in run["ms"][1:]),
                      run["peak"])
    ratio = out[True][1] / out[False][1]
    print(f"remat step {out[True][1]:.3f} ms against {out[False][1]:.3f} ms "
          f"without ({ratio:.4f}); peak {out[True][2] / 2**30:.3f} against "
          f"{out[False][2] / 2**30:.3f} GiB")
    return out


def remat_counts():
    """Phase 28(c): the full-width bfloat16 Jamba period's train step with
    remat and granite's in bfloat16 at B=8, S=512 with remat, each counted
    on the card and on meta (``cost_on_card``: equal Costs, charges =
    launches); granite's counted peak without remat on meta above its peak
    with remat (there the activations outweigh the gradients; the Jamba
    period's one period keeps nothing its backward does not rebuild)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import op_cost
    bf = torch.bfloat16
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), num_experts=0,
                                num_layers=8)
    granite = get_config("granite-moe-1b-a400m")
    peaks = {}
    for cfg, b, s in ((jamba, 8, 128), (granite, 8, 512)):
        with_remat = cost_on_card(cfg, "train", b, s, dtype=bf, remat=True)
        torch.cuda.empty_cache()
        call = _cost_step(cfg, "train", b, s, "meta", bf, remat=False)
        with op_cost.count() as c:
            call()
        peaks[cfg.name] = (with_remat["peak"], c.cost.peak_bytes)
        print(f"{cfg.name} train B={b} S={s} bfloat16: counted peak with "
              f"remat {with_remat['peak'] / 2**30:.3f} GiB, without "
              f"{c.cost.peak_bytes / 2**30:.3f} GiB (meta); flops "
              f"{with_remat['flops'] / 1e12:.3f} TFLOP with remat against "
              f"{c.cost.flops / 1e12:.3f} without")
        del call
    on, off = peaks[granite.name]
    assert on < off, "remat did not lower granite's counted peak"
    return peaks


def remat_phase(gen, tcfg):
    """Phase 28, the reference's remat lever and its bfloat16 train step:
    (a) ``ssm_scan_backward_bf16`` against its plain version with
    controls, and timed; (b) the full-width Jamba period in bfloat16
    trained with remat: card vs CPU, exact launches, remat against no
    remat bit for bit, device ms and peaks both ways; (c) counted with
    remat on the card and on meta.  Returns (errors, times, launches) of
    ``ssm_scan_backward_bf16``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    t0 = time.perf_counter()
    err = check_scan_backward_bf16(gen)
    times = time_scan_backward_bf16(gen)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_experts=0,
                              num_layers=8)
    model = init_lm(cfg, seed=11, device="cuda", dtype=torch.bfloat16)
    remat_vs_cpu(cfg, tcfg, model)
    runs = remat_steps(cfg, tcfg, model)
    del model
    release()
    remat_counts()
    print(f"phase 28 took {time.perf_counter() - t0:.1f} s")
    return ({"ssm_scan_backward_bf16": err},
            {"ssm_scan_backward_bf16": times},
            {"ssm_scan_backward_bf16":
             runs[True][0]["ssm_scan_backward_bf16"]})


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
        print(f"adaln_norm{'_epilogue' if epilogue else ''} block-a-row "
              f"kernel d=768: {blocks} blocks of {threads} threads per SM "
              f"({warps} warps; two float4 a thread; the first port held "
              f"one block of 8 warps an SM at B=4)")
        assert warps > 8, "adaln_norm holds no more warps than before"
    from repro_torch.kernels.adaln_norm import ROW_WARPS
    for f32, vpt, what in ((1, 6, "six float4"), (0, 3, "three 16-byte "
                                                  "vectors of bfloat16")):
        for epilogue in (0, 1):
            blocks = lib.adaln_norm_rows_occupancy(f32, vpt, 32 * ROW_WARPS,
                                                   epilogue)
            print(f"adaln_norm{'_epilogue' if epilogue else ''}"
                  f"{'' if f32 else '_bf16'} rows kernel d=768: {blocks} "
                  f"blocks of {ROW_WARPS} warps per SM (a warp a row, {what} "
                  f"a lane; B=4 launches {4 * 256 // ROW_WARPS} blocks)")
            assert blocks >= 2, "the adaLN rows kernel holds under 2 blocks"
    # eight heads a block, a three-stage ring: the CUDA cores' kernel
    # (float32 q) and the tensor cores' (bfloat16 q and cache)
    for tc, what in ((0, "CUDA cores, float32"),
                     (1, "tensor cores, bfloat16")):
        blocks = lib.decode_attention_occupancy(128, tc)
        print(f"decode_attention D=128 ({what}): {blocks} blocks of 4 warps "
              "per SM (decode_grid aims at 2)")
        assert blocks >= 2, "decode_attention holds fewer than 2 blocks an SM"
    for d in HEAD_DIMS:
        blocks = lib.flash_attention_occupancy(d)
        print(f"flash_attention D={d}: {blocks} blocks of 128 threads per "
              f"SM ({4 * blocks} warps)")
        assert blocks >= 1, "flash_attention cannot be resident"
    for d in (64, 128):
        blocks = lib.flash_attention_bf16_occupancy(d)
        print(f"flash_attention bf16 D={d} (wgmma): {blocks} block(s) of 384 "
              "threads per SM (a producer and two consumer warpgroups)")
        assert blocks >= 1, "flash_attention's wgmma kernel cannot be resident"
    import torch
    from repro_torch.kernels import rmsnorm as rms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kinds = {rms.BLOCK: "block", rms.ROW: "row"}
    for dtype, rows, d in ((torch.float32, 1, 4096),
                           (torch.float32, 8192, 4096),
                           (torch.bfloat16, 1, 1024),
                           (torch.bfloat16, 8192, 4096),
                           (torch.bfloat16, 3008, 7168)):
        plan = rms.launch_plan(rows, d, dtype)
        size = dtype.itemsize
        blocks = lib.rmsnorm_occupancy(size, size, plan.kernel, 16 // size,
                                       plan.vpt, plan.threads,
                                       plan.rows_per_block)
        held = blocks * plan.rows_per_block
        print(f"rmsnorm {str(dtype)[6:]} {rows}x{d}, the "
              f"{kinds[plan.kernel]} kernel {tuple(plan)}: {blocks} blocks "
              f"of {plan.threads} threads per SM, {held} rows of x "
              f"({held * d * size // 1024} KB) in flight an SM")
        assert blocks >= 1, "an rmsnorm kernel cannot be resident"
        if dtype == torch.float32 and rows > 1:
            assert blocks * 2 >= 8, \
                "rmsnorm holds fewer rows an SM than before"
    b, _, din, n = SCAN_CASES[0]
    blocks = lib.ssm_scan_occupancy(n, 1)
    print(f"ssm_scan N={n}: {blocks} blocks of 128 threads per SM "
          f"({4 * blocks} warps; a thread a channel, its states in "
          f"registers): the training shape's {b * din // 128} blocks take "
          f"{-(-b * din // 128 // (blocks * sms))} wave(s) on {sms} SMs")
    assert blocks * sms >= b * din // 128, \
        "the scan's training shape takes more than one wave"
    lanes = scan_layout(1, din, n)
    blocks = lib.ssm_scan_occupancy(n, lanes)
    print(f"ssm_scan N={n}, B=1 (Jamba's prefill): {lanes} lanes a channel, "
          f"{din * lanes // 128} blocks of 128 threads on {sms} SMs, "
          f"{blocks} resident per SM")
    assert lanes > 1 and blocks >= 1, \
        "the prefill's scan does not spread a channel over lanes"
    blocks = lib.ssm_scan_backward_occupancy()
    print(f"ssm_scan_backward: {blocks} blocks of 128 threads per SM "
          f"({4 * blocks} warps; four lanes a channel, each with 48 "
          "registers of history for its four states; the first port held "
          "64-register threads of one state, 32 warps)")
    assert 4 * blocks >= 16, "ssm_scan_backward holds fewer than 16 warps"
    print_backward_occupancy(lib)


def print_backward_occupancy(lib):
    """The adaLN backward's residency at d=768: blocks per SM and, since
    its launch in clusters, the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters) beside the grid of the DiT's train
    step (B=8, S=256); a tree from before the clusters reports blocks."""
    import torch
    from repro_torch.kernels import adaln_norm
    threads, vpt = adaln_norm.launch_shape(768, 4)
    fn = lib.adaln_norm_backward_occupancy
    for epilogue in (0, 1):
        name = f"adaln_norm{'_epilogue' if epilogue else ''}_backward d=768"
        if len(fn.argtypes) == 4:
            blocks = fn(4, vpt, threads, epilogue)
            print(f"{name}: {blocks} blocks of {threads} threads per SM (a "
                  "block walks its rows one at a time, two float4 a thread; "
                  "a second kernel adds the column sums)")
            assert blocks >= 1, "adaln_norm_backward cannot be resident"
            continue
        blocks = fn(4, vpt, threads, epilogue, 768, 0)
        clusters = fn(4, vpt, threads, epilogue, 768, 1)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows, cluster, per_row = adaln_norm.backward_grid(8, 256, sms)
        print(f"{name}: {blocks} blocks of {threads} threads per SM, "
              f"{(2 + epilogue) * 768 * 4} bytes of shared sums each; "
              f"clusters of {cluster} blocks, {clusters} resident on the "
              f"card; B=8, S=256 launches {8 * per_row // cluster} clusters "
              f"({rows} rows a block, {per_row // cluster} clusters a batch "
              "row)")
        assert blocks >= 1 and clusters >= 1, \
            "adaln_norm_backward cannot be resident"


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
    unpacked with ``git archive``) and time the adaLN, adaLN backward
    (both forms at B=8 and B=4, with its profiled split by kernel and
    residency), decode (also float32 at phase 26's 160 rows, with its
    bound and SDPA), rmsnorm and scan kernels at phase 4's shapes in
    this script's harness, and the layers they serve: phase 5's DiT
    forward at B=4, phase 8's decode step of full yi-6b (device time and
    host enqueue) and one full-width Jamba Mamba block forward at the
    trainer's shape; the bfloat16 scan kernels (``time_scan_kernels_bf16``);
    both bfloat16 adaLN forms at B=1 and B=4 (``time_adaln_bf16``) and the
    bfloat16 DiT forward with its adaLN launches' profiled time
    (``time_dit_bf16_forward``); then the attention kernels at phase 26's
    shapes
    (``time_attention_kernels``) and yi-6b's decode step in bfloat16
    (``bf16_decode_steps``), so that two trees are compared within one run
    on one card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.gdm import init_gdm
    from repro_torch.models.lm import init_lm
    phase("1. card")
    card_info()
    phase(f"2. build the kernels of {tree}")
    print_backward_occupancy(build_kernels())
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase(f"4. times of {tree}'s adaLN, adaLN backward, decode, rmsnorm and "
          "scan kernels")
    out = {"launch_floor_ms": launch_floor_ms()}
    for b in (1, 4):
        for name, t in time_adaln(gen, b, 256, 768).items():
            out[f"{name} B={b}"] = t["ms"]
    for b in (8, 4):
        for name, t in time_adaln_backward(gen, b, 256, 768).items():
            out[f"{name} B={b}"] = t["ms"]
            out.update({f"{name} B={b}, profiled {k}": v
                        for k, v in t["split"].items()})
    out["decode_attention B=8 S=4096"] = time_decode(gen, 8, 4096,
                                                     4096)["ms"]
    t = time_decode(gen, 1, 24, 24, cold=True)
    out.update({"decode_attention B=1 S=24": t["ms"],
                "decode_attention B=1 S=24, one call, warm": t["warm1_ms"],
                "decode_attention B=1 S=24, one call, L2 flushed":
                    t["cold1_ms"]})
    t = time_decode(gen, 1, 160, 160)
    out.update({"decode_attention B=1 S=160": t["ms"],
                "decode_attention B=1 S=160, bound": t["bound_ms"],
                "SDPA decode B=1 S=160": t["library_ms"]})
    t = time_rmsnorm(gen, 1, 4096, cold=True, plain=False)
    out.update({"rmsnorm 1x4096": t["ms"],
                "rmsnorm 1x4096, one call, warm": t["warm1_ms"],
                "rmsnorm 1x4096, one call, L2 flushed": t["cold1_ms"]})
    for rows in (1024, 8192):
        out[f"rmsnorm {rows}x4096"] = time_rmsnorm(gen, rows, 4096,
                                                   plain=False)["ms"]
    out.update(time_rmsnorm_kernels_bf16(gen))
    scan = time_ssm_scan(gen, plain=False)
    out["ssm_scan B=8 L=128 saving states"] = scan["ssm_scan"]["ms"]
    out["ssm_scan B=8 L=128 without states"] = \
        scan["ssm_scan"]["no_states_ms"]
    out["ssm_scan_backward B=8 L=128"] = scan["ssm_scan_backward"]["ms"]
    out.update(time_scan_kernels_bf16(gen))
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
    phase(f"27. {tree}'s bfloat16 adaLN kernels at B=1 and B=4 and the "
          "bfloat16 DiT forward")
    for b in (1, 4):
        for name, t in time_adaln_bf16(gen, b, 256, 768).items():
            out[f"{name} B={b}"] = t["ms"]
    (out["DiT bf16 forward B=4"],
     out["DiT bf16 forward B=4, profiled adaLN"]) = time_dit_bf16_forward(
         full)
    phase(f"26. {tree}'s attention kernels in bfloat16 and float32 at "
          "phase 26's shapes; yi-6b's decode step in bfloat16")
    out.update(time_attention_kernels(gen))
    (out["yi-6b bf16 decode step B=1, device"],
     out["yi-6b bf16 decode step B=1, host enqueue"],
     out["yi-6b bf16 decode step B=8 S=4096, kernels"]) = bf16_decode_steps(
         get_config("yi-6b"))
    for name in ("DiT forward B=4", "DiT bf16 forward B=4",
                 "DiT bf16 forward B=4, profiled adaLN",
                 "yi-6b decode step, device",
                 "yi-6b decode step, host enqueue",
                 "Mamba block forward B=8 L=128"):
        print(f"{name}: {out[name]:.4f} ms")
    print(json.dumps({"tree": tree, "kernel_times": out}))
    return 0


def time_dit_bf16_forward(cfg, batch: int = 4):
    """``--kernel-times``: phase 27's bfloat16 DiT (seed 17) at
    B=``batch``: the forward's device time from a CUDA graph
    (``forward_graph_ms``) and the device ms its adaLN launches take,
    profiled by kernel over five eager forwards (``kernel_split``)."""
    import torch
    from repro_torch.models.gdm import LATENT_CHANNELS, gdm_denoise, init_gdm
    model = init_gdm(cfg, seed=17, device="cuda", dtype=torch.bfloat16)
    graph_ms, n, total = forward_graph_ms(model, cfg, torch.bfloat16, batch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lat = torch.randn(batch, cfg.latent_hw ** 2, LATENT_CHANNELS,
                      generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.randint(0, 16, (batch,), generator=gen, device="cuda")
    prompt = torch.randint(2, cfg.vocab_size, (batch, 8), generator=gen,
                           device="cuda")
    with torch.no_grad():
        split = kernel_split(lambda: gdm_denoise(model, lat, t, prompt))
    adaln = {k: v for k, v in split.items() if "adaln" in k}
    print(f"DiT bf16 forward B={batch}: {graph_ms:.4f} ms of device time "
          f"(CUDA graph; {n} kernels summing to {total:.4f} ms eager); its "
          f"adaLN launches profiled {sum(adaln.values()):.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in adaln.items()) + ")")
    del model
    torch.cuda.empty_cache()
    return graph_ms, sum(adaln.values())


# the bfloat16 rmsnorm's shapes --kernel-times compares: Jamba's trainer
# and a yi-6b batch, llava's prefill, the trainer's rows, yi-6b's prefill,
# granite's, yi-6b's and deepseek's decode rows
RMS_BF16_SHAPES = ((8192, 4096), (3008, 7168), (1024, 4096), (128, 4096),
                   (1, 1024), (1, 4096), (1, 8192))


def time_rmsnorm_kernels_bf16(gen):
    """``--kernel-times``: the bfloat16 rmsnorm at ``RMS_BF16_SHAPES``
    beside a bfloat16 ``copy_`` of the same rows (the practical floor) and
    its byte bound; the float32 kernel on the 1024-wide row; the 4096-wide
    row also one call at a time, warm and with L2 flushed."""
    import torch
    from repro_torch.kernels import ops
    out = {}
    for rows, d in RMS_BF16_SHAPES:
        x32 = _randn(gen, rows, d)
        w32 = 1.0 + _randn(gen, d, scale=0.1)
        x, w = _bf16(x32), _bf16(w32)
        y = torch.empty_like(x)
        what = f"rmsnorm_bf16 {rows}x{d}"
        out[what] = device_ms(lambda: ops.rmsnorm(x, w))
        out[f"copy_ bf16 {rows}x{d}"] = device_ms(lambda: y.copy_(x))
        t_bound, by = bound_ms(2 * (2 * rows * d + d), 4 * rows * d)
        print(f"{what}: kernel {out[what]:.7f} ms, a bfloat16 copy_ of the "
              f"rows {out[f'copy_ bf16 {rows}x{d}']:.7f} ms, bound "
              f"{t_bound:.7f} ms ({by})")
        if d == 1024:
            out[f"rmsnorm {rows}x{d}"] = device_ms(lambda: ops.rmsnorm(x32,
                                                                      w32))
            print(f"  the float32 kernel on the same row: "
                  f"{out[f'rmsnorm {rows}x{d}']:.7f} ms")
        if (rows, d) == (1, 4096):
            (out[f"{what}, one call, warm"],
             out[f"{what}, one call, L2 flushed"]) = one_call_ms(
                 lambda: ops.rmsnorm(x, w), what)
    return out


def time_scan_kernels_bf16(gen):
    """``--kernel-times``: the bfloat16 scan at Jamba's prefill (B=1, L=32,
    returning the state) and at the training shape (saving its
    checkpoints), and the bfloat16 backward at the training shape, each
    with its profiled split by kernel."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward_cuda,
                                              ssm_scan_cuda)
    out = {}
    for (b, length, din, n), kw in (((1, 32, 8192, 16), "return_state"),
                                    ((8, 128, 8192, 16), "save_states")):
        ins = [_bf16(t) if i in (0, 1, 3, 4) else t
               for i, t in enumerate(scan_inputs(gen, b, length, din, n))]
        what = (f"ssm_scan_bf16 B={b} L={length} ({kw}, "
                f"{scan_layout(b, din, n)} lane(s) a channel)")
        fn = (lambda ins=ins, kw=kw: ssm_scan_cuda(*ins, **{kw: True}))
        out[what] = device_ms(fn)
        out.update({f"{what}, profiled {k}": v
                    for k, v in kernel_split(fn).items()})
        if kw == "save_states":
            _, _, st = ssm_scan_cuda(*ins, save_states=True)
            gy = _bf16(_randn(gen, b, length, din))
            what = f"ssm_scan_backward_bf16 B={b} L={length}"
            fn = (lambda: ssm_scan_backward_cuda(*ins, st, gy))
            out[what] = device_ms(fn)
            out.update({f"{what}, profiled {k}": v
                        for k, v in kernel_split(fn).items()})
    for k, v in out.items():
        print(f"{k}: {v:.7f} ms")
    return out


def main(argv) -> int:
    if argv[:1] == ["--kernel-times"] and len(argv) == 2:
        sys.path.insert(0, os.path.join(os.path.abspath(argv[1]), "src"))
        return kernel_times(argv[1])
    if argv:
        print("usage: chip_smoke.py [--kernel-times TREE]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase("1. card")
    card = card_info()
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models.convert import lm_from_jax, lm_to_jax
    from repro_torch.models.lm import init_lm

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
    errs.update(check_kernel_grads(gen))

    phase("4. times (median of "
          f"{TIMED_RUNS} device-timed samples of 10 back-to-back calls)")
    times = time_kernels(gen, full)
    # the backward at the DiT's training shape (B=8) goes in the JSON line
    time_adaln_backward(gen, 4, 256, 768)
    times.update(time_adaln_backward(gen, 8, 256, 768))
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
    zoo_ms = zoo_kernels(gen)

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
    per_step, _ = train_period(dataclasses.replace(jamba, num_layers=8),
                               tcfg, train_ms)
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

    granite = get_config("granite-moe-1b-a400m")
    pair = dataclasses.replace(granite, num_layers=2)
    phase("16. granite-moe-1b-a400m at full width, card vs CPU: moe_apply "
          "alone on the train shape; two layers from JAX-layout numpy: "
          "prefill + 4 decode steps, six train steps; routing near-ties")
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    moe_alone(granite)
    model = lm_from_jax(lm_to_jax(init_lm(pair, seed=11, device="cpu")),
                        pair, device="cuda")
    with RouteCheck(model) as route:
        lm_vs_cpu(pair, model=model, route=route)
    with RouteCheck(model) as route:
        train_vs_cpu(pair, tcfg, model=model, route=route)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    del model
    torch.cuda.empty_cache()

    phase("17. serve the edge launcher: full granite-moe-1b-a400m + full "
          "gdm-dit; granite's shapes of flash_attention, decode_attention "
          "and rmsnorm")
    serve_launcher(granite, full)
    granite_ms = granite_kernels(gen, granite)

    phase("18. train full-width granite-moe-1b-a400m (24 layers), global "
          "batch 8, seq 128, six steps; resume two layers from a "
          "checkpoint; compress_grads card vs CPU")
    train_period(granite, tcfg, {k: granite_ms[k] for k in (
        "flash_attention", "rmsnorm")})
    torch.cuda.empty_cache()
    model = resume(pair, tcfg)
    compress_vs_cpu(model)
    del model
    torch.cuda.empty_cache()

    phase("19. the zoo's last families at full width, cut depth, card vs "
          "CPU: seamless (2 + 2 layers, 1024 frames), one xLSTM period, "
          "llava (2 layers, 8 patches); prefill + 4 decode steps, six "
          "train steps")
    t0 = time.perf_counter()
    zoo_vs_cpu(tcfg)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s")

    phase("20. seamless-m4t-large-v2 whole (24 + 24 layers): prefill over "
          "1024 frames + 32 served decode steps with the memory; six train "
          "steps at B=8, S=128 with frame stubs")
    t0 = time.perf_counter()
    seamless_whole(get_config("seamless-m4t-large-v2"), tcfg)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s")

    xlstm = get_config("xlstm-1.3b")
    phase("21. xlstm-1.3b whole (48 layers): served by the edge launcher "
          "beside full gdm-dit; six train steps at B=8, S=128; llava-next-34b "
          "at full width, 2 of 60 layers: prefill of 2880 patches + 128 "
          "tokens, 16 served decode steps")
    t0 = time.perf_counter()
    serve_launcher(xlstm, full)
    train_period(xlstm, tcfg, {"rmsnorm": zoo_ms["rmsnorm 1024x2048"]},
                 profile=True)
    torch.cuda.empty_cache()
    llava_cut(dataclasses.replace(get_config("llava-next-34b"), num_layers=2))
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s")

    phase("22. the closed loop on a mesh over cuda:0 (sizes 1, 2, 4): "
          "make_env_mesh, train_fused and evaluate_fused on paper-fig3 at "
          "E=8 bit for bit with the unsharded run; a 4-cell fleet with three "
          "full-width gdm-dit services on a mesh of 2 frame for frame")
    mesh_loop(full, card)

    phase("23. the LM on a mesh over cuda:0: yi-6b's split-K decode on "
          "(2, 8) and the decode kernel on (1, 4) against the unsharded "
          "serve step (B=8, cache 512, 32 steps); granite's all-to-all MoE "
          "card vs CPU on (1, 4) and (2, 4), three full-width train steps "
          "on (2, 4) twice; data-parallel prefill and train on (2, 1) and "
          "(1, 1)")
    lm_mesh(card)

    phase("24. the DiT's training path: full-width gdm-dit gdm_loss card vs "
          "CPU (B=2, three AdamW steps); "
          f"{DIT_TRAIN_STEPS} steps on the card from LatentDataset through "
          "prefetch (B=8), exact launches, Omega before and after; "
          "from_gdm_model and the serve_gdm CLI")
    t0 = time.perf_counter()
    dit_step_vs_cpu(full)
    dit_launches = dit_train(full, card)
    # the backward kernels' launches come from the training path
    for name in ("adaln_norm_backward", "adaln_norm_epilogue_backward"):
        launches[name] = dit_launches[name]
    dit_helpers(card)
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s")

    phase("25. the cost counter on the card: granite-moe-1b-a400m's train "
          "step (B=8, S=128) and yi-6b's decode step (B=8, 4096-row cache) "
          "counted on the card and on meta, kernel charges vs launches, "
          "device time vs the roofline; the dry run on meta; a 2048-token "
          "KV-pool migration at yi-6b's geometry")
    count_phase()

    phase("26. the reference's bfloat16 configuration of the LM: the "
          "bfloat16 kernels vs their plain versions and timed; yi-6b whole "
          "in bfloat16 (prefill 128 + 32 serve steps) and two layers card "
          "vs CPU; float32 yi-6b over a bfloat16 state; a Jamba period in "
          "bfloat16; counts card = meta and the dry run in bfloat16")
    bf_errs, bf_times, bf_launches = bf16_phase(gen, yi)
    errs.update(bf_errs)
    times.update(bf_times)
    launches.update(bf_launches)

    phase("27. the DiT in bfloat16: both adaLN forms in bfloat16 vs their "
          "plain versions with controls; full-width gdm-dit built in "
          "bfloat16, gdm_denoise at B=4 card vs CPU with exact launches; "
          "its device time beside float32's; Omega over the bfloat16 "
          "weights card vs CPU")
    bf_errs, bf_times, bf_launches = dit_bf16_phase(gen, full)
    errs.update(bf_errs)
    times.update(bf_times)
    launches.update(bf_launches)

    phase("28. the reference's remat lever and its bfloat16 train step: "
          "ssm_scan_backward_bf16 vs its plain version with controls, timed "
          "beside float32's; the full-width Jamba period built in bfloat16 "
          "trained with remat: card vs CPU, exact launches, remat vs no "
          "remat bit for bit, step times and peaks; counted with remat on "
          "the card and on meta")
    bf_errs, bf_times, bf_launches = remat_phase(gen, tcfg)
    errs.update(bf_errs)
    times.update(bf_times)
    launches.update(bf_launches)

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
        "adaln_norm_backward": "none: no Pallas backward; the reference "
                               "differentiates src/repro/kernels/ref.py:137 "
                               "with XLA",
        "adaln_norm_epilogue_backward": "none: no Pallas backward; the "
                                        "reference differentiates "
                                        "src/repro/kernels/ref.py:137 "
                                        "with XLA",
    }
    for name in ("flash_attention", "decode_attention", "rmsnorm",
                 "ssm_scan", "adaln_norm", "adaln_norm_epilogue",
                 "ssm_scan_backward"):
        replaces[name + "_bf16"] = replaces[name] + " (its bfloat16 path)"
    sources = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
               for name in replaces}
    sources["adaln_norm_epilogue"] = sources["adaln_norm"]
    sources["adaln_norm_epilogue_backward"] = sources["adaln_norm_backward"]
    for name in list(sources):
        if name.endswith("_bf16"):
            sources[name] = sources[name[:-len("_bf16")]]
    failed_capture_raises()
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s, the "
          "kernels' build included")
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
