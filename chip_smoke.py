#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero before the result line):

1. the card: name and power limit from nvidia-smi, CUDA required;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time and ptxas' register report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (full-width gdm-dit at B in {1, 4, 8}, the reduced
   config) and on attention's masking cases; tolerance 1e-5 (float32);
4. time each kernel, its plain version and (for attention) PyTorch's
   ``scaled_dot_product_attention`` at B=4, full width, beside the least
   time the card could take;
5. one full-width ``run_block_batched`` call on the card against the same
   call on the CPU (plain versions) with the same weights;
6. serve the ``paper-fig3`` trace with three full-width gdm-dit services
   and check that the kernels' launch counts are exactly what the served
   block calls and the Omega measurement imply.

Then it prints one JSON line describing the kernels, and as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
TOL = 1e-5            # kernel vs plain version, float32, same inputs
# whole DiT step, card vs CPU: both sides sum K up to 3072 per product in a
# different order (cuBLAS vs the CPU BLAS), through 12 layers
STEP_TOL = 1e-4
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
              sleep_cycles: int = 20_000_000) -> float:
    """Device time of one ``fn()`` call, in ms: the median over ``runs``
    samples, each ``reps`` back-to-back calls between two CUDA events,
    divided by ``reps``.  Before each sample the stream sleeps
    (``sleep_cycles`` clock cycles, about 1 ms per 2e6) long enough for the
    host to enqueue all ``reps`` calls, so the events bracket device work,
    not the host's launch path."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------

def _randn(gen, *shape, scale=1.0):
    import torch
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def adaln_inputs(gen, b, s, d, epilogue):
    """Main-path operands: modulation as (B, 1, d) chunks of one (B, 1, 6d)
    projection, as the DiT layer passes them."""
    x = _randn(gen, b, s, d)
    mods = _randn(gen, b, 1, 6 * d, scale=0.1)
    sh, sc, g = mods.chunk(6, dim=-1)[:3]
    w = 1.0 + _randn(gen, d, scale=0.1)
    bias = _randn(gen, d, scale=0.1)
    extra = (g, _randn(gen, b, s, d)) if epilogue else ()
    return (x, sh, sc, w, bias) + extra


def check_adaln(gen):
    from repro_torch.kernels import ops, ref
    worst = {"adaln_norm": 0.0, "adaln_norm_epilogue": 0.0}
    for (b, s, d) in ((1, 256, 768), (4, 256, 768), (8, 256, 768),
                      (4, 16, 64), (3, 5, 100)):
        for epilogue in (False, True):
            args = adaln_inputs(gen, b, s, d, epilogue)
            got = ops.adaln_norm(*args)
            sh, sc = args[1].reshape(b, d), args[2].reshape(b, d)
            rest = (args[5].reshape(b, d), args[6]) if epilogue else ()
            want = ref.adaln_norm(args[0], sh, sc, args[3], args[4], *rest)
            pairs = zip(got, want) if epilogue else [(got, want)]
            err = max(float((g - w).abs().max()) for g, w in pairs)
            name = "adaln_norm_epilogue" if epilogue else "adaln_norm"
            print(f"{name:20s} B={b} S={s} d={d}: max|kernel - plain| = "
                  f"{err:.3e}")
            assert err <= TOL, f"{name} disagrees with its plain version"
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


# -- phase 4: times -------------------------------------------------------------

def time_kernels(gen, cfg):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b, s, d = 4, cfg.latent_hw ** 2, cfg.d_model
    h, hd = cfg.num_heads, cfg.resolved_head_dim
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
    q, k, v = (_randn(gen, b, s, h, hd) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nbytes = 4 * 4 * b * s * h * hd
    flops = 4 * b * h * s * s * hd
    t_bound, by = bound_ms(nbytes, flops)
    out["flash_attention"] = dict(
        ms=device_ms(lambda: ops.flash_attention(q, k, v, causal=False)),
        plain_ms=device_ms(lambda: ref.attention(q, k, v, causal=False)),
        bound_ms=t_bound, bound_by=by,
        library_ms=device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    for name, t in out.items():
        lib = "n/a: no single PyTorch call computes it" \
            if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"{name:20s} B={b} S={s} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), library {lib}")
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
    expected = {"adaln_norm": cfg.num_layers * forwards,
                "adaln_norm_epilogue": cfg.num_layers * forwards,
                "flash_attention": cfg.num_layers * forwards}
    print(f"kernel launches {launches}; expected {expected} "
          f"(L={cfg.num_layers} x {forwards} DiT forwards)")
    assert launches == expected, "the main path did not run the kernels " \
        "exactly once per DiT layer"
    return launches


def main() -> int:
    phase("1. card")
    card_info()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    phase("2. build")
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({build.last_build['path'] or build.library_path()})")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    full = get_config("gdm-dit")
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase("3. kernels vs plain versions on the card")
    errs = check_adaln(gen)
    errs["flash_attention"] = check_attention(gen)

    phase("4. times at B=4, full width (median of "
          f"{TIMED_RUNS} device-timed samples of 10 back-to-back calls)")
    times = time_kernels(gen, full)

    phase("5. one block call, card vs CPU")
    model = step_vs_cpu(full)
    block_ms = time_block_call(full, model)
    per_forward = full.num_layers * sum(t["ms"] for t in times.values())
    print(f"run_block_batched B=4 full width: {block_ms:.4f} ms per DiT "
          f"forward; the kernels take {per_forward:.4f} ms of it "
          f"({full.num_layers} x (adaLN + adaLN epilogue + attention))")
    del model

    phase("6. serve paper-fig3 with full-width gdm-dit services")
    launches = serve(full)

    replaces = {
        "adaln_norm": "src/repro/kernels/adaln_norm.py:76",
        "adaln_norm_epilogue": "src/repro/kernels/adaln_norm.py:86",
        "flash_attention": "src/repro/kernels/flash_attention.py:100",
    }
    sources = {
        "adaln_norm": "src/repro_torch/kernels/csrc/adaln_norm.cu",
        "adaln_norm_epilogue": "src/repro_torch/kernels/csrc/adaln_norm.cu",
        "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], **times[name]}
        for name in ("adaln_norm", "adaln_norm_epilogue", "flash_attention")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
