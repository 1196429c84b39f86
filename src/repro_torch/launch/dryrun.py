"""Multi-pod dry run: count every (arch x shape x mesh) cell on the meta device.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step for 256 or 512 placeholder devices and reads the roofline from
the compiled module.  The port has no compiler to ask, and its dry run is
meta by nature, as the reference's is abstract: for every cell it

  1. builds the production mesh, (16, 16) or (2, 16, 16), over
     ``("meta",) * 256`` or ``* 512`` (the rules read only its shape and
     names, and the steps' shard loops tell the counter which mesh
     position runs what);
  2. builds the model on ``torch.device("meta")`` and the cell's inputs
     as they already are on meta (``launch.steps.input_specs``), both in
     the cell's dtype (bfloat16 by default, as the reference's; ``--dtype
     float32`` for the port's earlier records): nothing allocated;
  3. runs the cell's step (train / prefill / serve) once, with the step
     factory's ``mesh=`` and ``global_batch=``, under
     :func:`repro_torch.distributed.op_cost.count`: every kernel gives its
     outputs' shapes and charges its formula, every other op its FLOPs
     and bytes; a shape error, a mesh the shard loops cannot split over,
     or an op the meta device cannot run is a FAILURE;
  4. records per device the argument bytes by the spec rules
     (``param_specs``, the float32 AdamW moments like their parameters,
     ``decode_state_specs``, ``input_specs_shardings``: what the
     reference's ``memory_analysis`` reports as arguments), and the FLOPs,
     bytes, collectives and peak of the busiest mesh position's executed
     work, with the three roofline terms on the H100 (the compute term
     at the dtype's rate), to results/dryrun_torch/<cell>.json (a float32
     cell's name ends in ``__float32``).

The model axis stays rules-only for the dense layers: one data shard
computes whole dense layers (the all-to-all MoE and the split-K decode
use the model axis), so the dry run's ``useful_ratio`` shows what a
Megatron split of the dense layers would take off each device.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both --dtype float32
  python -m repro_torch.launch.dryrun --all --mesh single --opt-level perf
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, TrainConfig,
                                 cell_supported, get_config, get_shape)
from repro_torch.distributed.op_cost import count
from repro_torch.distributed.roofline import analyze, model_flops_estimate
from repro_torch.distributed.sharding import (_axis_size, batch_spec,
                                              decode_state_specs,
                                              input_specs_shardings,
                                              param_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (StepOptions, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, trainable)
from repro_torch.models.lm import LM
from repro_torch.optim import adamw

META = torch.device("meta")

# Perf-pass option sets, as the reference's, with the levers the port has
# (``loss_chunk``, ``fused_position``, ``sharded_decode``, ``moe_a2a``,
# ``remat``, on at every level as there, set or by default): the
# reference's ``seq_shard_carry`` has no counterpart (the port keeps no
# activation sharding between layers), so its "perf-sp" level is not
# here.  As there, "baseline" inserts each decode row at its own position.
OPT_LEVELS = {
    "baseline": StepOptions(fused_position=False, remat=True),
    "perf": StepOptions(loss_chunk=512, fused_position=True, remat=True,
                        sharded_decode=True),
    "perf-losschunk": StepOptions(loss_chunk=512, fused_position=False),
    "perf-fusedpos": StepOptions(fused_position=True),
    "perf-flashdecode": StepOptions(fused_position=False,
                                    sharded_decode=True),
    "perf-moea2a": StepOptions(fused_position=False, moe_a2a=True),
    "perf2": StepOptions(loss_chunk=512, fused_position=True, remat=True,
                         sharded_decode=True, moe_a2a=True),
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def _shard_bytes(t: torch.Tensor, spec, mesh) -> float:
    """One device's bytes of ``t`` split by ``spec`` (a parameter's spec
    may carry one more entry, its period-stacked axis)."""
    factor = 1
    for axis in spec:
        factor *= _axis_size(mesh, axis)
    return t.numel() * t.element_size() / factor


def argument_bytes(cfg, shape, mesh, model: LM, inputs) -> float:
    """Per-device bytes of the step's arguments by the spec rules: the
    parameters at their element size (and for a train step the AdamW
    moments, float32 whatever the parameters' dtype and sharded like
    them; the port's step counter is a host integer) and the inputs."""
    specs = param_specs(model, mesh)
    params = dict(model.named_parameters())
    total = sum(_shard_bytes(p, specs[k], mesh) for k, p in params.items())
    if shape.kind == "train":
        total += 2 * sum(_shard_bytes(p, specs[k], mesh) * 4
                         / p.element_size() for k, p in params.items())
    if shape.kind in ("train", "prefill"):
        shardings = input_specs_shardings(cfg, shape, mesh)
        return total + sum(_shard_bytes(v, shardings[k].spec, mesh)
                           for k, v in inputs.items())
    b = shape.global_batch
    total += _shard_bytes(inputs["token"], batch_spec(mesh, b, 0), mesh)
    state_specs = decode_state_specs(cfg, shape, mesh, inputs["state"])
    for slot, slot_specs in zip(inputs["state"], state_specs):
        for key, leaf in slot.items():
            leaves = leaf if isinstance(leaf, tuple) else (leaf,)
            specs_of = (slot_specs[key] if isinstance(leaf, tuple)
                        else (slot_specs[key],))
            total += sum(_shard_bytes(t, s, mesh)
                         for t, s in zip(leaves, specs_of))
    if "memory" in inputs:
        total += _shard_bytes(inputs["memory"], batch_spec(mesh, b, 2), mesh)
    return total


def _cell(arch: str, shape_name: str, multi_pod: bool, dtype):
    """(cfg, shape, mesh, model, inputs) of a supported cell, on meta."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=("meta",) * n)
    model = LM(cfg, device=META, dtype=dtype)
    inputs = input_specs(cfg, shape, dtype=dtype)
    if shape.kind == "prefill":
        inputs.pop("labels", None)
    return cfg, shape, mesh, model, inputs


def cell_argument_bytes(arch: str, shape_name: str, *, multi_pod: bool,
                        dtype=torch.bfloat16) -> float:
    """A supported cell's per-device argument bytes in ``dtype`` alone
    (:func:`argument_bytes`; nothing is counted)."""
    return argument_bytes(*_cell(arch, shape_name, multi_pod, dtype))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             opts: StepOptions, dtype=torch.bfloat16) -> dict:
    """One cell's record, its parameters, inputs and decode state in
    ``dtype`` (the reference's default bfloat16)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod),
                "status": "skipped", "reason": why}

    n = 512 if multi_pod else 256
    b = shape.global_batch
    t0 = time.time()
    _, _, mesh, model, inputs = _cell(arch, shape_name, multi_pod, dtype)
    args = argument_bytes(cfg, shape, mesh, model, inputs)
    if shape.kind == "train":
        step = make_train_step(cfg, TrainConfig(), opts=opts, mesh=mesh,
                               global_batch=b)
        opt_state = adamw(1e-3)[0](trainable(model))
        call = lambda: step(model, opt_state, inputs)           # noqa: E731
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, max_seq=shape.seq_len,
                                 state_dtype=dtype, mesh=mesh,
                                 global_batch=b)
        call = lambda: step(model, inputs)                       # noqa: E731
    else:
        step = make_serve_step(cfg, opts=opts, mesh=mesh, global_batch=b)
        call = lambda: step(model, inputs["token"], inputs["state"],  # noqa: E731
                            inputs.get("memory"))
    t_build = time.time() - t0
    with count() as counter:
        call()
    t_count = time.time() - t0 - t_build

    rf = analyze(counter.cost, num_devices=n,
                 model_flops_global=model_flops_estimate(cfg, shape),
                 argument_bytes=args, dtype=dtype)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "num_devices": n,
        "dtype": str(dtype).replace("torch.", ""),
        "status": "ok",
        "lower_s": round(t_build, 2),
        "compile_s": round(t_count, 2),
        "busiest_position": list(counter.busiest()),
        "roofline": rf.to_dict(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt-level", choices=sorted(OPT_LEVELS),
                    default="baseline")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true", help="recompute existing")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    opts = OPT_LEVELS[args.opt_level]
    dtype = DTYPES[args.dtype]
    suffix = "" if args.dtype == "bfloat16" else f"__{args.dtype}"

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t0 = time.time()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = (f"{arch}__{shape_name}__{_mesh_name(multi)}__"
                       f"{args.opt_level}{suffix}")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip-cached] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape_name, multi_pod=multi,
                                   opts=opts, dtype=dtype)
                except Exception as e:                      # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi),
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    rf = rec["roofline"]
                    print(f"  ok: count={rec['compile_s']:.1f}s "
                          f"compute={rf['compute_s']*1e3:.2f}ms "
                          f"memory={rf['memory_s']*1e3:.2f}ms "
                          f"collective={rf['collective_s']*1e3:.2f}ms "
                          f"dominant={rf['dominant']} "
                          f"peak={rf['peak_memory_bytes']/2**30:.2f}GiB "
                          f"useful={rf['useful_ratio']:.3f}")
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec['error']}")
    print(f"[dryrun] done in {time.time() - t0:.1f} s")
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
