"""Port parity: the dry run and what it stands on.

``configs.base.param_count`` / ``active_param_count`` / ``ServeConfig``,
the roofline's formulas (``model_flops_estimate``,
``kernel_path_memory_estimate``) against the reference's, exactly; the
cost counter (``distributed/op_cost``, the counterpart of ``hlo_cost``)
on simple programs, on one step of five families counted the same on the
meta device and the CPU, and against the reference's ``module_cost`` of
the same step compiled by XLA; the collectives it charges against the
reference's; ``launch/dryrun.run_cell`` on the production meshes at
reduced width and its argument bytes against the reference's
``NamedSharding`` shard shapes, in float32 and in the reference's default
bfloat16 (the parameters' bytes of every arch against
``abstract_params(dtype=jnp.bfloat16)``; the roofline's compute term at
the bfloat16 rate).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.configs import cell_supported as jcell_supported
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs import grid_cells as jgrid_cells
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.distributed import roofline as jroofline
from repro.distributed import sharding as jsharding
from repro.distributed.hlo_cost import module_cost
from repro.launch import steps as jsteps
from repro_torch.configs import (ALL_ARCHS, SHAPES, ServeConfig, TrainConfig,
                                 get_config, grid_cells)
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import op_cost, roofline
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM, init_decode_state, init_lm
from repro_torch.models.lm import reference_leaf as tlm_reference_leaf
from repro_torch.nn.moe_sharded import moe_apply_sharded
from repro_torch.optim import adamw

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ["yi-6b", "granite-moe-1b-a400m", "jamba-v0.1-52b", "xlstm-1.3b",
            "seamless-m4t-large-v2"]
KINDS = ["prefill", "decode", "train"]
B, S = 8, 32               # the reference comparisons' batch and prompt
DECODE_CACHE = 64
REF_TIMEOUT = 240


# -- the reference's all-to-all, in a child with four host devices ----------------

_A2A_CHILD = r'''
import json, pathlib, sys
import jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_lm_mesh as T
from repro import nn as jnn
from repro.distributed.hlo_cost import module_cost
from repro.launch.mesh import make_host_mesh
from repro.nn.moe_sharded import moe_apply_sharded
_, jcfg = T._moe_cfgs(8, 2, 1.25)
params = jnn.moe_init(jax.random.PRNGKey(1), jcfg)
x = jnp.asarray(T._moe_input(T.MOE_SEED))
mesh = make_host_mesh((1, 4), ("data", "model"))
f = lambda p, x: moe_apply_sharded(p, x, cfg=jcfg, mesh=mesh)
g = jax.grad(lambda p, x: jnp.sum(f(p, x)[0] ** 2) + f(p, x)[1],
             argnums=(0, 1))
out = {name: module_cost(jax.jit(fn).lower(params, x).compile().as_text())
       .coll_detail for name, fn in (("forward", f), ("grad", g))}
pathlib.Path(sys.argv[1]).write_text(json.dumps(out))
'''


@pytest.fixture(scope="module", autouse=True)
def ref_a2a(tmp_path_factory):
    """The child runs while the module's other tests do."""
    out = tmp_path_factory.mktemp("ref_a2a") / "a2a.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _A2A_CHILD, str(out), str(ROOT / "tests")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# -- configs ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_is_the_reference_formula(arch):
    """The formula, not the built count (seamless 2.035 B here, 1.634 B as
    built; xlstm-1.3b 2.02 B and 3.581 B), full and reduced."""
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_config(arch).reduced(),
                       jget_config(arch).reduced())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


def test_serve_config_matches_reference():
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(
        JServeConfig())
    assert [f.name for f in dataclasses.fields(ServeConfig)] == [
        f.name for f in dataclasses.fields(JServeConfig)]


# -- the roofline's formulas and constants -------------------------------------------

def test_model_flops_estimate_matches_reference_on_every_cell():
    cells = grid_cells(include_skipped=True)
    assert [c[:2] for c in cells] == [c[:2] for c in jgrid_cells(
        include_skipped=True)]
    for arch, shape, _, _ in cells:
        assert roofline.model_flops_estimate(
            get_config(arch), SHAPES[shape]) == jroofline.model_flops_estimate(
            jget_config(arch), jget_shape(shape))


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_kernel_path_memory_estimate_bytes_match_reference(dtype_bytes):
    for arch, shape, _, _ in grid_cells(include_skipped=True):
        got = roofline.kernel_path_memory_estimate(
            get_config(arch), SHAPES[shape], dtype_bytes=dtype_bytes)
        want = jroofline.kernel_path_memory_estimate(
            jget_config(arch), jget_shape(shape),
            dtype_bytes=dtype_bytes)
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if k != "memory_s"} == {
            k: v for k, v in want.items() if k != "memory_s"}
        assert got["memory_s"] == got["total"] / 3.35e12


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == (
        67e12, 3.35e12, 450e9)
    cost = op_cost.Cost(flops=67e12, bytes=6.7e12, coll_bytes=45e9,
                        coll_detail={"all-reduce": [2, 45e9]},
                        kernels={"rmsnorm": [3, 1.0, 2.0]}, peak_bytes=5)
    rf = roofline.analyze(cost, num_devices=2, model_flops_global=67e12,
                          argument_bytes=7)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (1.0, 2.0, 0.1)
    assert rf.dominant == "memory" and rf.useful_ratio == 0.5
    assert (rf.peak_memory_bytes, rf.argument_bytes, rf.temp_bytes) == (
        12, 7, 5)
    assert rf.collective_detail == {"all-reduce": {
        "op": "all-reduce", "count": 2, "bytes": 45e9}}
    assert rf.kernel_detail == {"rmsnorm": {"calls": 3, "flops": 1.0,
                                            "bytes": 2.0}}
    want = set(dataclasses.asdict(jroofline.Roofline(
        0, 0, 0, {}, 0, 0, 0, "")))
    assert want <= set(rf.to_dict())


# -- the counter on simple programs ------------------------------------------------

def test_counter_on_a_matmul():
    """tests/test_distributed.py's matmul: 2·m·k·n FLOPs; the operands
    read and the result written once."""
    m, k, n = 32, 64, 48
    a, b = torch.randn(m, k), torch.randn(k, n)
    with op_cost.count() as c:
        a @ b
    assert c.cost.flops == 2 * m * k * n
    assert c.cost.bytes == 4 * (m * k + k * n + m * n)
    assert c.cost.peak_bytes == 4 * m * n
    assert c.bytes_by_op() == [("mm", 4 * (m * k + k * n + m * n))]


def test_counter_on_chained_products():
    """tests/test_distributed.py's scan: seven chained 16³ products count
    7·2·16³ (an eager loop is the unrolled scan)."""
    x = torch.randn(16, 16, device="meta")
    with op_cost.count() as c:
        for _ in range(7):
            x = x @ x
    assert c.cost.flops == 7 * 2 * 16 ** 3
    # each intermediate dies when the next one is made: two live at most
    assert c.cost.peak_bytes == 2 * 16 * 16 * 4


def test_views_and_allocations_move_nothing_and_region_writes_their_rows():
    cache = torch.zeros(2, 64, 4, 8)
    row = torch.randn(2, 1, 4, 8)
    with op_cost.count() as c:
        cache.view(2, 64, 32).transpose(0, 1)
        torch.empty(1000)
        cache.index_copy_(1, torch.tensor([5]), row)
    idx = 8
    assert c.cost.bytes == idx + 2 * row.numel() * 4
    assert c.cost.flops == 0


# -- one step, the same count on meta and on the CPU ----------------------------------

def _inputs(cfg, kind, device, b=2, s=16):
    shape = ShapeConfig("t", "train" if kind == "train" else "prefill", s, b)
    specs = steps.input_specs(cfg, shape, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)

    def make(t):
        if device == "meta":
            return t
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape,
                                 dtype=torch.int32, generator=gen)
        return torch.randn(t.shape, generator=gen)

    if kind == "prefill":
        specs.pop("labels", None)
    if kind != "decode":
        return {k: make(v) for k, v in specs.items()}
    out = {"token": make(torch.empty(b, dtype=torch.int32, device="meta")),
           "state": init_decode_state(cfg, b, s, dtype=torch.float32,
                                      device=device)}
    if cfg.is_encdec:
        out["memory"] = make(torch.empty(b, cfg.encoder_seq_len,
                                         cfg.d_model, device="meta"))
    return out


def _count_step(cfg, kind, device, mesh=None, b=2, s=16,
                opts=steps.StepOptions(remat=False)):
    model = (LM(cfg, device="meta") if device == "meta"
             else init_lm(cfg, seed=0, device=device))
    inputs = _inputs(cfg, kind, device, b=b, s=s)
    kw = dict(mesh=mesh, global_batch=b if mesh is not None else 0)
    if kind == "train":
        step = steps.make_train_step(cfg, TrainConfig(), opts=opts, **kw)
        opt = adamw(1e-3)[0](steps.trainable(model))
        call = lambda: step(model, opt, inputs)                  # noqa: E731
    elif kind == "prefill":
        step = steps.make_prefill_step(cfg, max_seq=s,
                                       state_dtype=torch.float32, **kw)
        call = lambda: step(model, inputs)                       # noqa: E731
    else:
        step = steps.make_serve_step(cfg, **kw)
        call = lambda: step(model, inputs["token"], inputs["state"],  # noqa: E731
                            inputs.get("memory"))
    with op_cost.count() as counter:
        call()
    return counter


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_step_counts_the_same_on_meta_and_cpu(arch, kind):
    """Every kernel a unit charged by its formula, on meta its outputs'
    shapes, on the CPU its plain version: FLOPs, bytes, collectives,
    kernel charges and peak all equal."""
    cfg = get_config(arch).reduced()
    meta = _count_step(cfg, kind, "meta").cost
    cpu = _count_step(cfg, kind, "cpu").cost
    assert meta == cpu
    assert meta.flops > 0 and meta.peak_bytes > 0
    if arch != "xlstm-1.3b":
        assert meta.kernels


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_train_step_counts_the_same_on_meta_and_cpu(arch):
    """The train step with remat, as the step without it above: every
    period's recompute charged by formula on meta and by the plain
    version on the CPU, the period's activations freed at its end on
    both; FLOPs, bytes, collectives, kernel charges and peak all equal,
    and more FLOPs than the step without remat."""
    cfg = get_config(arch).reduced()
    remat = steps.StepOptions(remat=True)
    meta = _count_step(cfg, "train", "meta", opts=remat).cost
    cpu = _count_step(cfg, "train", "cpu", opts=remat).cost
    assert meta == cpu
    assert meta.flops > _count_step(cfg, "train", "meta").cost.flops


@pytest.mark.parametrize("kind", ["prefill", "train", "train_remat"])
def test_slstm_shortcut_equals_the_whole_loop(kind):
    """On meta the sLSTM's loop runs three steps and counts the rest as
    the second; the CPU runs all 8.  Over a data mesh of two every
    position's FLOPs, bytes, collectives and kernel charges agree
    exactly.  The peak is the shortcut's estimate: the steps not run keep
    the second step's live bytes until its output dies, where the whole
    loop frees each step's at its own backward; within 2% here."""
    cfg = get_config("xlstm-1.3b").reduced()
    counts = {}
    for dev in ("meta", "cpu"):
        mesh = make_host_mesh((2, 1), ("data", "model"), devices=(dev,) * 2)
        c = _count_step(cfg, kind.split("_")[0], dev, mesh=mesh, b=4, s=8,
                        opts=steps.StepOptions(remat=kind == "train_remat"))
        counts[dev] = {p: v.cost for p, v in c.positions.items()}
    assert set(counts["meta"]) == set(counts["cpu"]) >= {(0, 0), (1, 0)}
    for pos, cpu in counts["cpu"].items():
        meta = counts["meta"][pos]
        assert dataclasses.replace(meta, peak_bytes=0) == \
            dataclasses.replace(cpu, peak_bytes=0)
        assert meta.peak_bytes == pytest.approx(cpu.peak_bytes, rel=0.02)


# -- against the reference's module_cost on a mesh of one ------------------------------

def _jcfg():
    return jget_config("yi-6b").reduced()


def _port_count(kind, s, remat=False):
    cfg = get_config("yi-6b").reduced()
    mesh = make_host_mesh((1, 1), ("data", "model"), devices=("meta",))
    return _count_step(cfg, kind, "meta", mesh=mesh, b=B, s=s,
                       opts=steps.StepOptions(remat=remat)).cost


def _aten_flops(cost):
    """The FLOPs outside the kernels' charges (the norms' elementwise
    FLOPs among them, which ``hlo_cost`` does not count)."""
    return cost.flops - sum(k[1] for k in cost.kernels.values())


def test_decode_count_equals_module_cost():
    """Reduced yi-6b, batch 8, a 64-row cache: 1 703 936 FLOPs both ways
    (the decode kernel's formula counts the whole cache, as the
    reference's XLA version computes it).  ``hlo_cost`` counts dots and
    convolutions only, so the norm kernel's elementwise FLOPs, which its
    formula charges, are left out here."""
    jcfg = _jcfg()
    params = jsteps.abstract_params(jcfg, dtype=jnp.float32)
    state = jax.eval_shape(lambda: jsteps.init_decode_state(
        jcfg, B, DECODE_CACHE, dtype=jnp.float32))
    step = jsteps.make_serve_step(jcfg, opts=jsteps.StepOptions(impl="xla"))
    compiled = jax.jit(step).lower(
        params, jax.ShapeDtypeStruct((B,), jnp.int32), state).compile()
    want = module_cost(compiled.as_text()).flops
    assert want == 1_703_936
    got = _port_count("decode", DECODE_CACHE)
    assert got.flops - got.kernels["rmsnorm"][1] == want
    assert got.kernels["decode_attention"][1] == 4 * B * DECODE_CACHE * 16 \
        * 4 * 2


def test_prefill_and_train_products_outside_attention_equal_module_cost():
    """The products outside attention, exactly.  Attention differs by
    construction: the reference's XLA attention computes every (query,
    key) pair and masks, 4·B·H·S²·D FLOPs a layer forward and twice that
    backward, which ``module_cost`` counts (the two dots sit in the
    scanned layer's ``while`` body, each trip counted); the port's
    attention kernel is charged for the causal pairs only.  The prefill
    also differs outside attention: the port's (and the reference's)
    ``lm_prefill`` projects K and V twice a layer, once for the cache and
    once inside ``attention_apply``, and XLA's CSE merges the copies,
    while the port runs both: 2·(2·B·S·d·kv_dim) FLOPs a layer more."""
    jcfg = _jcfg()
    cfg = get_config("yi-6b").reduced()
    h, d_h, layers = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    dense_attn = 4 * B * h * S * S * d_h * layers
    params = jsteps.abstract_params(jcfg, dtype=jnp.float32)
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    prefill = jsteps.make_prefill_step(
        jcfg, max_seq=S, state_dtype=jnp.float32,
        opts=jsteps.StepOptions(impl="xla"))
    want = module_cost(jax.jit(prefill).lower(
        params, {"tokens": tokens}).compile().as_text()).flops
    kv_again = 2 * (2 * B * S * cfg.d_model * cfg.kv_dim) * layers
    got = _port_count("prefill", S)
    assert _aten_flops(got) - kv_again == want - dense_attn
    train = jsteps.make_train_step(
        jcfg, JTrainConfig(), opts=jsteps.StepOptions(remat=False,
                                                      impl="xla"))
    opt = jsteps.abstract_opt_state(params)
    want = module_cost(jax.jit(train).lower(
        params, opt, {"tokens": tokens, "labels": tokens}).compile()
        .as_text()).flops
    got = _port_count("train", S, remat=False)
    assert _aten_flops(got) == want - 3 * dense_attn
    assert got.kernels["flash_attention_backward"][0] == layers


def test_remat_train_count_equals_module_cost():
    """The train step with remat on both sides (the reference's default):
    184 549 376 FLOPs from ``module_cost``, the port's outside its kernels
    167 772 160 = that less 4·B·H·S²·D a layer four times, its attention
    forward, the recompute's and the backward's two.  Each side recomputes
    the period's forward but its last product, the MLP's down
    projection, whose output the backward does not need: XLA drops it,
    and the checkpoint's recompute stops at the last tensor the backward
    saved, before it.  So against the step without remat both sides add
    the same 29 360 128 FLOPs of products outside attention.  The forward
    kernels are charged twice a layer, the final norm once."""
    jcfg = _jcfg()
    cfg = get_config("yi-6b").reduced()
    h, d_h, layers = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    dense_attn = 4 * B * h * S * S * d_h * layers
    params = jsteps.abstract_params(jcfg, dtype=jnp.float32)
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    opt = jsteps.abstract_opt_state(params)
    want = {}
    for remat in (False, True):
        train = jsteps.make_train_step(
            jcfg, JTrainConfig(), opts=jsteps.StepOptions(remat=remat,
                                                          impl="xla"))
        want[remat] = module_cost(jax.jit(train).lower(
            params, opt, {"tokens": tokens, "labels": tokens}).compile()
            .as_text()).flops
    assert want[True] == 184_549_376
    got = {r: _port_count("train", S, remat=r) for r in (False, True)}
    assert _aten_flops(got[True]) == want[True] - 4 * dense_attn
    assert _aten_flops(got[True]) - _aten_flops(got[False]) \
        == want[True] - want[False] - dense_attn == 29_360_128
    kernels = got[True].kernels
    assert kernels["flash_attention"][0] == 2 * layers
    assert kernels["rmsnorm"][0] == 2 * 2 * layers + 1
    assert kernels["flash_attention_backward"][0] == layers
    assert kernels["rmsnorm_backward"][0] == 2 * layers + 1


def test_remat_lowers_the_counted_peak():
    """Reduced yi-6b's train step at B=8, S=64 on meta: the saved
    activations of a period outweigh its input, so the counted peak falls
    from 5 789 716 bytes without remat to 3 793 684 with it; FLOPs rise by
    the recompute."""
    cfg = get_config("yi-6b").reduced()
    got = {r: _count_step(cfg, "train", "meta", b=8, s=64,
                          opts=steps.StepOptions(remat=r)).cost
           for r in (False, True)}
    assert got[False].peak_bytes == 5_789_716
    assert got[True].peak_bytes == 3_793_684
    assert got[True].flops > got[False].flops


def test_bf16_scan_gradient_is_charged_as_its_own_kernel():
    """On meta a bfloat16 scan's gradient is charged as
    ``ssm_scan_backward_bf16`` by the bfloat16 formula (u, dt, dy, B, C
    and their gradients at 2 bytes, A, D and theirs at 4), a float32 one
    as ``ssm_scan_backward``; on the CPU the kernel's wrapper refuses."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import (backward_work,
                                              ssm_scan_backward_cuda)
    b, length, din, n = 2, 16, 64, 8
    for dtype, name in ((torch.bfloat16, "ssm_scan_backward_bf16"),
                        (torch.float32, "ssm_scan_backward")):
        def make(*shape, dt=dtype):
            return torch.empty(*shape, dtype=dt, device="meta",
                               requires_grad=True)
        args = (make(b, length, din), make(b, length, din),
                make(din, n, dt=torch.float32), make(b, length, n),
                make(b, length, n), make(din, dt=torch.float32))
        with op_cost.count() as c:
            ops.ssm_scan(*args).sum().backward()
        work = backward_work((b, length, din), n,
                             torch.tensor([], dtype=dtype).element_size())
        assert c.cost.kernels[name] == [1, *work]
        other = ({"ssm_scan_backward", "ssm_scan_backward_bf16"} - {name})
        assert not other & set(c.cost.kernels)
    rows, small = b * length * din, b * length * n
    assert backward_work((b, length, din), n, 2)[1] == \
        2 * (5 * rows + 4 * small) + 4 * 2 * (din * n + din)
    cpu = [torch.zeros(b, length, din, dtype=torch.bfloat16)] * 2
    with pytest.raises(ValueError, match="ssm_scan_cuda: u is on cpu"):
        ssm_scan_backward_cuda(
            cpu[0], cpu[1], torch.zeros(din, n),
            torch.zeros(b, length, n, dtype=torch.bfloat16),
            torch.zeros(b, length, n, dtype=torch.bfloat16),
            torch.zeros(din), None, cpu[0])


# -- collectives --------------------------------------------------------------------------

def test_all_to_all_bytes_match_the_reference_shard_map(ref_a2a):
    """The all-to-all MoE at model size 4 on ("cpu",) * 4, forward and
    forward + backward of sum(y²) + aux: as many all-to-alls as the
    reference's ``shard_map`` (3 and 5), and the same blocks moved.  Two
    stated differences in bytes: ``hlo_cost`` reads no group size from
    ``replica_groups={{0,1,2,3}}`` and takes 2 (a factor 1/2 where the
    ring over 4 moves 3/4), and the port's expert ids are int64 where the
    reference's are int32 (the forward's id block, 4·cap_s of them)."""
    from test_torch_lm_mesh import MOE_SEED, _moe_cfgs, _moe_input, _tmesh
    from repro import nn as jnn
    from test_torch_lm_mesh import _moe_module
    cfg, jcfg = _moe_cfgs(8, 2, 1.25)
    module = _moe_module(cfg, jnn.moe_init(jax.random.PRNGKey(1), jcfg))
    for w in module.parameters():
        w.requires_grad_(True)
    x = torch.from_numpy(_moe_input(MOE_SEED)).requires_grad_(True)
    mesh = _tmesh((1, 4))
    counted = {}
    with op_cost.count() as c:
        y, aux = moe_apply_sharded(module, x, cfg=cfg, mesh=mesh)
    counted["forward"] = c.cost.coll_detail["all-to-all"]
    with op_cost.count() as c:
        y, aux = moe_apply_sharded(module, x, cfg=cfg, mesh=mesh)
        ((y ** 2).sum() + aux).backward()
    counted["grad"] = c.cost.coll_detail["all-to-all"]
    assert set(c.positions) == {(0, m) for m in range(4)}
    for p in c.positions.values():
        assert p.cost.coll_detail["all-to-all"] == counted["grad"]
    proc, out = ref_a2a
    _, err = proc.communicate(timeout=REF_TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out.read_text())
    t_l = x.shape[0] * x.shape[1] // 4
    cap_s = max(2, int(1.25 * t_l * 2 / 4))
    ids_int64_over_int32 = 4 * cap_s * 4
    for name in ("forward", "grad"):
        count, moved = counted[name]
        ref_count, ref_moved = ref[name]["all-to-all"]
        assert count == ref_count
        assert moved / (3 / 4) == ref_moved / (1 / 2) + ids_int64_over_int32


def test_gradient_sum_is_a_ring_all_reduce_over_the_data_shards():
    """A train step on a data mesh of two: each data position charged one
    all-reduce of every gradient's bytes, 2·bytes·(2-1)/2."""
    cfg = get_config("yi-6b").reduced()
    mesh = make_host_mesh((2, 1), ("data", "model"), devices=("meta",) * 2)
    c = _count_step(cfg, "train", "meta", mesh=mesh, b=4, s=8)
    grad_bytes = 4 * sum(p.numel() for p in LM(cfg, device="meta")
                         .parameters())
    for pos in ((0, 0), (1, 0)):
        assert c.positions[pos].cost.coll_detail == {
            "all-reduce": [1.0, grad_bytes]}
    no_mesh = _count_step(cfg, "train", "meta", b=4, s=8)
    assert no_mesh.cost.coll_bytes == 0 and not no_mesh.cost.coll_detail


# -- run_cell ---------------------------------------------------------------------------

def _reduced(monkeypatch):
    full = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: full(a).reduced())


@pytest.mark.parametrize("arch,shape,multi", [
    ("yi-6b", "train_4k", False),
    ("granite-moe-1b-a400m", "decode_32k", False),
    ("jamba-v0.1-52b", "prefill_32k", False),
    ("yi-6b", "decode_32k", True)])
def test_run_cell_is_ok_with_the_reference_keys(arch, shape, multi,
                                                monkeypatch):
    """The production mesh and shape at reduced width (full width is
    ``chip_smoke.py`` phase 25's, on the CPU of the card's host)."""
    _reduced(monkeypatch)
    rec = dryrun.run_cell(arch, shape, multi_pod=multi,
                          opts=dryrun.OPT_LEVELS["baseline"],
                          dtype=torch.float32)
    assert rec["status"] == "ok", rec
    assert {"arch", "shape", "mesh", "num_devices", "status", "lower_s",
            "compile_s", "roofline"} <= set(rec)
    assert rec["num_devices"] == (512 if multi else 256)
    rf = rec["roofline"]
    want = set(dataclasses.asdict(jroofline.Roofline(
        0, 0, 0, {}, 0, 0, 0, "")))
    assert want <= set(rf)
    assert rf["flops_per_device"] > 0 and rf["bytes_per_device"] > 0
    assert rf["peak_memory_bytes"] == rf["argument_bytes"] + rf["temp_bytes"]
    assert 0 < rf["useful_ratio"] <= 1
    assert json.loads(json.dumps(rec)) == rec


def test_run_cell_skips_long_500k_dense_cell_with_the_reference_reason():
    rec = dryrun.run_cell("yi-6b", "long_500k", multi_pod=False,
                          opts=dryrun.OPT_LEVELS["baseline"])
    ok, why = jcell_supported(jget_config("yi-6b"),
                                     jget_shape("long_500k"))
    assert not ok
    assert rec == {"arch": "yi-6b", "shape": "long_500k", "mesh": "single",
                   "status": "skipped", "reason": why}


def test_main_writes_a_record_per_cell(tmp_path, monkeypatch):
    _reduced(monkeypatch)
    dryrun.main(["--arch", "jamba-v0.1-52b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"jamba-v0.1-52b__long_500k__{mesh}"
                          "__baseline.json").read_text())
        assert rec["status"] == "ok" and rec["mesh"] == mesh


def _ref_elements(tree, specs, mesh):
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)))
               for x, s in zip(leaves, spec_leaves))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_argument_bytes_match_reference_shard_shapes(kind):
    """tests/test_launch.py's (2, 4) mesh with reduced yi-6b: the
    per-device argument elements (4 bytes each here) equal the totals of
    the reference's ``NamedSharding.shard_shape``: parameters, AdamW's
    moments like them (the reference's step counter, one int32 on every
    device, is a host integer in the port) and the batch, or the decode
    token and state."""
    jcfg = _jcfg()
    cfg = get_config("yi-6b").reduced()
    jmesh = AbstractMesh((2, 4), ("data", "model"))
    mesh = make_host_mesh((2, 4), ("data", "model"), devices=("meta",) * 8)
    params = jsteps.abstract_params(jcfg, dtype=jnp.float32)
    p_specs = jsharding.param_specs(params, jmesh)
    want = _ref_elements(params, p_specs, jmesh)
    if kind == "train":
        shape = ShapeConfig("tiny_train", "train", 32, 8)
        jshape = JShapeConfig("tiny_train", "train", 32, 8)
        want *= 3
        batch = jsteps.input_specs(jcfg, jshape, dtype=jnp.float32)
        b_sh = jsharding.input_specs_shardings(jcfg, jshape, jmesh)
        want += sum(int(np.prod(b_sh[k].shard_shape(v.shape)))
                    for k, v in batch.items())
    else:
        shape = ShapeConfig("tiny_decode", "decode", 64, 8)
        jshape = JShapeConfig("tiny_decode", "decode", 64, 8)
        sds = jsteps.input_specs(jcfg, jshape, dtype=jnp.float32)
        want += int(np.prod(NamedSharding(
            jmesh, jsharding.batch_spec(jmesh, 8, 0)).shard_shape((8,))))
        want += _ref_elements(sds["state"], jsharding.decode_state_specs(
            jcfg, jshape, jmesh, sds["state"]), jmesh)
    model = LM(cfg, device="meta")
    inputs = steps.input_specs(cfg, shape, dtype=torch.float32)
    got = dryrun.argument_bytes(cfg, shape, mesh, model, inputs)
    assert got == 4 * want


# -- the dry run in bfloat16, the reference's default ----------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_parameter_bytes_match_reference_in_bf16(arch):
    """Every arch at full width on meta: the parameters' bytes in
    bfloat16 (the float32 leaves the reference keeps, Mamba's ``a_log``
    and ``d`` and the MoE router, among them) equal those of the
    reference's ``abstract_params(dtype=jnp.bfloat16)``, leaf for leaf."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = LM(cfg, device="meta", dtype=torch.bfloat16)
    want = jax.tree_util.tree_leaves_with_path(
        jsteps.abstract_params(jcfg, dtype=jnp.bfloat16))
    groups = {}
    for name, p in model.named_parameters():
        path, _ = tlm_reference_leaf(name)
        groups.setdefault("/".join(path), []).append(p)
    got = {k: (sum(p.numel() for p in ps) * ps[0].element_size(),
               str(ps[0].dtype).replace("torch.", ""))
           for k, ps in groups.items()}
    assert len(got) == len(want)
    for path, leaf in want:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        assert got[key] == (leaf.size * leaf.dtype.itemsize,
                            leaf.dtype.name), key


def _ref_bytes(tree, specs, mesh):
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)))
               * x.dtype.itemsize for x, s in zip(leaves, spec_leaves))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_match_reference_in_bf16(kind):
    """The (2, 4) mesh of ``test_argument_bytes_match_reference_shard_
    shapes`` at the reference's default dtype, byte for byte: bfloat16
    parameters, AdamW's float32 moments, int32 tokens, the decode state's
    bfloat16 caches and int32 lengths, a seamless' bfloat16 frames."""
    arch = "seamless-m4t-large-v2" if kind == "prefill" else "yi-6b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jmesh = AbstractMesh((2, 4), ("data", "model"))
    mesh = make_host_mesh((2, 4), ("data", "model"), devices=("meta",) * 8)
    params = jsteps.abstract_params(jcfg, dtype=jnp.bfloat16)
    want = _ref_bytes(params, jsharding.param_specs(params, jmesh), jmesh)
    shape = ShapeConfig("tiny", kind, 64 if kind == "decode" else 32, 8)
    jshape = JShapeConfig("tiny", kind, 64 if kind == "decode" else 32, 8)
    sds = jsteps.input_specs(jcfg, jshape)
    if kind == "train":
        opt = jsteps.abstract_opt_state(params)
        want += _ref_bytes((opt.mu, opt.nu), jsharding.param_specs(
            (opt.mu, opt.nu), jmesh), jmesh)
    if kind != "decode":
        b_sh = jsharding.input_specs_shardings(jcfg, jshape, jmesh)
        if kind == "prefill":
            sds.pop("labels", None)
        want += sum(int(np.prod(b_sh[k].shard_shape(v.shape)))
                    * v.dtype.itemsize for k, v in sds.items())
    else:
        want += 4 * int(np.prod(NamedSharding(
            jmesh, jsharding.batch_spec(jmesh, 8, 0)).shard_shape((8,))))
        want += _ref_bytes(sds["state"], jsharding.decode_state_specs(
            jcfg, jshape, jmesh, sds["state"]), jmesh)
    model = LM(cfg, device="meta", dtype=torch.bfloat16)
    inputs = steps.input_specs(cfg, shape)
    if kind == "prefill":
        inputs.pop("labels", None)
    assert dryrun.argument_bytes(cfg, shape, mesh, model, inputs) == want


@pytest.mark.parametrize("arch,shape,multi", [
    ("yi-6b", "train_4k", False),
    ("granite-moe-1b-a400m", "decode_32k", False),
    ("jamba-v0.1-52b", "prefill_32k", False),
    ("yi-6b", "decode_32k", True)])
def test_run_cell_in_bf16_is_ok_where_float32_is(arch, shape, multi,
                                                 monkeypatch):
    """The cells ``test_run_cell_is_ok_with_the_reference_keys`` runs in
    float32, in the default bfloat16: ``ok``, its parameters' and its
    inputs' bytes by their element size (the arguments below the float32
    record's), the compute term at 989 TFLOP/s."""
    _reduced(monkeypatch)
    recs = {dt: dryrun.run_cell(arch, shape, multi_pod=multi,
                                opts=dryrun.OPT_LEVELS["baseline"],
                                dtype=dt)
            for dt in (torch.float32, torch.bfloat16)}
    f32, bf = recs[torch.float32]["roofline"], recs[torch.bfloat16]["roofline"]
    assert recs[torch.bfloat16]["status"] == "ok"
    assert recs[torch.bfloat16]["dtype"] == "bfloat16"
    assert bf["argument_bytes"] < f32["argument_bytes"]
    assert bf["compute_s"] == bf["flops_per_device"] / roofline.PEAK_BF16_FLOPS
    assert f32["compute_s"] == f32["flops_per_device"] / roofline.PEAK_FLOPS
    assert any(k.endswith("_bf16") for k in bf["kernel_detail"])
    assert not any(k.endswith("_bf16") for k in f32["kernel_detail"])


def test_opt_levels_insert_as_the_reference_levels_do():
    """``fused_position`` and ``remat`` (on at every level, set or by
    default) per level as the reference's ``OPT_LEVELS`` (its ``perf-sp``
    has no counterpart)."""
    from repro.launch import dryrun as jdryrun
    assert set(dryrun.OPT_LEVELS) == set(jdryrun.OPT_LEVELS) - {"perf-sp"}
    for name, opts in dryrun.OPT_LEVELS.items():
        ref = jdryrun.OPT_LEVELS[name]
        assert opts.remat is True
        for field in ("fused_position", "loss_chunk", "sharded_decode",
                      "moe_a2a", "microbatch", "grad_compression", "remat"):
            assert getattr(opts, field) == getattr(ref, field), (name, field)
