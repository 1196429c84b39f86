"""Port parity: the LM's mesh paths on the CPU.

The reference's ``shard_map`` paths (``tests/test_shardmap_paths.py``)
brought over on a (1, 1) ("data", "model") mesh, run in-process against
the reference: the split-K decode against the reference's oracle and the
plain insert path, the all-to-all MoE dispatch against the einsum
dispatch (where capacity drops nothing, the two agree), its gradients and
its capacity drops.

Then the port at model sizes 2 and 4 against the reference's own
``shard_map``, run in a child process with eight forced host devices on
(1, 2), (2, 2), (1, 4) and (2, 4) meshes (above size 1 the einsum
dispatch is no oracle: each shard's capacity counts its own tokens): the
split-K decode with its insert (outputs within 1e-5, caches equal), the
all-to-all dispatch at capacity factor 1.25 (outputs within the
reference test's 1e-4 / 1e-3, ``aux`` within 1e-5, gradients within
1e-4), two train steps of reduced granite with ``moe_a2a`` on (2, 2), and
reduced yi-6b's serve step with the split-K decode on (2, 4).

The spec rules against the reference's for every arch of the registry on
the (16, 16), (2, 16, 16) and (2, 4) shapes; the production meshes'
shapes and names; a mesh of one device bit for bit with no mesh; the
data-parallel steps against the unsharded ones (the einsum MoE dispatch
routes the whole batch on a mesh too); and the trainer over a mesh of two.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed import sharding as jsharding
from repro.kernels import ref as jref
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn.moe_sharded import moe_apply_sharded as jmoe_sharded
from repro_torch.configs import ASSIGNED_ARCHS, TrainConfig, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.flash_decode import sharded_decode_attention
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.nn import attention as tattn
from repro_torch.nn.moe import MoE, moe_apply
from repro_torch.nn.moe_sharded import moe_apply_sharded
from repro_torch.optim import optimizers as topt

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPUS = ("cpu",) * 8
MESHES = [(1, 2), (2, 2), (1, 4), (2, 4)]
DECODE_TOL = 1e-5          # split-K outputs; caches exactly
MOE_ATOL, MOE_RTOL = 1e-4, 1e-3   # the reference test's tolerances
AUX_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5            # steps and logits, absolute and relative
REF_TIMEOUT = 240
MOE_KW = dict(num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
              d_ff=24, moe_d_ff=24)
MOE_SEED = 3       # an input whose routing overflows a shard's capacity at
                   # every mesh size, so the einsum dispatch differs
SPLITK = dict(b=4, h=8, d=16, s=64, kh=2)
SPLITK_LENGTHS = (16, 17, 33, 64, 65)   # inserts at 15, 16, 32, 63, none


def _close(got, want, tol=STEP_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tmesh(shape):
    return tmesh.make_host_mesh(shape, ("data", "model"), devices=CPUS)


def _jmesh11():
    return jmesh.make_host_mesh((1, 1), ("data", "model"))


def _moe_cfgs(e, k, cf):
    kw = dict(MOE_KW, num_experts=e, experts_per_token=k,
              moe_capacity_factor=cf)
    from repro.configs import ModelConfig as JModelConfig
    return ModelConfig(**kw), JModelConfig(**kw)


def _moe_module(cfg, params):
    m = MoE(cfg, device="cpu")
    with torch.no_grad():
        for n in ("router", "gate_w", "up_w", "down_w"):
            getattr(m, n).copy_(torch.from_numpy(np.array(params[n])))
    return m


def _moe_input(seed, shape=(4, 16, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _splitk_inputs():
    c = SPLITK
    rng = np.random.default_rng(8)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(q=draw(len(SPLITK_LENGTHS), c["b"], c["h"], c["d"]),
                k=draw(c["b"], c["s"], c["kh"], c["d"]),
                v=draw(c["b"], c["s"], c["kh"], c["d"]),
                kn=draw(len(SPLITK_LENGTHS), c["b"], c["kh"], c["d"]),
                vn=draw(len(SPLITK_LENGTHS), c["b"], c["kh"], c["d"]),
                ragged=np.asarray([17, 64, 1, 30], np.int32))


def _granite(cf=1.25):
    arch = "granite-moe-1b-a400m"
    return (dataclasses.replace(get_config(arch).reduced(),
                                moe_capacity_factor=cf),
            dataclasses.replace(jget_config(arch).reduced(),
                                moe_capacity_factor=cf))


def _serve_tokens(cfg, steps=3, b=4):
    """The tokens the serve steps feed, drawn up front (not the argmax of
    the logits, which a near tie could flip between two runs)."""
    return np.random.default_rng(10).integers(
        0, cfg.vocab_size, size=(steps, b)).astype(np.int32)


def _tokens(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _state_leaves(state):
    """A port decode state's tensors in the reference's leaf order."""
    return [t for slot in state for key in sorted(slot)
            for t in (slot[key] if isinstance(slot[key], tuple)
                      else (slot[key],))]


# -- the reference's sharded paths, in a child with eight host devices -------------------

_REF_CHILD = r'''
import dataclasses, json, pathlib, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, str(pathlib.Path(sys.argv[3])))
import test_torch_lm_mesh as T
from repro import nn as jnn
from repro.configs.base import TrainConfig
from repro.data import DataConfig, TokenDataset
from repro.distributed.flash_decode import sharded_decode_attention
from repro.launch import steps
from repro.launch.mesh import make_host_mesh
from repro.models import lm
from repro.nn.moe_sharded import moe_apply_sharded
from repro.optim import optimizers as opt
out = pathlib.Path(sys.argv[1])
meshes = [tuple(m) for m in json.loads(sys.argv[2])]
res = {}
_, jcfg = T._moe_cfgs(8, 2, 1.25)
params = jnn.moe_init(jax.random.PRNGKey(1), jcfg)
x = jnp.asarray(T._moe_input(T.MOE_SEED))
sk = T._splitk_inputs()
for shape in meshes:
    mesh = make_host_mesh(shape, ("data", "model"))
    ba = ("data",) if shape[0] > 1 else ()
    tag = "x".join(map(str, shape))
    f = lambda p, x: moe_apply_sharded(p, x, cfg=jcfg, mesh=mesh,
                                       batch_axes=ba)
    y, aux = jax.jit(f)(params, x)
    g = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x)[0] ** 2) + f(p, x)[1],
                         argnums=(0, 1)))(params, x)
    res.update({f"moe/{tag}/y": y, f"moe/{tag}/aux": aux,
                f"moe/{tag}/gx": g[1],
                **{f"moe/{tag}/g{n}": v for n, v in g[0].items()}})
    kw = dict(axis="model", batch_axes=ba, mesh=mesh)
    insert = jax.jit(lambda q, kc, vc, lens, kn, vn: sharded_decode_attention(
        q, kc, vc, lens, k_new=kn, v_new=vn, **kw))
    kc, vc = jnp.asarray(sk["k"]), jnp.asarray(sk["v"])
    for t, n in enumerate(T.SPLITK_LENGTHS):
        lens = jnp.full((sk["k"].shape[0],), n, jnp.int32)
        o, kc, vc = insert(jnp.asarray(sk["q"][t]), kc, vc, lens,
                           jnp.asarray(sk["kn"][t]), jnp.asarray(sk["vn"][t]))
        res[f"splitk/{tag}/out{t}"] = o
    res[f"splitk/{tag}/k"], res[f"splitk/{tag}/v"] = kc, vc
    res[f"splitk/{tag}/ragged"] = jax.jit(
        lambda q, kc, vc, lens: sharded_decode_attention(q, kc, vc, lens,
                                                         **kw))(
        jnp.asarray(sk["q"][0]), kc, vc, jnp.asarray(sk["ragged"]))
# two train steps of reduced granite with the all-to-all dispatch on (2, 2)
_, gcfg = T._granite()
mesh = make_host_mesh((2, 2), ("data", "model"))
p = lm.init_lm(jax.random.PRNGKey(0), gcfg)
tc = TrainConfig(total_steps=2, warmup_steps=5)
step = jax.jit(steps.make_train_step(
    gcfg, tc, opts=steps.StepOptions(remat=False, impl="xla", moe_a2a=True),
    mesh=mesh, global_batch=4))
state = opt.adamw(3e-4)[0](p)
data = TokenDataset(DataConfig(vocab_size=gcfg.vocab_size, seq_len=16,
                               global_batch=4))
for s in range(2):
    p, state, met = step(p, state, {k: jnp.asarray(v) for k, v in
                                    data.batch_at(s).items()})
    for key in ("loss", "aux", "grad_norm"):
        res[f"train/{s}/{key}"] = met[key]
for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
    res[f"train/param{i}"] = leaf
# reduced yi-6b: an unsharded prefill, then three split-K serve steps
ycfg = T.jget_config("yi-6b").reduced()
yp = lm.init_lm(jax.random.PRNGKey(2), ycfg)
batch = T._tokens(ycfg, 4, 6, seed=9)
pre = steps.make_prefill_step(ycfg, max_seq=16, state_dtype=jnp.float32,
                              opts=steps.StepOptions(impl="xla"))(
    yp, {"tokens": jnp.asarray(batch["tokens"])})
mesh = make_host_mesh((2, 4), ("data", "model"))
serve = jax.jit(steps.make_serve_step(
    ycfg, opts=steps.StepOptions(impl="xla", sharded_decode=True),
    mesh=mesh, global_batch=4))
st = pre["state"]
for s, tok in enumerate(T._serve_tokens(ycfg)):
    logits, st = serve(yp, jnp.asarray(tok), st)
    res[f"serve/{s}"] = logits
for i, leaf in enumerate(jax.tree_util.tree_leaves(st)):
    res[f"serve/state{i}"] = leaf
np.savez(out / "ref.npz", **{k: np.asarray(v) for k, v in res.items()})
'''


@pytest.fixture(scope="module", autouse=True)
def ref_sharded(tmp_path_factory):
    """The child runs while the module's other tests do; the tests that
    read it wait for it."""
    out = tmp_path_factory.mktemp("ref_lm_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_CHILD, str(out), json.dumps(MESHES),
         str(ROOT / "tests")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_sharded):
    proc, out = ref_sharded
    _, err = proc.communicate(timeout=REF_TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(out / "ref.npz"))


# -- (1, 1) mesh, in-process against the reference ----------------------------------------

def test_sharded_decode_matches_oracle():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 8, 32)).astype(np.float32)
    kc = rng.standard_normal((3, 64, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((3, 64, 2, 32)).astype(np.float32)
    lens = np.asarray([17, 64, 1], np.int32)
    got = sharded_decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)),
                                   axis="model", batch_axes=(),
                                   mesh=_tmesh((1, 1)))
    want = jref.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)))
    _close(got, want, DECODE_TOL)


def test_sharded_decode_with_inshard_insert_matches_plain_path():
    """Six decode steps of one attention layer through the split-K decode
    on a (1, 1) mesh against the port's plain insert path and the
    reference's: outputs within 1e-5, caches equal to the plain path's."""
    from repro.configs import ModelConfig as JModelConfig
    kw = dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2,
              head_dim=8, d_ff=64, vocab_size=97)
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    key = jax.random.PRNGKey(0)
    p = jnn.attention_init(key, jcfg)
    x = np.asarray(jax.random.normal(key, (2, 6, 32)))
    attn = tattn.Attention(cfg, device="cpu")
    with torch.no_grad():
        for n in ("wq", "wk", "wv", "wo"):
            getattr(attn, n).w.copy_(torch.from_numpy(np.array(p[n]["w"])))
    c0 = jnn.init_kv_cache(jcfg, 2, 8, dtype=jnp.float32)
    c1 = tattn.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    c2 = tattn.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    sd = ((), "model", _tmesh((1, 1)))
    for t in range(6):
        y0, c0 = jnn.attention_decode(p, jnp.asarray(x[:, t:t + 1]), c0,
                                      cfg=jcfg, impl="xla")
        xt = torch.from_numpy(x[:, t:t + 1])
        y1, c1 = tattn.attention_decode(attn, xt, c1, cfg=cfg)
        y2, c2 = tattn.attention_decode(attn, xt, c2, cfg=cfg,
                                        sharded_decode=sd)
        _close(y2, y1.numpy(), DECODE_TOL)
        _close(y2, y0, DECODE_TOL)
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)
    assert torch.equal(c1.length, c2.length)
    _close(c2.k, c0.k, DECODE_TOL)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4)])
def test_moe_a2a_matches_einsum_dispatch(e, k):
    cfg, jcfg = _moe_cfgs(e, k, 8.0)
    key = jax.random.PRNGKey(e)
    p = jnn.moe_init(key, jcfg)
    x = np.asarray(jax.random.normal(key, (2, 8, 16)))
    y1, a1 = jnn.moe_apply(p, jnp.asarray(x), cfg=jcfg)
    y2, a2 = moe_apply_sharded(_moe_module(cfg, p), torch.from_numpy(x),
                               cfg=cfg, mesh=_tmesh((1, 1)), batch_axes=())
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), atol=MOE_ATOL,
                               rtol=MOE_RTOL)
    assert float(a2) == pytest.approx(float(a1), abs=AUX_TOL)


def test_moe_a2a_gradients_flow():
    """Every expert weight gets a nonzero gradient, and each gradient
    matches the reference's through its own (1, 1) ``shard_map``."""
    cfg, jcfg = _moe_cfgs(4, 2, 8.0)
    key = jax.random.PRNGKey(1)
    p = jnn.moe_init(key, jcfg)
    x = np.asarray(jax.random.normal(key, (1, 8, 16)))
    want = jax.grad(lambda p: jnp.sum(jmoe_sharded(
        p, jnp.asarray(x), cfg=jcfg, mesh=_jmesh11(),
        batch_axes=())[0] ** 2))(p)
    m = _moe_module(cfg, p)
    for w in m.parameters():
        w.requires_grad_(True)
    y, _ = moe_apply_sharded(m, torch.from_numpy(x), cfg=cfg,
                             mesh=_tmesh((1, 1)), batch_axes=())
    (y ** 2).sum().backward()
    for name in ("router", "gate_w", "up_w", "down_w"):
        g = getattr(m, name).grad
        if name != "router":
            assert bool((g != 0).any()), name
        _close(g, want[name], GRAD_TOL)


def test_moe_a2a_capacity_drops_are_finite():
    cfg, jcfg = _moe_cfgs(4, 2, 0.2)
    key = jax.random.PRNGKey(2)
    p = jnn.moe_init(key, jcfg)
    x = np.asarray(jax.random.normal(key, (2, 16, 16)))
    y, aux = moe_apply_sharded(_moe_module(cfg, p), torch.from_numpy(x),
                               cfg=cfg, mesh=_tmesh((1, 1)), batch_axes=())
    assert bool(torch.isfinite(y).all())
    want, waux = jmoe_sharded(p, jnp.asarray(x), cfg=jcfg, mesh=_jmesh11(),
                              batch_axes=())
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=MOE_ATOL,
                               rtol=MOE_RTOL)
    assert float(aux) == pytest.approx(float(waux), abs=AUX_TOL)


# -- model sizes 2 and 4, against the reference's shard_map -------------------------------

def _tag(shape):
    return "x".join(map(str, shape))


def _batch_axes(shape):
    return ("data",) if shape[0] > 1 else ()


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_a2a_matches_reference_shard_map(shape, ref):
    """Capacity factor 1.25: each shard's capacity drops pairs the
    einsum dispatch keeps, so the two differ; the port equals the
    reference's ``shard_map``: outputs, ``aux`` (data shard 0's, with the
    gradient of the data shards' mean, as the reference's) and the
    gradients of ``sum(y²) + aux``."""
    cfg, jcfg = _moe_cfgs(8, 2, 1.25)
    p = jnn.moe_init(jax.random.PRNGKey(1), jcfg)
    m = _moe_module(cfg, p)
    for w in m.parameters():
        w.requires_grad_(True)
    x = torch.from_numpy(_moe_input(MOE_SEED)).requires_grad_(True)
    y, aux = moe_apply_sharded(m, x, cfg=cfg, mesh=_tmesh(shape),
                               batch_axes=_batch_axes(shape))
    tag = f"moe/{_tag(shape)}"
    np.testing.assert_allclose(y.detach().numpy(), ref[f"{tag}/y"],
                               atol=MOE_ATOL, rtol=MOE_RTOL)
    assert float(aux) == pytest.approx(float(ref[f"{tag}/aux"]),
                                       abs=AUX_TOL)
    einsum, _ = moe_apply(m, x.detach())
    assert float((einsum - y).abs().max()) > 1e-2   # drops differ
    ((y ** 2).sum() + aux).backward()
    _close(x.grad, ref[f"{tag}/gx"], GRAD_TOL)
    for name in ("router", "gate_w", "up_w", "down_w"):
        _close(getattr(m, name).grad, ref[f"{tag}/g{name}"], GRAD_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_split_k_matches_reference_shard_map(shape, ref):
    """Five decode steps with the insert (at 15, 16, 32 and 63, then at
    64, which no shard owns) and one without, over ragged lengths:
    outputs within 1e-5, caches equal after the inserts."""
    sk = _splitk_inputs()
    kc, vc = torch.from_numpy(sk["k"]), torch.from_numpy(sk["v"])
    kw = dict(axis="model", batch_axes=_batch_axes(shape),
              mesh=_tmesh(shape))
    tag = f"splitk/{_tag(shape)}"
    for t, n in enumerate(SPLITK_LENGTHS):
        lens = torch.full((kc.shape[0],), n, dtype=torch.int32)
        out, kc2, vc2 = sharded_decode_attention(
            torch.from_numpy(sk["q"][t]), kc, vc, lens,
            k_new=torch.from_numpy(sk["kn"][t]),
            v_new=torch.from_numpy(sk["vn"][t]), **kw)
        assert kc2 is kc and vc2 is vc           # in place
        _close(out, ref[f"{tag}/out{t}"], DECODE_TOL)
    np.testing.assert_array_equal(kc.numpy(), ref[f"{tag}/k"])
    np.testing.assert_array_equal(vc.numpy(), ref[f"{tag}/v"])
    out = sharded_decode_attention(torch.from_numpy(sk["q"][0]), kc, vc,
                                   torch.from_numpy(sk["ragged"]), **kw)
    _close(out, ref[f"{tag}/ragged"], DECODE_TOL)


def test_train_step_with_a2a_matches_reference_on_2x2(ref):
    """Two steps of reduced granite (capacity factor 1.25) with
    ``moe_a2a`` on a (2, 2) mesh, global batch 4: loss, ``aux`` and
    gradient norm, then every parameter, within 1e-5."""
    from repro_torch.data import DataConfig, TokenDataset
    cfg, jcfg = _granite()
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    step = tsteps.make_train_step(
        cfg, TrainConfig(total_steps=2, warmup_steps=5),
        opts=tsteps.StepOptions(remat=False, moe_a2a=True),
        mesh=_tmesh((2, 2)), global_batch=4)
    state = topt.adamw(3e-4)[0](tsteps.trainable(model))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    for s in range(2):
        model, state, met = step(model, state, _torch(data.batch_at(s)))
        for key in ("loss", "aux", "grad_norm"):
            _close(met[key], ref[f"train/{s}/{key}"])
    for i, leaf in enumerate(jax.tree_util.tree_leaves(lm_to_jax(model))):
        _close(leaf, ref[f"train/param{i}"])


def _yi():
    cfg, jcfg = get_config("yi-6b").reduced(), jget_config("yi-6b").reduced()
    params = jlm.init_lm(jax.random.PRNGKey(2), jcfg)
    return cfg, lm_from_jax(_np_tree(params), cfg, device="cpu")


def _serve_steps(model, cfg, mesh, n=3, opts=tsteps.StepOptions()):
    batch = _tokens(cfg, 4, 6, seed=9)
    pre = tsteps.make_prefill_step(cfg, max_seq=16,
                                   state_dtype=torch.float32)(
        model, {"tokens": torch.from_numpy(batch["tokens"])})
    serve = tsteps.make_serve_step(cfg, opts=opts, mesh=mesh,
                                   global_batch=4 if mesh else 0)
    state, out = pre["state"], []
    for tok in _serve_tokens(cfg, n):
        logits, state = serve(model, torch.from_numpy(tok), state)
        out.append(logits)
    return out, state


def test_split_k_serve_step_matches_reference_on_2x4(ref):
    """Reduced yi-6b (2 kv heads; a model axis of 4 engages the split-K
    decode): three serve steps on a (2, 4) mesh, global batch 4, against
    the reference's: logits within 1e-5, the state within 1e-5."""
    cfg, model = _yi()
    logits, state = _serve_steps(model, cfg, _tmesh((2, 4)),
                                 opts=tsteps.StepOptions(sharded_decode=True))
    for s, lg in enumerate(logits):
        _close(lg, ref[f"serve/{s}"])
    for i, t in enumerate(_state_leaves(state)):
        _close(t, ref[f"serve/state{i}"])


# -- the spec rules and the production meshes -----------------------------------------------

class FakeMesh:
    """Duck-typed mesh for the port's rules, which read only its shape and
    names; the reference's get a ``jax.sharding.AbstractMesh`` of the same
    shape (no devices)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


SPEC_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16},
               "2x4": {"data": 2, "model": 4}}


@lru_cache(maxsize=None)
def _abstract(arch):
    jcfg = jget_config(arch)
    jp = jsteps.abstract_params(jcfg, dtype=jnp.float32)
    jstate = jax.eval_shape(lambda: jlm.init_decode_state(jcfg, 32, 64))
    return jp, jstate


def _flat_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("mesh", sorted(SPEC_MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_lm_spec_rules_match_reference(arch, mesh):
    """``param_specs`` (each port parameter gets its reference leaf's spec,
    the stacked period axis included), ``decode_state_specs``,
    ``input_specs_shardings`` and ``logits_spec`` give the reference's
    specs at the arch's full widths."""
    fake = FakeMesh(SPEC_MESHES[mesh])
    abstract = jax.sharding.AbstractMesh(tuple(fake.shape.values()),
                                         fake.axis_names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    jp, jstate = _abstract(arch)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jsharding.param_specs(jp, abstract),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    want = {jsharding._path_to_str(k): tuple(v) for k, v in want.items()}
    model = tlm.LM(cfg, device="meta")
    got = tsharding.param_specs(model, fake)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        path, _ = tlm.reference_leaf(name)
        assert tuple(spec) == want["/".join(path)], name
    assert set(want) == {"/".join(tlm.reference_leaf(n)[0]) for n in got}
    shape = ShapeConfig("d", "decode", 64, 32)
    jshape = JShapeConfig("d", "decode", 64, 32)
    state = tlm.init_decode_state(cfg, 32, 64, device="meta")
    got_s = tsharding.decode_state_specs(cfg, shape, fake, state)
    flat = [v for slot in got_s for key in sorted(slot) for v in (
        (slot[key],) if isinstance(slot[key], tsharding.P) else slot[key])]
    assert [tuple(v) for v in flat] == _flat_specs(
        jsharding.decode_state_specs(jcfg, jshape, abstract, jstate))
    for b in (32, 3):
        tshape = ShapeConfig("t", "train", 64, b)
        jt = JShapeConfig("t", "train", 64, b)
        got_i = tsharding.input_specs_shardings(cfg, tshape, fake)
        want_i = jsharding.input_specs_shardings(jcfg, jt, abstract)
        assert {k: tuple(v.spec) for k, v in got_i.items()} == \
            {k: tuple(v.spec) for k, v in want_i.items()}
        for decode in (False, True):
            assert tuple(tsharding.logits_spec(fake, decode, b)) == \
                tuple(jsharding.logits_spec(abstract, decode, b))
    assert tuple(tsharding.logits_spec(fake)) == \
        tuple(jsharding.logits_spec(abstract))


def test_production_meshes_match_reference(monkeypatch):
    """The reference's factories, with ``make_mesh`` recording what it is
    asked for (they need 256 and 512 devices), against the port's over
    repeated meta devices."""
    asked = []
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda shape, axes, **kw: asked.append(
                            (tuple(shape), tuple(axes))))
    from repro.configs.base import MeshConfig as JMeshConfig
    from repro_torch.configs.base import MeshConfig
    metas = ("meta",) * 512
    cases = [(lambda: jmesh.make_production_mesh(),
              lambda: tmesh.make_production_mesh(devices=metas)),
             (lambda: jmesh.make_production_mesh(multi_pod=True),
              lambda: tmesh.make_production_mesh(multi_pod=True,
                                                 devices=metas)),
             (lambda: jmesh.make_mesh_from_config(
                 JMeshConfig((2, 4), ("data", "model"))),
              lambda: tmesh.make_mesh_from_config(
                  MeshConfig((2, 4), ("data", "model")), devices=metas))]
    for jcall, tcall in cases:
        jcall()
        got = tcall()
        assert (tuple(got.devices.shape), got.axis_names) == asked[-1]
        assert {d.type for d in got.devices.flat} == {"meta"}
    assert [a[0] for a in asked] == [(16, 16), (2, 16, 16), (2, 4)]
    with pytest.raises(AssertionError):
        tmesh.make_production_mesh(devices=("cpu",) * 8)


# -- the steps on a mesh against the unsharded steps -------------------------------------

def _granite_model(cf=1.25):
    cfg, jcfg = _granite(cf)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return cfg, lambda: lm_from_jax(_np_tree(params), cfg, device="cpu")


def _train(cfg, model, mesh, steps=2,
           opts=tsteps.StepOptions(remat=False)):
    step = tsteps.make_train_step(
        cfg, TrainConfig(total_steps=steps, warmup_steps=5), opts=opts,
        mesh=mesh, global_batch=4 if mesh else 0)
    state = topt.adamw(3e-4)[0](tsteps.trainable(model))
    mets = []
    for s in range(steps):
        model, state, met = step(model, state, _torch(_tokens(cfg, 4, 16,
                                                              seed=s)))
        mets.append(met)
    return mets, dict(model.named_parameters())


def _prefill(cfg, model, mesh):
    step = tsteps.make_prefill_step(cfg, max_seq=16, mesh=mesh,
                                    state_dtype=torch.float32,
                                    global_batch=4 if mesh else 0)
    return step(model, {"tokens": torch.from_numpy(
        _tokens(cfg, 4, 16, seed=3)["tokens"])})


@pytest.mark.parametrize("opts", [
    tsteps.StepOptions(remat=False),
    tsteps.StepOptions(remat=False, moe_a2a=True),
    tsteps.StepOptions(remat=True),
    tsteps.StepOptions(remat=True, moe_a2a=True)],
    ids=["einsum", "a2a", "einsum_remat", "a2a_remat"])
def test_mesh_of_one_equals_no_mesh_bit_for_bit(opts):
    cfg, make = _granite_model()
    one = tmesh.make_host_mesh((1, 1), ("data", "model"), devices=("cpu",))
    (m0, p0), (m1, p1) = (_train(cfg, make(), mesh, opts=opts)
                          for mesh in (None, one))
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    f0, f1 = (_prefill(cfg, make(), mesh) for mesh in (None, one))
    assert torch.equal(f0["logits"], f1["logits"])
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(f0["state"]),
                                                 _state_leaves(f1["state"])))
    (l0, s0), (l1, s1) = (_serve_steps(make(), cfg, mesh)
                          for mesh in (None, one))
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(s0),
                                                 _state_leaves(s1)))


@pytest.mark.parametrize("dp", [2, 4])
def test_data_parallel_steps_match_unsharded(dp):
    """Reduced granite at capacity factor 1.25 (the einsum dispatch drops
    pairs; on a mesh it still routes the whole batch) on a (dp, 1) mesh:
    the train step's metrics and parameters, the prefill's logits and
    state and the serve steps' logits and state within 1e-5 of the
    unsharded steps."""
    cfg, make = _granite_model()
    mesh = _tmesh((dp, 1))
    (m0, p0), (m1, p1) = (_train(cfg, make(), m) for m in (None, mesh))
    for a, b in zip(m0, m1):
        for key in ("loss", "aux", "grad_norm"):
            _close(b[key], a[key].numpy())
    for k in p0:
        _close(p1[k], p0[k].detach().numpy())
    f0, f1 = (_prefill(cfg, make(), m) for m in (None, mesh))
    _close(f1["logits"], f0["logits"].numpy())
    for a, b in zip(_state_leaves(f0["state"]), _state_leaves(f1["state"])):
        _close(b, a.numpy())
    (l0, s0), (l1, s1) = (_serve_steps(make(), cfg, m)
                          for m in (None, mesh))
    for a, b in zip(l0, l1):
        _close(b, a.numpy())
    for a, b in zip(_state_leaves(s0), _state_leaves(s1)):
        _close(b, a.numpy())


@pytest.mark.parametrize("shape,split_k", [((1, 4), True), ((2, 4), True),
                                           ((1, 2), False)], ids=str)
def test_serve_step_on_a_model_axis_matches_unsharded(shape, split_k,
                                                      monkeypatch):
    """Reduced yi-6b (2 kv heads): a model axis that does not divide them
    runs the split-K decode, with no call of the ``decode_attention``
    kernel's wrapper; one that does runs it, once per layer, shard and
    step.  Logits and caches within 1e-5 of the unsharded step, the first
    layer's cache equal (its rows come from the same embeddings: the
    insert is a copy)."""
    calls = []
    real = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg, model = _yi()
    l0, s0 = _serve_steps(model, cfg, None)
    n0, calls[:] = len(calls), []
    l1, s1 = _serve_steps(model, cfg, _tmesh(shape),
                          opts=tsteps.StepOptions(sharded_decode=True))
    assert n0 == 3 * cfg.num_layers
    assert len(calls) == (0 if split_k else 3 * cfg.num_layers * shape[0])
    for a, b in zip(l0, l1):
        _close(b, a.numpy())
    for a, b in zip(_state_leaves(s0), _state_leaves(s1)):
        _close(b, a.numpy())
        assert torch.equal(a[0], b[0])


def test_trainer_over_a_mesh_of_two_matches_one():
    """``train.run`` over a ("data",) mesh of two CPU devices gives the
    losses of a mesh of one, within 1e-5."""
    cfg = get_config("yi-6b").reduced()
    tcfg = TrainConfig(total_steps=3, warmup_steps=5)
    one, two = (ttrain.run(cfg, tcfg, global_batch=4, seq_len=16,
                           device="cpu", log_every=0, devices=devs)
                for devs in (("cpu",), ("cpu",) * 2))
    _close(np.asarray(two["losses"]), np.asarray(one["losses"]))
    assert two["steps"] == one["steps"] == 3
