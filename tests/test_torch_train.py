"""Port parity: the hybrid (Jamba) LM and the trainer — ``lm_forward``,
prefill and decode, ``lm_loss`` and its gradients, the optimizer, the
schedule, the weight-decay mask, the data, ``make_train_step`` and the CLI
— against the JAX reference on weights carried across by
``repro_torch.models.convert`` and on the same numpy inputs.

The JAX side runs its ``xla`` path (the only one the reference can
differentiate: ``jax.grad`` through its Pallas kernels raises under jax
0.9.0), the port the CPU, where each kernel takes its plain version.
Tolerance 1e-5 in float32 throughout: the matrix products and reductions
sum in another order; after three AdamW steps an element whose gradient is
near zero can take a step of another size, which stays below it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import DataConfig as JDataConfig
from repro.data import TokenDataset as JTokenDataset
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.nn.ssm import MambaState
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

TOL = 1e-5
JAMBA = "jamba-v0.1-52b"
# the reduced Jamba without experts: one period of 8 (attention + 7 Mamba),
# and two periods of [attention, Mamba]
HYBRIDS = {"period8": dict(num_experts=0),
           "period2x2": dict(num_experts=0, attn_every=2, num_layers=4)}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _configs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module", params=sorted(HYBRIDS))
def hybrid(request):
    cfg, jcfg = _configs(JAMBA, **HYBRIDS[request.param])
    params = jlm.init_lm(jax.random.PRNGKey(1), jcfg)
    return cfg, jcfg, params, lm_from_jax(_np_tree(params), cfg,
                                          device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _batch(cfg, b, s, seed):
    toks = _tokens(cfg, (b, s + 1), seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- configs ----------------------------------------------------------------------------

def _as_plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("reduce", [False, True])
def test_jamba_config_copy_matches_reference(reduce):
    port, ref = get_config(JAMBA), jax_get_config(JAMBA)
    if reduce:
        port, ref = port.reduced(), ref.reduced()
    for f in dataclasses.fields(port):
        assert _as_plain(getattr(port, f.name)) == \
            _as_plain(getattr(ref, f.name)), f.name
    assert port.mamba.resolved_dt_rank(port.d_model) == \
        ref.mamba.resolved_dt_rank(ref.d_model)
    assert port.is_moe == ref.is_moe


def test_train_config_copy_matches_reference():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())


def test_layer_pattern_matches_reference(hybrid):
    cfg, jcfg, _, _ = hybrid
    assert [(s.mixer, s.mlp) for s in tlm.layer_pattern(cfg)] == \
        [(s.mixer, s.mlp) for s in jlm.layer_pattern(jcfg)]


def test_moe_slots_match_reference():
    """Jamba with its experts: MoE on every second slot of the period."""
    for reduce in (False, True):
        cfg, jcfg = get_config(JAMBA), jax_get_config(JAMBA)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        got = [(s.mixer, s.mlp) for s in tlm.layer_pattern(cfg)]
        assert got == [(s.mixer, s.mlp) for s in jlm.layer_pattern(jcfg)]
        assert [m for _, m in got] == ["swiglu", "moe"] * 4


def test_convert_round_trip_is_exact(hybrid):
    _, _, params, model = hybrid
    back = lm_to_jax(model)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, got)) == {str(p) for p, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


# -- forward, prefill, decode ---------------------------------------------------------

def test_forward_matches_reference(hybrid):
    cfg, jcfg, params, model = hybrid
    toks = _tokens(cfg, (2, 12), seed=1)
    want, want_aux = jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg,
                                                         impl="xla"))(
        params, toks)
    got, aux = tlm.lm_forward(model, torch.from_numpy(toks))
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


def _close_state(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            for a, b in zip(g[key], w[key]):
                if key == "kv" and a.dtype == torch.int32:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                else:
                    _close(a, b, tol)


def test_prefill_and_decode_match_reference(hybrid):
    cfg, jcfg, params, model = hybrid
    toks = _tokens(cfg, (2, 10), seed=2)
    want, jstate, _ = jlm.lm_prefill(params, toks[:, :7], jcfg, max_seq=10,
                                     impl="xla", state_dtype=jnp.float32)
    got, state, _ = tlm.lm_prefill(model, torch.from_numpy(toks[:, :7]),
                                   max_seq=10, state_dtype=torch.float32)
    _close(got, want)
    _close_state(state, jstate)
    assert isinstance(state[1]["mamba"], MambaState)
    step = jax.jit(lambda p, t, s: jlm.lm_decode_step(p, t, s, jcfg,
                                                      impl="xla"))
    for i in range(7, 10):
        want, jstate = step(params, toks[:, i], jstate)
        got, state = tlm.lm_decode_step(model, torch.from_numpy(toks[:, i]),
                                        state)
        _close(got, want)
        _close_state(state, jstate)


def test_init_decode_state_matches_reference_layout(hybrid):
    cfg, jcfg, _, _ = hybrid
    want = jlm.init_decode_state(jcfg, 2, 16, dtype=jnp.float32)
    got = tlm.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                device="cpu")
    _close_state(got, want)
    assert [a.nbytes for slot in got for a in next(iter(slot.values()))] == \
        [np.asarray(a).nbytes for slot in want
         for a in next(iter(slot.values()))]


def test_prefill_then_decode_matches_full_forward(hybrid):
    """The reference's consistency check: prefill + decode, and decode
    from a cold state, continue the full forward."""
    cfg, _, _, model = hybrid
    toks = torch.from_numpy(_tokens(cfg, (2, 9), seed=3))
    full, _ = tlm.lm_forward(model, toks)
    v = cfg.vocab_size
    pre, state, _ = tlm.lm_prefill(model, toks[:, :6], max_seq=9,
                                   state_dtype=torch.float32)
    _close(pre[:, -1, :v], full[:, 5, :v].detach().numpy())
    for t in range(6, 9):
        nxt, state = tlm.lm_decode_step(model, toks[:, t], state)
        _close(nxt[:, :v], full[:, t, :v].detach().numpy())
    state = tlm.init_decode_state(cfg, 2, 9, dtype=torch.float32,
                                  device="cpu")
    for t in range(9):
        nxt, state = tlm.lm_decode_step(model, toks[:, t], state)
        _close(nxt[:, :v], full[:, t, :v].detach().numpy())


# -- loss and gradients ------------------------------------------------------------------

def _leaf_close(got, want, tol=TOL):
    """A gradient leaf: |got - want| <= tol * max|want| + tol * |want|.
    The absolute term scales with the leaf, so a sum with cancellation
    inside a large leaf (the embedding gathers scattered rows, summed in
    an order that depends on the machine's BLAS) is held to float32 noise
    of the leaf's size, and a leaf near 1 keeps the plain 1e-5."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _grad_leaves(model, grads, paths):
    """The port's gradients in the reference's leaf layout."""
    by_name = dict(zip(tsteps.trainable(model), grads))
    out = {}
    for path in paths:
        name = _port_names(path, len(model.layers))
        out[path] = np.stack([by_name[n].detach().numpy() for n in name]) \
            if isinstance(name, list) else by_name[name].detach().numpy()
    return out


@pytest.mark.parametrize("loss_chunk", [0, 4])
def test_loss_and_gradients_match_reference(hybrid, loss_chunk):
    cfg, jcfg, params, model = hybrid
    batch = _batch(cfg, 2, 8, seed=4)
    (want, wmet), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, jcfg, impl="xla",
                                 loss_chunk=loss_chunk),
        has_aux=True))(params, batch)
    named = tsteps.trainable(model)
    total, met = tlm.lm_loss(model, _torch_batch(batch),
                             loss_chunk=loss_chunk)
    grads = torch.autograd.grad(total, list(named.values()))
    _close(total, want)
    for key in ("loss", "aux", "perplexity"):
        _close(met[key], wmet[key])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(_np_tree(wgrads)))
    paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(
        lm_to_jax(model))]            # the same layout for the gradients
    for path, got in _grad_leaves(model, grads, paths).items():
        _leaf_close(got, flat_want[path])


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


@pytest.mark.parametrize("loss_chunk", [0, 4])
def test_float32_gradients_sit_on_the_float64_result(hybrid, loss_chunk,
                                                     monkeypatch):
    """Both sides' loss gradients again in float64 (the reference under
    ``jax.enable_x64``, the port's weights in ``torch.float64``, the same
    numpy weights and batch), as the truth the float32 gradients are held
    to.  Both codes pin their reductions to float32 by name
    (``astype(jnp.float32)``, ``.float()``), so for this evaluation those
    names are rebound to float64.

    The two float64 gradients agree to 1e-6 of each leaf's size; every
    float32 gradient leaf of the port sits within the leaf-scaled 1e-5 of
    the truth; and the port's float32 ``embed.table`` gradient, and all of
    its gradients together, are no farther from the truth (root mean
    square) than twice the reference's own float32 gradients are.  So the
    leaf-scaled tolerance of the float32 comparison sits on a correct
    gradient: the gap it allows is the float32 summation order of both
    sides, not a fault of the port."""
    cfg, jcfg, params, model = hybrid
    batch = _batch(cfg, 2, 8, seed=4)
    np_params = _np_tree(params)

    def ref_grads(p):
        return jax.grad(lambda p, b: jlm.lm_loss(
            p, b, jcfg, impl="xla", loss_chunk=loss_chunk)[0])(p, batch)

    want32 = dict(jax.tree_util.tree_leaves_with_path(
        _np_tree(jax.jit(ref_grads)(params))))
    leaves = list(tsteps.trainable(model).values())
    total, _ = tlm.lm_loss(model, _torch_batch(batch), loss_chunk=loss_chunk)
    paths = list(want32)
    got32 = _grad_leaves(model, torch.autograd.grad(total, leaves), paths)

    model64 = lm_from_jax(np_params, cfg, device="cpu").double()
    with jax.enable_x64(True):
        monkeypatch.setattr(jnp, "float32", jnp.float64)
        truth = dict(jax.tree_util.tree_leaves_with_path(_np_tree(ref_grads(
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                   np_params)))))
        monkeypatch.setattr(torch, "float32", torch.float64)
        monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
        leaves = list(tsteps.trainable(model64).values())
        total64, _ = tlm.lm_loss(model64, _torch_batch(batch),
                                 loss_chunk=loss_chunk)
        got64 = _grad_leaves(model64, torch.autograd.grad(total64, leaves),
                             paths)
        monkeypatch.undo()
    assert total64.dtype == torch.float64
    p_sq = r_sq = 0.0
    for path in paths:
        t = truth[path]
        assert t.dtype == np.float64 and got64[path].dtype == np.float64
        scale = float(np.abs(t).max())
        assert float(np.abs(got64[path] - t).max()) <= 1e-6 * scale, path
        _leaf_close(got32[path], t)
        p_sq += float(np.sum(np.square(got32[path] - t)))
        r_sq += float(np.sum(np.square(want32[path] - t)))
    embed = next(p for p in paths if jax.tree_util.keystr(p)
                 == "['embed']['table']")
    assert _rms(got32[embed] - truth[embed]) <= \
        2 * _rms(want32[embed] - truth[embed])
    assert p_sq ** 0.5 <= 2 * r_sq ** 0.5


def _port_names(path, periods):
    """The port's parameter name(s) of a reference leaf path: a stacked
    ``layers`` leaf has one per period."""
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    if keys[0] == "layers":
        return [".".join(["layers", str(p)] + keys[1:])
                for p in range(periods)]
    return ".".join(keys)


def test_padded_vocab_logits_are_masked_and_skipped_by_the_loss():
    cfg, jcfg = _configs("qwen1.5-4b")
    params = jlm.init_lm(jax.random.PRNGKey(2), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    batch = _batch(cfg, 2, 6, seed=5)
    want, _ = jlm.lm_loss(params, batch, jcfg, impl="xla")
    got, _ = tlm.lm_loss(model, _torch_batch(batch))
    _close(got, want)


# -- optimizer, schedule, mask, data ---------------------------------------------------

def test_wd_mask_matches_reference_leaf_for_leaf(hybrid):
    _, _, params, model = hybrid
    want = dict(jax.tree_util.tree_leaves_with_path(jsteps._wd_mask(params)))
    got = tsteps._wd_mask(dict(model.named_parameters()))
    seen = set()
    for path, flag in want.items():
        names = _port_names(path, len(model.layers))
        for name in names if isinstance(names, list) else [names]:
            assert got[name] == bool(flag), name
            seen.add(name)
    assert seen == set(got)
    # the stacked period axis makes the reference decay a layer's vectors
    assert got["layers.0.1.mamba.d"] and got["layers.0.1.mamba.conv_b"]
    assert not got["layers.0.1.mamba.dt_proj.b"]
    assert got["layers.0.1.mamba.a_log"] and got["layers.0.1.mamba.conv_w"]
    assert not got["embed.table"] and not got["final_norm.scale"]


@pytest.mark.parametrize("name,args", [
    ("cosine_decay", (3e-4, 5, 40)), ("cosine_decay", (1e-3, 100, 1000)),
    ("linear_warmup", (3e-4, 7)), ("constant", (2e-4,)),
    ("exponential_decay", (1e-3, 0.5, 10))])
def test_schedule_matches_reference_per_step(name, args):
    """float32 as the reference computes it; jnp's and numpy's float32
    cos and pow may round one ulp apart, and XLA flushes float32
    subnormals (below 1.18e-38) to zero where numpy keeps them."""
    want_fn, got_fn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    tiny = float(np.finfo(np.float32).tiny)
    for step in list(range(0, 60)) + [99, 100, 101, 500, 999, 1000, 1200]:
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got_fn(step), want, rtol=1e-6, atol=tiny)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32) * 1e-3,
            "c": rng.standard_normal((2, 2, 2)).astype(np.float32) * 10}


@pytest.mark.parametrize("kind", ["adamw", "adamw_wd", "sgd", "sgd_momentum"])
def test_optimizer_steps_match_reference(kind):
    sched = (3e-3, 2, 10)
    if kind.startswith("adamw"):
        kw = dict(weight_decay=0.1, wd_mask=lambda p: {k: k != "b" for k in p}) \
            if kind == "adamw_wd" else {}
        jinit, jupd = jopt.adamw(jsched.cosine_decay(*sched), **kw)
        tinit, tupd = topt.adamw(tsched.cosine_decay(*sched), **kw)
    else:
        m = 0.9 if kind == "sgd_momentum" else 0.0
        jinit, jupd = jopt.sgd(jsched.cosine_decay(*sched), momentum=m)
        tinit, tupd = topt.sgd(tsched.cosine_decay(*sched), momentum=m)
    jp = _tree(0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    js, ts = jinit(jp), tinit(tp)
    for step in range(4):
        g = _tree(step + 1)
        jg, norm = jopt.clip_by_global_norm(g, 1.0)
        tg, tnorm = topt.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, 1.0)
        _close(tnorm, norm)
        ju, js = jupd(jg, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = tupd(tg, ts, tp)
        tp = topt.apply_updates(tp, tu)
        assert ts.step == int(js.step)
        for k in jp:
            _close(tu[k], ju[k], 1e-7)
            _close(tp[k], jp[k], 1e-6)


def test_clip_divides_by_the_floored_norm():
    g = {"x": torch.zeros(3)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == 0.0 and not clipped["x"].any()


def test_token_batches_are_bit_identical():
    for cfg in (DataConfig(vocab_size=128, seq_len=16, global_batch=4,
                           seed=3),
                DataConfig(vocab_size=65_536, seq_len=128, global_batch=8,
                           host_index=1, host_count=2)):
        want = JTokenDataset(JDataConfig(**dataclasses.asdict(cfg)))
        got = TokenDataset(cfg)
        for step in (0, 1, 17):
            for key, arr in want.batch_at(step).items():
                np.testing.assert_array_equal(got.batch_at(step)[key], arr)
                assert got.batch_at(step)[key].dtype == arr.dtype


# -- the train step ------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw,opts", [
    (JAMBA, HYBRIDS["period8"], {}),
    (JAMBA, HYBRIDS["period2x2"], dict(loss_chunk=8)),
    ("yi-6b", {}, dict(microbatch=2)),
])
def test_three_train_steps_match_reference(arch, kw, opts):
    cfg, jcfg = _configs(arch, **kw)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    tc = dict(total_steps=3, warmup_steps=5)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JTrainConfig(**tc),
        opts=jsteps.StepOptions(remat=False, impl="xla", **opts)))
    tstep = tsteps.make_train_step(cfg, TrainConfig(**tc),
                                   opts=tsteps.StepOptions(remat=False,
                                                           **opts))
    jstate = jopt.adamw(3e-4)[0](params)
    tstate = topt.adamw(3e-4)[0](tsteps.trainable(model))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    for step in range(3):
        batch = data.batch_at(step)
        params, jstate, jmet = jstep(params, jstate,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        model, tstate, tmet = tstep(model, tstate, _torch_batch(batch))
        for key in ("loss", "grad_norm", "perplexity"):
            _close(tmet[key], jmet[key])
    got = lm_to_jax(model)
    for (path, want), leaf in zip(jax.tree_util.tree_leaves_with_path(params),
                                  jax.tree_util.tree_leaves(got)):
        _close(leaf, want)
    assert tstate.step == int(jstate.step) == 3
    for key in ("mu", "nu"):
        moments = dict(getattr(tstate, key))
        for path, want in jax.tree_util.tree_leaves_with_path(
                getattr(jstate, key)):
            names = _port_names(path, len(model.layers))
            leaf = (np.stack([moments[n].numpy() for n in names])
                    if isinstance(names, list) else moments[names].numpy())
            _close(leaf, want)


def test_step_marks_its_phases_in_order():
    cfg, _ = _configs("yi-6b")
    model = tlm.init_lm(cfg, seed=0, device="cpu")
    step = tsteps.make_train_step(cfg, TrainConfig(total_steps=2),
                                  opts=tsteps.StepOptions(microbatch=2))
    state = topt.adamw(3e-4)[0](tsteps.trainable(model))
    seen = []
    batch = _torch_batch(_batch(cfg, 4, 8, seed=6))
    step(model, state, batch, mark=seen.append)
    assert seen == ["forward", "backward"] * 2 + ["optimizer", "end"]


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_unported_step_levers_raise(arch):
    """The mesh levers of the train step, once refused, now run: two
    steps with ``moe_a2a`` on a (1, 1) ("data", "model") mesh with the
    global batch, against the reference's on its own (1, 1) mesh (granite
    through the all-to-all dispatch at capacity factor 1.25; yi-6b has no
    experts, so the lever leaves the einsum path, as in the
    reference), within the step's 1e-5."""
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro_torch.launch.mesh import make_host_mesh
    cfg, jcfg = _configs(arch, **({"moe_capacity_factor": 1.25}
                                  if arch != "yi-6b" else {}))
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    tc = dict(total_steps=2, warmup_steps=5)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JTrainConfig(**tc),
        opts=jsteps.StepOptions(remat=False, impl="xla", moe_a2a=True),
        mesh=jmake_host_mesh((1, 1), ("data", "model")), global_batch=4))
    tstep = tsteps.make_train_step(
        cfg, TrainConfig(**tc),
        opts=tsteps.StepOptions(remat=False, moe_a2a=True),
        mesh=make_host_mesh((1, 1), ("data", "model"), devices=("cpu",)),
        global_batch=4)
    jstate = jopt.adamw(3e-4)[0](params)
    tstate = topt.adamw(3e-4)[0](tsteps.trainable(model))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    for step in range(2):
        batch = data.batch_at(step)
        params, jstate, jmet = jstep(params, jstate,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        model, tstate, tmet = tstep(model, tstate, _torch_batch(batch))
        for key in ("loss", "aux", "grad_norm"):
            _close(tmet[key], jmet[key])
    got = lm_to_jax(model)
    for want, leaf in zip(jax.tree_util.tree_leaves(params),
                          jax.tree_util.tree_leaves(got)):
        _close(leaf, want)


# -- the CLI ---------------------------------------------------------------------------------

def test_cli_trains_the_reduced_config_on_the_cpu(capsys):
    out = ttrain.main(["--steps", "3", "--device", "cpu", "--log-every",
                       "1"])
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert out["first_loss"] == out["losses"][0]
    assert "phase_ms" not in out            # no device times off the card
    text = capsys.readouterr().out
    assert text.count("[train] step") == 3 and "[train] done" in text


def test_cli_matches_run_on_the_same_weights():
    """``main`` is ``run`` on the reduced config with the CLI's AdamW and
    cosine settings."""
    out = ttrain.main(["--steps", "2", "--device", "cpu", "--seed", "4",
                       "--log-every", "0", "--microbatch", "2"])
    cfg = get_config("yi-6b").reduced()
    tcfg = TrainConfig(total_steps=2, warmup_steps=5, microbatch=2, seed=4)
    again = ttrain.run(cfg, tcfg, device="cpu", log_every=0,
                       opts=tsteps.StepOptions(microbatch=2))
    assert again["losses"] == out["losses"]


def test_cli_trains_jamba_with_its_experts():
    """The reduced Jamba keeps its experts (moe_every=2), as the
    reference's CLI trains it; its loss carries the MoE aux loss."""
    out = ttrain.main(["--arch", JAMBA, "--steps", "2", "--device", "cpu",
                       "--global-batch", "2", "--seq-len", "16",
                       "--log-every", "0"])
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    assert all(a > 0 for a in out["aux"])


def test_cli_grad_compression_changes_no_number():
    """The reference's CLI passes its step no error-feedback state, so
    ``--grad-compression`` trains exactly as without it."""
    args = ["--steps", "2", "--device", "cpu", "--log-every", "0"]
    assert ttrain.main(args + ["--grad-compression"])["losses"] == \
        ttrain.main(args)["losses"]
