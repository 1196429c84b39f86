"""Port parity: the MoE family — ``nn/moe.moe_apply`` (routing, capacity
drops, ties, the aux loss, gradients), the MoE LMs (reduced
granite-moe-1b-a400m, qwen3-moe-235b-a22b and Jamba with its experts:
forward, loss, prefill, decode), their train steps with and without int8
error-feedback gradient compression, and the trainer's CLI — against the
JAX reference on weights carried across by ``repro_torch.models.convert``
and on the same numpy inputs.

The JAX side runs its ``xla`` path, the port the CPU.  Tolerances: 1e-6
for one MoE layer (float32; the expert products sum in another order),
1e-5 for whole models and train steps (as ``test_torch_train.py``), 1e-5
of each leaf's scale for gradients; integer decisions (expert ids, the
capacity drops) and the int8 payloads exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.nn import moe as tmoe
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt

MOE_TOL = 1e-6
TOL = 1e-5
STEPS_TOL = 1e-4
# a residual is its gradient minus the gradient's quantization, so it
# carries the gradient's own rounding: up to 1.2e-5 of the leaf's scale
# on the reduced Jamba's dt_proj bias, whose gradient sums over batch and
# time
RESIDUAL_TOL = 2e-5
GRANITE, QWEN3, JAMBA = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
                         "jamba-v0.1-52b")
ARCHS = [GRANITE, QWEN3, JAMBA]
# (d, E, k, f, tokens) of one MoE layer: the reduced configs' widths, and
# granite's 32 experts top-8 at a narrow d
LAYERS = {"reduced": (64, 4, 2, 64, (2, 12)),
          "granite-experts": (96, 32, 8, 48, (4, 16))}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _leaf_close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


# -- configs ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, QWEN3])
@pytest.mark.parametrize("reduce", [False, True])
def test_config_copy_matches_reference(arch, reduce):
    port, ref = get_config(arch), jax_get_config(arch)
    if reduce:
        port, ref = port.reduced(), ref.reduced()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.padded_vocab() == ref.padded_vocab()
    assert port.is_moe and ref.is_moe


def test_granite_at_full_width():
    """1.335 B parameters, the vocab padded to 49 408, GQA 2 and head 64
    (inside decode_attention's limits)."""
    cfg = get_config(GRANITE)
    assert cfg.padded_vocab() == 49_408
    assert cfg.num_heads // cfg.num_kv_heads == 2
    assert cfg.resolved_head_dim == 64
    with torch.device("meta"):
        model = tlm.LM(cfg)
    n = sum(p.numel() for p in model.parameters())
    # per layer: attention 3 145 728, two norms 2048, router 32 768,
    # experts 3 x 32 x 1024 x 512; embedding 49 408 x 1024; final norm
    assert n == 24 * (3_145_728 + 2_048 + 32_768 + 50_331_648) \
        + 50_593_792 + 1_024 == 1_334_887_424
    assert sum(p.numel() for name, p in model.named_parameters()
               if ".moe." in name) == 24 * (1024 * 32 + 3 * 32 * 1024 * 512)


# -- one MoE layer ---------------------------------------------------------------------

def _layer(name, **kw):
    d, e, k, f, _ = LAYERS[name]
    fields = dict(num_layers=2, d_model=d, num_heads=4, num_kv_heads=4,
                  d_ff=2 * f, num_experts=e, experts_per_token=k,
                  moe_d_ff=f, **kw)
    jcfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    params = jmoe.moe_init(jax.random.PRNGKey(e), jcfg)
    module = tmoe.MoE(cfg, device="cpu")
    with torch.no_grad():
        for key in ("router", "gate_w", "up_w", "down_w"):
            getattr(module, key).copy_(torch.from_numpy(
                np.array(params[key])))
    return jcfg, params, module


def _inputs(name, seed, zero_rows=()):
    d = LAYERS[name][0]
    x = np.random.default_rng(seed).standard_normal(
        LAYERS[name][4] + (d,)).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


def _reference_routing(params, x, k, e, capacity):
    """The reference's ids (``jax.lax.top_k``) and, per (token, slot), its
    keep decision, recomputed from them with numpy as its code does."""
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    _, ids = jax.lax.top_k(jax.nn.softmax(xf @ params["router"], axis=-1), k)
    ids = np.asarray(ids)
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(e), side="left")
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    return ids, (pos < capacity).reshape(ids.shape)


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("capacity_factor", [None, 0.1])
def test_moe_apply_matches_reference(name, capacity_factor):
    """y, aux, the routing ids and the drop set; 0.1 drops (as
    ``tests/test_nn.py``), and the all-zero row ties every expert."""
    jcfg, params, module = _layer(name)
    x = _inputs(name, seed=1, zero_rows=[(0, 3), (1, 0)])
    want, want_aux = jmoe.moe_apply(params, jnp.asarray(x), cfg=jcfg,
                                    capacity_factor=capacity_factor)
    got, aux = tmoe.moe_apply(module, torch.from_numpy(x),
                              capacity_factor=capacity_factor)
    _close(got, want, MOE_TOL)
    _close(aux, want_aux, MOE_TOL)

    t = x.shape[0] * x.shape[1]
    cap = tmoe.capacity(module, t, capacity_factor)
    cf = jcfg.moe_capacity_factor if capacity_factor is None \
        else capacity_factor
    assert cap == int(max(jcfg.experts_per_token,
                          cf * t * jcfg.experts_per_token
                          / jcfg.num_experts))
    r = tmoe.route(module, torch.from_numpy(x).reshape(t, -1), cap)
    ids, keep = _reference_routing(params, x, jcfg.experts_per_token,
                                   jcfg.num_experts, cap)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    got_keep = np.empty(t * module.k, bool)
    got_keep[r.order.numpy()] = r.keep.numpy()
    np.testing.assert_array_equal(got_keep.reshape(ids.shape), keep)
    if capacity_factor is not None:
        assert not keep.all()                  # the small capacity drops
    # equal probabilities: the lower expert index first, as lax.top_k
    np.testing.assert_array_equal(ids[3], np.arange(module.k))
    np.testing.assert_array_equal(r.ids[3].numpy(), np.arange(module.k))


def test_moe_apply_gradients_match_reference():
    """d(sum(y * w) + aux) for every parameter and the input, against
    ``jax.grad`` of the reference, with drops."""
    name = "granite-experts"
    jcfg, params, module = _layer(name)
    x = _inputs(name, seed=2)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, cfg=jcfg, capacity_factor=0.5)
        return jnp.sum(y * w) + aux

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: getattr(module, k).requires_grad_(True)
              for k in ("router", "gate_w", "up_w", "down_w")}
    y, aux = tmoe.moe_apply(module, xt, capacity_factor=0.5)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                              [xt] + list(leaves.values()))
    _leaf_close(got[0].numpy(), gx)
    for g, key in zip(got[1:], leaves):
        _leaf_close(g.numpy(), gp[key])


def test_moe_init_draws_the_reference_scales():
    cfg = get_config(GRANITE).reduced()
    module = tmoe.MoE(dataclasses.replace(cfg, d_model=256, moe_d_ff=128,
                                          num_experts=16), device="cpu")
    module.reset_parameters(torch.Generator().manual_seed(0))
    d, f, layers = 256, 128, cfg.num_layers
    for key, std in (("router", d ** -0.5), ("gate_w", d ** -0.5),
                     ("up_w", d ** -0.5),
                     ("down_w", f ** -0.5 / (2 * layers) ** 0.5)):
        got = float(getattr(module, key).std())
        assert abs(got - std) <= 0.02 * std, key


# -- whole models -----------------------------------------------------------------------

def _configs(arch):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


@pytest.fixture(scope="module", params=ARCHS)
def moe_lm(request):
    cfg, jcfg = _configs(request.param)
    params = jlm.init_lm(jax.random.PRNGKey(ARCHS.index(request.param)),
                         jcfg)
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


def test_convert_round_trip_is_exact(moe_lm):
    _, _, params, model = moe_lm
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_to_jax(model)))
    assert set(map(str, got)) == {str(p) for p, _ in want}
    assert any("moe" in str(p) for p, _ in want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_forward_and_loss_match_reference(moe_lm):
    cfg, jcfg, params, model = moe_lm
    batch = _batch(cfg, 2, 12, seed=1)
    want, want_aux = jax.jit(lambda p, t: jlm.lm_forward(
        p, t, jcfg, impl="xla"))(params, batch["tokens"])
    got, aux = tlm.lm_forward(model, torch.from_numpy(batch["tokens"]))
    _close(got, want)
    _close(aux, want_aux)
    assert float(aux) > 0
    jtotal, jmet = jlm.lm_loss(params, batch, jcfg, impl="xla")
    total, met = tlm.lm_loss(model, _torch_batch(batch))
    _close(total, jtotal)
    for key in ("loss", "aux", "perplexity"):
        _close(met[key], jmet[key])


def test_loss_gradients_match_reference(moe_lm):
    """Every gradient of ``lm_loss`` (the aux loss included) against
    ``jax.grad``, within 1e-5 of each leaf's scale."""
    cfg, jcfg, params, model = moe_lm
    batch = _batch(cfg, 2, 8, seed=4)
    want = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(
        p, b, jcfg, impl="xla")[0]))(params, batch)
    named = tsteps.trainable(model)
    total, _ = tlm.lm_loss(model, _torch_batch(batch))
    got = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    periods = len(model.layers)
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(want)):
        _leaf_close(_by_reference_leaf(got, path, periods), leaf)


def _close_state(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            for a, b in zip(g[key], w[key]):
                if a.dtype == torch.int32:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                else:
                    _close(a, b)


def test_prefill_and_decode_match_reference(moe_lm):
    cfg, jcfg, params, model = moe_lm
    toks = _tokens(cfg, (2, 10), seed=2)
    want, jstate, _ = jlm.lm_prefill(params, toks[:, :7], jcfg, max_seq=10,
                                     impl="xla", state_dtype=jnp.float32)
    got, state, _ = tlm.lm_prefill(model, torch.from_numpy(toks[:, :7]),
                                   max_seq=10, state_dtype=torch.float32)
    _close(got, want)
    _close_state(state, jstate)
    step = jax.jit(lambda p, t, s: jlm.lm_decode_step(p, t, s, jcfg,
                                                      impl="xla"))
    for i in range(7, 10):
        want, jstate = step(params, toks[:, i], jstate)
        got, state = tlm.lm_decode_step(model, torch.from_numpy(toks[:, i]),
                                        state)
        _close(got, want)
        _close_state(state, jstate)


def test_wd_mask_matches_reference_leaf_for_leaf(moe_lm):
    """Every MoE leaf is decayed, the router too: the reference reads
    ranks with the stacked period axis."""
    _, _, params, model = moe_lm
    want = dict(jax.tree_util.tree_leaves_with_path(jsteps._wd_mask(params)))
    got = tsteps._wd_mask(dict(model.named_parameters()))
    for path, flag in want.items():
        for name in _port_names(path, len(model.layers)):
            assert got[name] == flag, name
    assert all(got[n] for n in got if ".moe." in n)


# -- the train step -------------------------------------------------------------------

def _port_names(path, periods):
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    if keys[0] == "layers":
        return [".".join(["layers", str(p)] + keys[1:])
                for p in range(periods)]
    return [".".join(keys)]


def _by_reference_leaf(named, path, periods):
    arrs = [named[n].detach().numpy() for n in _port_names(path, periods)]
    return np.stack(arrs) if path[0].key == "layers" else arrs[0]


def _port_dict(tree, periods):
    """A reference tree shaped like the params as the port's {name:
    tensor} dict, the stacked layer leaves split by period."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        leaf = np.array(leaf)
        names = _port_names(path, periods)
        rows = leaf if path[0].key == "layers" else [leaf]
        out.update((n, torch.from_numpy(np.array(r)))
                   for n, r in zip(names, rows))
    return out


def _train_pair(arch, compress):
    cfg, jcfg = _configs(arch)
    params = jlm.init_lm(jax.random.PRNGKey(5), jcfg)
    tc = dict(total_steps=6, warmup_steps=5)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JTrainConfig(**tc), opts=jsteps.StepOptions(
            remat=False, impl="xla", grad_compression=compress)))
    tstep = tsteps.make_train_step(cfg, TrainConfig(**tc), opts=tsteps.
                                   StepOptions(remat=False,
                                               grad_compression=compress))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    return cfg, params, jstep, tstep, data


@pytest.mark.parametrize("arch", [GRANITE, JAMBA])
def test_six_train_steps_match_reference(arch):
    """Six ``make_train_step`` steps on the same weights and batches: every
    step's metrics within 1e-5; the parameters and AdamW moments after
    six steps within ``STEPS_TOL`` of each leaf's scale (the gap grows
    with the steps: three hold 1e-5 in ``test_torch_train.py``; Adam steps
    an element whose gradient is at rounding level by a size that rounding
    decides)."""
    cfg, params, jstep, tstep, data = _train_pair(arch, False)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    jstate = jopt.adamw(3e-4)[0](params)
    named = tsteps.trainable(model)
    tstate = topt.adamw(3e-4)[0](named)
    for step in range(6):
        batch = data.batch_at(step)
        params, jstate, jmet = jstep(params, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        model, tstate, tmet = tstep(model, tstate, _torch_batch(batch))
        for key in ("loss", "aux", "grad_norm", "perplexity"):
            _close(tmet[key], jmet[key])
    periods = len(model.layers)
    assert tstate.step == int(jstate.step) == 6
    for got, want_tree in ((named, params), (tstate.mu, jstate.mu),
                           (tstate.nu, jstate.nu)):
        for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
            _leaf_close(_by_reference_leaf(got, path, periods), want,
                        STEPS_TOL)


@pytest.mark.parametrize("arch", [GRANITE, JAMBA])
def test_six_compressed_train_steps_match_reference(arch, monkeypatch):
    """Six steps with int8 error-feedback compression (an ``ef_state``
    given, so the step compresses and returns it), each from the
    reference's state of the step before (parameters, moments and
    residuals copied into the port): the metrics within 1e-5, and the new
    residuals, parameters and moments within 1e-5 of each leaf's scale.

    The two sides' gradients differ at rounding level, so an element
    whose ``g / scale`` lies at a .5 boundary may quantize one step apart
    (the payload itself is bit-exact on equal inputs:
    ``test_compress_grads_is_bit_exact_over_steps``).  Such elements are
    counted, must sit within 1e-3 of the boundary on the port's side, and
    are left out of the comparison of that step's update.  The ratios
    ``g / scale`` are read from the gradients the step itself quantizes
    (its call of ``compress_grads``), not computed a second time."""
    cfg, params, jstep, tstep, data = _train_pair(arch, True)
    jstate = jopt.adamw(3e-4)[0](params)
    jef = jcomp.init_error_feedback(params)
    periods = cfg.num_layers // len(tlm.layer_pattern(cfg))
    flips = 0
    quantized = {}
    compress = tsteps.compress_grads

    def seen(grads, ef, groups=None):
        # the port's quantization inputs, as compress_grads forms them
        quantized["xs"] = {k: g.detach().float() + ef.residual[k]
                           for k, g in grads.items()}
        return compress(grads, ef, groups)

    monkeypatch.setattr(tsteps, "compress_grads", seen)
    for step in range(6):
        model = lm_from_jax(_np_tree(params), cfg, device="cpu")
        named = tsteps.trainable(model)
        tstate = topt.OptState(int(jstate.step),
                               _port_dict(jstate.mu, periods),
                               _port_dict(jstate.nu, periods))
        tef = tcomp.EFState(_port_dict(jef.residual, periods))
        batch = data.batch_at(step)
        params, jstate, jmet, jef = jstep(params, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()}, jef)
        model, tstate, tmet, tef = tstep(model, tstate, _torch_batch(batch),
                                         tef)
        # the port's quantization inputs g / scale, from its own gradients
        xs = quantized.pop("xs")
        assert list(xs) == list(named)
        ratio, scale = {}, {}
        for names in tsteps._leaf_groups(xs):     # one scale a leaf
            amax = max(float(xs[n].abs().max()) for n in names)
            for n in names:
                scale[n] = amax / 127
                ratio[n] = xs[n].numpy() / scale[n]
        for key in ("loss", "aux", "grad_norm", "perplexity"):
            _close(tmet[key], jmet[key])
        want_r = _port_dict(jef.residual, periods)
        want_p = _port_dict(params, periods)
        want_m = {f: _port_dict(getattr(jstate, f), periods)
                  for f in ("mu", "nu")}
        for name, r in tef.residual.items():
            flipped = np.abs(r.numpy() - want_r[name].numpy()) \
                > 0.5 * scale[name]
            if flipped.any():
                frac = np.abs(ratio[name][flipped]) % 1.0
                assert np.abs(frac - 0.5).max() <= 1e-3, name
                flips += int(flipped.sum())
            # a residual carries its gradient's rounding: held at
            # RESIDUAL_TOL of the gradient's scale, 127 quanta
            np.testing.assert_allclose(
                r.numpy()[~flipped], want_r[name].numpy()[~flipped],
                rtol=0, atol=RESIDUAL_TOL * 127 * scale[name],
                err_msg=name)
            for what, got, want in (
                    ("param", named[name], want_p[name]),
                    ("mu", tstate.mu[name], want_m["mu"][name]),
                    ("nu", tstate.nu[name], want_m["nu"][name])):
                got, want = got.detach().numpy(), want.numpy()
                np.testing.assert_allclose(
                    got[~flipped], want[~flipped], rtol=TOL,
                    atol=TOL * float(np.abs(want).max()),
                    err_msg=f"{what} {name} step {step}")
    # near-ties are rare: at most one element in 10^4 a step
    assert flips <= 6 * 1e-4 * sum(p.numel() for p in named.values())


# -- gradient compression -------------------------------------------------------------

def test_quantize_int8_is_bit_exact():
    """Payload and scale equal bit for bit, ties at .5 rounded to even,
    the all-zero tensor and a tensor at the clip edge included."""
    rng = np.random.default_rng(7)
    cases = [rng.standard_normal((64, 33)).astype(np.float32) * 1e-3,
             np.zeros((5,), np.float32),
             np.array([127.0, -127.0, 63.5, -0.5, 0.5, 1.5, 2.5],
                      np.float32),
             (rng.standard_normal(4096) * 3.0).astype(np.float32)]
    for x in cases:
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compress_grads_is_bit_exact_over_steps():
    """Three steps of error feedback: the dequantized gradients and the
    residuals bit for bit."""
    rng = np.random.default_rng(8)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 4, 5)}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jef = jcomp.init_error_feedback({k: jnp.zeros(s)
                                     for k, s in shapes.items()})
    tef = tcomp.init_error_feedback({k: torch.zeros(s)
                                     for k, s in shapes.items()})
    for g in grads:
        jg, jef = jcomp.compress_grads({k: jnp.asarray(v)
                                        for k, v in g.items()}, jef)
        tg, tef = tcomp.compress_grads({k: torch.from_numpy(v)
                                        for k, v in g.items()}, tef)
        for k in shapes:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))


# -- the CLI ---------------------------------------------------------------------------

def test_cli_loss_decreases_on_granite():
    """The reference's ``tests/test_launch.py`` train test, on the port."""
    r = ttrain.main(["--arch", GRANITE, "--steps", "25", "--global-batch",
                     "4", "--seq-len", "48", "--log-every", "0", "--lr",
                     "1e-3", "--device", "cpu"])
    assert r["steps"] == 25
    assert r["last_loss"] < r["first_loss"]
    assert len(r["aux"]) == 25 and min(r["aux"]) >= 1.0 - 1e-6


def test_moe_path_keeps_tf32_off():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
