"""Port parity: the zoo's last three families — enc-dec
(seamless-m4t-large-v2), xLSTM (xlstm-1.3b) and the VLM (llava-next-34b) —
and the whole config registry, against the JAX reference on weights
carried across by ``repro_torch.models.convert`` and on the same numpy
inputs.

Covered: every config field for field and the (arch x shape) grid;
``lm_forward``, ``lm_loss`` with its gradients, ``lm_prefill`` and
``lm_decode_step`` (seamless with its encoder memory, llava with its
patches); ``input_specs``, ``make_prefill_step``, ``make_serve_step`` and
one ``make_train_step`` step with the stubs; the weights both ways
(checkpoints and the CLIs: ``test_torch_zoo_io.py``).

The reference runs its ``xla`` path (the only one it can differentiate),
the port the CPU, where each kernel takes its plain version.
Tolerances: logits and states within 1e-5 of their largest magnitude
(float32 sums in another order), gradients within the leaf-scaled 1e-5 of
``test_torch_train.py``, parameters after a train step within 1e-5
absolute and relative, greedy tokens equal, weights exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import grid_cells as jax_grid_cells
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, SHAPES,
                                 TrainConfig, cell_supported, get_config,
                                 get_shape, grid_cells)
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.optim import optimizers as topt

TOL = 1e-5
FAMILIES = ["xlstm-1.3b", "seamless-m4t-large-v2", "llava-next-34b"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _close(got, want, tol=TOL):
    """|got - want| <= tol * max|want| over the whole array."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= \
        tol * max(float(np.abs(want).max()), 1e-30)


# -- configs and the registry ------------------------------------------------------------

@pytest.mark.parametrize("arch", J_ALL_ARCHS)
@pytest.mark.parametrize("reduce", [False, True])
def test_config_copy_matches_reference(arch, reduce):
    port, ref = get_config(arch), jax_get_config(arch)
    if reduce:
        port, ref = port.reduced(), ref.reduced()
    for f in dataclasses.fields(port):
        assert _plain(getattr(port, f.name)) == \
            _plain(getattr(ref, f.name)), f.name
    assert (port.padded_vocab(), port.q_dim, port.kv_dim, port.is_encdec,
            port.is_moe) == (ref.padded_vocab(), ref.q_dim, ref.kv_dim,
                             ref.is_encdec, ref.is_moe)
    assert [(s.mixer, s.mlp, s.cross) for s in tlm.layer_pattern(port)] == \
        [(s.mixer, s.mlp, s.cross) for s in jlm.layer_pattern(ref)]


def test_registry_matches_reference():
    """The reference's ``test_assigned_grid_has_40_cells_with_documented_
    skips`` and ``test_layer_pattern_periods`` on the port: 40 cells, the 8
    full-attention archs skipping long_500k."""
    assert ALL_ARCHS == J_ALL_ARCHS and ASSIGNED_ARCHS == J_ASSIGNED
    assert list(SHAPES) == list(J_SHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(J_SHAPES[name])
        assert get_shape(name).is_decode == J_SHAPES[name].is_decode
    cells = grid_cells(include_skipped=True)
    assert cells == jax_grid_cells(include_skipped=True)
    assert len(cells) == 40
    skipped = [c for c in cells if not c[2]]
    assert len(skipped) == 8 and all(c[1] == "long_500k" for c in skipped)
    assert grid_cells() == jax_grid_cells() and len(grid_cells()) == 32
    assert cell_supported(get_config("xlstm-1.3b"), SHAPES["long_500k"]) \
        == (True, "")
    pattern = tlm.layer_pattern(get_config("xlstm-1.3b"))
    assert len(pattern) == 8
    assert [s.mixer for s in pattern] == ["slstm"] + ["mlstm"] * 7
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", J_ASSIGNED)
def test_input_specs_match_reference(arch):
    """Every (arch, shape) cell's inputs on the meta device: the
    reference's shapes and dtypes (its default bfloat16 stubs and caches,
    float32 recurrent states, int32 tokens); decode states laid out as the
    reference's."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        got = tsteps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, J_SHAPES[name])
        assert set(got) == set(want)
        gl = jax.tree_util.tree_leaves(got)
        wl = jax.tree_util.tree_leaves(want)
        assert [tuple(t.shape) for t in gl] == [tuple(t.shape) for t in wl]
        for g, w in zip(gl, wl):
            assert g.device.type == "meta"
            assert g.dtype == {"int32": torch.int32,
                               "bfloat16": torch.bfloat16,
                               "float32": torch.float32}[w.dtype.name]


# -- the three families ------------------------------------------------------------------

@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch = request.param
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    params = jlm.init_lm(jax.random.PRNGKey(FAMILIES.index(arch)), jcfg)
    return cfg, jcfg, params, lm_from_jax(_np_tree(params), cfg,
                                          device="cpu")


def _stubs(cfg, b, seed):
    """The family's stub inputs: 4 patch embeddings (the first 4 positions)
    or ``encoder_seq_len`` audio frames, N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.num_patch_tokens:
        out["patch_embeds"] = (0.5 * rng.standard_normal(
            (b, 4, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = (0.5 * rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                **_stubs(cfg, b, seed))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state_leaves(state):
    """A port decode state's tensors in the reference's leaf order."""
    return [t for slot in state for key in sorted(slot)
            for t in (slot[key] if isinstance(slot[key], tuple)
                      else (slot[key],))]


def _close_state(got, want):
    gl, wl = _state_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


def test_convert_round_trip_is_exact(family):
    cfg, _, params, model = family
    back = lm_to_jax(model)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, got)) == {str(p) for p, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
    names = dict(model.named_parameters())
    if cfg.is_encdec:
        assert "encoder.layers.1.0.mlp.up.b" in names
        assert "layers.0.0.cross.wq.w" in names and "frame_proj.w" in names
    if cfg.xlstm is not None:
        assert "layers.0.0.slstm.r" in names
        assert "layers.0.1.mlstm.conv_w" in names
    if cfg.num_patch_tokens:
        assert "patch_proj.w" in names


def test_forward_and_loss_match_reference(family):
    cfg, jcfg, params, model = family
    batch = _batch(cfg, 2, 10, seed=1)
    stubs = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    want, _ = jax.jit(lambda p, b: jlm.lm_forward(
        p, b["tokens"], jcfg, impl="xla", **{k: b[k] for k in stubs}))(
        params, batch)
    got, _ = tlm.lm_forward(model, torch.from_numpy(batch["tokens"]),
                            **_torch(stubs))
    v = cfg.vocab_size
    _close(got[..., :v], np.asarray(want)[..., :v])
    assert torch.equal(got[..., :v].argmax(-1),
                       torch.from_numpy(np.asarray(want)[..., :v]
                                        .argmax(-1)))
    assert bool((got[..., v:] <= -1e8).all())
    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, jcfg, impl="xla"), has_aux=True))(
        params, batch)
    named = tsteps.trainable(model)
    total, met = tlm.lm_loss(model, _torch(batch))
    grads = dict(zip(named, torch.autograd.grad(total,
                                                list(named.values()))))
    _close(total, jtotal)
    _close(met["perplexity"], jmet["perplexity"])
    for path, want in jax.tree_util.tree_leaves_with_path(_np_tree(jgrads)):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        stacked = next((i for i, k in enumerate(keys) if k == "layers"), None)
        if stacked is None:
            got = grads[".".join(keys)].numpy()
        else:
            got = np.stack([grads[".".join(keys[:stacked + 1] + [str(p)]
                                           + keys[stacked + 1:])].numpy()
                            for p in range(want.shape[0])])
        # leaf-scaled, as test_torch_train.py's _leaf_close
        np.testing.assert_allclose(got, want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg="/".join(keys))
    del named


def test_prefill_and_decode_match_reference(family):
    """Prefill of 7 tokens, then three greedy steps of each side's own
    tokens (which must agree), seamless cross-attending to its memory."""
    cfg, jcfg, params, model = family
    batch = _batch(cfg, 2, 7, seed=2)
    stubs = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    want, jstate, jmem = jlm.lm_prefill(params, batch["tokens"], jcfg,
                                        max_seq=10, impl="xla",
                                        state_dtype=jnp.float32, **stubs)
    got, state, memory = tlm.lm_prefill(
        model, torch.from_numpy(batch["tokens"]), max_seq=10,
        state_dtype=torch.float32, **_torch(stubs))
    v = cfg.vocab_size
    _close(got[..., :v], np.asarray(want)[..., :v])
    _close_state(state, jstate)
    assert (memory is None) == (jmem is None) == (not cfg.is_encdec)
    if memory is not None:
        _close(memory, jmem)
    step = jax.jit(lambda p, t, s, m: jlm.lm_decode_step(
        p, t, s, jcfg, memory=m, impl="xla"))
    jtok = np.asarray(want)[:, -1, :v].argmax(-1).astype(np.int32)
    tok = got[:, -1, :v].argmax(-1).to(torch.int32)
    for _ in range(3):
        np.testing.assert_array_equal(tok.numpy(), jtok)
        wl, jstate = step(params, jtok, jstate, jmem)
        gl, state = tlm.lm_decode_step(model, tok, state, memory=memory)
        _close(gl[:, :v], np.asarray(wl)[:, :v])
        _close_state(state, jstate)
        jtok = np.asarray(wl)[:, :v].argmax(-1).astype(np.int32)
        tok = gl[:, :v].argmax(-1).to(torch.int32)


def test_init_decode_state_matches_reference_layout(family):
    cfg, jcfg, _, _ = family
    want = jlm.init_decode_state(jcfg, 2, 16, dtype=jnp.float32)
    got = tlm.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                device="cpu")
    _close_state(got, want)
    assert [t.nbytes for t in _state_leaves(got)] == \
        [np.asarray(t).nbytes for t in jax.tree_util.tree_leaves(want)]


def test_prefill_then_decode_matches_full_forward(family):
    """The reference's consistency check on the port: prefill + decode
    (with the memory and the patches), and decode from a cold state,
    continue the full forward."""
    cfg, _, _, model = family
    batch = _torch(_batch(cfg, 2, 9, seed=3))
    stubs = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    toks = batch["tokens"]
    full, _ = tlm.lm_forward(model, toks, **stubs)
    v = cfg.vocab_size
    pre, state, memory = tlm.lm_prefill(model, toks[:, :6], max_seq=9,
                                        state_dtype=torch.float32, **stubs)
    _close(pre[:, -1, :v], full[:, 5, :v].detach().numpy())
    for t in range(6, 9):
        nxt, state = tlm.lm_decode_step(model, toks[:, t], state,
                                        memory=memory)
        _close(nxt[:, :v], full[:, t, :v].detach().numpy())
    if cfg.num_patch_tokens:
        return           # patches fill positions a token decode cannot
    state = tlm.init_decode_state(cfg, 2, 9, dtype=torch.float32,
                                  device="cpu")
    for t in range(9):
        nxt, state = tlm.lm_decode_step(model, toks[:, t], state,
                                        memory=memory)
        _close(nxt[:, :v], full[:, t, :v].detach().numpy())


def test_prefill_and_serve_steps_match_reference(family):
    cfg, jcfg, params, model = family
    batch = _batch(cfg, 2, 6, seed=4)
    del batch["labels"]
    jpre = jsteps.make_prefill_step(jcfg, max_seq=9,
                                    state_dtype=jnp.float32,
                                    opts=jsteps.StepOptions(impl="xla"))
    jserve_step = jax.jit(jsteps.make_serve_step(
        jcfg, opts=jsteps.StepOptions(impl="xla")))
    want = jpre(params, batch)
    got = tsteps.make_prefill_step(cfg, max_seq=9,
                                   state_dtype=torch.float32)(
        model, _torch(batch))
    assert set(got) == set(want)
    _close(got["logits"], want["logits"])
    _close_state(got["state"], want["state"])
    if cfg.is_encdec:
        _close(got["memory"], want["memory"])
    serve = tsteps.make_serve_step(cfg)
    tok = np.asarray(want["logits"])[:, :cfg.vocab_size].argmax(-1)
    jstate, state = want["state"], got["state"]
    for _ in range(2):
        tok = tok.astype(np.int32)
        wl, jstate = jserve_step(params, tok, jstate, want.get("memory"))
        gl, state = serve(model, torch.from_numpy(tok), state,
                          got.get("memory"))
        assert not gl.requires_grad
        _close(gl, wl)
        _close_state(state, jstate)
        tok = np.asarray(wl)[:, :cfg.vocab_size].argmax(-1)


def test_train_step_with_stubs_matches_reference(family):
    """One ``make_train_step`` step on a batch with the family's stubs:
    the step's numbers within 1e-5 of their size, and every parameter
    after it within 1e-5 absolute and relative, as
    ``test_torch_train.py`` holds its steps (Adam moves an element whose
    gradient is near zero by a step whose size hinges on that gradient's
    rounding, up to the learning rate)."""
    cfg, jcfg, params, _ = family
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    tc = dict(total_steps=2, warmup_steps=5)
    batch = _batch(cfg, 2, 8, seed=5)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JTrainConfig(**tc),
        opts=jsteps.StepOptions(remat=False, impl="xla")))
    jstate = jopt.adamw(3e-4)[0](params)
    new, jstate, jmet = jstep(params, jstate,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tsteps.make_train_step(cfg, TrainConfig(**tc),
                                   opts=tsteps.StepOptions(remat=False))
    tstate = topt.adamw(3e-4)[0](tsteps.trainable(model))
    model, tstate, tmet = tstep(model, tstate, _torch(batch))
    for key in ("loss", "grad_norm", "perplexity"):
        _close(tmet[key], jmet[key])
    got = dict(jax.tree_util.tree_leaves_with_path(lm_to_jax(model)))
    for path, want in jax.tree_util.tree_leaves_with_path(new):
        np.testing.assert_allclose(got[path], np.asarray(want), atol=TOL,
                                   rtol=TOL)
    assert tstate.step == int(jstate.step) == 1


def test_unported_serving_levers_raise():
    """The serving levers, once refused, now run: the enc-dec's prefill
    and two decode steps with ``sharded_decode`` on a (1, 1) ("data",
    "model") mesh with the global batch, against the reference's steps on
    its own (1, 1) mesh, within 1e-5 (the split-K decode itself, which a
    model axis of one never engages, is held to the reference's at sizes
    2 and 4 in ``test_torch_lm_mesh.py``)."""
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro_torch.launch.mesh import make_host_mesh
    arch = "seamless-m4t-large-v2"
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    params = jlm.init_lm(jax.random.PRNGKey(3), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    jmesh = jmake_host_mesh((1, 1), ("data", "model"))
    mesh = make_host_mesh((1, 1), ("data", "model"), devices=("cpu",))
    jopts = jsteps.StepOptions(impl="xla", sharded_decode=True)
    opts = tsteps.StepOptions(sharded_decode=True)
    batch = _batch(cfg, 2, 6, seed=4)
    del batch["labels"]
    want = jsteps.make_prefill_step(jcfg, max_seq=9, state_dtype=jnp.float32,
                                    opts=jopts, mesh=jmesh,
                                    global_batch=2)(params, batch)
    got = tsteps.make_prefill_step(cfg, max_seq=9, mesh=mesh,
                                   state_dtype=torch.float32,
                                   global_batch=2)(model, _torch(batch))
    _close(got["logits"], want["logits"])
    _close_state(got["state"], want["state"])
    _close(got["memory"], want["memory"])
    jserve = jax.jit(jsteps.make_serve_step(jcfg, opts=jopts, mesh=jmesh,
                                            global_batch=2))
    serve = tsteps.make_serve_step(cfg, opts=opts, mesh=mesh, global_batch=2)
    tok = np.asarray(want["logits"])[:, :cfg.vocab_size].argmax(-1)
    jstate, state = want["state"], got["state"]
    for _ in range(2):
        tok = tok.astype(np.int32)
        wl, jstate = jserve(params, tok, jstate, want["memory"])
        gl, state = serve(model, torch.from_numpy(tok), state,
                          got["memory"])
        _close(gl, wl)
        _close_state(state, jstate)
        tok = np.asarray(wl)[:, :cfg.vocab_size].argmax(-1)