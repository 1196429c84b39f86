"""Port parity: the dense LM of the edge launcher (rope, KV cache, forward,
prefill and decode) against the JAX reference ``repro.models.lm``, on
weights carried across by ``repro_torch.models.convert.lm_from_jax`` and on
the same numpy inputs.

The JAX side runs jitted on its ``xla`` path (the kernels' oracles; the
Pallas kernels in interpret mode are pinned in ``test_torch_kernels.py``),
the port on the CPU, where each kernel takes its plain version.
Tolerances:

* reduced yi-6b (G=2) and qwen1.5-4b (G=1, QKV bias, padded vocab), d=64:
  1e-5 — the matrix products and reductions sum in another order;
* one layer at full yi-6b width (d=4096, 32 x 128 heads over 4 kv heads,
  d_ff=11008), vocab cut to 512: 1e-4 — the same, over contractions up to
  K=11008 long.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.nn import rope as jrope
from repro_torch.configs import get_config
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.nn import rope as trope
from repro_torch.nn.attention import KVCache

ARCHS = ["yi-6b", "qwen1.5-4b"]
TOL = 1e-5
FULL_TOL = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _configs(arch):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    cfg, jcfg = _configs(request.param)
    params = jlm.init_lm(jax.random.PRNGKey(ARCHS.index(request.param)), jcfg)
    return cfg, jcfg, params, lm_from_jax(_np_tree(params), cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _to_torch_state(jstate):
    """The reference's decode state (a tuple over pattern slots of
    ``{"kv": KVCache}``) as the port's, copied."""
    return tuple({"kv": KVCache(*(torch.from_numpy(np.array(a))
                                  for a in slot["kv"]))}
                 for slot in jstate)


def _close_state(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["kv"].k.numpy(), np.asarray(w["kv"].k),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(g["kv"].v.numpy(), np.asarray(w["kv"].v),
                                   atol=tol, rtol=tol)
        assert g["kv"].length.dtype == torch.int32
        np.testing.assert_array_equal(g["kv"].length.numpy(),
                                      np.asarray(w["kv"].length))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


# -- configs and weights ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduce", [False, True])
def test_config_copy_matches_reference(arch, reduce):
    port, ref = get_config(arch), jax_get_config(arch)
    if reduce:
        port, ref = port.reduced(), ref.reduced()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.padded_vocab() == ref.padded_vocab()
    assert (port.q_dim, port.kv_dim) == (ref.q_dim, ref.kv_dim)


def test_padded_vocab_of_the_full_configs():
    assert get_config("qwen1.5-4b").padded_vocab() == 152_064
    assert get_config("yi-6b").padded_vocab() == 64_000


def test_convert_round_trip_is_exact(reduced):
    _, _, params, model = reduced
    back = lm_to_jax(model)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, got)) == {str(p) for p, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_convert_rejects_a_mismatched_tree(reduced):
    cfg, _, params, _ = reduced
    tree = _np_tree(params)
    with pytest.raises(ValueError, match="layers"):
        lm_from_jax(tree, dataclasses.replace(cfg, num_layers=3),
                    device="cpu")
    del tree["head"]
    with pytest.raises(KeyError, match="head"):
        lm_from_jax(tree, cfg, device="cpu")


def test_other_families_wait_for_their_slice():
    """Every family of the zoo is ported: the hybrid family
    (``test_torch_train.py``), experts in every family that has them
    (``test_torch_moe.py``), xLSTM, enc-dec and the VLM
    (``test_torch_zoo.py``).  Their patterns are the reference's, the
    enc-dec encoder's too, and no family waits for a later slice: a
    family name the reference treats as dense (``ssm`` without an xLSTM
    config, ``encdec`` without encoder layers) is dense here as well."""
    yi, jyi = get_config("yi-6b"), jax_get_config("yi-6b")
    xl, jxl = get_config("xlstm-1.3b").xlstm, jax_get_config("xlstm-1.3b").xlstm
    for kw in (dict(family="moe", num_experts=4, experts_per_token=2),
               dict(num_experts=4, experts_per_token=2),
               dict(family="hybrid", attn_every=2, moe_every=2,
                    num_experts=4, experts_per_token=2),
               dict(family="ssm"), dict(family="encdec"),
               dict(family="ssm", xlstm=(xl, jxl)),
               dict(family="audio", encoder_layers=2, cross_attention=True),
               dict(family="vlm", num_patch_tokens=8,
                    frontend="image_patches")):
        port = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
        ref = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
        for decoder in (True, False):
            got = tlm.layer_pattern(dataclasses.replace(yi, **port),
                                    decoder=decoder)
            want = jlm.layer_pattern(dataclasses.replace(jyi, **ref),
                                     decoder=decoder)
            assert [(s.mixer, s.mlp, s.cross) for s in got] == \
                [(s.mixer, s.mlp, s.cross) for s in want]


# -- rope -----------------------------------------------------------------------------

def test_rope_at_yi_theta_matches_reference():
    """yi's rope_theta=5e6, positions past 20k.  The reference builds its
    frequencies in float32 even with x64 on; so does the port, and a
    float64 table would move the late angles by more than the tolerance."""
    theta = get_config("yi-6b").rope_theta
    hd = 128
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
    pos = np.stack([np.arange(9), 16_000 + np.arange(9) * 777]).astype(np.int32)
    with jax.enable_x64(True):
        want_freq = np.asarray(jrope.rope_frequencies(hd, theta))
        want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           theta))
    assert want_freq.dtype == np.float32
    got_freq = trope.rope_frequencies(hd, theta)
    assert got_freq.dtype == torch.float32
    np.testing.assert_array_equal(got_freq.numpy(), want_freq)
    for th in (1e4, 5e5, 1e6):
        for d in (16, 64, 128):
            np.testing.assert_array_equal(
                trope.rope_frequencies(d, th).numpy(),
                np.asarray(jrope.rope_frequencies(d, th)))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)
    freq64 = 1.0 / theta ** (np.arange(0, hd, 2) / hd)
    late = pos[1, -1] * np.abs(freq64 - got_freq.numpy().astype(np.float64))
    assert late.max() > TOL


# -- forward, prefill, decode ---------------------------------------------------------

def test_forward_matches_reference(reduced):
    cfg, jcfg, params, model = reduced
    toks = _tokens(cfg, (2, 12), seed=1)
    want, _ = jax.jit(lambda p, t: jlm.lm_forward(p, t, jcfg, impl="xla"))(
        params, toks)
    got, aux = tlm.lm_forward(model, torch.from_numpy(toks))
    assert got.shape == (2, 12, cfg.padded_vocab())
    _close(got, want)
    assert float(aux) == 0.0


def test_prefill_matches_reference(reduced):
    cfg, jcfg, params, model = reduced
    toks = _tokens(cfg, (2, 7), seed=2)
    want, wstate, _ = jax.jit(lambda p, t: jlm.lm_prefill(
        p, t, jcfg, max_seq=10, impl="xla", state_dtype=jnp.float32))(
            params, toks)
    got, state, _ = tlm.lm_prefill(model, torch.from_numpy(toks),
                                   max_seq=10, state_dtype=torch.float32)
    _close(got, want)
    _close_state(state, wstate)


@pytest.mark.parametrize("fused", [True, False])
def test_decode_step_matches_reference(reduced, fused):
    cfg, jcfg, params, model = reduced
    toks = _tokens(cfg, (2, 9), seed=3)
    _, jstate, _ = jlm.lm_prefill(params, toks[:, :6], jcfg, max_seq=10,
                                  impl="xla", state_dtype=jnp.float32)
    state = _to_torch_state(jstate)
    step = jax.jit(lambda p, t, s: jlm.lm_decode_step(
        p, t, s, jcfg, impl="xla", fused_position=fused))
    for i in range(6, 9):
        want, jstate = step(params, toks[:, i], jstate)
        got, state = tlm.lm_decode_step(model, torch.from_numpy(toks[:, i]),
                                        state, fused_position=fused)
        _close(got, want)
        _close_state(state, jstate)


@pytest.mark.parametrize("fused", [True, False])
def test_decode_insert_at_a_full_cache_matches_reference(reduced, fused):
    """length == S: the fused insert clamps its start and overwrites row
    S - 1; the one-hot insert writes nothing.  Rows at different lengths
    take the unfused insert each at its own position."""
    cfg, jcfg, params, model = reduced
    s = 8
    toks = _tokens(cfg, (2, s + 1), seed=4)
    _, jstate, _ = jlm.lm_prefill(params, toks[:, :s], jcfg, max_seq=s,
                                  impl="xla", state_dtype=jnp.float32)
    if not fused:        # one row full, the other at position 3
        jstate = jax.tree_util.tree_map(lambda a: a, jstate)
        kv = jstate[0]["kv"]
        jstate = ({"kv": kv._replace(length=kv.length.at[:, 1].set(3))},)
    state = _to_torch_state(jstate)
    want, jnew = jlm.lm_decode_step(params, toks[:, s], jstate, jcfg,
                                    impl="xla", fused_position=fused)
    got, new = tlm.lm_decode_step(model, torch.from_numpy(toks[:, s]), state,
                                  fused_position=fused)
    _close(got, want)
    _close_state(new, jnew)
    assert int(new[0]["kv"].length[0, 0]) == s + 1


def test_prefill_then_decode_matches_full_forward(reduced):
    """The reference's own consistency check, carried over to the port."""
    cfg, _, _, model = reduced
    toks = torch.from_numpy(_tokens(cfg, (2, 10), seed=5))
    s = 8
    full, _ = tlm.lm_forward(model, toks[:, :s + 1])
    pre, state, _ = tlm.lm_prefill(model, toks[:, :s], max_seq=s + 2,
                                   state_dtype=torch.float32)
    v = cfg.vocab_size
    _close(pre[:, -1, :v], full[:, s - 1, :v].numpy())
    nxt, _ = tlm.lm_decode_step(model, toks[:, s], state)
    _close(nxt[:, :v], full[:, s, :v].numpy())


def test_cold_decode_matches_forward(reduced):
    cfg, _, _, model = reduced
    toks = torch.from_numpy(_tokens(cfg, (2, 5), seed=6))
    full, _ = tlm.lm_forward(model, toks)
    state = tlm.init_decode_state(cfg, 2, 8, dtype=torch.float32,
                                  device="cpu")
    outs = []
    for t in range(5):
        logits, state = tlm.lm_decode_step(model, toks[:, t], state)
        outs.append(logits)
    v = cfg.vocab_size
    _close(torch.stack(outs, 1)[..., :v], full[..., :v].numpy())


def test_init_decode_state_matches_reference_layout(reduced):
    cfg, jcfg, _, _ = reduced
    want = jlm.init_decode_state(jcfg, 1, 24, dtype=jnp.float32)
    got = tlm.init_decode_state(cfg, 1, 24, dtype=torch.float32,
                                device="cpu")
    _close_state(got, want)
    assert [a.nbytes for a in got[0]["kv"]] == \
        [np.asarray(a).nbytes for a in want[0]["kv"]]


def test_padded_vocab_columns_are_masked():
    cfg, jcfg = _configs("qwen1.5-4b")
    assert cfg.padded_vocab() > cfg.vocab_size
    model = tlm.init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 4), seed=7))
    logits, _ = tlm.lm_forward(model, toks)
    pre, state, _ = tlm.lm_prefill(model, toks, max_seq=6,
                                   state_dtype=torch.float32)
    step, _ = tlm.lm_decode_step(model, toks[:, 0], state)
    for out in (logits, pre, step):
        assert bool((out[..., cfg.vocab_size:] == -1e9).all())
        assert bool((out[..., :cfg.vocab_size] > -1e8).all())


def test_tied_head_matches_reference():
    cfg = dataclasses.replace(_configs("yi-6b")[0], tie_embeddings=True)
    jcfg = dataclasses.replace(_configs("yi-6b")[1], tie_embeddings=True)
    params = jlm.init_lm(jax.random.PRNGKey(5), jcfg)
    assert "head" not in params
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    toks = _tokens(cfg, (1, 6), seed=8)
    want, _ = jlm.lm_forward(params, toks, jcfg, impl="xla")
    got, _ = tlm.lm_forward(model, torch.from_numpy(toks))
    _close(got, want)


def test_init_follows_the_reference_distributions():
    """Same tree and shapes; each weight's spread equal to the reference's
    draw within sampling error; norms exactly one."""
    cfg, jcfg = _configs("qwen1.5-4b")
    want = _np_tree(jlm.init_lm(jax.random.PRNGKey(3), jcfg))
    got = lm_to_jax(tlm.init_lm(cfg, seed=3, device="cpu"))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = flat_want[path]
        assert g.shape == w.shape, path
        if w.std() == 0:
            np.testing.assert_array_equal(g, w)
        else:
            assert abs(g.std() / w.std() - 1) < 5 / np.sqrt(w.size), path


def test_full_width_layer_matches_reference():
    """One yi-6b layer at full width (vocab cut to 512): prefill of 6
    tokens, then two decode steps, against the reference."""
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=1,
                              vocab_size=512)
    jcfg = dataclasses.replace(jax_get_config("yi-6b"), num_layers=1,
                               vocab_size=512, dtype="float32")
    params = jlm.init_lm(jax.random.PRNGKey(7), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    toks = _tokens(cfg, (1, 8), seed=9)
    want, jstate, _ = jax.jit(lambda p, t: jlm.lm_prefill(
        p, t, jcfg, max_seq=8, impl="xla", state_dtype=jnp.float32))(
            params, toks[:, :6])
    got, state, _ = tlm.lm_prefill(model, torch.from_numpy(toks[:, :6]),
                                   max_seq=8, state_dtype=torch.float32)
    _close(got, want, FULL_TOL)
    _close_state(state, jstate, FULL_TOL)
    step = jax.jit(lambda p, t, s: jlm.lm_decode_step(p, t, s, jcfg,
                                                      impl="xla"))
    for i in (6, 7):
        want, jstate = step(params, toks[:, i], jstate)
        got, state = tlm.lm_decode_step(model, torch.from_numpy(toks[:, i]),
                                        state)
        _close(got, want, FULL_TOL)
    _close_state(state, jstate, FULL_TOL)
