"""Port parity: the DiT denoiser and its sampling chain against the JAX
reference, on weights carried across from the reference
(``repro_torch.models.convert``) and on the same numpy/JAX-drawn inputs.

The JAX side runs jitted on its ``xla`` path with x64 off (float32, as the
DiT always runs), and the port on the CPU, where each kernel takes its plain
version.  Tolerances:

* reduced gdm-dit (d=64, S=16, 2 layers): 1e-5 — the matrix products and
  reductions sum in another order on the two sides;
* full widths with one layer (d=768, 12 heads x 64, S=256, d_ff=3072):
  1e-4 — the same, over contractions up to K=3072 long.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import gdm as jgdm
from repro_torch.configs import get_config
from repro_torch.models import gdm as tgdm
from repro_torch.models.convert import dit_from_jax, dit_to_jax

CFG = get_config("gdm-dit").reduced()
JCFG = jax_get_config("gdm-dit").reduced()
# full widths, one layer; the prompt vocabulary (49,408 rows of the
# embedding table, not a width the kernels see) is cut to keep the
# reference's init quick
FULL1 = dataclasses.replace(get_config("gdm-dit"), num_layers=1,
                            vocab_size=1024)
JFULL1 = dataclasses.replace(jax_get_config("gdm-dit"), num_layers=1,
                             vocab_size=1024)

SHARED_FIELDS = [f.name for f in dataclasses.fields(CFG)]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def reduced():
    params = jgdm.init_gdm(jax.random.PRNGKey(0), JCFG)
    return params, dit_from_jax(_np_tree(params), CFG, device="cpu")


@pytest.fixture(scope="module")
def full1():
    params = jgdm.init_gdm(jax.random.PRNGKey(1), JFULL1)
    return params, dit_from_jax(_np_tree(params), FULL1, device="cpu")


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((b, cfg.latent_hw ** 2, 4)).astype(np.float32)
    prompt = rng.integers(2, cfg.vocab_size, size=(b, 8)).astype(np.int32)
    return latent, prompt


@pytest.mark.parametrize("port,ref", [(CFG, JCFG), (FULL1, JFULL1)])
def test_config_copy_matches_reference(port, ref):
    for name in SHARED_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.q_dim, port.kv_dim, port.resolved_head_dim) == \
        (ref.q_dim, ref.kv_dim, ref.resolved_head_dim)


def test_convert_round_trip_is_exact(reduced):
    params, model = reduced
    back = dit_to_jax(model)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, want)) == set(map(str, got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_convert_rejects_a_mismatched_tree(reduced):
    params, _ = reduced
    tree = _np_tree(params)
    with pytest.raises(ValueError, match="layers"):
        dit_from_jax(tree, dataclasses.replace(CFG, num_layers=3),
                     device="cpu")
    del tree["patch_out"]
    with pytest.raises(KeyError, match="patch_out"):
        dit_from_jax(tree, CFG, device="cpu")


def test_init_follows_the_reference_distributions():
    """Same parameter tree, same shapes, and each weight's spread equal to
    the reference's draw within sampling error (five standard errors for n
    draws on each side); biases and norms exactly equal."""
    cfg = dataclasses.replace(CFG, d_model=128, num_heads=8, d_ff=256)
    jcfg = dataclasses.replace(JCFG, d_model=128, num_heads=8, d_ff=256)
    want = _np_tree(jgdm.init_gdm(jax.random.PRNGKey(3), jcfg))
    got = dit_to_jax(tgdm.init_gdm(cfg, seed=3, device="cpu"))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = flat_want[path]
        assert g.shape == w.shape, path
        if w.std() == 0:
            np.testing.assert_array_equal(g, w)
        else:
            n = w.size
            assert abs(g.std() / w.std() - 1) < 5 / np.sqrt(n), path
            assert abs(g.mean()) < 5 * w.std() / np.sqrt(n), path


@pytest.mark.parametrize("which,tol", [("reduced", 1e-5), ("full1", 1e-4)])
def test_denoise_matches_reference(which, tol, request):
    params, model = request.getfixturevalue(which)
    cfg, jcfg = (CFG, JCFG) if which == "reduced" else (FULL1, JFULL1)
    b = 3 if which == "reduced" else 1
    latent, prompt = _batch(cfg, b, seed=4)
    t = np.arange(b, dtype=np.int32) % 4
    want = jax.jit(lambda p, l, tt, pr: jgdm.gdm_denoise(
        p, l, tt, pr, jcfg, impl="xla"))(params, latent, t, prompt)
    with torch.no_grad():
        got = tgdm.gdm_denoise(model, torch.from_numpy(latent),
                               torch.from_numpy(t), torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("which,tol", [("reduced", 1e-5), ("full1", 1e-4)])
def test_run_block_batched_mixed_blocks_match_reference(which, tol, request):
    params, model = request.getfixturevalue(which)
    cfg, jcfg = (CFG, JCFG) if which == "reduced" else (FULL1, JFULL1)
    block_idx = np.array([0, 3, 1, 2], np.int32) if which == "reduced" \
        else np.array([2], np.int32)
    latent, prompt = _batch(cfg, len(block_idx), seed=5)
    spb, total = 2, 8
    want = jax.jit(lambda p, l: jgdm.run_block_batched(
        p, l, prompt, jcfg, jgdm.make_schedule(total), block_idx,
        steps_per_block=spb, total_steps=total, impl="xla"))(params, latent)
    with torch.no_grad():
        got = tgdm.run_block_batched(
            model, torch.from_numpy(latent), torch.from_numpy(prompt),
            tgdm.make_schedule(total, device="cpu"),
            torch.from_numpy(block_idx), steps_per_block=spb,
            total_steps=total)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol)


def test_schedule_and_ddim_step_match_reference(reduced):
    params, model = reduced
    total = 8
    want = jgdm.make_schedule(total)
    got = tgdm.make_schedule(total, device="cpu")
    for key in ("betas", "alphas", "alpha_bar"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-7, rtol=1e-6)
    latent, prompt = _batch(CFG, 2, seed=6)
    step = np.array([7, 0], np.int32)      # t=0 takes the alpha_bar_prev=1 edge
    w_lat, w_x0 = jax.jit(lambda p, l: jgdm.ddim_step(
        p, l, step, prompt, JCFG, want, total_steps=total, impl="xla"))(
            params, latent)
    with torch.no_grad():
        g_lat, g_x0 = tgdm.ddim_step(model, torch.from_numpy(latent),
                                     torch.from_numpy(step),
                                     torch.from_numpy(prompt), got,
                                     total_steps=total)
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(w_lat), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(g_x0.numpy(), np.asarray(w_x0), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("which,n_prompts,tol",
                         [("reduced", 3, 1e-5), ("full1", 1, 1e-4)])
def test_quality_per_block_with_injected_draws_matches_reference(
        which, n_prompts, tol, request):
    """Omega(k) from the same noise and prompts: the reference draws its
    noise from ``key`` inside ``sample_chain``; the port is handed it."""
    params, model = request.getfixturevalue(which)
    cfg, jcfg = (CFG, JCFG) if which == "reduced" else (FULL1, JFULL1)
    key = jax.random.PRNGKey(9)
    blocks, spb = 4, 1
    prompts = jax.random.randint(key, (n_prompts, 8), 2, cfg.vocab_size)
    noise = jax.random.normal(key, (n_prompts, cfg.latent_hw ** 2, 4))
    want = jax.jit(lambda p: jgdm.quality_per_block(
        p, key, prompts, jcfg, num_blocks=blocks, steps_per_block=spb,
        impl="xla"))(params)
    with torch.no_grad():
        got = tgdm.quality_per_block(
            model, torch.from_numpy(np.array(noise)),
            torch.from_numpy(np.array(prompts)), num_blocks=blocks,
            steps_per_block=spb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_ssim_proxy_matches_reference():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((3, 16, 4)).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    np.testing.assert_allclose(
        tgdm.ssim_proxy(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jgdm.ssim_proxy(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6, rtol=1e-6)


def test_attention_apply_refuses_rope():
    """The DiT's attention call refuses the rotary embedding: with
    ``rope=False`` it is the plain projections around non-causal attention,
    while the LM's default (``rope=True``) rotates q and k."""
    from repro_torch.kernels import ref
    from repro_torch.nn.attention import attention_apply
    from repro_torch.nn.linear import dense_apply
    layer = tgdm.DiTLayer(CFG, device="cpu")
    layer.attn.apply(lambda m: m.reset_parameters(torch.Generator()
                                                  .manual_seed(0))
                     if hasattr(m, "reset_parameters") else None)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 6, CFG.d_model)).astype(np.float32))
    got = attention_apply(layer.attn, x, cfg=CFG, causal=False, rope=False)
    hd, h = CFG.resolved_head_dim, CFG.num_heads
    q, k, v = (dense_apply(w, x).reshape(1, 6, -1, hd)
               for w in (layer.attn.wq, layer.attn.wk, layer.attn.wv))
    want = dense_apply(layer.attn.wo, ref.attention(
        q, k, v, causal=False).reshape(1, 6, h * hd))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    rotated = attention_apply(layer.attn, x, cfg=CFG, causal=False)
    assert float((rotated - got).abs().max()) > 1e-3
