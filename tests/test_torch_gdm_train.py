"""Port parity: the DiT's training path — the adaLN backward (its plain
version, the arithmetic of its CUDA kernel and the autograd function that
carries it), ``gdm_loss`` and its gradients, thirty AdamW steps,
``LatentDataset``, ``prefetch``, ``from_gdm_model`` and ``sim_config`` —
against the JAX reference, on the reduced ``gdm-dit`` (d=64, 2 layers,
S=16), weights carried across by ``repro_torch.models.convert`` and the
reference's own ``jax.random`` draws passed in.

The JAX side runs its ``xla`` path (``jax.grad`` through its Pallas
kernels raises under jax 0.9.0), the port the CPU, where each kernel takes
its plain version.  Tolerances, float32 throughout, each relative to the
largest magnitude of the quantity compared:

* the adaLN backward: 1e-6 against autograd and ``jax.grad`` (sums over at
  most 2 x 8 rows of 24 in another order);
* the kernel's arithmetic (its per-block sums, added across a cluster by
  column slice, then over clusters and batch rows, and its refactored
  dscale, dweight and dbias): 1e-5 — the same sums associated otherwise;
* ``gdm_loss``: 1e-6 for the loss, 1e-5 for each gradient leaf (products
  and reductions in another order, through two layers);
* thirty AdamW steps: see ``test_thirty_adamw_steps_match_reference``.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.gdm_paper import sim_config as jax_sim_config
from repro.data.pipeline import LatentDataset as JLatentDataset
from repro.kernels import ref as jref
from repro.models import gdm as jgdm
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.sim.quality import from_gdm_model as jax_from_gdm_model
from repro_torch.configs import get_config
from repro_torch.configs.gdm_paper import SIM_SCENARIO, sim_config
from repro_torch.data import LatentDataset, prefetch
from repro_torch.kernels import LAUNCHES, grad, ref, reset_launches
from repro_torch.kernels import adaln_norm as adaln_mod
from repro_torch.launch.steps import trainable
from repro_torch.models import gdm as tgdm
from repro_torch.models.convert import dit_from_jax, dit_to_jax
from repro_torch.optim import adamw, apply_updates
from repro_torch.sim import from_gdm_model, get_scenario

CFG = get_config("gdm-dit").reduced()
JCFG = jax_get_config("gdm-dit").reduced()


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@jax.jit
def _jax_loss_and_grad(params, batch, key):
    """The reference's loss and gradients, compiled once for the file."""
    return jax.value_and_grad(
        lambda p: jgdm.gdm_loss(p, batch, key, JCFG, impl="xla"),
        has_aux=True)(params)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the adaLN backward ---------------------------------------------------------

def _adaln_case(b, s, d, epilogue, offset, seed):
    """Operands as the DiT passes them: shift/scale/gate are (B, d) views
    of one (B, 6d + offset) projection (row stride 6d + offset), dy and dr
    upstream gradients; numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(  # noqa: E731
        np.float32)
    mods = f(b, 6 * d + offset, s=0.3)
    arrays = dict(x=f(b, s, d), mods=mods, w=1.0 + f(d, s=0.1),
                  bias=f(d, s=0.1), dy=f(b, s, d), dr=f(b, s, d),
                  residual=f(b, s, d))
    return arrays


def _views(a, d, offset, epilogue):
    mods = torch.from_numpy(a["mods"])[:, offset:]
    sh, sc, g = mods[:, :d], mods[:, d:2 * d], mods[:, 2 * d:3 * d]
    x = torch.from_numpy(a["x"])
    w, bias = torch.from_numpy(a["w"]), torch.from_numpy(a["bias"])
    ops_args = (x, sh, sc, w, bias) + (
        (g, torch.from_numpy(a["residual"])) if epilogue else ())
    return ops_args


# (B, S, d, epilogue, offset of the modulation view, dr given)
ADALN_CASES = [(2, 8, 24, False, 0, False), (2, 8, 24, True, 0, True),
               (2, 8, 24, True, 0, False), (3, 5, 20, False, 1, False),
               (3, 5, 20, True, 3, True), (1, 7, 9, True, 1, False)]


@pytest.mark.parametrize("b,s,d,epilogue,offset,with_dr", ADALN_CASES)
def test_adaln_backward_matches_autograd_and_jax(b, s, d, epilogue, offset,
                                                 with_dr):
    a = _adaln_case(b, s, d, epilogue, offset, seed=b * 100 + d)
    args = _views(a, d, offset, epilogue)
    dy = torch.from_numpy(a["dy"])
    dr = torch.from_numpy(a["dr"]) if with_dr else None
    got = ref.adaln_norm_backward(*args[:5], dy, *args[5:], dr=dr)
    # autograd of the port's plain version
    leaves = [t.clone().requires_grad_() for t in args]
    out = ref.adaln_norm(*leaves)
    if epilogue:
        outs, cots = (out[0], out[1]), (dy, dr if with_dr else
                                        torch.zeros_like(dy))
    else:
        outs, cots = (out,), (dy,)
    want = torch.autograd.grad(outs, leaves, cots)
    assert len(got) == len(want) == len(args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-6
    # jax.grad of the reference's plain version
    jargs = [jnp.asarray(t.numpy()) for t in args]
    jout, vjp = jax.vjp(lambda *t: jref.adaln_norm(*t), *jargs)
    jcot = (jnp.asarray(a["dy"]), jnp.asarray(
        a["dr"] if with_dr else np.zeros_like(a["dy"]))) if epilogue \
        else jnp.asarray(a["dy"])
    for g, w in zip(got, vjp(jcot)):
        assert _rel(g, w) <= 1e-6


def _kernel_arithmetic(x, sh, sc, w, bias, dy, gate=None, residual=None,
                       dr=None, rows=3, cluster=4, width=1, eps=1e-5):
    """``csrc/adaln_norm_backward.cu``'s algorithm in torch: blocks of
    ``rows`` rows of one batch row keep sum dy, sum dy * xh (and sum dx' *
    x) over their rows, a batch row's blocks padded with empty ones to a
    multiple of ``cluster``; rank r of a cluster adds column slice r (the
    row's n vectors of ``width`` floats [r n / C, (r + 1) n / C)) over the
    cluster's blocks in rank order; the last
    cluster to finish a slice adds the clusters in order and forms dshift,
    dscale = w * C + b * A and (1 + sc) times both sums; the last batch row
    adds those in batch order into dweight and dbias."""
    del sh
    bsz, seq, d = x.shape
    dx = torch.empty_like(x)
    dres = torch.empty_like(x)
    blocks = -(-(-(-seq // rows)) // cluster) * cluster
    kp = 3 if residual is not None else 2
    sums = torch.zeros(bsz, blocks, kp, d)
    for b in range(bsz):
        for c in range(blocks):
            for s in range(c * rows, min(seq, (c + 1) * rows)):
                h = x[b, s]
                v = h if residual is None else residual[b, s] + gate[b] * h
                mean = v.sum() / d
                rstd = 1.0 / torch.sqrt(((v - mean) ** 2).sum() / d + eps)
                xh = (v - mean) * rstd
                gg = dy[b, s] * (1.0 + sc[b]) * w
                o = rstd * (gg - gg.sum() / d - xh * (gg * xh).sum() / d)
                sums[b, c, 0] += dy[b, s]
                sums[b, c, 1] += dy[b, s] * xh
                if residual is None:
                    dx[b, s] = o
                    continue
                if dr is not None:
                    o = o + dr[b, s]
                dres[b, s] = o
                dx[b, s] = gate[b] * o
                sums[b, c, 2] += o * h
    clusters = blocks // cluster
    part = torch.zeros(bsz, clusters, kp, d)
    n = d // width
    for r in range(cluster):
        cols = slice(r * n // cluster * width, (r + 1) * n // cluster * width)
        for k in range(clusters):
            for q in range(cluster):           # rank order
                part[:, k, :, cols] += sums[:, k * cluster + q, :, cols]
    tot = torch.zeros(bsz, kp, d)
    for k in range(clusters):                  # cluster order
        tot += part[:, k]
    a_, c_ = tot[:, 0], tot[:, 1]
    mid = torch.stack(((1 + sc) * c_, (1 + sc) * a_), 1)
    dwb = torch.zeros(2, d)
    for b in range(bsz):                       # batch order
        dwb += mid[b]
    out = (dx, a_, w * c_ + bias * a_, dwb[0], dwb[1])
    return out + ((tot[:, 2], dres) if residual is not None else ())


@pytest.mark.parametrize("case,rows,cluster,width", [
    (1, 3, 4, 1), (3, 3, 4, 1), (4, 3, 4, 1),
    (0, 3, 8, 1),    # S=8, not a multiple of R * C = 24: 3 blocks, 5 empty
    (5, 2, 4, 1),    # S=7 over blocks of 2: 4 blocks, the last half full
    (2, 1, 8, 1),    # a block a row, one cluster a batch row
    (1, 3, 4, 4)],   # slices of whole float4: 1, 2, 1, 2 of d/4 = 6
    ids=["1", "3", "4", "0-padded", "5-ragged", "2-one-cluster",
         "1-float4"])
def test_adaln_backward_kernel_arithmetic_matches_plain(case, rows, cluster,
                                                        width):
    b, s, d, epilogue, offset, with_dr = ADALN_CASES[case]
    a = _adaln_case(b, s, d, epilogue, offset, seed=7 + case)
    args = _views(a, d, offset, epilogue)
    dy = torch.from_numpy(a["dy"])
    dr = torch.from_numpy(a["dr"]) if with_dr else None
    want = ref.adaln_norm_backward(*args[:5], dy, *args[5:], dr=dr)
    got = _kernel_arithmetic(*args[:5], dy, *args[5:], dr=dr, rows=rows,
                             cluster=cluster, width=width)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


# (B, S, SMs) -> (rows a block, blocks a cluster, blocks a batch row):
# about four blocks an SM over the B * S rows, within one batch row, the
# blocks padded to a multiple of the cluster
@pytest.mark.parametrize("b,s,sms,want", [
    (8, 256, 132, (4, 8, 64)),         # the DiT's train step: no padding
    (4, 256, 132, (2, 8, 128)),
    (1, 256, 132, (1, 8, 256)),
    (16, 256, 132, (8, 8, 32)),
    (2, 3, 132, (1, 8, 8)),            # fewer rows than C: 5 empty blocks
    (3, 17, 132, (1, 8, 24)),          # S not a multiple of R * C
    (4096, 16, 1, (16, 8, 8)),         # one block of rows, 7 empty
    (2, 40, 4, (5, 8, 8))])            # R * C = S: one full cluster
def test_backward_rows_per_block(b, s, sms, want):
    assert adaln_mod.backward_grid(b, s, sms) == want
    rows, cluster, blocks = want
    assert blocks % cluster == 0 and (blocks - cluster) * rows < s <= \
        blocks * rows


@pytest.mark.parametrize("epilogue,use_r", [(False, False), (True, True),
                                            (True, False)])
def test_adaln_autograd_function_carries_the_kernels(monkeypatch, epilogue,
                                                     use_r):
    """``AdaLNNormFn`` with its two kernels stood in for by the plain
    versions (counting launches, as the wrappers do): the gradient of every
    operand is autograd's of the plain version; an unused r brings no dr."""
    seen = {}

    def fwd(*args, gate=None, residual=None, eps=1e-5):
        LAUNCHES["adaln_norm_epilogue" if residual is not None
                 else "adaln_norm"] += 1
        return ref.adaln_norm(*args, gate=gate, residual=residual, eps=eps)

    def bwd(*args, gate=None, residual=None, dr=None, eps=1e-5):
        seen["dr"] = dr
        LAUNCHES["adaln_norm_epilogue_backward" if residual is not None
                 else "adaln_norm_backward"] += 1
        return ref.adaln_norm_backward(*args, gate=gate, residual=residual,
                                       dr=dr, eps=eps)

    monkeypatch.setattr(grad, "adaln_norm_cuda", fwd)
    monkeypatch.setattr(grad, "adaln_norm_backward_cuda", bwd)
    a = _adaln_case(2, 6, 16, epilogue, 2, seed=3)
    args = [t.clone().requires_grad_() for t in _views(a, 16, 2, epilogue)]
    dy, dr = torch.from_numpy(a["dy"]), torch.from_numpy(a["dr"])

    def loss(fn):
        out = fn(*args)
        if not epilogue:
            return (out * dy).sum()
        return (out[0] * dy).sum() + ((out[1] * dr).sum() if use_r else 0)

    reset_launches()
    got = torch.autograd.grad(loss(lambda *t: grad.AdaLNNormFn.apply(
        *t[:5], *(t[5:] if epilogue else (None, None)), 1e-5)), args)
    want = torch.autograd.grad(loss(ref.adaln_norm), args)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6
    name = "adaln_norm_epilogue" if epilogue else "adaln_norm"
    assert LAUNCHES[name] == LAUNCHES[name + "_backward"] == 1
    assert (seen["dr"] is not None) == use_r


# -- gdm_loss -------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    params = jgdm.init_gdm(jax.random.PRNGKey(0), JCFG)
    return params, dit_from_jax(_np_tree(params), CFG, device="cpu")


def _draws(key, lat_shape, total_steps=16):
    """The reference's draws inside gdm_loss, made here to pass to the
    port: ``split``, then ``randint`` and ``normal``."""
    k1, k2 = jax.random.split(key)
    t = jax.random.randint(k1, (lat_shape[0],), 0, total_steps)
    eps = jax.random.normal(k2, lat_shape, jnp.float32)
    return torch.tensor(np.asarray(t)), torch.tensor(np.asarray(eps))


def _lat_shape(latent):
    """gdm_loss's (B, H*W, C) view of a (B, H, W, C) latent."""
    return (latent.shape[0], latent.shape[1] * latent.shape[2],
            tgdm.LATENT_CHANNELS)


def _grad_tree(model, grads):
    """The port's gradients laid out as the reference's parameter tree."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads):
            p.copy_(g)
    return dit_to_jax(clone)


def test_gdm_loss_and_gradients_match_reference(reduced):
    params, model = reduced
    raw = LatentDataset(latent_hw=CFG.latent_hw,
                        vocab_size=CFG.vocab_size).sample(8, 40)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    key = jax.random.PRNGKey(5)
    (jl, jaux), jg = _jax_loss_and_grad(params, batch, key)
    t, eps = _draws(key, _lat_shape(raw["latent"]))
    model = copy.deepcopy(model)
    leaves = list(trainable(model).values())
    loss, aux = tgdm.gdm_loss(model, {k: torch.from_numpy(v)
                                      for k, v in raw.items()}, t=t, eps=eps)
    assert set(aux) == set(jaux) == {"loss"}
    assert _rel(loss, jl) <= 1e-6
    got = _grad_tree(model, torch.autograd.grad(loss, leaves))
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(map(str, got)) == set(map(str, want))
    for path, w in want.items():
        assert _rel(got[path], w) <= 1e-5, jax.tree_util.keystr(path)


def test_gdm_loss_draws_from_its_generator(reduced):
    _, model = reduced
    raw = LatentDataset(latent_hw=CFG.latent_hw,
                        vocab_size=CFG.vocab_size).sample(2, 1)
    losses = [float(tgdm.gdm_loss(model, raw, generator=torch.Generator(
        ).manual_seed(seed))[0]) for seed in (3, 3, 4)]
    assert losses[0] == losses[1] != losses[2]
    # t first, then eps, from the one generator
    gen = torch.Generator().manual_seed(3)
    t = torch.randint(0, 16, (2,), generator=gen)
    eps = torch.randn((2, CFG.latent_hw ** 2, 4), generator=gen)
    assert float(tgdm.gdm_loss(model, raw, t=t, eps=eps)[0]) == losses[0]


def test_thirty_adamw_steps_match_reference(reduced):
    """The port's copy of ``tests/test_models.py``'s
    ``test_gdm_training_reduces_loss`` (30 steps of AdamW at 3e-3 on
    ``LatentDataset`` batches of 8, key ``PRNGKey(i)`` at step i) beside the
    reference's, from the same weights and draws.  Each step's loss within
    1e-4 relative, and the final parameters within 1e-2 of how far
    training moved them, over the model and for each leaf: Adam moves an
    element by about the rate whatever its gradient, so float32 rounding
    can send the few elements whose gradient is at rounding level a step
    of another size, and that gap carries on (the precedent of the card-vs-
    CPU train steps)."""
    params, model = reduced
    model = copy.deepcopy(model)
    start = _np_tree(params)
    tparams = trainable(model)
    names = list(tparams)
    jinit, jupd = jadamw(3e-3)
    tinit, tupd = adamw(3e-3)
    jopt, topt = jinit(params), tinit(tparams)
    ds = LatentDataset(latent_hw=CFG.latent_hw, vocab_size=CFG.vocab_size)

    jl, tl = [], []
    for i in range(30):
        raw = ds.sample(8, i)
        key = jax.random.PRNGKey(i)
        (l, _), g = _jax_loss_and_grad(
            params, {k: jnp.asarray(v) for k, v in raw.items()}, key)
        u, jopt = jupd(g, jopt, params)
        params = japply(params, u)
        t, eps = _draws(key, _lat_shape(raw["latent"]))
        loss, _ = tgdm.gdm_loss(model, raw, t=t, eps=eps)
        grads = torch.autograd.grad(loss, list(tparams.values()))
        upd, topt = tupd(dict(zip(names, grads)), topt, tparams)
        apply_updates(tparams, upd)
        jl.append(float(l))
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.mean(tl[-5:]) < np.mean(tl[:5])
    got = dict(jax.tree_util.tree_leaves_with_path(dit_to_jax(model)))
    moved = gap = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(_np_tree(params)):
        first = dict(jax.tree_util.tree_leaves_with_path(start))[path]
        leaf_moved = float(np.linalg.norm(want - first))
        leaf_gap = float(np.linalg.norm(got[path] - want))
        assert leaf_gap <= 1e-2 * leaf_moved, jax.tree_util.keystr(path)
        moved += leaf_moved ** 2
        gap += leaf_gap ** 2
    assert gap ** 0.5 <= 1e-2 * moved ** 0.5


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(latent_hw=8, vocab_size=100,
                                             prompt_len=5, seed=3)])
def test_latent_dataset_is_bit_identical(kw):
    for step in (0, 7):
        got = LatentDataset(**kw).sample(4, step)
        want = JLatentDataset(**kw).sample(4, step)
        assert set(got) == set(want) == {"prompt", "latent"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_yields_every_item_in_order_on_its_device():
    ds = LatentDataset(latent_hw=4, vocab_size=50)
    items = [ds.sample(2, i) for i in range(5)]
    out = list(prefetch(iter(items), size=2, device="cpu"))
    assert len(out) == 5
    for got, want in zip(out, items):
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    # nested items keep their structure; a failing source raises in order

    def source():
        yield {"a": [np.ones(2), (np.zeros(1),)]}
        raise KeyError("boom")

    it = prefetch(source(), device="cpu")
    first = next(it)
    assert isinstance(first["a"], list) and isinstance(first["a"][1], tuple)
    with pytest.raises(KeyError, match="boom"):
        next(it)


# -- the carried helpers --------------------------------------------------------

def test_from_gdm_model_matches_reference_through_its_seam():
    """The reference's curves for two services at B=4, steps_per_block=2,
    and the port's on the same weights (converted) and the same draws: the
    reference draws service s's prompts and noise from ``PRNGKey(seed +
    s)``.  Within 1e-5: the SSIM proxy of chains through two layers."""
    seed, services, blocks = 3, 2, 4
    want = jax_from_gdm_model(services, blocks, seed=seed)
    models, prompts, noise = [], [], []
    for s in range(services):
        key = jax.random.PRNGKey(seed + s)
        models.append(dit_from_jax(_np_tree(jgdm.init_gdm(key, JCFG)), CFG,
                                   device="cpu"))
        prompt = jax.random.randint(key, (4, 8), 0, JCFG.vocab_size)
        prompts.append(np.array(prompt))
        noise.append(np.array(jax.random.normal(
            key, (4, JCFG.latent_hw ** 2, jgdm.LATENT_CHANNELS))))
    got = from_gdm_model(services, blocks, seed=seed, device="cpu",
                         models=models, prompts=prompts, noise=noise)
    assert got.shape == want.shape == (services, blocks + 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the port's own draws: the reference's properties
    own = from_gdm_model(services, blocks, seed=seed, device="cpu")
    assert (own[:, 0] == 0).all() and (np.diff(own, axis=1) >= 0).all()
    assert np.abs(own[:, -1] - 1.0).max() <= 1e-5
    assert ((own >= 0) & (own <= 1)).all()


def test_sim_config_matches_reference():
    assert SIM_SCENARIO == "paper-fig3"
    assert sim_config() == get_scenario(SIM_SCENARIO)
    for args, kw in (((), {}), (("channel-starved",), dict(num_ues=9)),
                     (("smoke",), dict(horizon=5))):
        got, want = sim_config(*args, **kw), jax_sim_config(*args, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sim_config("channel-starved", num_ues=9).num_ues == 9
