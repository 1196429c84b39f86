"""Port parity: the reference's ``remat`` step lever (``StepOptions.remat``,
on by default in the train step; ``lm_loss(remat=)`` checkpoints every
decoder period) and the bfloat16 train step.

Covered: a train step with remat against one without, bit for bit on the
CPU (the loss, every gradient leaf, the parameters after one AdamW step)
in six families, dense, MoE, hybrid, enc-dec with its encoder frames,
xLSTM and the VLM with its patches: the recompute runs the period's
forward again, and on the CPU every op of a period gives the same bits
twice; the port's step with remat against the reference's
``make_train_step(opts=StepOptions(remat=True))`` at the trainer pins'
1e-5; the reduced Jamba built in bfloat16 (the reference's
``init_lm(dtype=jnp.bfloat16)`` weights carried across), its loss and
every gradient leaf against the reference's bfloat16 gradients; a step
with remat on a data mesh of two against the unsharded one, and against
the same sharded step without remat bit for bit.

The reference runs its ``xla`` path, as the trainer pins do: ``jax.grad``
through its Pallas kernels raises under jax 0.9.0.  Tolerances: float32
as ``tests/test_torch_train.py`` (1e-5: products and reductions summed in
another order); bfloat16: the loss within ``BF16_TOL``, and each gradient
leaf's distance from the reference's float32 gradient of the same weights
at most ``TRUTH_RATIO`` times the reference's bfloat16 distance, both as
||bf16 - f32|| / ||f32||.  Both frameworks round every op's output to
bfloat16 but not at the same places (XLA rounds once at a fusion's end),
and on the Mamba leaves fed by the dt path two such roundings part by as
much as each parts from float32 (5-7% as a norm here), so a bar on their
gap alone would have to hide a fault of that size; a fault in the port
moves the port, not the reference, farther from float32, and a 5% scale
of the scan's ddt fails the bar.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.optim import optimizers as topt

TOL = 1e-5
BF16_TOL = 5e-2
TRUTH_RATIO = 1.5
FAMILIES = ["yi-6b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
            "seamless-m4t-large-v2", "xlstm-1.3b", "llava-next-34b"]
JAMBA = "jamba-v0.1-52b"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, b, s, seed):
    """Tokens, labels and the family's stubs (4 patch embeddings, or the
    encoder's frames), as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    out = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    if cfg.num_patch_tokens:
        out["patch_embeds"] = (0.5 * rng.standard_normal(
            (b, 4, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = (0.5 * rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _kept_grads(monkeypatch):
    """Each train step's gradients as the step hands them to clipping
    (copied: clipping scales them in place)."""
    clip, kept = tsteps.clip_by_global_norm, []

    def keep(grads, max_norm):
        kept.append({k: g.detach().clone() for k, g in grads.items()})
        return clip(grads, max_norm)

    monkeypatch.setattr(tsteps, "clip_by_global_norm", keep)
    return kept


def _gap(got, want):
    """||got - want|| over ||want||, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-300)


# -- remat against no remat, bit for bit --------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_step_equals_the_step_without_bit_for_bit(arch, monkeypatch):
    """The loss, every gradient leaf and the parameters after one AdamW
    step, with ``remat`` and without, from the same weights and batch."""
    cfg = get_config(arch).reduced()
    batch = _torch(_batch(cfg, 2, 8, seed=3))
    kept = _kept_grads(monkeypatch)
    out = {}
    for remat in (True, False):
        model = tlm.init_lm(cfg, seed=1, device="cpu")
        step = tsteps.make_train_step(
            cfg, TrainConfig(total_steps=2, warmup_steps=1),
            opts=tsteps.StepOptions(remat=remat))
        state = topt.adamw(3e-4)[0](tsteps.trainable(model))
        model, state, met = step(model, state, batch)
        out[remat] = (met, kept[-1], dict(model.named_parameters()))
    (m1, g1, p1), (m0, g0, p0) = out[True], out[False]
    for key in ("loss", "aux", "grad_norm"):
        assert torch.equal(m1[key], m0[key]), key
    assert g1.keys() == g0.keys()
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k


def test_train_step_remats_by_default_and_the_trainer_does_not():
    """The step options' default is the reference's (remat on); the
    trainer's ``run`` and its CLI pass ``remat=False``, as the reference's
    CLI does."""
    import inspect
    from repro_torch.launch import train as ttrain
    assert tsteps.StepOptions().remat is True
    assert jsteps.StepOptions().remat is True
    default = inspect.signature(ttrain.run).parameters["opts"].default
    assert default.remat is False


def test_remat_forward_equals_the_plain_forward():
    """``lm_forward(remat=True)`` under autograd gives the plain forward's
    logits and aux, bit for bit, and without a graph the same."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = tlm.init_lm(cfg, seed=2, device="cpu")
    for w in model.parameters():
        w.requires_grad_(True)
    tokens = torch.from_numpy(_batch(cfg, 2, 8, seed=4)["tokens"])
    want = tlm.lm_forward(model, tokens)
    got = tlm.lm_forward(model, tokens, remat=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with torch.no_grad():
        again = tlm.lm_forward(model, tokens, remat=True)
    assert torch.equal(again[0], want[0])


# -- against the reference's step with remat ------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    (JAMBA, dict(num_experts=0, attn_every=2, num_layers=4)),
    ("granite-moe-1b-a400m", {}),
])
def test_remat_steps_match_reference_remat_steps(arch, kw):
    """Two steps with remat on both sides from the same weights and
    batches: every step's loss, gradient norm and perplexity, then every
    parameter, within the trainer pins' 1e-5."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    tc = dict(total_steps=2, warmup_steps=5)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JTrainConfig(**tc),
        opts=jsteps.StepOptions(remat=True, impl="xla")))
    tstep = tsteps.make_train_step(cfg, TrainConfig(**tc),
                                   opts=tsteps.StepOptions(remat=True))
    jstate = jopt.adamw(3e-4)[0](params)
    tstate = topt.adamw(3e-4)[0](tsteps.trainable(model))
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    for step in range(2):
        batch = data.batch_at(step)
        params, jstate, jmet = jstep(params, jstate,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        model, tstate, tmet = tstep(model, tstate, _torch(batch))
        for key in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       atol=TOL, rtol=TOL)
    for want, got in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(lm_to_jax(model))):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


# -- the bfloat16 train step ------------------------------------------------------------

_JIT_INIT = jax.jit(jlm.init_lm, static_argnames=("cfg", "dtype"))


@functools.lru_cache(maxsize=None)
def _jamba_bf16_reference():
    """The reduced Jamba (one period of 8, no experts) from the reference's
    bfloat16 ``init_lm``, a batch, and the reference's loss and gradients
    of it with remat (what its bfloat16 train step differentiates), in
    bfloat16 and from the same weights widened to float32."""
    jcfg = dataclasses.replace(jax_get_config(JAMBA).reduced(),
                               num_experts=0)
    params = _JIT_INIT(jax.random.PRNGKey(5), cfg=jcfg, dtype=jnp.bfloat16)
    batch = _batch(get_config(JAMBA).reduced(), 2, 16, seed=6)

    def loss(p):
        return jlm.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                           jcfg, impl="xla", remat=True)[0]

    vg = jax.jit(jax.value_and_grad(loss))
    value, grads = vg(params)
    wide = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    _, grads32 = vg(wide)
    return params, batch, float(value), grads, grads32


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose gradient is scaled by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _bf16_port_gradients(monkeypatch, ddt_scale=None):
    """The port's bfloat16 train step with remat on the reference's
    bfloat16 weights and batch: its loss and its gradients as the step
    hands them to clipping; with ``ddt_scale`` the scan's ddt is scaled by
    it (a fault planted in the scan's backward)."""
    params, batch, *_ = _jamba_bf16_reference()
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), num_experts=0)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    kept = _kept_grads(monkeypatch)
    if ddt_scale is not None:
        real = ops.ssm_scan

        def faulty(u, delta, *args, **kw):
            return real(u, _ScaleGrad.apply(delta, ddt_scale), *args, **kw)

        monkeypatch.setattr(ops, "ssm_scan", faulty)
    step = tsteps.make_train_step(cfg, TrainConfig())
    state = topt.adamw(3e-4)[0](tsteps.trainable(model))
    _, _, met = step(model, state, _torch(batch))
    names = list(tsteps.trainable(model))
    return float(met["loss"]), {k: kept[0][k] for k in names}


def _distance_ratios(got):
    """{leaf: (port's distance from the reference's float32 gradient over
    the reference's bfloat16 distance, the port's gap from the reference's
    bfloat16 gradient)}, each distance ||a - b|| / ||b||."""
    _, _, _, grads, grads32 = _jamba_bf16_reference()
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), num_experts=0)
    want = dict(lm_from_jax(_np_tree(grads), cfg,
                            device="cpu").named_parameters())
    wide = dict(lm_from_jax(_np_tree(grads32), cfg,
                            device="cpu").named_parameters())
    out = {}
    for k, g in got.items():
        assert g.dtype == want[k].dtype, k
        g, w, t = (x.float().numpy() for x in (g, want[k], wide[k]))
        out[k] = (_gap(g, t) / _gap(w, t), _gap(g, w))
    return out


def test_bf16_train_step_matches_reference_bf16_gradients(monkeypatch):
    """The port's bfloat16 train step with remat (its gradients as the step
    hands them to clipping) against the reference's bfloat16 step: the
    loss within BF16_TOL; every leaf keeps the parameter's dtype and sits
    at most TRUTH_RATIO times as far from the reference's float32
    gradient as the reference's bfloat16 gradient does.  Here the ratio
    is 1.25 at most, and the port's leaves sit up to 6.0% from the
    reference's bfloat16 ones as a norm (the Mamba leaves fed by the dt
    path), where the reference's own sit up to 7.0% from float32."""
    want_loss = _jamba_bf16_reference()[2]
    loss, got = _bf16_port_gradients(monkeypatch)
    assert abs(loss - want_loss) <= BF16_TOL * abs(want_loss)
    for k, (ratio, gap) in _distance_ratios(got).items():
        assert ratio <= TRUTH_RATIO, (k, ratio, gap)


@pytest.mark.parametrize("scale", [1.05, 1.1])
def test_bf16_gradient_bar_sees_a_ddt_fault(monkeypatch, scale):
    """The bar above fails the port's step with the scan's ddt scaled by
    5% or 10%: the dt path's leaves move up to 2.0 and 3.1 times as far
    from float32 as the reference's bfloat16 gradients."""
    _, got = _bf16_port_gradients(monkeypatch, ddt_scale=scale)
    ratios = _distance_ratios(got)
    worst = max(ratios, key=lambda k: ratios[k][0])
    assert ratios[worst][0] > TRUTH_RATIO
    assert "mamba.dt_proj" in worst


def test_bf16_step_runs_with_float32_moments():
    """The bfloat16 train step keeps AdamW's moments in float32, as the
    reference does, and moves every bfloat16 matrix (a norm's scale near 1
    keeps its value where the step is below half its bfloat16 ulp,
    2^-8)."""
    params, batch, *_ = _jamba_bf16_reference()
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), num_experts=0)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    before = {k: p.detach().clone() for k, p in
              tsteps.trainable(model).items()}
    step = tsteps.make_train_step(cfg, TrainConfig(total_steps=2,
                                                   warmup_steps=1))
    state = topt.adamw(3e-4)[0](tsteps.trainable(model))
    model, state, met = step(model, state, _torch(batch))
    assert np.isfinite(float(met["loss"]))
    assert all(m.dtype == torch.float32 for m in state.mu.values())
    assert all(bool(m.any()) for m in state.mu.values())
    for k, p in tsteps.trainable(model).items():
        assert p.dtype == before[k].dtype
        if p.dim() >= 2:
            assert not torch.equal(p, before[k]), k


# -- on a data mesh ------------------------------------------------------------------------

def test_sharded_remat_step_equals_the_unsharded_one():
    """Reduced granite (capacity factor 1.25) on a (2, 1) mesh of the CPU
    with remat: two steps' metrics and the parameters within 1e-5 of the
    unsharded step with remat, and bit for bit with the same sharded step
    without remat."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              moe_capacity_factor=1.25)
    mesh = make_host_mesh((2, 1), ("data", "model"), devices=("cpu",) * 2)

    def run(mesh, remat):
        model = tlm.init_lm(cfg, seed=0, device="cpu")
        step = tsteps.make_train_step(
            cfg, TrainConfig(total_steps=2, warmup_steps=5),
            opts=tsteps.StepOptions(remat=remat), mesh=mesh,
            global_batch=4 if mesh else 0)
        state = topt.adamw(3e-4)[0](tsteps.trainable(model))
        mets = []
        for s in range(2):
            model, state, met = step(model, state,
                                     _torch(_batch(cfg, 4, 16, seed=s)))
            mets.append(met)
        return mets, dict(model.named_parameters())

    (m0, p0), (m1, p1), (m2, p2) = (run(None, True), run(mesh, True),
                                    run(mesh, False))
    for a, b, c in zip(m0, m1, m2):
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(b[key]), float(a[key]),
                                       atol=TOL, rtol=TOL)
            assert torch.equal(b[key], c[key])
    for k in p0:
        np.testing.assert_allclose(p1[k].detach().numpy(),
                                   p0[k].detach().numpy(), atol=TOL,
                                   rtol=TOL)
        assert torch.equal(p1[k], p2[k])
