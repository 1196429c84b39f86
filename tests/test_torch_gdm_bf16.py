"""Port parity: the DiT in bfloat16 (the reference's ``init_gdm(dtype=
jnp.bfloat16)``) and the adaLN kernel's bfloat16 forms.

Covered: the adaLN plain version in bfloat16, both forms, against the
reference's Pallas kernel in interpret mode and its ``ref.adaln_norm`` at
``tests/test_kernels.py``'s shapes, with float32 and bfloat16 weight and
bias (the reference's tests pair float32 weights with bfloat16 x, its
bfloat16 DiT bfloat16 weights with either x); the epilogue normalising
the unrounded residual; the reduced DiT's bfloat16 weights across
``dit_from_jax`` / ``dit_to_jax`` and through checkpoints both ways;
``gdm_denoise`` on a bfloat16 latent against the reference under
``impl="xla"`` and ``impl="interpret"``; ``run_block_batched`` and
``quality_per_block`` on float32 latents over the bfloat16 weights;
``ddim_step``'s float32 result and ``run_block_batched``'s refusal of a
bfloat16 latent on both sides; a bfloat16 forward counted the same on
meta and on the CPU, the adaLN kernels charged under their ``_bf16``
names at 2 bytes an element; the refusal of a gradient through a
bfloat16 operand.

Tolerances.  The adaLN kernel: the reference's own bfloat16 bar (3e-2,
absolute and relative as ``assert_allclose`` applies it), compared in
float32.  ``gdm_denoise`` in bfloat16: every value within ``BF16_TOL`` of
the largest |output| (the measured gap is 4.1e-3 to 6.7e-3 over four
seeds, about one bfloat16 ulp of the largest value: the two frameworks
round each op's output at different places, see
``tests/test_torch_bf16.py``).  Float32 latents over bfloat16 weights
compute in float32 on both sides: 1e-5, the float32 bar of the reduced
DiT.  Weights and checkpoints: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import gdm as jgdm
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.distributed import op_cost
from repro_torch.kernels import adaln_norm as tadaln
from repro_torch.kernels import ops, ref
from repro_torch.kernels.grad import AdaLNNormFn
from repro_torch.models import gdm as tgdm
from repro_torch.models.convert import dit_from_jax, dit_to_jax

CFG = get_config("gdm-dit").reduced()
JCFG = jax_get_config("gdm-dit").reduced()
BF = torch.bfloat16
ADALN_TOL = 3e-2
BF16_TOL = 2e-2
F32_TOL = 1e-5
RNG_SEED = 42
SMS = 132             # the H100's SMs, for the rows kernel's layout


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _arr(rng, *shape, bf16=True, scale=1.0):
    """N(0, scale^2) numpy, rounded to bfloat16 where asked (both sides
    then read the same values)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _pair(x, bf16=True):
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF)
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint8).tobytes(), x.dtype.itemsize, x.shape


@pytest.fixture(scope="module")
def reduced_bf16():
    params = jgdm.init_gdm(jax.random.PRNGKey(0), JCFG, dtype=jnp.bfloat16)
    return params, dit_from_jax(_np_tree(params), CFG, device="cpu")


# -- the adaLN kernel's plain version in bfloat16 ----------------------------------

def _adaln_operands(rng, b, s, d, params_bf16, epilogue):
    x = _pair(_arr(rng, b, s, d))
    sh, sc = (_pair(_arr(rng, b, d, scale=0.3)) for _ in range(2))
    w = _pair(_arr(rng, d, bf16=params_bf16), params_bf16)
    bias = _pair(_arr(rng, d, bf16=params_bf16, scale=0.1), params_bf16)
    extra = ()
    if epilogue:
        g = _pair(_arr(rng, b, d, scale=0.3))
        extra = (g, _pair(_arr(rng, b, s, d)))
    ops_ = (x, sh, sc, w, bias) + extra
    return [o[0] for o in ops_], [o[1] for o in ops_]


def _check_adaln(got, want, tol=ADALN_TOL):
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("params_bf16", [False, True])
@pytest.mark.parametrize("b,s,d", [(1, 16, 64), (4, 16, 64), (2, 64, 96),
                                   (2, 17, 64)])
def test_adaln_norm_bf16_matches_pallas(b, s, d, params_bf16):
    rng = np.random.default_rng(RNG_SEED)
    jargs, targs = _adaln_operands(rng, b, s, d, params_bf16, False)
    got = ops.adaln_norm(*targs)
    _check_adaln(got, jops.adaln_norm(*jargs, impl="interpret",
                                      block_rows=8))
    _check_adaln(got, jref.adaln_norm(*jargs))


@pytest.mark.parametrize("params_bf16", [False, True])
@pytest.mark.parametrize("b,s,d", [(1, 16, 64), (4, 16, 64), (2, 17, 96)])
def test_adaln_norm_epilogue_bf16_matches_pallas(b, s, d, params_bf16):
    rng = np.random.default_rng(RNG_SEED)
    jargs, targs = _adaln_operands(rng, b, s, d, params_bf16, True)
    y, r = ops.adaln_norm(*targs)
    wy, wr = jops.adaln_norm(*jargs, impl="interpret", block_rows=8)
    ry, rr = jref.adaln_norm(*jargs[:5], gate=jargs[5], residual=jargs[6])
    for got, want in ((y, wy), (r, wr), (y, ry), (r, rr)):
        _check_adaln(got, want)


def test_adaln_epilogue_normalises_the_unrounded_residual():
    """The reference writes r rounded to bfloat16 but normalises the
    float32 r: the port's y is the plain form of the float32 r rounded
    once, and the plain form of the rounded r (what a kernel that
    normalised its own output would give) differs from it."""
    rng = np.random.default_rng(RNG_SEED)
    _, (x, sh, sc, w, bias, g, res) = _adaln_operands(rng, 4, 16, 64, True,
                                                      True)
    y, r = ops.adaln_norm(x, sh, sc, w, bias, g, res)
    r32 = res.float() + g.float()[:, None, :] * x.float()
    assert torch.equal(r, r32.to(BF))
    assert torch.equal(y, ref.adaln_norm(r32, sh, sc, w, bias).to(BF))
    after_rounding = ref.adaln_norm(r, sh, sc, w, bias)
    assert not torch.equal(y, after_rounding)


def _adaln_bf16_emulation(x, shift, scale, weight, bias, gate=None,
                          residual=None, *, eps=1e-5, kernel="block"):
    """``adaln_norm.cu``'s bfloat16 arithmetic with 16-byte vectors on CPU
    tensors: every operand widened to float32 as it is read; the row's
    vectors of 8 values dealt out as ``kernel`` deals them, each holder
    adding its values vector by vector in element order, the holders'
    partials meeting in a shuffle butterfly (offsets 16 .. 1): in
    ``"block"`` (``adaln_kernel``) thread t of ``launch_shape(d, 8, 2)``
    holds vector t and the warps' sums meet in warp order; in ``"rows"``
    (``adaln_rows_kernel``) lane l of the row's warp holds vectors l + 32 k
    (k < ``row_vectors``), and lane 0's sum is the row's (every
    lane's, by commutativity).  The epilogue normalises the float32 r and writes
    it rounded; each output rounded once to bfloat16."""
    b, s, d = x.shape
    if kernel == "block":
        threads, vpt = tadaln.launch_shape(d, 8, 2)
        lanes_a_row, slots = threads, vpt
    else:
        lanes_a_row = 32
        slots = tadaln.row_vectors(b, s, d, SMS, itemsize=2)
    f = [None if t is None else t.float()
         for t in (x, shift, scale, weight, bias, gate, residual)]
    x, shift, scale, weight, bias, gate, residual = f
    r = x if residual is None else residual + gate[:, None, :] * x
    rows = r.reshape(b * s, d)
    lanes = torch.arange(32)

    def row_sum(vals):
        padded = torch.zeros(rows.shape[0], slots * lanes_a_row * 8)
        padded[:, :d] = vals
        per = padded.view(-1, slots, lanes_a_row, 8)   # [row, k, holder, e]
        part = torch.zeros(rows.shape[0], lanes_a_row)
        for k in range(slots):
            for e in range(8):
                part = part + per[:, k, :, e]
        part = part.view(-1, lanes_a_row // 32, 32)
        for off in (16, 8, 4, 2, 1):
            part = part + part[..., lanes ^ off]
        assert bool((part == part[..., :1]).all())
        total = torch.zeros(rows.shape[0])
        for w in range(lanes_a_row // 32):
            total = total + part[:, w, 0]
        return total

    mean = row_sum(rows) / d
    c = rows - mean[:, None]
    rstd = 1.0 / torch.sqrt(row_sum(c * c) / d + eps)
    y = (c * rstd[:, None]) * weight + bias
    bidx = torch.arange(b * s) // s
    y = (y * (1.0 + scale[bidx]) + shift[bidx]).view(b, s, d).to(BF)
    return y if residual is None else (y, r.to(BF))


def _mean_row_gap(got, want):
    """The largest, over rows, of mean|got - want| / mean|want|: the
    row bar ``chip_smoke.py`` holds the card's kernel to (2^-11)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs().mean(-1) / w.abs().mean(-1)).max())


@pytest.mark.parametrize("params_bf16", [False, True])
@pytest.mark.parametrize("b,s,d", [(2, 16, 768), (4, 16, 64), (2, 17, 96),
                                   (1, 4, 4096)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_adaln_bf16_block_arithmetic_matches_pallas(b, s, d, params_bf16,
                                                    epilogue):
    """The kernels' bfloat16 arithmetic (a block a row, and a warp a row
    where ``ROW_MAX_D`` admits the row; 16-byte vectors, fixed-order sums)
    holds the reference's Pallas kernel at its 3e-2, and the port's plain
    version within the card's row bar."""
    rng = np.random.default_rng(RNG_SEED + d)
    jargs, targs = _adaln_operands(rng, b, s, d, params_bf16, epilogue)
    want = jops.adaln_norm(*jargs, impl="interpret", block_rows=8)
    plain = ops.adaln_norm(*targs)
    if not epilogue:
        want, plain = (want,), (plain,)
    for kernel in ("block", "rows") if d <= tadaln.ROW_MAX_D else ("block",):
        got = _adaln_bf16_emulation(*targs, kernel=kernel)
        for g, w, p in zip(got if epilogue else (got,), want, plain):
            _check_adaln(g, w)
            assert _mean_row_gap(g, p) <= 2.0 ** -11


# -- the kernel wrapper's bfloat16 shapes, charges and refusals -------------------

def test_adaln_load_width_and_work_in_bf16():
    """16 bytes a load are 8 bfloat16 values: the DiT's (B, 6d) chunks
    qualify, a modulation view one value off does not; a bfloat16 call
    is charged 2 bytes an element (the weights at their own size)."""
    b, d = 4, 768
    x = torch.zeros(b, 256, d, dtype=BF)
    w = torch.zeros(d)
    for offset, width in ((0, 8), (1, 1)):
        mods = torch.zeros(b, 1, 6 * d + offset, dtype=BF)
        sh, sc = mods[..., offset:].chunk(6, dim=-1)[:2]
        assert tadaln.load_width(x, sh.reshape(b, d), sc.reshape(b, d),
                                 w, w) == width
    mods = torch.zeros(b, 6 * d)
    assert tadaln.load_width(x.float(), mods[:, :d], mods[:, d:2 * d],
                             w, w) == 4
    rows = b * 256 * d
    assert tadaln.work(b, 256, d, False, 2) == (10.0 * rows,
                                                2.0 * (2 * rows + 2 * b * d
                                                       + 2 * d))
    assert tadaln.work(b, 256, d, True, 2, 4) == (
        12.0 * rows, 2.0 * (4 * rows + 3 * b * d) + 4.0 * 2 * d)
    assert tadaln.launch_shape(d, 8, 2) == (96, 1)
    assert tadaln.launch_shape(4096, 8, 2) == (512, 1)
    for batch, epilogue, vectors in ((1, False, 3), (4, True, 3),
                                     (3, True, None), (1, True, None)):
        assert tadaln.row_vectors(batch, 256, d, SMS, itemsize=2,
                                  epilogue=epilogue) == vectors
    assert tadaln.row_vectors(b, 256, 2048, SMS, itemsize=2) is None
    assert tadaln.launch_shape(d, 4) == (96, 2)
    assert tadaln.launch_shape(d, 1) == (384, 2)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("b,s,d", [(1, 256, 768), (4, 256, 768),
                                   (3, 255, 96), (9, 61, 64), (40, 17, 1024),
                                   (1, 4, 4096)])
def test_adaln_bf16_launch_covers_each_batch_row(b, s, d, epilogue):
    """The bfloat16 launch for 16-byte vectors, walked in Python as the
    kernels walk it: where ``row_vectors`` gives the rows kernel, every
    row of every batch row is taken by exactly one warp, a block's rows
    all lie in one batch row (they share its scale and shift) and a lane's
    vectors cover the row; elsewhere a block a row of ``launch_shape``
    threads covers the row.  At the DiT's width B=1 still gives at least
    128 warps (of the H100's 132 SMs), and d=4096 fits."""
    vectors = tadaln.row_vectors(b, s, d, SMS, itemsize=2, epilogue=epilogue)
    if vectors is None:
        threads, vpt = tadaln.launch_shape(d, 8, 2)
        assert threads * vpt * 8 >= d and threads <= tadaln.MAX_THREADS
        assert d > tadaln.ROW_MAX_D or (
            epilogue and b * s < tadaln.BF16_EPILOGUE_ROWS_PER_SM * SMS)
        warps = b * s * threads // 32
    else:
        assert vectors * 32 * 8 >= d and vectors <= 4
        per = tadaln.ROW_WARPS                   # warps, one row each
        blocks = -(-s // per)
        taken = {}
        for block in range(b * blocks):
            batch, j = divmod(block, blocks)
            rows = {batch * s + j * per + w for w in range(per)
                    if j * per + w < s}
            assert {r // s for r in rows} <= {batch}
            for r in rows:
                assert r not in taken
                taken[r] = block
        assert sorted(taken) == list(range(b * s))
        warps = b * blocks * per
    if (b, d) == (1, 768):
        assert warps >= 128
    if d == 4096:
        assert vectors is None and tadaln.launch_shape(d, 8, 2) == (512, 1)


@pytest.mark.parametrize("which", ["x", "weight"])
def test_adaln_gradient_through_bf16_raises(which):
    """The backward kernel takes float32 only: a gradient through a
    bfloat16 operand raises in the card's autograd function (before any
    launch) and on meta, never falls back."""
    rng = np.random.default_rng(RNG_SEED)
    _, args = _adaln_operands(rng, 2, 8, 64, which == "weight", False)
    if which == "weight":
        args[0] = args[0].float()
        args[1], args[2] = args[1].float(), args[2].float()
    leaf = args[0 if which == "x" else 3].requires_grad_(True)
    assert leaf.dtype == BF
    with pytest.raises(NotImplementedError, match="float32 only"):
        AdaLNNormFn.apply(*args, None, None, 1e-5)
    meta = [t.detach().to("meta") for t in args]
    meta[0 if which == "x" else 3].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.adaln_norm(*meta)


# -- weights and checkpoints ------------------------------------------------------------

def test_dit_weights_cross_bit_for_bit(reduced_bf16):
    params, model = reduced_bf16
    assert {p.dtype for p in model.parameters()} == {BF}
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(dit_to_jax(model)))
    assert len(got) == len(want)
    for path, leaf in want:
        assert _bits(got[path]) == _bits(leaf), jax.tree_util.keystr(path)
    f32 = dit_from_jax(_np_tree(params), CFG, device="cpu",
                       dtype=torch.float32)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              f32.named_parameters()):
        assert q.dtype == torch.float32 and torch.equal(p.float(), q), n


def test_bf16_dit_checkpoint_crosses_both_ways(reduced_bf16, tmp_path):
    """The port's bfloat16 DiT saved restores into the reference's
    bfloat16 template bit for bit; the reference's own save of its
    bfloat16 params restores into the port's tree and DiT bit for bit."""
    params, model = reduced_bf16
    save(str(tmp_path / "port"), 4, dit_to_jax(model))
    got, step = jckpt.restore(str(tmp_path / "port"),
                              jax.tree_util.tree_map(jnp.zeros_like, params))
    assert step == 4
    for (path, leaf), g in zip(jax.tree_util.tree_leaves_with_path(params),
                               jax.tree_util.tree_leaves(got)):
        assert g.dtype == jnp.bfloat16
        assert _bits(g) == _bits(leaf), jax.tree_util.keystr(path)
    other = jgdm.init_gdm(jax.random.PRNGKey(1), JCFG, dtype=jnp.bfloat16)
    jckpt.save(str(tmp_path / "ref"), 5, other)
    tree, step = restore(str(tmp_path / "ref"), dit_to_jax(model))
    assert step == 5
    back = dit_from_jax(tree, CFG, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(other):
        g = dict(jax.tree_util.tree_leaves_with_path(dit_to_jax(back)))[path]
        assert _bits(g) == _bits(leaf), jax.tree_util.keystr(path)


# -- the DiT in bfloat16 against the reference ------------------------------------------

def _batch(b, seed, bf16):
    rng = np.random.default_rng(seed)
    latent = _arr(rng, b, CFG.latent_hw ** 2, 4, bf16=bf16)
    prompt = rng.integers(2, CFG.vocab_size, size=(b, 8)).astype(np.int32)
    return latent, prompt


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_denoise_bf16_matches_reference(reduced_bf16, impl):
    """A bfloat16 latent over the bfloat16 DiT: the stream in bfloat16 on
    both sides (the reference's both adaLN forms and flash through Pallas
    in interpret mode, or XLA), eps bfloat16, within ``BF16_TOL`` of the
    largest |eps|."""
    params, model = reduced_bf16
    latent, prompt = _batch(3, 4, True)
    t = np.array([0, 5, 15], np.int32)
    want = jax.jit(lambda p, l: jgdm.gdm_denoise(
        p, l, t, prompt, JCFG, impl=impl))(params,
                                           jnp.asarray(latent, jnp.bfloat16))
    with torch.no_grad():
        got = tgdm.gdm_denoise(model, torch.from_numpy(latent).to(BF),
                               torch.from_numpy(t), torch.from_numpy(prompt))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    gap = np.abs(_f32(got) - _f32(want)).max() / np.abs(_f32(want)).max()
    assert gap <= BF16_TOL, gap


def test_run_block_batched_float32_over_bf16_weights(reduced_bf16):
    """A float32 latent over the bfloat16 weights computes in float32 on
    both sides: the float32 bar."""
    params, model = reduced_bf16
    block_idx = np.array([0, 3, 1, 2], np.int32)
    latent, prompt = _batch(len(block_idx), 5, False)
    spb, total = 2, 8
    want = jax.jit(lambda p, l: jgdm.run_block_batched(
        p, l, prompt, JCFG, jgdm.make_schedule(total), block_idx,
        steps_per_block=spb, total_steps=total, impl="xla"))(params, latent)
    with torch.no_grad():
        got = tgdm.run_block_batched(
            model, torch.from_numpy(latent), torch.from_numpy(prompt),
            tgdm.make_schedule(total, device="cpu"),
            torch.from_numpy(block_idx), steps_per_block=spb,
            total_steps=total)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_quality_per_block_over_bf16_weights(reduced_bf16):
    params, model = reduced_bf16
    key = jax.random.PRNGKey(9)
    prompts = jax.random.randint(key, (3, 8), 2, CFG.vocab_size)
    noise = jax.random.normal(key, (3, CFG.latent_hw ** 2, 4))
    want = jax.jit(lambda p: jgdm.quality_per_block(
        p, key, prompts, JCFG, num_blocks=4, steps_per_block=1,
        impl="xla"))(params)
    with torch.no_grad():
        got = tgdm.quality_per_block(
            model, torch.from_numpy(np.array(noise)),
            torch.from_numpy(np.array(prompts)), num_blocks=4,
            steps_per_block=1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_ddim_step_on_a_bf16_latent_returns_float32(reduced_bf16):
    """The float32 schedule promotes the update on both sides; the
    reference's eps in bfloat16 and the port's within ``BF16_TOL``, so
    the updates agree to that bar."""
    params, model = reduced_bf16
    total = 8
    latent, prompt = _batch(2, 6, True)
    step = np.array([7, 0], np.int32)
    w_lat, w_x0 = jax.jit(lambda p, l: jgdm.ddim_step(
        p, l, step, prompt, JCFG, jgdm.make_schedule(total),
        total_steps=total, impl="xla"))(params,
                                        jnp.asarray(latent, jnp.bfloat16))
    with torch.no_grad():
        g_lat, g_x0 = tgdm.ddim_step(
            model, torch.from_numpy(latent).to(BF), torch.from_numpy(step),
            torch.from_numpy(prompt), tgdm.make_schedule(total,
                                                         device="cpu"),
            total_steps=total)
    for g, w in ((g_lat, w_lat), (g_x0, w_x0)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        gap = np.abs(g.numpy() - np.asarray(w)).max() / np.abs(
            np.asarray(w)).max()
        assert gap <= BF16_TOL, gap


def test_run_block_batched_refuses_a_bf16_latent(reduced_bf16):
    params, model = reduced_bf16
    latent, prompt = _batch(2, 7, True)
    idx = np.array([0, 1], np.int32)
    with pytest.raises(TypeError):
        jgdm.run_block_batched(params, jnp.asarray(latent, jnp.bfloat16),
                               prompt, JCFG, jgdm.make_schedule(8), idx,
                               steps_per_block=2, total_steps=8, impl="xla")
    with pytest.raises(TypeError, match="float32"):
        tgdm.run_block_batched(model, torch.from_numpy(latent).to(BF),
                               torch.from_numpy(prompt),
                               tgdm.make_schedule(8, device="cpu"),
                               torch.from_numpy(idx), steps_per_block=2,
                               total_steps=8)


def test_init_gdm_dtype():
    """``init_gdm(dtype=)`` builds every parameter in it, float32 by
    default, as the reference's."""
    assert {p.dtype for p in tgdm.init_gdm(CFG, device="cpu")
            .parameters()} == {torch.float32}
    model = tgdm.init_gdm(CFG, seed=3, device="cpu", dtype=BF)
    assert {p.dtype for p in model.parameters()} == {BF}
    assert all(torch.isfinite(p.float()).all() for p in model.parameters())


# -- a bfloat16 forward counted on meta and on the CPU --------------------------------

def test_bf16_forward_counts_the_same_on_meta_and_cpu():
    """Two layers: one call each of ``adaln_norm_bf16`` and
    ``adaln_norm_epilogue_bf16`` a layer, charged at 2 bytes an element,
    and ``flash_attention_bf16``; the same ``Cost`` on meta and the CPU."""
    b, s, d = 2, CFG.latent_hw ** 2, CFG.d_model
    costs = []
    for device in ("meta", "cpu"):
        model = tgdm.DiT(CFG, device=device, dtype=BF)
        if device == "cpu":
            model.reset_parameters(torch.Generator().manual_seed(0))
        if device == "meta":
            lat = torch.empty(b, s, 4, dtype=BF, device="meta")
            t = torch.empty(b, dtype=torch.long, device="meta")
            prompt = torch.empty(b, 8, dtype=torch.long, device="meta")
        else:
            lat = torch.randn(b, s, 4).to(BF)
            t = torch.tensor([1, 3])
            prompt = torch.randint(2, CFG.vocab_size, (b, 8))
        with torch.no_grad(), op_cost.count() as counter:
            tgdm.gdm_denoise(model, lat, t, prompt)
        costs.append(counter.cost)
    assert costs[0] == costs[1]
    kernels = costs[0].kernels
    layers = CFG.num_layers
    for name, epilogue in (("adaln_norm_bf16", False),
                           ("adaln_norm_epilogue_bf16", True)):
        flops, nbytes = tadaln.work(b, s, d, epilogue, 2)
        assert kernels[name] == [layers, layers * flops, layers * nbytes]
    assert kernels["flash_attention_bf16"][0] == layers
    assert not {"adaln_norm", "adaln_norm_epilogue",
                "flash_attention"} & set(kernels)
