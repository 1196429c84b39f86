"""Port parity in bfloat16, the reference's default dtype of the LM.

Covered: the plain versions of the four kernels that have a bfloat16
variant (flash attention, decode attention, rmsnorm, the selective scan)
in bfloat16 against the reference's Pallas kernels run in interpret mode,
at ``tests/test_kernels.py``'s shapes and bars, the output's dtype
checked; a prefill and two serve steps of six families (dense yi-6b,
granite's MoE, Jamba with experts, xLSTM, seamless with its encoder
memory, llava with its patches) from the reference's bfloat16 weights
(``init_lm(dtype=jnp.bfloat16)``) carried across, the state in bfloat16
on both sides; the mixed case (float32 parameters, bfloat16 state); the
serve step's cache insert at one position and at each row's own
(``StepOptions.fused_position``), in float32 and bfloat16; bfloat16
leaves across ``lm_from_jax`` / ``lm_to_jax`` and through checkpoints
both ways; the dtypes ``kernels.check_operand`` refuses; one step of each
family counted the same on meta and on the CPU in bfloat16.

Tolerances.  The kernels: the reference's own bfloat16 bars (2e-2, the
scan 5e-2, absolute and relative as ``assert_allclose`` applies them),
compared in float32.  The families: every logit within ``BF16_TOL`` of
the largest |logit| and every state value within it of the largest
state value, compared in float32.  Both frameworks round each op's
output to bfloat16, but not at the same places (XLA fuses chains of
elementwise ops and rounds once at the fusion's end; the port rounds
after each op), so two runs part by a few bfloat16 ulps (2^-8 relative)
a layer.  The mixed case rounds only the cache, identically on both
sides: ``MIXED_TOL``.  Weights and checkpoints: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import (load_train_state, restore,
                                    restore_train_state, save, train_state)
from repro_torch.configs import get_config
from repro_torch.distributed import op_cost
from repro_torch.kernels import check_operand, ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.optim import optimizers as topt

BF16_TOL = 5e-2
MIXED_TOL = 4e-3
RNG_SEED = 42
FAMILIES = ["yi-6b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
            "xlstm-1.3b", "seamless-m4t-large-v2", "llava-next-34b"]
BF = torch.bfloat16


def _arr(rng, *shape, bf16=True, scale=1.0):
    """N(0, scale^2) numpy, rounded to bfloat16 where asked (both sides
    then read the same values)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _pair(x, bf16=True):
    """The same values as a JAX array and a torch tensor, bfloat16 or
    float32."""
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF)
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check_kernel(got, want, tol):
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


# -- the four kernels' plain versions against the Pallas kernels ------------------

@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (1, 8, 8, 2, 2, 16, True),
    (2, 16, 16, 4, 2, 32, True),
    (1, 24, 24, 8, 1, 16, True),
    (2, 8, 40, 8, 2, 32, True),
    (1, 17, 23, 4, 4, 64, True),
    (4, 16, 16, 4, 4, 16, False),
    (2, 64, 64, 4, 2, 16, False),
    (3, 17, 17, 4, 4, 16, False)])
def test_flash_attention_bf16_matches_pallas(b, sq, sk, h, kh, d, causal):
    rng = np.random.default_rng(RNG_SEED)
    (jq, q), (jk, k), (jv, v) = (_pair(_arr(rng, *s)) for s in (
        (b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    off = max(sk - sq, 0) if causal else 0
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=off,
                                impl="interpret", block_q=8, block_k=8)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    _check_kernel(got, want, 2e-2)


@pytest.mark.parametrize("b,s,h,kh,d", [
    (1, 16, 2, 2, 16), (2, 64, 4, 2, 32), (3, 40, 8, 8, 16),
    (1, 128, 8, 1, 32), (2, 33, 4, 1, 64)])
def test_decode_attention_bf16_matches_pallas(b, s, h, kh, d):
    rng = np.random.default_rng(RNG_SEED)
    (jq, q), (jk, k), (jv, v) = (_pair(_arr(rng, *sh)) for sh in (
        (b, h, d), (b, s, kh, d), (b, s, kh, d)))
    lens = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                 impl="interpret", block_k=16)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens))
    _check_kernel(got, want, 2e-2)


def test_decode_attention_float32_query_over_bf16_cache():
    """A float32 model writing a bfloat16 cache: q float32, the output
    float32, the cache's values as the reference's kernel reads them."""
    rng = np.random.default_rng(RNG_SEED)
    (jq, q) = _pair(_arr(rng, 2, 8, 32, bf16=False), bf16=False)
    (jk, k), (jv, v) = (_pair(_arr(rng, 2, 40, 2, 32)) for _ in range(2))
    lens = np.array([40, 17], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                 impl="interpret", block_k=16)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,length,din,n", [
    (1, 16, 32, 8), (2, 32, 64, 8), (1, 64, 32, 16), (2, 48, 96, 4)])
def test_ssm_scan_bf16_matches_pallas(b, length, din, n):
    """u, dt, B and C bfloat16, A and D float32, as the reference's Mamba
    block hands them over; y bfloat16, the final state float32."""
    rng = np.random.default_rng(RNG_SEED)
    ju, u = _pair(_arr(rng, b, length, din))
    jdt, dt = _pair(np.abs(_arr(rng, b, length, din)) * 0.1)
    ja, a = _pair(-np.abs(_arr(rng, din, n, bf16=False)), bf16=False)
    (jb, bm), (jc, cm) = (_pair(_arr(rng, b, length, n)) for _ in range(2))
    jd, dv = _pair(_arr(rng, din, bf16=False), bf16=False)
    want = jops.ssm_scan(ju, jdt, ja, jb, jc, jd, impl="interpret",
                         chunk=16, block_d=32)
    got, h_final = ops.ssm_scan(u, dt, a, bm, cm, dv, return_state=True)
    _check_kernel(got, want, 5e-2)
    _, wh = jref.ssm_scan(ju, jdt, ja, jb, jc, jd)
    assert h_final.dtype == torch.float32
    np.testing.assert_allclose(h_final.numpy(), np.asarray(wh), atol=1e-4,
                               rtol=1e-4)


def _rmsnorm_lanes_emulation(x, scale, *, eps=1e-6):
    """``rmsnorm.cu``'s row kernel on CPU tensors (bfloat16 x,
    a bfloat16 or float32 scale): a row on ``lane_shape`` threads of
    16-byte vectors (8 values); thread t widens vectors t + k * threads
    (k < 2) to float32 and adds their squares in k, then element order; a
    warp's 32 partials meet in a shuffle butterfly (offsets 16 .. 1), the
    warps' sums add in warp order; then x times the inverse root, times
    scale, in float32, rounded once to bfloat16."""
    from repro_torch.kernels.rmsnorm import lane_shape
    rows, d = x.shape
    threads, vpt = lane_shape(d, 8)
    padded = torch.zeros(rows, threads * vpt * 8)
    padded[:, :d] = x.float()
    per = padded.view(rows, vpt, threads, 8)
    part = torch.zeros(rows, threads)
    for k in range(vpt):
        for e in range(8):
            part = part + per[:, k, :, e] * per[:, k, :, e]
    part = part.view(rows, threads // 32, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    total = torch.zeros(rows)
    for w in range(threads // 32):
        total = total + part[:, w, 0]
    inv = torch.rsqrt(total / d + eps)
    return (x.float() * inv[:, None] * scale.float()).to(BF)


@pytest.mark.parametrize("shape", [
    (4, 32), (3, 17, 96), (2, 5, 7, 64),     # one warp: no barrier
    (2, 1024),        # granite's row: two warps of two vectors a lane
    (2, 4096),        # yi-6b's and Jamba's rows: 256 threads
    (2, 7168)])       # llava's rows: 448 threads
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_rmsnorm_bf16_matches_pallas(shape, scale_dtype):
    """The port's plain version, and the row kernel's order of sums
    (``_rmsnorm_lanes_emulation``), on bfloat16 rows with either
    scale dtype, against the reference's Pallas kernel (interpret mode)
    and its oracle at the reference's bfloat16 bar."""
    rng = np.random.default_rng(RNG_SEED)
    jx, x = _pair(_arr(rng, *shape))
    js, sc = _pair(_arr(rng, shape[-1], bf16=scale_dtype == "bfloat16"),
                   bf16=scale_dtype == "bfloat16")
    want = jops.rmsnorm(jx, js, impl="interpret", block_rows=8)
    got = ops.rmsnorm(x, sc)
    _check_kernel(got, want, 2e-2)
    lanes = _rmsnorm_lanes_emulation(x.reshape(-1, shape[-1]),
                                     sc).reshape(shape)
    _check_kernel(lanes, want, 2e-2)
    _check_kernel(lanes, jref.rmsnorm(jx, js), 2e-2)


# -- check_operand's refusals --------------------------------------------------------

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype,takes,ok", [
    (torch.float32, (torch.float32,), True),
    (BF, (torch.float32, BF), True),
    (BF, (torch.float32,), False),          # a kernel without bf16 (adaLN)
    (torch.float16, (torch.float32, BF), False),
    (torch.float64, (torch.float32, BF), False),
    (torch.float32, (BF,), False)])         # a mix: v unlike k
def test_check_operand_refuses_other_dtypes(dtype, takes, ok):
    t = torch.zeros(2, 3, dtype=dtype)
    if ok:
        check_operand("x", t, CPU, (2, 3), dtypes=takes)
        return
    with pytest.raises(TypeError, match=f"x: dtype {dtype}; the kernel "
                       "takes"):
        check_operand("x", t, CPU, (2, 3), dtypes=takes)


def test_check_operand_takes_float32_by_default():
    with pytest.raises(TypeError, match="takes float32 here"):
        check_operand("scale", torch.zeros(3, dtype=BF), CPU, (3,))


# -- the families in bfloat16 --------------------------------------------------------

def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


_JIT_INIT = jax.jit(jlm.init_lm, static_argnames=("cfg", "dtype"))


@functools.lru_cache(maxsize=None)
def _init(arch, seed, dtype):
    """The reference's bfloat16 ``init_lm`` of reduced ``arch`` (jitted:
    eagerly it takes seconds), shared by the tests; for float32 its
    leaves widened (float32 parameters whose values bfloat16 holds)."""
    params = _JIT_INIT(jax.random.PRNGKey(seed),
                       cfg=jax_get_config(arch).reduced(),
                       dtype=jnp.bfloat16)
    if dtype == jnp.bfloat16:
        return params
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)


def _stubs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.num_patch_tokens:
        out["patch_embeds"] = (0.5 * rng.standard_normal(
            (b, 4, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = (0.5 * rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


def _state_leaves(state):
    """Copies of a port decode state's tensors (the serve step updates
    them in place) in the reference's leaf order."""
    return [t.clone() for slot in state for key in sorted(slot)
            for t in (slot[key] if isinstance(slot[key], tuple)
                      else (slot[key],))]


def _gap(got, want):
    """max|got - want| over max|want|, in float32."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _run_both(arch, params_dtype, state_dtype, opts=None, jopts=None,
              steps=2, b=2, s=6, seed=4, ragged=False):
    """The reference's and the port's prefill and ``steps`` serve steps
    of reduced ``arch`` from the same weights (the reference's, drawn in
    ``params_dtype``) and the same tokens.  With ``ragged``, row 1 of every
    cache is two positions shorter before the steps, on both sides.
    Returns [(port, reference)] pairs of the logits and the states'
    leaves after the prefill and after each step."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jdt = jnp.bfloat16 if params_dtype == BF else jnp.float32
    sdt = jnp.bfloat16 if state_dtype == BF else jnp.float32
    params = _init(arch, FAMILIES.index(arch), jdt)
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + steps)) \
        .astype(np.int32)
    batch = dict(tokens=toks[:, :s], **_stubs(cfg, b, seed))
    xla = jsteps.StepOptions(impl="xla")
    want = jax.jit(jsteps.make_prefill_step(
        jcfg, max_seq=s + steps + 1, state_dtype=sdt, opts=xla))(params,
                                                                 batch)
    got = tsteps.make_prefill_step(cfg, max_seq=s + steps + 1,
                                   state_dtype=state_dtype)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    wstate, gstate = want["state"], got["state"]
    if ragged:
        wstate = jax.tree_util.tree_map(lambda x: x, wstate)
        for slot_w, slot_g in zip(wstate, gstate):
            if "kv" in slot_g:
                kv = slot_w["kv"]
                slot_w["kv"] = kv._replace(length=kv.length.at[:, 1].add(-2))
                slot_g["kv"].length[:, 1] -= 2
    out = [((got["logits"], _state_leaves(gstate)),
            (want["logits"], jax.tree_util.tree_leaves(wstate)))]
    jserve = jax.jit(jsteps.make_serve_step(jcfg, opts=jopts or xla))
    serve = tsteps.make_serve_step(cfg, opts=opts or tsteps.StepOptions())
    for t in range(steps):
        tok = toks[:, s + t]
        wl, wstate = jserve(params, jnp.asarray(tok), wstate,
                            want.get("memory"))
        gl, gstate = serve(model, torch.from_numpy(tok), gstate,
                           got.get("memory"))
        out.append(((gl, _state_leaves(gstate)),
                    (wl, jax.tree_util.tree_leaves(wstate))))
    return cfg, out


def _hold(cfg, runs, tol):
    """Every pair's logits (the real vocabulary) and state leaves within
    ``tol`` of the reference's largest magnitude; lengths exact; every
    state leaf of the reference's dtype."""
    v = cfg.vocab_size
    worst = 0.0
    for (gl, gs), (wl, ws) in runs:
        assert gl.dtype == {"bfloat16": BF, "float32": torch.float32}[
            jnp.asarray(wl).dtype.name]
        worst = max(worst, _gap(gl[..., :v], np.asarray(wl)[..., :v]))
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert str(g.dtype).replace("torch.", "") == w.dtype.name
            if g.is_floating_point():
                worst = max(worst, _gap(g, w))
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert worst <= tol, worst
    return worst


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_serve_steps_in_bf16(arch):
    """bfloat16 weights and state on both sides; logits (bfloat16, as the
    reference's) and states within ``BF16_TOL`` of the largest."""
    cfg, runs = _run_both(arch, BF, BF)
    _hold(cfg, runs, BF16_TOL)


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b"])
def test_float32_params_with_a_bf16_state(arch):
    """The reference's ``make_prefill_step`` default over float32 params:
    the caches and conv tails bfloat16, everything else float32."""
    cfg, runs = _run_both(arch, torch.float32, BF)
    _hold(cfg, runs, MIXED_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("fused", [True, False])
def test_fused_position_both_ways_match_reference(dtype, fused):
    """``StepOptions(fused_position=)`` through ``make_serve_step``: rows
    of unequal lengths insert at the first row's position (True) or at
    their own (False), as the reference's; float32 at 1e-5, bfloat16 at
    ``BF16_TOL``."""
    cfg, runs = _run_both(
        "yi-6b", dtype, dtype, ragged=True,
        opts=tsteps.StepOptions(fused_position=fused),
        jopts=jsteps.StepOptions(fused_position=fused, impl="xla"))
    _hold(cfg, runs, 1e-5 if dtype == torch.float32 else BF16_TOL)


def test_fused_position_changes_the_cache():
    """The two inserts part on a ragged batch: the lever is live."""
    caches = []
    for fused in (True, False):
        _, runs = _run_both("yi-6b", torch.float32, torch.float32,
                            ragged=True, steps=1,
                            opts=tsteps.StepOptions(fused_position=fused))
        caches.append(runs[-1][0][1][0])
    assert not torch.equal(caches[0], caches[1])


# -- weights and checkpoints ---------------------------------------------------------

@pytest.fixture(scope="module")
def jamba_bf16():
    return (jax_get_config("jamba-v0.1-52b").reduced(),
            _init("jamba-v0.1-52b", 5, jnp.bfloat16))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint8).tobytes(), x.dtype, x.shape


def test_lm_weights_cross_bit_for_bit(jamba_bf16):
    """bfloat16 leaves (and the float32 ones the reference keeps) across
    ``lm_from_jax`` and back, bit for bit."""
    jcfg, params = jamba_bf16
    model = lm_from_jax(_np_tree(params), get_config(
        "jamba-v0.1-52b").reduced(), device="cpu")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["layers.0.1.mamba.a_log"] == torch.float32
    assert dtypes["layers.0.1.moe.router"] == torch.float32
    assert dtypes["layers.0.0.attn.wq.w"] == BF
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_to_jax(model)))
    assert len(got) == len(want)
    for path, leaf in want:
        assert _bits(got[path]) == _bits(leaf), jax.tree_util.keystr(path)


def test_restore_into_a_bf16_template(tmp_path):
    """The reference's ``test_elastic_restore_dtype_cast`` on the port,
    the values checked too."""
    state = {"params": {"w": torch.arange(6, dtype=torch.float32)
                        .reshape(2, 3) * 0.37},
             "step": torch.tensor(7)}
    save(str(tmp_path), 3, state)
    template = {"params": {"w": torch.zeros(2, 3, dtype=BF)},
                "step": torch.tensor(0)}
    out, _ = restore(str(tmp_path), template)
    assert out["params"]["w"].dtype == BF
    assert torch.equal(out["params"]["w"], state["params"]["w"].to(BF))


def test_bf16_lm_checkpoint_crosses_both_ways(jamba_bf16, tmp_path):
    """A bfloat16 LM and its AdamW state saved by the port restore into
    the reference's bfloat16 template bit for bit; the reference's own
    bfloat16 save restores into the port bit for bit."""
    jcfg, params = jamba_bf16
    cfg = get_config("jamba-v0.1-52b").reduced()
    model = lm_from_jax(_np_tree(params), cfg, device="cpu")
    opt = topt.adamw(1e-3)[0](tsteps.trainable(model))
    save(str(tmp_path / "port"), 2, train_state(model, opt))
    jstate = jopt.adamw(1e-3)[0](params)
    like = jax.tree_util.tree_map(jnp.zeros_like, (params, jstate))
    (got_p, _), step = jckpt.restore(str(tmp_path / "port"), like)
    assert step == 2
    for (path, leaf), got in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves(got_p)):
        assert _bits(got) == _bits(leaf), jax.tree_util.keystr(path)
    jckpt.save(str(tmp_path / "ref"), 3, (params, jstate))
    back = lm_from_jax(_np_tree(_init("jamba-v0.1-52b", 6, jnp.bfloat16)),
                       cfg, device="cpu")
    opt2 = topt.adamw(1e-3)[0](tsteps.trainable(back))
    opt2, step = restore_train_state(str(tmp_path / "ref"), back, opt2)
    assert step == 3
    for (n, p), (_, q) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    arrays = {k: np.asarray(v) for k, v in
              jckpt.checkpoint._flatten_with_paths((params, jstate)).items()}
    load_train_state(arrays, back, opt2)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 back.parameters()))


# -- one step counted the same on meta and on the CPU, in bfloat16 ----------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b"])
def test_bf16_step_counts_the_same_on_meta_and_cpu(arch, kind):
    """The bfloat16 kernels charged under their own names, at 2 bytes an
    element, the same on meta (shapes only) and on the CPU (the plain
    versions)."""
    cfg = get_config(arch).reduced()
    costs = []
    for device in ("meta", "cpu"):
        model = tlm.LM(cfg, device=device, dtype=BF)
        if device == "cpu":
            model.reset_parameters(torch.Generator().manual_seed(0))
        b, s = 2, 8
        if kind == "prefill":
            toks = (torch.empty(b, s, dtype=torch.int32, device="meta")
                    if device == "meta" else
                    torch.randint(0, cfg.vocab_size, (b, s),
                                  dtype=torch.int32))
            step = tsteps.make_prefill_step(cfg, max_seq=s)
            call = lambda: step(model, {"tokens": toks})   # noqa: E731
        else:
            state = tlm.init_decode_state(cfg, b, s, device=device)
            tok = torch.zeros(b, dtype=torch.int32, device=device)
            step = tsteps.make_serve_step(cfg)
            call = lambda: step(model, tok, state)         # noqa: E731
        with op_cost.count() as counter:
            call()
        costs.append(counter.cost)
    assert costs[0] == costs[1]
    names = set(costs[0].kernels)
    assert "rmsnorm_bf16" in names and "rmsnorm" not in names
    assert ("flash_attention_bf16" if kind == "prefill"
            else "decode_attention_bf16") in names
    if arch.startswith("jamba") and kind == "prefill":
        assert "ssm_scan_bf16" in names
