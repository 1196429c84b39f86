"""Port parity: the plain PyTorch versions of the hand-written kernels
(``repro_torch.kernels.ref``, which the CPU dispatch runs) against the JAX
reference's oracle (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerance 1e-6 in float32: the port's ops follow the oracle's op order, so
only the summation order inside a reduction or a contraction differs.
The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.  The gradient formulas that the
card's ``flash_attention`` and ``rmsnorm`` run backwards are held here, on
CPU tensors, to autograd of the plain versions and to ``jax.grad`` of the
oracles at 1e-5 (sums over keys, rows and heads in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-6


def _inputs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


# -- adaln_norm ------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d", [(2, 16, 64), (3, 17, 48), (1, 256, 96)])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("b1d", [False, True])
def test_adaln_norm_matches_reference(b, s, d, epilogue, b1d):
    x, sh, sc, g, res, w, bias = _inputs(
        b * 1000 + s, (b, s, d), (b, d), (b, d), (b, d), (b, s, d), (d,), (d,))
    w = 1.0 + 0.1 * w
    mod = (lambda a: a.reshape(b, 1, d)) if b1d else (lambda a: a)
    extra_np = (mod(g), res) if epilogue else ()
    want_ref = jref.adaln_norm(x, sh, sc, w, bias,
                               *((g, res) if epilogue else ()))
    want_pallas = jops.adaln_norm(x, mod(sh), mod(sc), w, bias, *extra_np,
                                  impl="interpret", block_rows=8)
    t = torch.from_numpy
    got_plain = tref.adaln_norm(t(x), t(sh), t(sc), t(w), t(bias),
                                *((t(g), t(res)) if epilogue else ()))
    got_ops = tops.adaln_norm(t(x), t(mod(sh)), t(mod(sc)), t(w), t(bias),
                              *((t(mod(g)), t(res)) if epilogue else ()))
    outs = (lambda o: o) if epilogue else (lambda o: (o,))
    for got, ref_out, pal_out, op_out in zip(
            outs(got_plain), outs(want_ref), outs(want_pallas), outs(got_ops)):
        _close(got, ref_out)
        _close(got, pal_out)
        np.testing.assert_array_equal(op_out.numpy(), got.numpy())


def test_adaln_norm_cpu_dispatch_takes_strided_modulation():
    """The DiT passes shift/scale/gate as (B, 1, d) chunks of one (B, 1, 6d)
    projection: strided views, as the CUDA wrapper takes them too."""
    b, s, d = 2, 8, 32
    x, mods, w, bias = (torch.from_numpy(a) for a in _inputs(
        5, (b, s, d), (b, 1, 6 * d), (d,), (d,)))
    sh, sc, g = mods.chunk(6, dim=-1)[:3]
    assert not sh.is_contiguous()
    y, r = tops.adaln_norm(x, sh, sc, w, bias, g, x)
    y_want, r_want = tref.adaln_norm(x, sh.reshape(b, d).contiguous(),
                                     sc.reshape(b, d).contiguous(), w, bias,
                                     g.reshape(b, d).contiguous(), x)
    np.testing.assert_array_equal(y.numpy(), y_want.numpy())
    np.testing.assert_array_equal(r.numpy(), r_want.numpy())


def _adaln_block_emulation(x, shift, scale, weight, bias, gate=None,
                           residual=None, *, eps=1e-5, width=4,
                           kernel="block"):
    """``adaln_norm.cu``'s arithmetic on CPU tensors.  ``"block"``
    (``adaln_kernel``): one block a row of ``launch_shape`` threads;
    thread t holds vectors t + k * threads (k < vpt) of ``width`` floats
    and adds its values in k, then element order; a warp's 32 partials
    meet in a shuffle butterfly (offsets 16 .. 1) and the warps' sums are
    added in warp order.  ``"rows"`` (``adaln_rows_kernel``, float4 only):
    one warp a row, lane l holds vectors l + 32 k (k < ``row_vectors``),
    the same butterfly, no cross-warp step.  Mean first, then
    the mean of squared deviations, as the kernel's two sums."""
    from repro_torch.kernels.adaln_norm import launch_shape, row_vectors
    b, s, d = x.shape
    if kernel == "block":
        threads, vpt = launch_shape(d, width)
    else:
        threads, vpt = 32, row_vectors(b, s, d, 132)
    r = x if residual is None else residual + gate[:, None, :] * x
    rows = r.reshape(b * s, d)
    cap = threads * vpt * width
    lanes = torch.arange(32)

    def block_sum(vals):                      # vals: (rows, d), pads zero
        padded = torch.zeros(rows.shape[0], cap)
        padded[:, :d] = vals
        per = padded.view(-1, vpt, threads, width)
        part = torch.zeros(rows.shape[0], threads)
        for k in range(vpt):
            for e in range(width):
                part = part + per[:, k, :, e]
        part = part.view(-1, threads // 32, 32)
        for off in (16, 8, 4, 2, 1):
            part = part + part[..., lanes ^ off]
        total = torch.zeros(rows.shape[0])
        for w in range(threads // 32):
            total = total + part[:, w, 0]
        return total

    mean = block_sum(rows) / d
    c = rows - mean[:, None]
    rstd = 1.0 / torch.sqrt(block_sum(c * c) / d + eps)
    y = (c * rstd[:, None]) * weight + bias
    bidx = torch.arange(b * s) // s
    y = y * (1.0 + scale[bidx]) + shift[bidx]
    y = y.view(b, s, d)
    return y if residual is None else (y, r)


@pytest.mark.parametrize("b,s,d,width,tol", [
    (2, 16, 768, 4, TOL),   # the DiT's width: a warp a row, six float4 a
                            # lane (and 96 threads, two float4 each)
    (3, 5, 99, 1, TOL),     # no multiple of 4: single floats
    (1, 4, 2048, 1, 1e-5),  # four values a thread
    (2, 3, 4096, 1, 1e-5),  # the widest row: 512 threads, eight values each
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_adaln_block_sums_match_reference(b, s, d, width, tol, epilogue):
    """The kernels' fixed-order sums hold the reference's
    adaLN at 1e-6 at the DiT's width (float32, only the order of the sums
    differs).  Rows of thousands of values are held at the card's 1e-5:
    there the plain version's own sums sit up to 2.9e-6 from the
    reference's (measured here at d = 2048 to 4096)."""
    x, sh, sc, g, res, w, bias = _inputs(
        d + b, (b, s, d), (b, d), (b, d), (b, d), (b, s, d), (d,), (d,))
    w = 1.0 + 0.1 * w
    extra = (g, res) if epilogue else ()
    want = jref.adaln_norm(x, sh, sc, w, bias, *extra)
    t = torch.from_numpy
    plain = tref.adaln_norm(t(x), t(sh), t(sc), t(w), t(bias),
                            *(t(a) for a in extra))
    # the rows kernel takes float4 rows up to ROW_MAX_D values
    for kernel in ("block", "rows") if width == 4 and d <= 1024 else (
            "block",):
        got = _adaln_block_emulation(t(x), t(sh), t(sc), t(w), t(bias),
                                     *(t(a) for a in extra), width=width,
                                     kernel=kernel)
        for got_o, want_o in zip(*((got, want) if epilogue else ((got,),
                                                                (want,)))):
            _close(got_o, want_o, tol)
        _close(got[0] if epilogue else got, plain[0] if epilogue else plain,
               tol)


def test_adaln_load_width_follows_shapes_strides_and_offsets():
    """The wrapper moves 16 bytes a load only where every row of every
    operand starts on a 16-byte boundary; the choice needs no card."""
    from repro_torch.kernels.adaln_norm import launch_shape, load_width
    b, s, d = 2, 4, 768
    x, res = torch.zeros(b, s, d), torch.zeros(b, s, d)
    w, bias = torch.zeros(d), torch.zeros(d)

    def chunks(width, first=0):
        mods = torch.zeros(b, 1, width)[..., first:first + 6 * d]
        return [c.reshape(b, d) for c in mods.chunk(6, dim=-1)[:3]]

    sh, sc, g = chunks(6 * d)                     # the DiT's projection
    assert load_width(x, sh, sc, w, bias) == 4
    assert load_width(x, sh, sc, w, bias, g, res) == 4
    sh1, sc1, g1 = chunks(6 * d + 1, first=1)     # views 4 bytes off
    assert load_width(x, sh1, sc1, w, bias) == 1
    assert load_width(x, sh, sc, w, bias, g1, res) == 1
    sh2, sc2, _ = chunks(6 * d + 2)               # row stride 4610 floats
    assert sh2.data_ptr() % 16 == 0 and sh2.stride(0) % 4 == 2
    assert load_width(x, sh2, sc, w, bias) == 1
    flat = torch.zeros(b * s * d + 1)
    assert load_width(flat[1:].view(b, s, d), sh, sc, w, bias) == 1
    assert load_width(x, sh, sc, torch.zeros(d + 1)[1:], bias) == 1
    assert load_width(torch.zeros(b, s, 99), torch.zeros(b, 99),
                      torch.zeros(b, 99), torch.zeros(99),
                      torch.zeros(99)) == 1
    assert load_width(torch.zeros(b, s, 100), torch.zeros(b, 100),
                      torch.zeros(b, 100), torch.zeros(100),
                      torch.zeros(100)) == 4
    assert launch_shape(768, 4) == (96, 2)
    assert launch_shape(768, 1) == (384, 2)
    assert launch_shape(99, 1) == (64, 2)
    assert launch_shape(2048, 1) == (512, 4)
    assert launch_shape(4096, 1) == (512, 8)
    assert launch_shape(4096, 4) == (512, 2)
    from repro_torch.kernels.adaln_norm import launch_plan
    for (b_, s_, d_, width, epilogue), plan in (
            ((4, 256, 768, 4, False), (1, 128, 6)),   # the DiT: a warp a row
            ((1, 256, 768, 4, True), (1, 128, 6)),
            ((2, 8, 100, 4, False), (1, 128, 1)),
            ((4, 256, 768, 1, False), (0, 384, 2)),   # single floats
            ((2, 8, 2048, 4, True), (0, 256, 2))):    # over 1024 values
        assert launch_plan(b_, s_, d_, width, 4, epilogue, 132) == plan


# -- flash_attention ---------------------------------------------------------------

ATTN_CASES = [
    # (b, sq, sk, h, kh, d, causal, window, q_offset)
    (2, 16, 16, 4, 4, 16, False, 0, 0),      # reduced gdm-dit (the DiT path)
    (1, 64, 64, 4, 4, 16, False, 0, 0),      # hw=8 patch grid
    (2, 16, 16, 4, 4, 32, True, 0, 0),       # causal
    (2, 24, 24, 4, 2, 16, True, 6, 0),       # sliding window + GQA
    (1, 16, 16, 4, 4, 16, False, 5, 0),      # window without causal
    (2, 8, 40, 8, 2, 32, True, 0, 32),       # chunked prefill (q_offset)
    (1, 24, 24, 8, 1, 16, True, 0, 0),       # multi-query
    (1, 17, 23, 4, 4, 64, False, 0, 0),      # ragged Sk != Sq
]


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window,q_offset", ATTN_CASES)
def test_attention_matches_reference(b, sq, sk, h, kh, d, causal, window,
                                     q_offset):
    q, k, v = _inputs(sq * 100 + sk, (b, sq, h, d), (b, sk, kh, d),
                      (b, sk, kh, d))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want_ref = jref.attention(q, k, v, **kw)
    want_pallas = jops.flash_attention(q, k, v, impl="interpret", block_q=8,
                                       block_k=8, **kw)
    t = torch.from_numpy
    got = tref.attention(t(q), t(k), t(v), **kw)
    _close(got, want_ref)
    _close(got, want_pallas)
    np.testing.assert_array_equal(
        tops.flash_attention(t(q), t(k), t(v), **kw).numpy(), got.numpy())


def test_attention_fully_masked_rows_match_reference():
    """A row with every key masked (q_offset before the first key) gets the
    oracle's uniform weights over the real keys, from the finite -1e30."""
    q, k, v = _inputs(9, (1, 4, 2, 16), (1, 6, 2, 16), (1, 6, 2, 16))
    kw = dict(causal=True, q_offset=-3)
    want = jref.attention(q, k, v, **kw)
    got = tref.attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(got, want)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits
    to the magnitude, then clear them (a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma(a, b, split):
    """a @ b as the tensor cores form it from TF32 operands, accumulated in
    float32 (a product of two TF32 values is exact in float32).  With
    ``split`` (3xTF32) each operand is big = tf32(x) plus small =
    tf32(x - big), and the three products that matter are summed small
    terms first: big.small + small.big + big.big."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (ab @ b_s + a_s @ bb) + ab @ bb


def _tensor_core_attention(q, k, v, causal, split):
    """Attention with both products (S = Q K^T, O = P V) on emulated TF32
    tensor cores and the softmax in float32, as ``flash_attention.cu``
    computes it: scale * log2(e) folded into the scores, exp2, masked
    scores at -1e30, GQA by index."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(h // kh, dim=2).permute(0, 2, 3, 1)  # b h d s
    vf = v.repeat_interleave(h // kh, dim=2).transpose(1, 2)      # b h s d
    s = _mma(q.transpose(1, 2), kf, split) * (d ** -0.5 * math.log2(math.e))
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(keep, s, torch.tensor(-1e30))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = _mma(p, vf, split) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d,causal", [
    (1, 256, 3, 3, 64, False),      # the DiT's attention, 3 of its 12 heads
    (1, 128, 8, 2, 128, True),      # the trainer's: D=128, GQA, causal
])
def test_3xtf32_attention_holds_the_float32_tolerance(b, s, h, kh, d, causal,
                                                      split):
    """The arithmetic of ``flash_attention.cu``'s tensor-core route, on the
    CPU: 3xTF32 products hold 1e-5 (the card's tolerance against the plain
    version) at the DiT's and the trainer's shapes; plain TF32 (no small
    terms) misses it there, so this test tells the two apart."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    want = tref.attention(q, k, v, causal=causal)
    err = float((_tensor_core_attention(q, k, v, causal, split)
                 - want).abs().max())
    if split:
        assert err <= 1e-5
    else:
        assert err > 1e-5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """Ties go away from zero, a carry rounds up into the exponent."""
    x = torch.tensor([1.0, 1 + 2 ** -12, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -11), 2 - 2 ** -12, 1 + 2 ** -10])
    want = [1.0, 1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 2.0,
            1 + 2 ** -10]
    np.testing.assert_array_equal(_tf32(x).numpy(),
                                  np.array(want, np.float32))


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor is an
    error there, and only ``ops`` routes it to the plain path."""
    from repro_torch.kernels.adaln_norm import adaln_norm_cuda
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    x = torch.zeros(1, 4, 8)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="cpu"):
        adaln_norm_cuda(x, torch.zeros(1, 8), torch.zeros(1, 8), v, v)
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="cpu"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="cpu"):
        decode_attention_cuda(torch.zeros(1, 2, 16), q, q,
                              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="cpu"):
        rmsnorm_cuda(x, v)


class _Elsewhere(torch.Tensor):
    """A tensor that says it lives on a device the ops have no path for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ops_refuse_unknown_devices():
    """A device that is neither the card, the CPU nor meta raises; the
    meta device (the dry run's) gets each op's output shapes."""
    x = torch.zeros(1, 2, 4).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="no implementation"):
        tops.adaln_norm(x, torch.zeros(1, 4), torch.zeros(1, 4),
                        torch.zeros(4), torch.zeros(4))
    q = torch.zeros(1, 2, 1, 16).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="no implementation"):
        tops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no implementation"):
        tops.decode_attention(q[:, 0], q, q, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="no implementation"):
        tops.rmsnorm(x, torch.zeros(4))
    meta = torch.zeros(1, 2, 4, device="meta")
    row = torch.zeros(1, 4, device="meta")
    vec = torch.zeros(4, device="meta")
    y, r = tops.adaln_norm(meta, row, row, vec, vec, gate=row, residual=meta)
    assert y.shape == r.shape == meta.shape and y.device.type == "meta"
    q = torch.zeros(1, 2, 1, 16, device="meta")
    assert tops.flash_attention(q, q, q).shape == q.shape
    assert tops.decode_attention(
        q[:, 0], q, q, torch.zeros(1, dtype=torch.int32, device="meta")
    ).shape == q[:, 0].shape
    assert tops.rmsnorm(meta, vec).shape == meta.shape


# -- decode_attention ---------------------------------------------------------------

DECODE_CASES = [
    # (b, s, h, kh, d, lengths)
    (3, 24, 4, 2, 16, [0, 1, 24]),             # reduced yi-6b: G=2; 0, 1, S
    (4, 37, 8, 2, 32, [5, 0, 37, 60]),         # G=4, ragged, length > S
    (2, 19, 4, 4, 16, [7, 19]),                # reduced qwen1.5-4b: G=1
    (2, 300, 4, 1, 64, [1, 257]),              # G=4 over several kv tiles
    (1, 24, 32, 4, 128, [9]),                  # yi-6b heads at the launcher
]


@pytest.mark.parametrize("b,s,h,kh,d,lengths", DECODE_CASES)
def test_decode_attention_matches_reference(b, s, h, kh, d, lengths):
    q, k, v = _inputs(b * 100 + s, (b, h, d), (b, s, kh, d), (b, s, kh, d))
    lens = np.asarray(lengths, np.int32)
    want_ref = jref.decode_attention(q, k, v, lens)
    t = torch.from_numpy
    got = tref.decode_attention(t(q), t(k), t(v), t(lens))
    _close(got, want_ref)
    # the Pallas kernel pads the cache to whole tiles of 8 and, when every
    # score of a row is masked (length 0), averages the pad rows in too; so
    # a length-0 row is compared with it only where S needs no pad
    if s % 8 == 0 or min(lengths) > 0:
        want_pallas = jops.decode_attention(q, k, v, lens, impl="interpret",
                                            block_k=8)
        _close(got, want_pallas)
    np.testing.assert_array_equal(
        tops.decode_attention(t(q), t(k), t(v), t(lens)).numpy(),
        got.numpy())


def test_decode_attention_empty_row_is_the_uniform_average():
    """Length 0: every score is the finite -1e30, so the row is the mean of
    its S values, as in the reference oracle."""
    q, k, v = _inputs(3, (1, 4, 16), (1, 6, 2, 16), (1, 6, 2, 16))
    got = tref.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.zeros(1, dtype=torch.int32))
    want = np.repeat(v.mean(axis=1), 2, axis=1)
    _close(got, want)


def _decode_kernel_emulation(q, k, v, lengths, sms=132, tile=32):
    """``decode_attention.cu``'s arithmetic on CPU tensors: the splits of
    ``decode_grid`` (chunks of whole ``tile``-key tiles: 32 on the CUDA
    cores, 64 on the tensor cores), each tile divided among the block's
    four warps (``tile / 4`` keys each), every warp keeping its own running
    max, sum and accumulator over its keys of every tile (one max and the
    exponentials per tile and head), the warps merged in warp order with
    the log-sum-exp rule (a warp with no key adds nothing), then the splits
    merged in split order by the same rule.  The head groups only share
    the heads out among blocks; each head's arithmetic is the same."""
    from repro_torch.kernels.decode_attention import decode_grid, split_keys
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5
    warps, kpw = 4, tile // 4
    splits, _ = decode_grid(b * kh, g, s, sms, tile)
    chunk = split_keys(s, splits, tile)              # whole tiles
    inf = torch.tensor(float("inf"))

    def merge(parts):
        """(m, l, acc) partials merged in order, as the kernels do."""
        mx = torch.full((g,), -inf)
        for pm, pl, _ in parts:
            mx = torch.where(pl > 0, torch.maximum(mx, pm), mx)
        lsum, a = torch.zeros(g), torch.zeros(g, d)
        for pm, pl, pacc in parts:
            w = torch.where(pl > 0, torch.exp(pm - mx), torch.zeros(g))
            lsum = lsum + pl * w
            a = a + pacc * w[:, None]
        return mx, lsum, a

    out = torch.empty_like(q)
    for bi in range(b):
        ln = int(lengths[bi])
        masked = ln <= 0
        n = s if masked else min(ln, s)
        for kv in range(kh):
            qg = q[bi, kv * g:(kv + 1) * g]
            parts = []
            for sp in range(splits):
                k0 = sp * chunk
                k1 = min(k0 + chunk, s, n)
                state = [[torch.full((g,), -inf), torch.zeros(g),
                          torch.zeros(g, d)] for _ in range(warps)]
                for t0 in range(k0, k1, tile):
                    nk = min(tile, k1 - t0)
                    for w, (m, lw, acc) in enumerate(state):
                        w0 = w * kpw
                        if w0 >= nk:               # no key of this warp
                            continue
                        sc = torch.full((g, kpw), -inf)
                        kn = min(kpw, nk - w0)
                        rows = slice(t0 + w0, t0 + w0 + kn)
                        sc[:, :kn] = (torch.full((g, kn), -1e30) if masked
                                      else (qg @ k[bi, rows, kv].T) * scale)
                        mx = torch.maximum(m, sc.amax(-1))
                        alpha = torch.exp(m - mx)
                        p = torch.exp(sc - mx[:, None])
                        state[w] = [mx, lw * alpha + p.sum(-1),
                                    acc * alpha[:, None]
                                    + p[:, :kn] @ v[bi, rows, kv]]
                parts.append(merge(state))
            _, lsum, a = merge(parts)
            out[bi, kv * g:(kv + 1) * g] = a / lsum.clamp_min(1e-30)[:, None]
    return out, splits


@pytest.mark.parametrize("b,s,h,kh,d,lengths,tile,want_splits", [
    # the first four keep the ids they had before the tile size was a
    # parameter (32 keys, the CUDA cores')
    pytest.param(1, 24, 32, 4, 128, [24], 32, 1,      # the launcher's decode
                 id="1-24-32-4-128-lengths0-1"),
    pytest.param(5, 24, 32, 4, 128, [0, 1, 23, 24, 30], 32, 1,
                 id="5-24-32-4-128-lengths1-1"),
    pytest.param(7, 320, 8, 2, 32, [0, 1, 64, 65, 319, 320, 330], 32, 5,
                 id="7-320-8-2-32-lengths2-5"),       # split edges
    pytest.param(2, 200, 4, 1, 64, [33, 200], 32, 3,  # 3 splits of 96 keys
                 id="2-200-4-1-64-lengths3-3"),
    # odd G at the CUDA cores' edges: 8-key warp slices, 32-key tiles,
    # 96-key splits; 0, 1, S and past S
    (4, 200, 14, 2, 32, [0, 1, 8, 9], 32, 3),
    (4, 200, 14, 2, 32, [31, 33, 96, 97], 32, 3),
    (3, 200, 6, 2, 16, [7, 192, 200], 32, 3),
    (2, 200, 6, 2, 16, [193, 201], 32, 3),
    # the tensor cores' partition: 16-key warp slices, 64-key tiles,
    # 192-key splits
    (4, 300, 14, 2, 32, [0, 1, 15, 16], 64, 2),
    (4, 300, 14, 2, 32, [17, 63, 65, 192], 64, 2),
    (3, 300, 6, 2, 16, [191, 193, 300], 64, 2),
    (2, 304, 6, 2, 16, [303, 305], 64, 2),
])
def test_decode_kernel_tiles_and_splits_match_reference(b, s, h, kh, d,
                                                        lengths, tile,
                                                        want_splits):
    """The kernel's partition (the splits its grid rule gives at 132 SMs,
    tiles of 32 or 64 keys divided among four warps) and its per-warp
    online softmax with the fixed-order log-sum-exp merges of the warps
    and of the splits hold the oracle and the Pallas kernel at 1e-6
    (float32, only the order of the sums differs).  Lengths 0, 1, S - 1, S
    and past S, and at warp-slice, tile and split edges, with odd G."""
    q, k, v = _inputs(s * 10 + b, (b, h, d), (b, s, kh, d), (b, s, kh, d))
    lens = np.asarray(lengths, np.int32)
    t = torch.from_numpy
    got, splits = _decode_kernel_emulation(t(q), t(k), t(v), t(lens),
                                           tile=tile)
    assert splits == want_splits
    _close(got, jref.decode_attention(q, k, v, lens))
    block_k = 8 if s % 64 else 64
    # the Pallas kernel averages its pad rows into a length-0 row (ROADMAP
    # Queue 3): compare such rows only where S needs no pad
    if s % block_k == 0 or min(lengths) > 0:
        _close(got, jops.decode_attention(q, k, v, lens, impl="interpret",
                                          block_k=block_k))


def test_decode_grid_fills_the_card_from_shapes_alone():
    """The grid rule on 132 SMs: splits of whole tiles that fill two blocks
    an SM but take at least two tiles each (a short cache takes one split
    and no merge), then the G query heads spread over blocks while they
    are fewer than the SMs.  At the launcher's shape the heads spread (32
    blocks, where one block per kv head would use 4 SMs); at B=8, S=4096
    one tile is read once for all 8 heads; llava's G=7 and deepseek's G=8
    split their ~3000-4096 keys into 2-4 tiles a block."""
    from repro_torch.kernels.decode_attention import (TILE_KEYS,
                                                      TILE_KEYS_MMA,
                                                      decode_grid, split_keys,
                                                      tile_keys)
    assert tile_keys(torch.bfloat16, torch.bfloat16) == TILE_KEYS_MMA == 64
    assert tile_keys(torch.float32, torch.bfloat16) == TILE_KEYS == 32
    assert tile_keys(torch.float32, torch.float32) == TILE_KEYS

    def blocks(b, kh, g, s, tile=TILE_KEYS):
        splits, groups = decode_grid(b * kh, g, s, 132, tile)
        # the keys a split takes, as the kernel accepts them: whole tiles,
        # every key covered, no split empty
        chunk = split_keys(s, splits, tile)
        assert chunk % tile == 0 and (splits - 1) * chunk < s <= splits * chunk
        return splits, groups, b * kh * splits * groups

    assert blocks(1, 4, 8, 24) == (1, 8, 32)
    assert blocks(1, 4, 8, 24, 64) == (1, 8, 32)
    assert blocks(8, 4, 8, 4096) == (8, 1, 256)
    assert blocks(8, 4, 8, 4096, 64) == (8, 1, 256)
    assert blocks(1, 4, 8, 4096) == (64, 1, 256)
    assert blocks(1, 4, 8, 4096, 64) == (32, 1, 128)
    assert blocks(1, 4, 8, 160) == (2, 8, 64)           # phase 26's cache
    assert blocks(1, 4, 8, 160, 64) == (1, 8, 32)       # 3 tiles, no merge
    assert blocks(8, 4, 8, 24) == (1, 4, 128)
    assert blocks(8, 8, 1, 4096) == (4, 1, 256)         # G = 1
    assert blocks(2, 4, 4, 777) == (9, 1, 72)           # 3 tiles a split
    assert blocks(1, 4, 8, 63) == (1, 8, 32)            # under two tiles
    assert blocks(64, 4, 8, 24) == (1, 1, 256)          # more pairs than SMs
    assert blocks(1, 8, 7, 3024) == (32, 1, 256)        # llava, G=7
    assert blocks(1, 8, 7, 3024, 64) == (24, 1, 192)
    assert blocks(1, 8, 8, 4096) == (32, 1, 256)        # deepseek, G=8
    assert blocks(1, 8, 8, 4096, 64) == (32, 1, 256)
    assert blocks(1, 1, 1, 1 << 20) == (128, 1, 128)    # the merge's limit


# -- rmsnorm ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 64), (3, 100, 64), (1, 1, 2560),
                                   (257, 48), (2, 3, 4096)])
def test_rmsnorm_matches_reference(shape):
    x, w = _inputs(len(shape) * 10 + shape[-1], shape, (shape[-1],))
    w = 1.0 + 0.1 * w
    want_ref = jref.rmsnorm(x, w)
    want_pallas = jops.rmsnorm(x, w, impl="interpret", block_rows=256)
    t = torch.from_numpy
    got = tref.rmsnorm(t(x), t(w))
    _close(got, want_ref)
    _close(got, want_pallas)
    np.testing.assert_array_equal(tops.rmsnorm(t(x), t(w)).numpy(),
                                  got.numpy())


def _rmsnorm_block_emulation(x, scale, *, eps=1e-6, width=4):
    """``rmsnorm.cu``'s arithmetic on CPU tensors: a row on ``launch_shape``
    threads (a block takes one or two rows; each row's arithmetic is the
    same); thread t holds vectors t + k * threads (k < vpt) of ``width``
    floats and adds their squares in k, then element order; a warp's 32
    partials meet in a shuffle butterfly (offsets 16 .. 1), and after the
    one barrier the warps' sums are added in warp order; then x times the
    inverse root, times scale."""
    from repro_torch.kernels.rmsnorm import launch_shape
    rows, d = x.shape
    threads, vpt = launch_shape(d, width)
    padded = torch.zeros(rows, threads * vpt * width)
    padded[:, :d] = x
    per = padded.view(rows, vpt, threads, width)
    part = torch.zeros(rows, threads)
    for k in range(vpt):
        for e in range(width):
            part = part + per[:, k, :, e] * per[:, k, :, e]
    part = part.view(rows, threads // 32, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    total = torch.zeros(rows)
    for w in range(threads // 32):
        total = total + part[:, w, 0]
    inv = torch.rsqrt(total / d + eps)
    return x * inv[:, None] * scale


@pytest.mark.parametrize("rows,d,width,tol", [
    (3, 64, 4, TOL),         # one warp, four float4 a thread, half idle
    (5, 100, 1, TOL),        # single floats, one warp
    (4, 99, 1, TOL),         # no multiple of 4
    (2, 2560, 4, TOL),       # qwen1.5-4b's width: 160 threads
    (3, 4096, 4, 1e-5),      # yi-6b's and Jamba's rows: 256 threads
    (2, 4096, 1, 1e-5),      # an unaligned view: 1024 threads, four each
    (2, 8192, 4, 1e-5),      # the widest row: 512 threads, four float4
    (2, 8192, 1, 1e-5),      # the widest unaligned row: eight floats each
])
def test_rmsnorm_block_sums_match_reference(rows, d, width, tol):
    """The kernel's one-barrier, fixed-order block sum holds the
    reference's oracle and its Pallas kernel at 1e-6, and rows of 4096 or
    more at the card's 1e-5 (the sums of thousands of squares round in
    another order)."""
    x, w = _inputs(d + rows, (rows, d), (d,))
    w = 1.0 + 0.1 * w
    t = torch.from_numpy
    got = _rmsnorm_block_emulation(t(x), t(w), width=width)
    _close(got, jref.rmsnorm(x, w), tol)
    _close(got, jops.rmsnorm(x, w, impl="interpret", block_rows=8), tol)
    _close(got, tref.rmsnorm(t(x), t(w)), tol)


def test_rmsnorm_load_width_and_launch_shape_follow_rows_and_pointers():
    """The wrapper moves 16 bytes a load only where d % 4 == 0 (8 in
    bfloat16) and x and scale start on 16-byte boundaries, gives a thread
    of the block kernel four vectors of x and four of scale while a row
    has at most 4096 vectors, and gives a block two rows from 512 rows up;
    the row kernel two vectors a lane; the choice needs no card."""
    from repro_torch.kernels.rmsnorm import (lane_shape, launch_shape,
                                             load_width, rows_per_block)
    x, w = torch.zeros(3, 4096), torch.zeros(4096)
    assert load_width(x, w) == 4
    assert load_width(torch.zeros(3 * 4096 + 1)[1:].view(3, 4096), w) == 1
    assert load_width(x, torch.zeros(4097)[1:]) == 1
    assert load_width(torch.zeros(2, 99), torch.zeros(99)) == 1
    assert load_width(torch.zeros(2, 100), torch.zeros(100)) == 4
    assert launch_shape(4096, 4) == (256, 4)      # the decode row
    assert launch_shape(8192, 4) == (512, 4)
    assert launch_shape(2560, 4) == (160, 4)
    assert launch_shape(64, 4) == (32, 4)
    assert launch_shape(4096, 1) == (1024, 4)
    assert launch_shape(8192, 1) == (1024, 8)
    assert launch_shape(100, 1) == (32, 4)
    assert launch_shape(99, 1) == (32, 4)
    assert launch_shape(1, 1) == (32, 4)
    assert [rows_per_block(r) for r in (1, 65, 511, 512, 1024, 8192)] == [
        1, 1, 1, 2, 2, 2]
    # bfloat16: 16 bytes are 8 values, whatever the scale's dtype
    bf = torch.bfloat16
    xb, wb = torch.zeros(3, 4096, dtype=bf), torch.zeros(4096, dtype=bf)
    assert load_width(xb, wb) == 8
    assert load_width(xb, w) == 8                   # a float32 scale
    assert load_width(torch.zeros(3 * 4096 + 1, dtype=bf)[1:].view(3, 4096),
                      wb) == 1
    assert load_width(xb, torch.zeros(4097)[1:]) == 1
    assert load_width(torch.zeros(2, 100, dtype=bf),
                      torch.zeros(100, dtype=bf)) == 1
    assert launch_shape(4096, 8) == (128, 4)        # the block kernel's
    # the row kernel: two vectors a lane
    assert lane_shape(1024, 8) == (64, 2)           # two warps
    assert lane_shape(4096, 8) == (256, 2)
    assert lane_shape(7168, 8) == (448, 2)
    assert lane_shape(8192, 8) == (512, 2)
    assert lane_shape(64, 8) == (32, 2)


@pytest.mark.parametrize("rows,d,dtype,width,kernel", [
    # 16-byte bfloat16: the row kernel, at every row count
    *[(r, d, "bf16", 8, "row") for d in (1024, 4096)
      for r in (1, 16, 128, 256, 512, 1024, 8192)],
    *[(r, 7168, "bf16", 8, "row")
      for r in (1, 128, 512, 791, 792, 1024, 3008, 8192)],
    (1, 8192, "bf16", 8, "row"), (8192, 8192, "bf16", 8, "row"),
    (8192, 2048, "bf16", 8, "row"),
    # single values a load, and float32: the block kernel
    (3, 4096, "bf16", 1, "block"), (7, 100, "bf16", 1, "block"),
    (8192, 7168, "bf16", 1, "block"),
    *[(r, d, "f32", 4, "block") for r, d in (
        (1, 4096), (1024, 4096), (8192, 4096), (1, 1024), (3008, 7168))],
    (5, 99, "f32", 1, "block")])
def test_rmsnorm_launch_plan_picks_the_kernel(rows, d, dtype, width, kernel):
    """``launch_plan`` picks each kernel from the dtype and the load
    width, with the shapes ``launch_shape`` / ``lane_shape`` give and the
    block kernel's rows a block from the row count; the choice needs no
    card."""
    from repro_torch.kernels import rmsnorm as rms
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    plan = rms.launch_plan(rows, d, dt, width)
    if kernel == "block":
        assert plan == rms.Plan(rms.BLOCK, *rms.launch_shape(d, width),
                                rms.rows_per_block(rows))
    else:
        assert plan == rms.Plan(rms.ROW, *rms.lane_shape(d, width), 1)
    assert rms.launch_plan(rows, d, dt) == rms.launch_plan(
        rows, d, dt, 16 // dt.itemsize)


@pytest.mark.parametrize("x_dtype,scale_dtype,takes", [
    ("bf16", "bf16", True), ("bf16", "f32", True), ("f32", "f32", True),
    ("f32", "bf16", False)])
def test_rmsnorm_scale_dtypes(x_dtype, scale_dtype, takes):
    """The kernels take a float32 or bfloat16 scale over bfloat16 rows, as
    the reference's kernel does, and only a float32 scale over float32
    rows: the rule the wrapper checks, on the CPU."""
    from repro_torch.kernels.rmsnorm import scale_dtypes
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    assert (dt[scale_dtype] in scale_dtypes(dt[x_dtype])) == takes


def test_rmsnorm_is_the_reference_layer_function():
    """The port's ``nn.rmsnorm_apply`` (which the LM calls) computes the
    reference's ``nn.rmsnorm_apply`` — the dense LM's norm — as well as
    the kernel's oracle."""
    from repro.nn.norm import rmsnorm_apply as j_apply
    from repro_torch.nn.norm import RMSNorm, rmsnorm_apply
    x, w = _inputs(11, (5, 7, 96), (96,))
    norm = RMSNorm(96, device="cpu")
    norm.scale.data.copy_(torch.from_numpy(1.0 + 0.1 * w))
    for eps in (1e-6, 1e-5):
        got = rmsnorm_apply(norm, torch.from_numpy(x), eps=eps)
        _close(got, j_apply({"scale": 1.0 + 0.1 * w}, x, eps=eps))



# -- gradients on the card: the formulas and the autograd functions -------------------

GRAD_TOL = 1e-5

GRAD_CASES = [
    # (b, sq, sk, h, kh, d, causal, window, q_offset): the training
    # attention (causal, GQA), a window, q_offset, rows with every key
    # masked, multi-query, ragged Sk
    (2, 12, 12, 4, 2, 16, True, 0, 0),
    (2, 10, 10, 4, 4, 8, True, 4, 0),
    (1, 6, 14, 4, 2, 8, True, 0, 8),
    (1, 5, 7, 2, 2, 8, True, 0, -3),
    (1, 9, 9, 4, 1, 8, False, 0, 0),
    (2, 7, 11, 2, 2, 16, False, 3, 0),
]


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window,q_offset", GRAD_CASES)
def test_attention_backward_matches_autograd_and_jax(b, sq, sk, h, kh, d,
                                                     causal, window,
                                                     q_offset):
    """``grad.attention_backward`` (what ``flash_attention``'s backward runs
    on the card) on CPU tensors, against autograd of the plain version and
    ``jax.grad`` of the reference's oracle."""
    from repro_torch.kernels import grad
    q, k, v, do = _inputs(sq * 7 + sk, (b, sq, h, d), (b, sk, kh, d),
                          (b, sk, kh, d), (b, sq, h, d))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jax.grad(lambda q, k, v: jnp.sum(jref.attention(q, k, v, **kw)
                                            * do), argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tref.attention(*leaves, **kw)
    auto = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    got = grad.attention_backward(*(torch.from_numpy(a) for a in (q, k, v)),
                                  o.detach(), torch.from_numpy(do), **kw)
    for g, a, w in zip(got, auto, want):
        _close(g, a.numpy(), GRAD_TOL)
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 4096), (1, 1, 96)])
def test_rmsnorm_backward_matches_autograd_and_jax(shape):
    from repro_torch.kernels import grad
    x, w, dy = _inputs(shape[-1] + len(shape), shape, (shape[-1],), shape)
    w = 1.0 + 0.1 * w
    want = jax.grad(lambda x, w: jnp.sum(jref.rmsnorm(x, w) * dy),
                    argnums=(0, 1))(x, w)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    auto = torch.autograd.grad(tref.rmsnorm(*leaves), leaves,
                               torch.from_numpy(dy))
    got = grad.rmsnorm_backward(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(dy))
    for g, a, want_g in zip(got, auto, want):
        scale = max(1.0, float(np.abs(want_g).max()))
        _close(g / scale, a.numpy() / scale, GRAD_TOL)
        _close(g / scale, np.asarray(want_g) / scale, GRAD_TOL)


def test_autograd_functions_carry_gradients(monkeypatch):
    """The autograd functions that ``ops`` takes on the card, with their
    CUDA launches stood in for by the plain versions (there is no card
    here): every input gets the gradient autograd gives the plain path."""
    from repro_torch.kernels import grad
    from repro_torch.kernels import ssm_scan as scan_mod
    monkeypatch.setattr(grad, "flash_attention_cuda", tref.attention)
    monkeypatch.setattr(grad, "rmsnorm_cuda", tref.rmsnorm)

    def fake_scan(u, delta, a, bmat, cmat, d, *, return_state=False,
                  save_states=False):
        y, h = tref.ssm_scan(u, delta, a, bmat, cmat, d)
        return y, h, torch.empty(0)        # no checkpoints to save

    def fake_backward(u, delta, a, bmat, cmat, d, states, gy):
        leaves = [x.detach().requires_grad_()
                  for x in (u, delta, a, bmat, cmat, d)]
        with torch.enable_grad():
            y, _ = tref.ssm_scan(*leaves)
        return torch.autograd.grad(y, leaves, gy)

    monkeypatch.setattr(scan_mod, "ssm_scan_cuda", fake_scan)
    monkeypatch.setattr(scan_mod, "ssm_scan_backward_cuda", fake_backward)

    def both(fn_kernel, fn_plain, arrays):
        a = [torch.from_numpy(x).requires_grad_() for x in arrays]
        b = [torch.from_numpy(x).requires_grad_() for x in arrays]
        out_k, out_p = fn_kernel(*a), fn_plain(*b)
        w = torch.from_numpy(_inputs(1, tuple(out_p.shape))[0])
        for gk, gp in zip(torch.autograd.grad((out_k * w).sum(), a),
                          torch.autograd.grad((out_p * w).sum(), b)):
            _close(gk, gp.numpy(), GRAD_TOL)

    qkv = _inputs(2, (2, 6, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8))
    both(lambda q, k, v: grad.FlashAttentionFn.apply(q, k, v, True, 3, 0,
                                                     None),
         lambda q, k, v: tref.attention(q, k, v, causal=True, window=3),
         qkv)
    x, w = _inputs(3, (4, 16), (16,))
    both(lambda x, w: grad.RmsNormFn.apply(x, w, 1e-6), tref.rmsnorm, [x, w])
    ins = _inputs(4, (2, 5, 8), (2, 5, 8), (8, 4), (2, 5, 4), (2, 5, 4),
                  (8,))
    ins[1] = np.abs(ins[1]) * 0.3
    ins[2] = -np.abs(ins[2])

    def kernel_path(*t):
        return scan_mod.SsmScanFn.apply(*t)

    def plain_path(*t):
        return tref.ssm_scan(*t)[0]

    both(kernel_path, plain_path, ins)


def test_kernels_without_a_backward_refuse_gradients(monkeypatch):
    """On the card ``decode_attention``, the one kernel without a
    backward, raises where a gradient is wanted instead of cutting the
    graph, before it reaches the library (stubbed here: reaching it fails
    the test).  ``adaln_norm`` has its backward kernel now: its wrapper
    takes inputs that require grad (``ops.adaln_norm`` routes them through
    ``AdaLNNormFn``) and goes on to its usual checks."""
    from repro_torch.kernels import build
    from repro_torch.kernels.adaln_norm import (adaln_norm_backward_cuda,
                                                adaln_norm_cuda)
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(build, "library", no_library)
    x = torch.zeros(1, 4, 8, requires_grad=True)
    mod = torch.zeros(1, 8)
    v = torch.zeros(8)
    q = torch.zeros(1, 2, 16, requires_grad=True)
    cache = torch.zeros(1, 4, 2, 16)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        decode_attention_cuda(q, cache, cache, lens)
    with pytest.raises(ValueError, match="cpu"):
        adaln_norm_cuda(x, mod, mod, v, v)
    with pytest.raises(ValueError, match="cpu"):
        adaln_norm_backward_cuda(x, mod, mod, v, v, torch.zeros(1, 4, 8))
    with torch.no_grad():              # no graph to cut: the usual checks
        with pytest.raises(ValueError, match="cpu"):
            adaln_norm_cuda(x, mod, mod, v, v)
        with pytest.raises(ValueError, match="cpu"):
            decode_attention_cuda(q, cache, cache, lens)
