"""Port parity: the selective scan and the Mamba block (``repro_torch.
kernels.ref.ssm_scan``, its written-out backward, ``repro_torch.nn.ssm``)
against the JAX reference (``repro.kernels.ref.ssm_scan``, the Pallas
kernel in interpret mode, ``jax.grad``, ``repro.nn.ssm``), on the same
numpy inputs and on weights carried across.

Tolerances, float32: the scan 1e-6 (the same op order as the oracle, only
the sums over N and the exps round differently); gradients 1e-5 (sums over
L and over the batch and channels, in another order); the Mamba block 1e-5
(its matrix products sum in another order).  The CUDA kernels run only on
the card, where ``chip_smoke.py`` holds them against these plain versions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MambaConfig as JMambaConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import ssm as jssm
from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import state_tile
from repro_torch.nn import ssm as tssm

TOL = 1e-6
GRAD_TOL = 1e-5
BLOCK_TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _scan_inputs(seed, b, length, din, n, *, h0=False):
    """Inputs shaped as a Mamba block makes them: dt a softplus, a = -exp
    of the S4D-real log, u ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((b, length, din)).astype(f)
    delta = np.log1p(np.exp(rng.standard_normal((b, length, din)) - 2.0)
                     ).astype(f)
    a = -np.tile(np.arange(1, n + 1, dtype=f), (din, 1)) * (
        0.5 + rng.random((din, 1)).astype(f))
    bmat = rng.standard_normal((b, length, n)).astype(f)
    cmat = rng.standard_normal((b, length, n)).astype(f)
    d = rng.standard_normal(din).astype(f)
    out = [u, delta, a.astype(f), bmat, cmat, d]
    if h0:
        out.append(rng.standard_normal((b, din, n)).astype(f))
    return out


SCAN_CASES = [
    # (b, L, Din, N): the reduced Jamba mixer (d_in 128, N 8), N 16,
    # B = 1, L = 1, an L that is no multiple of a chunk, a ragged Din
    (2, 12, 128, 8),
    (2, 32, 64, 16),
    (1, 16, 32, 16),
    (3, 1, 48, 8),
    (2, 37, 40, 5),
]


@pytest.mark.parametrize("b,length,din,n", SCAN_CASES)
def test_scan_matches_reference(b, length, din, n):
    u, delta, a, bmat, cmat, d = _scan_inputs(length * 10 + n, b, length,
                                              din, n)
    want_y, want_h = jref.ssm_scan(u, delta, a, bmat, cmat, d)
    want_pallas = jops.ssm_scan(u, delta, a, bmat, cmat, d,
                                impl="interpret", chunk=8, block_d=16)
    t = torch.from_numpy
    got_y, got_h = tref.ssm_scan(t(u), t(delta), t(a), t(bmat), t(cmat), t(d))
    _close(got_y, want_y)
    _close(got_h, want_h)
    _close(got_y, want_pallas)
    args = [t(x) for x in (u, delta, a, bmat, cmat, d)]
    np.testing.assert_array_equal(tops.ssm_scan(*args).numpy(),
                                  got_y.numpy())
    y2, h2 = tops.ssm_scan(*args, return_state=True)
    np.testing.assert_array_equal(h2.numpy(), got_h.numpy())


SCAN_TOL = 1e-5       # the card's: relative to the largest |output|


def _scan_kernel_emulation(u, delta, a, bmat, cmat, d):
    """``ssm_scan.cu``'s arithmetic on CPU tensors: a * log2(e) formed once
    per state, each step h = 2^(dt * a2) * h + (dt * u) * B_t, y_t = C_t . h
    summed in state order (the kernel's zero states past N add exact
    zeros), then D * u."""
    bsz, length, din = u.shape
    n = a.shape[1]
    a2 = a * torch.tensor(math.log2(math.e), dtype=torch.float32)
    h = torch.zeros(bsz, din, n)
    ys = []
    for t in range(length):
        dt, ut = delta[:, t], u[:, t]
        du = dt * ut
        h = torch.exp2(dt[..., None] * a2) * h + du[..., None] * bmat[:, t,
                                                                     None]
        acc = torch.zeros(bsz, din)
        for k in range(n):
            acc = acc + h[..., k] * cmat[:, t, None, k]
        ys.append(acc + d * ut)
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("b,length,din,n", SCAN_CASES + [
    (2, 20, 100, 16),    # 100 channels: no whole warps
    (2, 9, 24, 1),       # N = 1: one state, fifteen zero ones
    (1, 17, 40, 4),      # N = 4
])
def test_scan_kernel_arithmetic_matches_reference(b, length, din, n):
    """The forward kernel's exp2 form and order of sums hold the
    reference's scan and its Pallas kernel at the card's tolerance, y and
    the final state alike."""
    ins = _scan_inputs(length * 7 + din + n, b, length, din, n)
    want_y, want_h = jref.ssm_scan(*ins)
    want_pallas = jops.ssm_scan(*ins, impl="interpret", chunk=8,
                                block_d=8)
    got_y, got_h = _scan_kernel_emulation(
        *(torch.from_numpy(x) for x in ins))
    for got, want in ((got_y, want_y), (got_y, want_pallas),
                      (got_h, want_h)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= SCAN_TOL * float(np.abs(want).max())


def test_scan_from_an_initial_state_matches_reference():
    u, delta, a, bmat, cmat, d, h0 = _scan_inputs(3, 2, 10, 24, 8, h0=True)
    want_y, want_h = jref.ssm_scan(u, delta, a, bmat, cmat, d, h0=h0)
    t = torch.from_numpy
    got_y, got_h = tref.ssm_scan(t(u), t(delta), t(a), t(bmat), t(cmat),
                                 t(d), h0=t(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)


@pytest.mark.parametrize("b,length,din,n", SCAN_CASES[:2] + SCAN_CASES[3:])
@pytest.mark.parametrize("with_state", [False, True])
def test_scan_gradients_match_jax_grad(b, length, din, n, with_state):
    """Autograd through the plain scan (the CPU's training path and what
    the backward kernel is held to on the card) against ``jax.grad`` of
    the oracle: all six input gradients, and dh0 with an initial state and
    a gradient on h_final."""
    *ins, h0 = _scan_inputs(length + din, b, length, din, n, h0=True)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal((b, length, din)).astype(np.float32)
    gh = rng.standard_normal((b, din, n)).astype(np.float32)

    def jloss(u, delta, a, bmat, cmat, d, h0):
        y, h = jref.ssm_scan(u, delta, a, bmat, cmat, d,
                             h0=h0 if with_state else None)
        out = jnp.sum(y * gy)
        return out + jnp.sum(h * gh) if with_state else out

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ins, h0)
    t = torch.from_numpy
    leaves = [t(x).requires_grad_() for x in ins + [h0]]
    y, h = tref.ssm_scan(*leaves[:6], h0=leaves[6] if with_state else None)
    obj = (y * t(gy)).sum() + ((h * t(gh)).sum() if with_state else 0)
    auto = torch.autograd.grad(obj, leaves, allow_unused=True,
                               materialize_grads=True)
    names = ("u", "delta", "a", "bmat", "cmat", "d", "h0")
    for i, name in enumerate(names):
        if name == "h0" and not with_state:
            continue
        scale = max(1.0, float(np.abs(want[i]).max()))
        _close(auto[i].numpy() / scale, np.asarray(want[i]) / scale,
               GRAD_TOL)


def test_ops_scan_refuses_unknown_devices():
    """A device that is neither the card, the CPU nor meta raises; the
    meta device gets y's shape (and the final state's) and, where a
    gradient is wanted, the card's refusal of a differentiated state."""
    from test_torch_kernels import _Elsewhere
    x = torch.zeros(1, 2, 4).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="no implementation"):
        tops.ssm_scan(x, x, torch.zeros(4, 2), torch.zeros(1, 2, 2),
                      torch.zeros(1, 2, 2), torch.zeros(4))
    m = torch.zeros(1, 2, 4, device="meta")
    args = (m, m, torch.zeros(4, 2, device="meta"),
            torch.zeros(1, 2, 2, device="meta"),
            torch.zeros(1, 2, 2, device="meta"),
            torch.zeros(4, device="meta"))
    y, h = tops.ssm_scan(*args, return_state=True)
    assert y.shape == m.shape and h.shape == (1, 4, 2)
    with pytest.raises(NotImplementedError, match="no_grad"):
        tops.ssm_scan(m.requires_grad_(), *args[1:], return_state=True)


# -- the kernels' arithmetic as redesigned for Hopper: the forward's lanes a
#    channel and the backward's recompute and orders of sums, on CPU tensors

LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)
NT = 16               # the backward's states a channel, padded
SMS = 132             # an H100's SMs, for scan_lanes


def _fma(a, b, c):
    """a * b + c rounded once to float32, as the card's fma: the product
    is exact in float64 (two 24-bit significands); the sum's two roundings
    part from one by an ulp at most, far inside every bar here."""
    return (a.double() * b.double() + c.double()).float()


def _pad(x, size, dim):
    """``x`` zero-padded along ``dim`` to ``size``."""
    shape = list(x.shape)
    shape[dim] = size - shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim)


def _join(parts):
    """Lanes or channels joined as the kernels' xor butterflies join them:
    (x0 + x1) + (x2 + x3), pairs of neighbours first."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _scan_lanes_emulation(u, delta, a, bmat, cmat, d, lanes):
    """``ssm_scan.cu`` with ``lanes`` threads a channel: the states padded
    to ``state_tile(N)``, each step h = fma(2^(dt * a2), h, (dt * u) * B_t)
    with a2 = a * log2(e); each lane's ``state_tile(N) / lanes`` states
    summed into C_t . h by fma in n order, the lanes joined in the
    shuffles' order, then y = fma(D, u, that)."""
    bsz, length, din = u.shape
    n = a.shape[1]
    nt = state_tile(n)
    a2 = _pad(a, nt, 1) * LOG2E
    bm, cm = _pad(bmat, nt, 2), _pad(cmat, nt, 2)
    s = nt // lanes
    h = torch.zeros(bsz, din, nt)
    ys = []
    for t in range(length):
        dt, ut = delta[:, t], u[:, t]
        h = _fma(torch.exp2(dt[..., None] * a2), h,
                 (dt * ut)[..., None] * bm[:, t, None])
        parts = []
        for q in range(lanes):
            acc = torch.zeros(bsz, din)
            for i in range(q * s, (q + 1) * s):
                acc = _fma(h[..., i], cm[:, t, None, i], acc)
            parts.append(acc)
        ys.append(_fma(d, ut, _join(parts)))
    return torch.stack(ys, 1), h[..., :n]


def _lane_sums(x, y):
    """Over the 16 padded states: fma(x, y) chains over each lane's four
    states in n order, then the channel's four lanes joined."""
    parts = []
    for q in range(NT // 4):
        acc = torch.zeros(x.shape[:-1])
        for i in range(4 * q, 4 * q + 4):
            acc = _fma(x[..., i], y[..., i], acc)
        parts.append(acc)
    return _join(parts)


def _over_channels(x, nblk, n):
    """dB or dC from per-channel terms (B, L, 32 * nblk, 16): the 8
    channels of a warp by the transposing butterfly ((c0 + c4) + (c2 +
    c6)) + ((c1 + c5) + (c3 + c7)), the block's 4 warps in order, every
    8th block in block order, then those 8 sums in order."""
    bsz, length = x.shape[:2]
    x = x.reshape(bsz, length, nblk, 4, 8, NT)
    x = x[..., :4, :] + x[..., 4:, :]
    x = x[..., :2, :] + x[..., 2:, :]
    x = x[..., 0, :] + x[..., 1, :]
    blocks = x[..., 0, :]
    for w in range(1, 4):
        blocks = blocks + x[..., w, :]
    parts = []
    for w in range(8):
        acc = torch.zeros(bsz, length, NT)
        for blk in range(w, nblk, 8):
            acc = acc + blocks[:, :, blk]
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total[..., :n]


def _scan_backward_emulation(u, delta, a, bmat, cmat, d, gy):
    """``ssm_scan_backward.cu``'s arithmetic in float32 (bfloat16 values
    widened): channels padded to whole 32-channel blocks and states to 16;
    the forward's states at every 16th step kept as checkpoints; each
    chunk, last first, recomputed from its checkpoint with the forward's
    update and walked backwards carrying g = dL/dh_t with the recompute's
    decays; du and ddt from the lanes' fma sums over states (the dA term
    summed over a2 = a * log2(e) and scaled by ln(2)); dB and dC summed
    over channels in the kernel's order; dA and dD over the batch in
    order.  Returns (du, ddt, dA, dB, dC, dD) in float32."""
    bsz, length, din = u.shape
    n = a.shape[1]
    nblk = -(-din // 32)
    u, delta, gy = (_pad(x, 32 * nblk, 2) for x in (u, delta, gy))
    a = _pad(_pad(a, NT, 1), 32 * nblk, 0)
    a2 = a * LOG2E
    bm, cm = _pad(bmat, NT, 2), _pad(cmat, NT, 2)
    dd = _pad(d, 32 * nblk, 0)
    du_all = delta * u

    def update(h, t):
        return _fma(torch.exp2(delta[:, t, :, None] * a2), h,
                    du_all[:, t, :, None] * bm[:, t, None])

    h = torch.zeros(bsz, 32 * nblk, NT)
    checkpoints = []
    for t in range(length):
        if t % 16 == 0:
            checkpoints.append(h)
        h = update(h, t)
    g = torch.zeros_like(h)
    ga = torch.zeros_like(h)
    gd = torch.zeros(bsz, 32 * nblk)
    gb_sum, gda_sum = torch.empty_like(u), torch.empty_like(u)
    cb = torch.empty(bsz, length, 32 * nblk, NT)
    cc = torch.empty_like(cb)
    for c in reversed(range(len(checkpoints))):
        t0 = 16 * c
        h, hist = checkpoints[c], []
        for t in range(t0, min(t0 + 16, length)):
            hist.append(h)
            h = update(h, t)
        for t in reversed(range(t0, min(t0 + 16, length))):
            dk, gk = delta[:, t, :, None], gy[:, t, :, None]
            hp = hist[t - t0]
            g = _fma(gk, cm[:, t, None], g)
            cb[:, t] = g * du_all[:, t, :, None]
            cc[:, t] = gk * h
            gb_sum[:, t] = _lane_sums(g, bm[:, t, None].expand_as(g))
            da = torch.exp2(dk * a2)
            q = (g * hp) * da
            gda_sum[:, t] = _lane_sums(q, a2.expand_as(q))
            ga = _fma(q, dk, ga)
            g = g * da
            h = hp
            gd = _fma(gy[:, t], u[:, t], gd)
    du = _fma(delta, gb_sum, dd * gy)[..., :din]
    ddt = _fma(u, gb_sum, gda_sum * LN2)[..., :din]
    da_sum, dd_sum = torch.zeros_like(ga[0]), torch.zeros_like(gd[0])
    for b in range(bsz):
        da_sum, dd_sum = da_sum + ga[b], dd_sum + gd[b]
    return (du, ddt, da_sum[:din, :n], _over_channels(cb, nblk, n),
            _over_channels(cc, nblk, n), dd_sum[:din])


# (B, L, Din, N): a block that is not whole (200 channels) at a ragged L,
# a ragged N with Din no multiple of a block, and Jamba's prefill
# narrowed to 512 channels; all leave an H100's SMs idle at one lane a
# channel
ARITH_CASES = [(2, 50, 200, 16), (3, 37, 100, 5), (1, 32, 512, 16)]


def test_scan_lanes_is_a_rule_of_the_shape():
    """One lane a channel where 128-channel blocks fill the SMs (the
    training shape), else four states a lane (Jamba's prefill)."""
    from repro_torch.kernels.ssm_scan import scan_lanes
    assert scan_lanes(8, 8192, 16, SMS) == 1
    assert scan_lanes(3, 8192, 16, SMS) == 1          # 192 blocks
    assert scan_lanes(2, 8192, 16, SMS) == 4          # 128 blocks
    assert scan_lanes(1, 8192, 16, SMS) == 4
    assert scan_lanes(1, 8192, 8, SMS) == 2
    assert scan_lanes(1, 8192, 4, SMS) == 1
    assert scan_lanes(1, 8192, 16, 64) == 1


@pytest.mark.parametrize("b,length,din,n", ARITH_CASES)
def test_scan_small_grid_arithmetic_matches_reference(b, length, din, n):
    """The forward kernel's layout where one lane a channel leaves the SMs
    idle (its lanes each a share of the states, y joined over them), and
    the one-lane layout, hold the reference's scan and its Pallas kernel
    at the card's tolerance, y and the final state alike."""
    from repro_torch.kernels.ssm_scan import scan_lanes
    lanes = scan_lanes(b, din, n, SMS)
    assert lanes == state_tile(n) // 4 > 1
    ins = _scan_inputs(length + din + n, b, length, din, n)
    want_y, want_h = jref.ssm_scan(*ins)
    want_pallas = jops.ssm_scan(*ins, impl="interpret")
    for k in (lanes, 1):
        got_y, got_h = _scan_lanes_emulation(
            *(torch.from_numpy(x) for x in ins), k)
        for got, want in ((got_y, want_y), (got_y, want_pallas),
                          (got_h, want_h)):
            want = np.asarray(want)
            err = float(np.abs(got.numpy() - want).max())
            assert err <= SCAN_TOL * float(np.abs(want).max()), (k, err)


@pytest.mark.parametrize("b,length,din,n", ARITH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_backward_arithmetic_matches_jax_grad(b, length, din, n,
                                                   dtype):
    """The backward kernel's recompute from checkpoints and its orders of
    sums against ``jax.grad`` of the reference's scan: in float32 each
    gradient within 1e-5 of its largest magnitude; in bfloat16 (u, dt, B,
    C and dy bfloat16, A and D float32, as the reference's Mamba block
    trains) du, ddt, dB and dC rounded once and within the bfloat16 bar
    5e-2 * (1 + |reference|) of the reference's bfloat16 gradient, dA and
    dD float32 within 1e-5 of their largest."""
    ins = _scan_inputs(length * 3 + din + n, b, length, din, n)
    gy = np.random.default_rng(din).standard_normal(
        (b, length, din)).astype(np.float32)
    bf16 = dtype == "bfloat16"
    jt = jnp.bfloat16 if bf16 else jnp.float32
    jins = [jnp.asarray(x, jt) if i in (0, 1, 3, 4) else jnp.asarray(x)
            for i, x in enumerate(ins)]
    jgy = jnp.asarray(gy, jt)
    _, vjp = jax.vjp(lambda *xs: jref.ssm_scan(*xs)[0], *jins)
    want = vjp(jgy)
    # the values the card reads: bfloat16 ones widened exactly
    got = _scan_backward_emulation(
        *(torch.from_numpy(np.array(x.astype(jnp.float32)))
          for x in jins + [jgy]))
    for i, name in enumerate(("du", "ddt", "dA", "dB", "dC", "dD")):
        w = np.asarray(want[i].astype(jnp.float32))
        if bf16 and i not in (2, 5):
            g = got[i].to(torch.bfloat16).float().numpy()
            assert (np.abs(g - w) <= 5e-2 * (1 + np.abs(w))).all(), name
        else:
            err = float(np.abs(got[i].numpy() - w).max())
            assert err <= SCAN_TOL * float(np.abs(w).max()), (name, err)


def test_scan_cuda_wrappers_reject_cpu_tensors():
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward_cuda,
                                              ssm_scan_cuda)
    args = [torch.from_numpy(x) for x in _scan_inputs(0, 1, 4, 8, 4)]
    with pytest.raises(ValueError, match="cpu"):
        ssm_scan_cuda(*args)
    with pytest.raises(ValueError, match="cpu"):
        ssm_scan_backward_cuda(*args, torch.zeros(1), torch.zeros(1, 4, 8))


# -- the Mamba block -------------------------------------------------------------------

D_MODEL = 32


def _mamba(seed=0, d_state=8):
    jcfg = JModelConfig(num_layers=1, d_model=D_MODEL, num_heads=4,
                        num_kv_heads=4, d_ff=0,
                        mamba=JMambaConfig(d_state=d_state))
    cfg = ModelConfig(num_layers=1, d_model=D_MODEL, num_heads=4,
                      num_kv_heads=4, d_ff=0,
                      mamba=MambaConfig(d_state=d_state))
    params = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    block = tssm.Mamba(cfg, device="cpu")
    flat = {jax.tree_util.keystr(p, simple=True, separator="."): np.array(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    named = dict(block.named_parameters())
    assert set(named) == set(flat)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(torch.from_numpy(flat[name]))
    return cfg, jcfg, params, block


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("d_state", [8, 16])
def test_mamba_apply_matches_reference(d_state):
    cfg, jcfg, params, block = _mamba(d_state=d_state)
    x = _x((2, 11, D_MODEL), 1)
    want = jssm.mamba_apply(params, x, cfg=jcfg, impl="xla")
    want_pallas = jssm.mamba_apply(params, x, cfg=jcfg, impl="interpret")
    got = tssm.mamba_apply(block, torch.from_numpy(x), cfg=cfg)
    _close(got, want, BLOCK_TOL)
    _close(got, want_pallas, BLOCK_TOL)


def test_mamba_prefill_state_matches_reference():
    """The prefill path: output, raw pre-conv tail and final scan state."""
    cfg, jcfg, params, block = _mamba()
    x = _x((2, 9, D_MODEL), 2)
    want, wstate = jssm.mamba_apply(params, x, cfg=jcfg, return_state=True)
    got, state = tssm.mamba_apply(block, torch.from_numpy(x), cfg=cfg,
                                  return_state=True)
    _close(got, want, BLOCK_TOL)
    _close(state.conv, wstate.conv, BLOCK_TOL)
    _close(state.ssm, wstate.ssm, BLOCK_TOL)
    assert state.conv.shape == (2, 3, 2 * D_MODEL)


def test_mamba_decode_matches_reference():
    cfg, jcfg, params, block = _mamba()
    x = _x((2, 4, D_MODEL), 3)
    jst = jssm.mamba_init_state(jcfg, 2, dtype=jnp.float32)
    st = tssm.mamba_init_state(cfg, 2, device="cpu")
    _close(st.conv, jst.conv)
    _close(st.ssm, jst.ssm)
    for t in range(4):
        want, jst = jssm.mamba_decode(params, x[:, t:t + 1], jst, cfg=jcfg)
        got, st = tssm.mamba_decode(block, torch.from_numpy(x[:, t:t + 1]),
                                    st, cfg=cfg)
        _close(got, want, BLOCK_TOL)
        _close(st.conv, jst.conv, BLOCK_TOL)
        _close(st.ssm, jst.ssm, BLOCK_TOL)


def test_mamba_full_vs_decode():
    """The reference's own continuity checks, carried over: decoding token
    by token from a zero state, and from a prefill's state, reproduces the
    full-sequence forward."""
    cfg, _, _, block = _mamba()
    x = torch.from_numpy(_x((2, 8, D_MODEL), 4))
    full = tssm.mamba_apply(block, x, cfg=cfg)
    st = tssm.mamba_init_state(cfg, 2, device="cpu")
    outs = []
    for t in range(8):
        y, st = tssm.mamba_decode(block, x[:, t:t + 1], st, cfg=cfg)
        outs.append(y)
    _close(torch.cat(outs, 1), full, 1e-5)
    _, st = tssm.mamba_apply(block, x[:, :6], cfg=cfg, return_state=True)
    y6, _ = tssm.mamba_decode(block, x[:, 6:7], st, cfg=cfg)
    _close(y6, full[:, 6:7], 1e-5)


def test_causal_conv_sums_taps_in_order():
    """Tap i reads x shifted by K-1-i; the bias is added after the taps."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    out, tail = tssm._causal_conv(x, w, b)
    want, wtail = jssm._causal_conv(x.numpy(), w.numpy(), b.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tail.numpy(), np.asarray(wtail))


def test_mamba_init_follows_the_reference():
    """A: the correctly rounded float32 log of 1..N bit for bit, and within
    1 ulp of the reference's; D and the conv bias exactly; the dt bias
    inside the inverse softplus of [1e-3, 1e-1]; the weights' spreads.

    The reference's ``jnp.log`` in float32 is not correctly rounded, and
    XLA's CPU code rounds it differently with the host's vector ISA (on
    some hosts log(7) is one ulp off), so the exact value held here is the
    float64 log rounded once, and the reference is held to 1 ulp of it."""
    cfg = ModelConfig(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=0, mamba=MambaConfig(d_state=16))
    block = tssm.Mamba(cfg, device="cpu")
    block.apply(lambda m: m.reset_parameters(torch.Generator().manual_seed(0))
                if hasattr(m, "reset_parameters") else None)
    jcfg = JModelConfig(num_layers=4, d_model=64, num_heads=4,
                        num_kv_heads=4, d_ff=0,
                        mamba=JMambaConfig(d_state=16))
    want = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    a_log = block.a_log.detach().numpy()
    exact = np.log(np.arange(1, 17, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(a_log, np.broadcast_to(exact, a_log.shape))
    np.testing.assert_array_max_ulp(a_log, np.asarray(want["a_log"]),
                                    maxulp=1)
    np.testing.assert_array_equal(block.d.detach().numpy(),
                                  np.asarray(want["d"]))
    assert not block.conv_b.detach().any()
    dt = torch.nn.functional.softplus(block.dt_proj.b.detach())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    for got, w in ((block.conv_w, want["conv_w"]),
                   (block.dt_proj.w, want["dt_proj"]["w"]),
                   (block.in_proj.w, want["in_proj"]["w"]),
                   (block.out_proj.w, want["out_proj"]["w"])):
        w = np.asarray(w)
        g = got.detach().numpy()
        assert g.shape == w.shape
        assert abs(g.std() / w.std() - 1) < 5 / math.sqrt(w.size)
