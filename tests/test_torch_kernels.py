"""Port parity: the plain PyTorch versions of the hand-written kernels
(``repro_torch.kernels.ref``, which the CPU dispatch runs) against the JAX
reference's oracle (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerance 1e-6 in float32: the port's ops follow the oracle's op order, so
only the summation order inside a reduction or a contraction differs.
The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""
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


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor is an
    error there, and only ``ops`` routes it to the plain path."""
    from repro_torch.kernels.adaln_norm import adaln_norm_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    x = torch.zeros(1, 4, 8)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="cpu"):
        adaln_norm_cuda(x, torch.zeros(1, 8), torch.zeros(1, 8), v, v)
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="cpu"):
        flash_attention_cuda(q, q, q)


def test_ops_refuse_unknown_devices():
    x = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        tops.adaln_norm(x, torch.zeros(1, 4, device="meta"),
                        torch.zeros(1, 4, device="meta"),
                        torch.zeros(4, device="meta"),
                        torch.zeros(4, device="meta"))
    q = torch.zeros(1, 2, 1, 16, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        tops.flash_attention(q, q, q)

