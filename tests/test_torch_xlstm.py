"""Port parity: the modules of the xLSTM and enc-dec families —
``repro_torch.nn.xlstm`` (mLSTM's parallel form, its closed-form prefill
state and its recurrent step; sLSTM's sequential forward and step) and
cross-attention (``attention_apply(memory=)``, ``cross_attention_decode``)
— against ``repro.nn.xlstm`` and ``repro.nn.attention`` on the same
weights and numpy inputs, at the reduced configs' widths.

The reference runs its ``xla`` path (these modules reach no Pallas kernel
there, but cross-attention's ``ops.flash_attention`` and
``ops.decode_attention`` do: ``impl="xla"`` takes their oracles), the port
the CPU.  Tolerance: 1e-6 of each output's largest magnitude (float32; the
cumulative gate sums and the products sum in another order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import attention as jattn
from repro.nn import xlstm as jxl
from repro_torch.configs import get_config
from repro_torch.nn import attention as tattn
from repro_torch.nn import xlstm as txl

TOL = 1e-6
XLSTM = "xlstm-1.3b"


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _load(module, tree):
    """The reference's param dict into the port's module, name for name."""
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[".".join(path)] = np.asarray(t)

    walk(tree, ())
    names = dict(module.named_parameters())
    assert set(names) == set(flat)
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(torch.from_numpy(np.array(flat[name])))
    return module


def _configs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), **kw))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def mlstm():
    cfg, jcfg = _configs(XLSTM)
    params = jxl.mlstm_init(jax.random.PRNGKey(1), jcfg)
    return cfg, jcfg, params, _load(txl.MLSTM(cfg, device="cpu"), params)


@pytest.fixture(scope="module")
def slstm():
    cfg, jcfg = _configs(XLSTM)
    params = jxl.slstm_init(jax.random.PRNGKey(2), jcfg)
    return cfg, jcfg, params, _load(txl.SLSTM(cfg, device="cpu"), params)


def test_mlstm_head_width_is_d_inner_over_heads():
    cfg, full = get_config(XLSTM).reduced(), get_config(XLSTM)
    state = txl.mlstm_init_state(full, 1, device="meta")
    assert state.c.shape == (1, 4, 1024, 1024)      # d_in 4096 over 4 heads
    assert txl.SLSTM(full, device="meta").r.shape == (4, 512, 2048)
    want = jxl.mlstm_init_state(jax_get_config(XLSTM).reduced(), 2)
    for g, w in zip(txl.mlstm_init_state(cfg, 2, device="cpu"), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seq", [1, 9])
def test_mlstm_apply_matches_reference(mlstm, seq):
    cfg, jcfg, params, mod = mlstm
    x = _x((2, seq, cfg.d_model), seed=seq)
    _close(txl.mlstm_apply(mod, torch.from_numpy(x), cfg=cfg),
           jxl.mlstm_apply(params, x, cfg=jcfg))


def test_mlstm_prefill_state_and_decode_match_reference(mlstm):
    """The closed-form final state, then three recurrent steps from it and
    one from a cold state (stabiliser at NEG_INF)."""
    cfg, jcfg, params, mod = mlstm
    x = _x((2, 7, cfg.d_model), seed=3)
    wy, wst, wtail = jxl.mlstm_apply_with_state(params, x, cfg=jcfg)
    gy, gst, gtail = txl.mlstm_apply_with_state(mod, torch.from_numpy(x),
                                                cfg=cfg)
    _close(gy, wy)
    _close(gtail, wtail)
    for g, w in zip(gst, wst):
        _close(g, w)
    for t in range(3):
        x1 = _x((2, 1, cfg.d_model), seed=10 + t)
        wy, wst, wtail = jxl.mlstm_decode(params, x1, wst, cfg=jcfg,
                                          conv_tail=wtail)
        gy, gst, gtail = txl.mlstm_decode(mod, torch.from_numpy(x1), gst,
                                          cfg=cfg, conv_tail=gtail)
        _close(gy, wy)
        for g, w in zip(gst, wst):
            _close(g, w)
    x1 = _x((2, 1, cfg.d_model), seed=20)
    wy, wst, _ = jxl.mlstm_decode(params, x1, jxl.mlstm_init_state(jcfg, 2),
                                  cfg=jcfg)
    gy, gst, _ = txl.mlstm_decode(mod, torch.from_numpy(x1),
                                  txl.mlstm_init_state(cfg, 2, device="cpu"),
                                  cfg=cfg)
    _close(gy, wy)
    for g, w in zip(gst, wst):
        _close(g, w)


def test_slstm_apply_and_decode_match_reference(slstm):
    cfg, jcfg, params, mod = slstm
    x = _x((2, 9, cfg.d_model), seed=4)
    wy, wst = jxl.slstm_apply(params, x, cfg=jcfg, return_state=True)
    gy, gst = txl.slstm_apply(mod, torch.from_numpy(x), cfg=cfg,
                              return_state=True)
    _close(gy, wy)
    for g, w in zip(gst, wst):
        _close(g, w)
    _close(txl.slstm_apply(mod, torch.from_numpy(x), cfg=cfg), wy)
    for t, state in enumerate((wst, jxl.slstm_init_state(jcfg, 2))):
        tstate = txl.SLSTMState(*(torch.from_numpy(np.array(a))
                                  for a in state))
        x1 = _x((2, 1, cfg.d_model), seed=30 + t)
        wy, wnew = jxl.slstm_decode(params, x1, state, cfg=jcfg)
        gy, gnew = txl.slstm_decode(mod, torch.from_numpy(x1), tstate,
                                    cfg=cfg)
        _close(gy, wy)
        for g, w in zip(gnew, wnew):
            _close(g, w)


def test_slstm_gates_are_gate_major():
    """The recurrent term is laid out (B, H, 4, dh) and moved to (B, 4, H,
    dh) before the split into i, f, z, o: a plain reshape would hand each
    gate another head's slice.  With the input's projection zero and h_prev
    nonzero in head 0 only, only head 0's columns of each gate move."""
    cfg, _ = _configs(XLSTM)
    mod = txl.SLSTM(cfg, device="cpu")
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    with torch.no_grad():
        mod.r.copy_(torch.arange(h * dh * 4 * dh, dtype=torch.float32)
                    .reshape(h, dh, 4 * dh) * 1e-4)
    state = txl.slstm_init_state(cfg, 1, device="cpu")
    hp = torch.zeros(1, d)
    hp[0, :dh] = 1.0
    state = state._replace(h=hp, m=torch.zeros(1, d))
    new = txl._slstm_cell(mod, torch.zeros(1, 4 * d), state, h)
    moved = (new.c != 0).reshape(h, dh)
    assert bool(moved[0].all()) and not bool(moved[1:].any())


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_cross_attention_matches_reference(arch):
    """Keys and values from the memory, no rope, no causal mask, over a
    full sequence and one decode token (every row attends to all S_mem);
    llava's reduced heads are GQA (4 over 2)."""
    cfg, jcfg = _configs(arch)
    params = jattn.attention_init(jax.random.PRNGKey(5), jcfg, cross=True)
    mod = _load(tattn.Attention(cfg, device="cpu"), params)
    x = _x((2, 5, cfg.d_model), seed=6)
    memory = _x((2, 11, cfg.d_model), seed=7)
    _close(tattn.attention_apply(mod, torch.from_numpy(x), cfg=cfg,
                                 memory=torch.from_numpy(memory)),
           jattn.attention_apply(params, x, cfg=jcfg, memory=memory,
                                 impl="xla"))
    _close(tattn.cross_attention_decode(mod, torch.from_numpy(x[:, :1]),
                                        torch.from_numpy(memory), cfg=cfg),
           jattn.cross_attention_decode(params, x[:, :1], memory, cfg=jcfg,
                                        impl="xla"))
