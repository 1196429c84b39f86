"""Port parity: the edge serving launcher (``repro_torch.launch.serve``)
against ``repro.launch.serve`` — its two services on the same weights and
the same numpy draws, and the whole CLI run through the same model keys.

Token streams, integer stats and payload bytes must be identical; the
GDM qualities and float stats agree within 1e-5 (the DiT sums in another
order on the two sides).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.models import gdm as jgdm
from repro.models import lm as jlm
from repro.serving.kv_manager import state_nbytes as jnbytes
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import dit_from_jax, lm_from_jax
from repro_torch.serving.kv_manager import state_nbytes as tnbytes

TOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _lm(key, arch="yi-6b"):
    cfg = get_config(arch).reduced()
    params = jlm.init_lm(key, jax_get_config(arch).reduced())
    return lm_from_jax(_np_tree(params), cfg, device="cpu")


def _dit(key):
    cfg = get_config("gdm-dit").reduced()
    params = jgdm.init_gdm(key, jax_get_config("gdm-dit").reduced())
    return dit_from_jax(_np_tree(params), cfg, device="cpu")


@pytest.mark.parametrize("arch", ["yi-6b", "qwen1.5-4b"])
def test_lm_block_fn_matches_reference(arch):
    key = jax.random.PRNGKey(2)
    blocks, tpb = 3, 4
    j_fn, j_init = jserve.build_lm_block_fn(key, arch=arch,
                                            tokens_per_block=tpb,
                                            num_blocks=blocks)
    counters = tserve.Counters()
    t_fn, t_init = tserve.build_lm_block_fn(model=_lm(key, arch),
                                            tokens_per_block=tpb,
                                            num_blocks=blocks,
                                            counters=counters)
    for seed in (0, 1):
        js = j_init(np.random.default_rng(seed))
        ts = t_init(np.random.default_rng(seed))
        assert ts["token"].dtype == torch.int32
        assert tnbytes(ts) == jnbytes(js)
        for b in range(blocks):
            js, jq = j_fn(js, b)
            ts, tq = t_fn(ts, b)
            assert ts["text"] == js["text"]
            assert tq == jq
            assert tnbytes(ts) == jnbytes(js)
            for g, w in zip(ts["state"][0]["kv"], js["state"][0]["kv"]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=TOL, rtol=TOL)
        assert len(ts["text"]) == 1 + blocks * tpb
    assert counters.lm_tokens == 2 * blocks * tpb


def test_gdm_block_fn_matches_reference():
    key = jax.random.PRNGKey(3)
    blocks, spb = 4, 2
    j_fn, j_init = jserve.build_gdm_block_fn(key, steps_per_block=spb,
                                             num_blocks=blocks)
    counters = tserve.Counters()
    t_fn, t_init = tserve.build_gdm_block_fn(model=_dit(key),
                                             steps_per_block=spb,
                                             num_blocks=blocks,
                                             counters=counters)
    # the reference x0 is filled on a prompt's first block: chain 2 starts
    # mid-chain at block 1; chain 3 repeats chain 1's prompt, a cache hit
    for seed, first in ((0, 0), (1, 1), (0, 2)):
        js = j_init(np.random.default_rng(seed))
        ts = t_init(np.random.default_rng(seed))
        assert ts["prompt"].dtype == torch.int32
        assert tnbytes(ts) == jnbytes(js)
        for b in range(first, blocks):
            js, jq = j_fn(js, b)
            ts, tq = t_fn(ts, b)
            assert abs(tq - jq) <= TOL
            np.testing.assert_allclose(ts["latent"].numpy(),
                                       np.asarray(js["latent"]), atol=TOL,
                                       rtol=TOL)
            assert tnbytes(ts) == jnbytes(js)
    # forwards: 4 + 3 + 2 blocks run, plus the chains' remaining blocks the
    # reference x0 needs on each prompt's first block (3 and 2; the third
    # chain's prompt is the first's)
    assert counters.dit_forwards == spb * (4 + 3 + 2 + 3 + 2)


def _strip(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_stats_equal(g, w)
        elif isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert g == w, k
        else:
            assert abs(g - w) <= TOL * max(1.0, abs(w)), (k, g, w)


def test_main_matches_reference(monkeypatch):
    argv = ["--frames", "10", "--requests", "4", "--nodes", "2",
            "--blocks", "2"]
    want = jserve.main(argv)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    # the port's main draws its models with torch; hand it the reference's
    # draws from the keys the reference's main splits
    monkeypatch.setattr(tserve, "init_gdm",
                        lambda cfg, *, seed, device: _dit(k1))
    monkeypatch.setattr(tserve, "init_lm",
                        lambda cfg, *, seed, device: _lm(k2))
    got = tserve.main(argv + ["--device", "cpu"])
    assert want["completed"] > 0
    _assert_stats_equal(_strip(got), _strip(want))


def test_run_counts_what_it_serves():
    """The launcher's counters: LM tokens are the decoded text of every LM
    request, and the full run completes both services."""
    counters = tserve.Counters()
    stats, engine = tserve.run(gdm=_dit(jax.random.PRNGKey(4)),
                               lm=_lm(jax.random.PRNGKey(5)), frames=12,
                               requests=6, nodes=3, blocks=2, seed=1,
                               device="cpu", counters=counters)
    assert stats["completed"] == 6
    lm_reqs = [r for r in engine.completed if r.service == 1]
    assert lm_reqs and len(lm_reqs) < 6
    assert counters.lm_tokens == sum(len(r.state["text"]) - 1
                                     for r in lm_reqs)
    assert counters.dit_forwards > 0 and counters.dit_forwards % 2 == 0
