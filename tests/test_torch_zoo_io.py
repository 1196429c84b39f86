"""Port parity: the last three families of the zoo (enc-dec
seamless-m4t-large-v2, xLSTM xlstm-1.3b, the VLM llava-next-34b) at the
edges of the port — a train state's checkpoint crossing between the two
packages both ways, and the CLIs: the trainer cannot train seamless (as
the reference's cannot: its batches carry no frames) and trains xlstm
and llava; the edge launcher serves ``--lm-arch`` xlstm and seamless with
the reference launcher's stats.

Checkpoints are exact (they store the float32 bits); the launcher's
integer stats are equal and its float stats within 1e-5 (the DiT sums in
another order on the two sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import (load_train_state, restore_train_state,
                                    save, train_state)
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.convert import dit_from_jax, lm_from_jax
from repro_torch.optim import optimizers as topt

TOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- checkpoints across the packages --------------------------------------------------------

@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "xlstm-1.3b"])
def test_train_state_crosses_between_packages(arch, tmp_path):
    """A reduced train state (params and AdamW moments after one reference
    update) saved by the reference restores into the port bit for bit,
    and the port's save restores into the reference bit for bit."""
    jcfg = jax_get_config(arch).reduced()
    params = jlm.init_lm(jax.random.PRNGKey(7), jcfg)
    init, update = jopt.adamw(1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p * 7.0), params)
    _, state = update(grads, init(params), params)
    params, state = _np_tree(params), _np_tree(state)
    jckpt.save(str(tmp_path / "ref"), 1, (params, state))
    model = tlm.init_lm(get_config(arch).reduced(), seed=1, device="cpu")
    opt = topt.adamw(1e-3)[0](tsteps.trainable(model))
    opt, step = restore_train_state(str(tmp_path / "ref"), model, opt)
    assert step == 1 and opt.step == 1
    want = jckpt.checkpoint._flatten_with_paths((params, state))
    got = train_state(model, opt)
    assert set(got) == set(want)
    assert any("/encoder/layers/[0]/" in k or "/slstm/r" in k for k in got)
    for key, arr in want.items():
        assert got[key].dtype == np.asarray(arr).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(arr), err_msg=key)
    save(str(tmp_path / "port"), 2, got)
    like = jax.tree_util.tree_map(jnp.zeros_like, (params, state))
    back, step = jckpt.restore(str(tmp_path / "port"), like)
    assert step == 2
    for (path, w), g in zip(
            jax.tree_util.tree_leaves_with_path((params, state)),
            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))
    # and the port's own loader reads the reference's arrays
    model2 = tlm.init_lm(get_config(arch).reduced(), seed=2, device="cpu")
    opt2 = load_train_state({k: np.asarray(v) for k, v in want.items()},
                            model2, topt.adamw(1e-3)[0](
                                tsteps.trainable(model2)))
    assert all(np.array_equal(a, train_state(model2, opt2)[k])
               for k, a in got.items())


# -- the CLIs ------------------------------------------------------------------------------

def test_cli_cannot_train_seamless_without_frames():
    """The reference's ``TokenDataset`` gives no frames, so its CLI cannot
    train an enc-dec arch (``lm_forward`` asserts); the port's raises the
    same way and invents none.  xlstm-1.3b and llava (without patches)
    train."""
    jcfg = jax_get_config("seamless-m4t-large-v2").reduced()
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(AssertionError, match="enc_frames"):
        jlm.lm_forward(params, jnp.zeros((1, 4), jnp.int32), jcfg,
                       impl="xla")
    args = ["--steps", "2", "--global-batch", "2", "--seq-len", "8",
            "--log-every", "0", "--device", "cpu"]
    with pytest.raises(ValueError, match="enc_frames"):
        ttrain.main(["--arch", "seamless-m4t-large-v2"] + args)
    for arch in ("xlstm-1.3b", "llava-next-34b"):
        out = ttrain.main(["--arch", arch] + args)
        assert out["steps"] == 2 and np.isfinite(out["last_loss"])


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "seamless-m4t-large-v2"])
def test_launcher_main_matches_reference(arch, monkeypatch):
    """``--lm-arch`` xlstm and seamless: the port's launcher on the
    reference's draws gives the reference launcher's stats (integers
    exactly, floats within 1e-5).  Both decode seamless without its
    memory."""
    argv = ["--frames", "10", "--requests", "4", "--nodes", "2",
            "--blocks", "2", "--lm-arch", arch]
    want = jserve.main(argv)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dit = dit_from_jax(_np_tree(jserve.init_gdm(k1, jax_get_config(
        "gdm-dit").reduced())), get_config("gdm-dit").reduced(),
        device="cpu")
    lm = lm_from_jax(_np_tree(jlm.init_lm(k2, jax_get_config(arch)
                                          .reduced())),
                     get_config(arch).reduced(), device="cpu")
    monkeypatch.setattr(tserve, "init_gdm", lambda cfg, *, seed, device: dit)
    monkeypatch.setattr(tserve, "init_lm", lambda cfg, *, seed, device: lm)
    got = tserve.main(argv + ["--device", "cpu"])
    assert want["completed"] > 0
    for key, w in want.items():
        if key == "wall_s":
            continue
        if isinstance(w, dict):
            assert got[key] == pytest.approx(w, rel=TOL, abs=TOL), key
        elif isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert got[key] == w, key
        else:
            assert abs(got[key] - w) <= TOL * max(1.0, abs(w)), key
