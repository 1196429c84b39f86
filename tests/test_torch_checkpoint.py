"""Port parity: ``repro_torch.checkpoint`` against ``repro.checkpoint`` —
every case of ``tests/test_checkpoint.py`` on the port, checkpoints that
cross between the two packages in both directions (a reduced
granite-moe-1b-a400m's ``(params, opt_state)``), and the trainer's
``--ckpt-dir``: six steps straight against three, a resume and three more,
bit for bit on the CPU.  Everything here is exact: a checkpoint stores the
float32 bits.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.models import gdm as jgdm
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_train_state, restore,
                                    restore_train_state, save, train_state)
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import dit_from_jax, dit_to_jax, lm_from_jax
from repro_torch.optim import optimizers as topt

STATE = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
         "step": torch.tensor(7)}
GRANITE = "granite-moe-1b-a400m"


# -- the reference's cases, on the port ----------------------------------------------

def test_roundtrip(tmp_path):
    save(str(tmp_path), 7, STATE)
    out, step = restore(str(tmp_path), STATE)
    assert step == 7
    assert torch.equal(out["params"]["w"], STATE["params"]["w"])
    assert isinstance(out["step"], torch.Tensor) and int(out["step"]) == 7


def test_latest_step_and_gc(tmp_path):
    for s in (1, 2, 3, 4):
        save(str(tmp_path), s, STATE, keep=2)
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(os.listdir(tmp_path))
    assert len([d for d in kept if d.startswith("step_")]) == 2


def test_partial_checkpoint_is_ignored(tmp_path):
    save(str(tmp_path), 5, STATE)
    os.makedirs(tmp_path / "step_0000000009")           # no manifest
    assert latest_step(str(tmp_path)) == 5
    os.makedirs(tmp_path / "step_0000000011")           # corrupt manifest
    with open(tmp_path / "step_0000000011" / "manifest.json", "w") as f:
        f.write("{broken")
    assert latest_step(str(tmp_path)) == 5
    save(str(tmp_path), 13, STATE)                      # missing shard
    os.remove(tmp_path / "step_0000000013" / "shard_00000.npz")
    assert latest_step(str(tmp_path)) == 5


def test_restore_validates_shapes(tmp_path):
    save(str(tmp_path), 1, STATE)
    bad = {"params": {"w": torch.zeros(3, 3)}, "step": torch.tensor(0)}
    with pytest.raises(ValueError):
        restore(str(tmp_path), bad)


def test_restore_missing_key_raises(tmp_path):
    save(str(tmp_path), 1, STATE)
    bigger = {"params": {"w": STATE["params"]["w"], "extra": torch.zeros(2)},
              "step": torch.tensor(0)}
    with pytest.raises(KeyError):
        restore(str(tmp_path), bigger)


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), every=2, keep=5)
    for step in range(1, 7):
        ck.maybe_save(step, STATE)
    ck.wait()
    assert latest_step(str(tmp_path)) == 6
    assert ck.last_saved == 6


def test_async_checkpointer_copies_before_it_returns(tmp_path):
    """The state is on the host before ``maybe_save`` returns: a tensor
    updated in place afterwards (as the train step updates the model) does
    not reach the file."""
    w = torch.ones(64, 64)
    ck = AsyncCheckpointer(str(tmp_path), every=1)
    ck.maybe_save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    out, _ = restore(str(tmp_path), {"w": w})
    assert torch.equal(out["w"], torch.ones(64, 64))


def test_elastic_restore_dtype_cast(tmp_path):
    save(str(tmp_path), 3, STATE)
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
                "step": torch.tensor(0)}
    out, _ = restore(str(tmp_path), template)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert np.asarray(restore(str(tmp_path), jax.tree_util.tree_map(
        lambda t: t.numpy(), STATE))[0]["params"]["w"]).dtype == np.float32


def test_legacy_gdm_layer_list_checkpoint(tmp_path):
    """A reference checkpoint from before the DiT layer scan (``layers`` a
    per-layer list, keys ``layers/[i]/...``) restores into the port's
    legacy template; stacked, it is the reference's DiT leaf for leaf."""
    cfg = jax_get_config("gdm-dit").reduced()
    params = jgdm.init_gdm(jax.random.PRNGKey(0), cfg)
    legacy = dict(params, layers=jgdm.unstack_layer_params(params["layers"]))
    jckpt.save(str(tmp_path), 1, legacy)
    tree = dit_to_jax(dit_from_jax(jax.tree_util.tree_map(
        np.asarray, params), get_config("gdm-dit").reduced(), device="cpu"))
    template = dict(tree, layers=[jax.tree_util.tree_map(
        lambda a: torch.zeros(a.shape[1:]), tree["layers"])
        for _ in range(cfg.num_layers)])
    restored, step = restore(str(tmp_path), template)
    assert step == 1
    stacked = jax.tree_util.tree_map(lambda *xs: torch.stack(xs).numpy(),
                                     *restored["layers"])
    model = dit_from_jax(dict(restored, layers=stacked),
                         get_config("gdm-dit").reduced(), device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            dit_to_jax(model)):
        want = dict(jax.tree_util.tree_leaves_with_path(params))[path]
        np.testing.assert_array_equal(leaf, np.asarray(want))


def test_train_resume_after_simulated_crash(tmp_path):
    """The reference's end-to-end case: checkpoint, 'crash', resume."""
    ckpt = str(tmp_path / "ck")
    args = ["--arch", "yi-6b", "--global-batch", "2", "--seq-len", "32",
            "--ckpt-dir", ckpt, "--ckpt-every", "3", "--log-every", "0",
            "--device", "cpu"]
    ttrain.main(args + ["--steps", "6"])
    assert latest_step(ckpt) == 6
    r2 = ttrain.main(args + ["--steps", "8"])
    assert r2["steps"] == 2 and r2["start_step"] == 6


# -- across the two packages -------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    """A reduced granite-moe and its AdamW state after one reference step
    (nonzero moments and step), as numpy and as the port's."""
    jcfg = jax_get_config(GRANITE).reduced()
    params = jlm.init_lm(jax.random.PRNGKey(3), jcfg)
    init, update = jopt.adamw(1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p * 7.0), params)
    _, state = update(grads, init(params), params)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    return jcfg, params, state


def _port_pair(cfg):
    model = lm_from_jax(jax.tree_util.tree_map(
        np.asarray, jlm.init_lm(jax.random.PRNGKey(9), jax_get_config(
            GRANITE).reduced())), cfg, device="cpu")
    return model, topt.adamw(1e-3)[0](tsteps.trainable(model))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_reference_checkpoint_restores_into_the_port(granite, tmp_path):
    jcfg, params, state = granite
    jckpt.save(str(tmp_path), 1, (params, state))
    model, opt = _port_pair(get_config(GRANITE).reduced())
    opt, step = restore_train_state(str(tmp_path), model, opt)
    assert step == 1 and opt.step == 1
    got = train_state(model, opt)
    want = jckpt.checkpoint._flatten_with_paths((params, state))
    assert set(got) == set(want)
    assert any("/moe/router" in k for k in got)
    for key, arr in want.items():
        assert got[key].dtype == np.asarray(arr).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(arr), err_msg=key)


def test_port_checkpoint_restores_into_the_reference(granite, tmp_path):
    jcfg, params, state = granite
    model, opt = _port_pair(get_config(GRANITE).reduced())
    arrays = jckpt.checkpoint._flatten_with_paths((params, state))
    opt = load_train_state({k: np.asarray(v) for k, v in arrays.items()},
                           model, opt)
    save(str(tmp_path), 4, train_state(model, opt))
    like = jax.tree_util.tree_map(jnp.zeros_like, (params, state))
    (got_p, got_s), step = jckpt.restore(str(tmp_path), like)
    assert step == 4
    want, got = _flat((params, state)), _flat((got_p, got_s))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_both_packages_write_the_same_manifest(granite, tmp_path):
    _, params, state = granite
    model, opt = _port_pair(get_config(GRANITE).reduced())
    opt = load_train_state(jckpt.checkpoint._flatten_with_paths(
        (params, state)), model, opt)
    jckpt.save(str(tmp_path / "ref"), 2, (params, state))
    save(str(tmp_path / "port"), 2, train_state(model, opt))
    manifests = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_0000000002" / "manifest.json") as f:
            m = json.load(f)
        manifests.append({k: m[k] for k in ("step", "keys", "dtypes",
                                            "shapes", "shards")})
    assert manifests[0] == manifests[1]


def test_load_train_state_refuses_a_mismatch(granite):
    _, params, state = granite
    arrays = {k: np.asarray(v) for k, v in
              jckpt.checkpoint._flatten_with_paths((params, state)).items()}
    model, opt = _port_pair(get_config(GRANITE).reduced())
    bad = dict(arrays)
    del bad["[1]/mu/layers/[0]/moe/router"]
    with pytest.raises(KeyError, match="moe/router"):
        load_train_state(bad, model, opt)
    bad = dict(arrays)
    bad["[0]/embed/table"] = bad["[0]/embed/table"][:, :3]
    with pytest.raises(ValueError, match="embed/table"):
        load_train_state(bad, model, opt)


# -- the trainer's --ckpt-dir ----------------------------------------------------------------

def test_cli_resume_equals_an_uninterrupted_run(tmp_path):
    """Six granite steps straight, saving at 3 and 6; then the step-6
    checkpoint removed and the run started again: it resumes at 3, and its
    steps 4-6 and its step-6 checkpoint equal the straight run's bit for
    bit."""
    ckpt = str(tmp_path / "ck")
    args = ["--arch", GRANITE, "--steps", "6", "--global-batch", "2",
            "--seq-len", "16", "--ckpt-dir", ckpt, "--ckpt-every", "3",
            "--log-every", "0", "--device", "cpu"]
    straight = ttrain.main(args)
    assert straight["steps"] == 6 and latest_step(ckpt) == 6
    last = os.path.join(ckpt, "step_0000000006")
    with np.load(os.path.join(last, "shard_00000.npz")) as z:
        want = {k: z[k] for k in z.files}
    shutil.rmtree(last)
    assert latest_step(ckpt) == 3
    resumed = ttrain.main(args)
    assert resumed["start_step"] == 3 and resumed["steps"] == 3
    assert resumed["losses"] == straight["losses"][3:]
    assert resumed["aux"] == straight["aux"][3:]
    with np.load(os.path.join(last, "shard_00000.npz")) as z:
        assert set(z.files) == set(want)
        for k in z.files:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    assert int(want["[1]/step"]) == 6
