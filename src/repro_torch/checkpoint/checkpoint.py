"""Fault-tolerant checkpoints: atomic npz shards and a JSON manifest, in
the format of ``repro.checkpoint``, so that either package restores what
the other saved.

Crash-safety contract, as the reference's:

* a checkpoint directory is written under a temporary name and renamed
  atomically, so readers never see partial state;
* ``manifest.json`` records the step, the keys, dtypes and shapes and the
  shard list; ``latest_step`` returns only directories whose manifest
  parses and whose shards all exist, and ``save`` keeps the newest
  ``keep``;
* ``restore`` validates shapes against its template, and a key missing
  from the checkpoint raises.

A state is a tree of dicts, tuples, lists and NamedTuples whose leaves are
tensors or numpy arrays; a leaf's key is its path, joined by "/" as the
reference's ``_path_str`` joins it: a dict key as itself, a sequence index
as ``[i]``, a NamedTuple field by name.  The trainer's state is the
reference's ``(params, OptState(step, mu, nu))``: :func:`train_state`
flattens ``(model, opt_state)`` under those keys (``[0]/layers/[0]/attn/
wq/w`` stacked over the periods, an enc-dec encoder's ``[0]/encoder/
layers/[0]/...`` over its layers, ``[1]/step`` int32, ``[1]/mu/...``) and
:func:`load_train_state` reads them back into the model and the moments in
place.

``AsyncCheckpointer`` copies the state to host numpy arrays before its
thread starts, so training goes on while the copy is written.

A bfloat16 tensor, or a bfloat16 numpy array (the leaves of
``dit_to_jax`` / ``lm_to_jax`` of a bfloat16 model), is written widened
to float32, which holds its value
exactly and which either package restores into a bfloat16 template
exactly (the reference writes its own bfloat16 arrays as numpy's 2-byte
void, which its ``restore`` cannot cast; this module reads them as
bfloat16 bits).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import from_numpy, is_bfloat16
from repro_torch.models.lm import reference_leaf

MANIFEST = "manifest.json"


def _children(tree):
    """(key, subtree) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", sub) for i, sub in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {} if tree is None else {prefix: tree}
    flat: Dict[str, Any] = {}
    for key, sub in kids:
        flat.update(_flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                        else key))
    return flat


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaf_fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return None if tree is None else leaf_fn(prefix, tree)
    new = [_rebuild(sub, leaf_fn, f"{prefix}/{key}" if prefix else key)
           for key, sub in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if hasattr(tree, "_fields"):
        return type(tree)(*new)
    return type(tree)(new)


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a tensor (never a view of a parameter that the
    next step updates in place); other leaves as numpy arrays; bfloat16
    widened to float32 either way."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().to("cpu", torch.float32).numpy()
        return leaf.detach().to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    return from_numpy(arr).float().numpy() if is_bfloat16(arr) else arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A host tensor of a checkpoint's array (bfloat16 bits as
    bfloat16)."""
    if is_bfloat16(arr):
        return from_numpy(arr)
    return torch.from_numpy(np.require(arr, requirements="CW"))


def save(ckpt_dir: str, step: int, state, *, host_index: int = 0,
         host_count: int = 1, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + f".tmp.{host_index}.{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)

    arrays = {k: _host(v) for k, v in _flatten_with_paths(state).items()}
    np.savez(os.path.join(tmp, f"shard_{host_index:05d}.npz"), **arrays)
    manifest = {
        "step": step,
        "host_count": host_count,
        "keys": sorted(arrays),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "shards": [f"shard_{i:05d}.npz" for i in range(host_count)],
        "time": time.time(),
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _garbage_collect(ckpt_dir, keep)
    return final


def _garbage_collect(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_complete_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def _complete_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or ".tmp." in name:
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            with open(os.path.join(path, MANIFEST)) as f:
                m = json.load(f)
            if all(os.path.exists(os.path.join(path, s))
                   for s in m["shards"]):
                yield int(m["step"])
        except (OSError, ValueError, KeyError):
            continue   # a partial or corrupt checkpoint: ignored by design


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list(_complete_steps(ckpt_dir))
    return max(steps) if steps else None


def _read(ckpt_dir: str, step: Optional[int]) -> Tuple[Dict[str, np.ndarray],
                                                       int]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    for shard in manifest["shards"]:
        with np.load(os.path.join(path, shard)) as z:
            for k in z.files:
                arrays[k] = z[k]
    return arrays, step


def _check(arrays: Dict[str, np.ndarray], keys, step: int) -> None:
    missing = sorted(set(keys) - set(arrays))
    if missing:
        raise KeyError(f"checkpoint at step {step} missing keys: "
                       f"{missing[:5]}")


def restore(ckpt_dir: str, like, *, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (the newest complete step
    unless ``step``).  Each leaf must have its template's shape and takes
    its dtype; a tensor leaf comes back as a tensor on the template's
    device, any other as a numpy array."""
    arrays, step = _read(ckpt_dir, step)
    _check(arrays, _flatten_with_paths(like), step)

    def leaf(key, tmpl):
        arr = arrays[key]
        if hasattr(tmpl, "shape") and tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                             f"template {tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            return _tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype)
        if is_bfloat16(arr):               # numpy casts no 2-byte void
            arr = _tensor(arr).float().numpy()
        return arr.astype(tmpl.dtype) if hasattr(tmpl, "dtype") else arr

    return _rebuild(like, leaf), step


# -- the trainer's state under the reference's keys ---------------------------------

def _ref_key(name: str) -> Tuple[str, Optional[int]]:
    """A parameter name of the port's LM -> (its key in the reference's
    params tree, its period on the stacked layer axis, or None)."""
    parts, period = reference_leaf(name)
    if period is not None:        # the slot indexes the tuple of layers
        i = parts.index("layers") + 1
        parts = parts[:i] + (f"[{parts[i]}]",) + parts[i + 1:]
    return "/".join(parts), period


def _stacked(named: Dict[str, torch.Tensor], prefix: str
             ) -> Dict[str, np.ndarray]:
    """Host copies of ``named`` under the reference's keys, the layers'
    tensors stacked over the periods (each copied once, into its row)."""
    groups: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        key, period = _ref_key(name)
        groups.setdefault(prefix + key, {})[period] = t
    out = {}
    for key, by_period in groups.items():
        first = next(iter(by_period.values()))
        stacked = None not in by_period
        shape = ((len(by_period),) if stacked else ()) + tuple(first.shape)
        kind = torch.float32 if first.dtype == torch.bfloat16 \
            else first.dtype                      # bfloat16 widened
        arr = np.empty(shape, dtype=torch.empty((), dtype=kind)
                       .numpy().dtype)
        for period, t in by_period.items():
            dst = arr[period] if stacked else arr
            torch.from_numpy(dst).copy_(t.detach())
        out[key] = arr
    return out


def train_state(model, opt_state) -> Dict[str, np.ndarray]:
    """``(model, opt_state)`` (an LM and its AdamW state) as host numpy
    arrays under the reference's keys for ``(params, OptState(step, mu,
    nu))``: a state for :func:`save` that ``repro.checkpoint.restore``
    reads into the reference's ``(params, opt_state)``."""
    out = _stacked(dict(model.named_parameters()), "[0]/")
    out["[1]/step"] = np.asarray(opt_state.step, dtype=np.int32)
    for field in ("mu", "nu"):
        moments = getattr(opt_state, field)
        if moments is not None:
            out.update(_stacked(moments, f"[1]/{field}/"))
    return out


@torch.no_grad()
def load_train_state(arrays: Dict[str, np.ndarray], model, opt_state):
    """Copy a checkpoint's arrays (the keys of :func:`train_state`) into
    ``model``'s parameters and ``opt_state``'s moments in place; returns
    the optimizer state at the saved step.  Raises KeyError on a missing
    key and ValueError on a shape that disagrees."""
    targets = [("[0]/", dict(model.named_parameters()))]
    targets += [(f"[1]/{f}/", getattr(opt_state, f)) for f in ("mu", "nu")
                if getattr(opt_state, f) is not None]
    keys = {"[1]/step"} | {prefix + _ref_key(n)[0]
                           for prefix, named in targets for n in named}
    _check(arrays, keys, int(arrays.get("[1]/step", -1)))
    for prefix, named in targets:
        for name, t in named.items():
            key, period = _ref_key(name)
            value = arrays[prefix + key]
            value = value if period is None else value[period]
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {prefix + key}: ckpt "
                                 f"{value.shape} vs model {tuple(t.shape)}")
            t.copy_(_tensor(value))
    return opt_state._replace(step=int(arrays["[1]/step"]))


def restore_train_state(ckpt_dir: str, model, opt_state, *,
                        step: Optional[int] = None):
    """Restore the trainer's state (the newest complete step unless
    ``step``) into ``model`` and ``opt_state`` in place.  Returns
    (opt_state, step)."""
    arrays, step = _read(ckpt_dir, step)
    return load_train_state(arrays, model, opt_state), step


class AsyncCheckpointer:
    """Double-buffered background saver: ``maybe_save`` returns once the
    state is copied to the host."""

    def __init__(self, ckpt_dir: str, *, every: int = 100, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.last_seconds: Optional[float] = None   # the last save's wall

    def maybe_save(self, step: int, state) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        # host copies before the thread starts: the train step updates the
        # parameters in place
        host_state = _rebuild(state, lambda _, leaf: _host(leaf))

        def work():
            t0 = time.perf_counter()
            save(self.ckpt_dir, step, host_state, keep=self.keep)
            self.last_saved = step
            self.last_seconds = time.perf_counter() - t0

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
