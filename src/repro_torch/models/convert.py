"""Weights carried across from the JAX reference.

``torch`` cannot reproduce ``jax.random``, so a port that must match the
reference number for number loads the parameters the reference drew, as
numpy arrays (any array type numpy can read).  Dense weights keep the
reference's ``(in, out)`` layout.

* The GDM params are a nested dict whose ``layers`` entry is stacked along
  a leading layer axis (``repro.models.gdm.stack_layer_params``):
  :func:`dit_from_jax` returns a :class:`~repro_torch.models.gdm.DiT` whose
  parameter ``layers.{i}.attn.wq.w`` is ``params["layers"]["attn"]["wq"]
  ["w"][i]``.
* The LM params (``repro.models.lm.init_lm``) hold in ``layers`` a tuple
  with one dict per pattern slot, each leaf stacked over the periods:
  :func:`lm_from_jax` returns a :class:`~repro_torch.models.lm.LM` whose
  ``layers.{p}.{j}.attn.wq.w`` is ``params["layers"][j]["attn"]["wq"]["w"]
  [p]``; an enc-dec encoder's ``params["encoder"]["layers"]`` (a tuple of
  one slot, stacked over ``encoder_layers``) goes to
  ``encoder.layers.{i}.0``.

* The D3QL Q-net params (``repro.rl.networks.qnet_init``) are a flat
  dict of layers: :func:`qnet_from_jax` returns a
  :class:`~repro_torch.rl.networks.QNet` whose ``lstm.wx`` is
  ``params["lstm"]["wx"]`` and ``fc0.w`` is ``params["fc0"]["w"]``.

:func:`dit_to_jax`, :func:`lm_to_jax` and :func:`qnet_to_jax` are the
inverses, exact.

A bfloat16 leaf (the reference's ``init_lm(dtype=jnp.bfloat16)`` or
``init_gdm(dtype=jnp.bfloat16)``; numpy holds it in ``ml_dtypes``' 2-byte
type, which ``torch.from_numpy`` refuses) crosses as its bits, through an
int16 view, so a bfloat16 parameter holds the reference's value bit for
bit; ``lm_from_jax`` and ``dit_from_jax`` build the model in bfloat16
where the params hold such leaves (an LM's float32 leaves, Mamba's
``a_log`` and ``d`` and the MoE router, stay float32, as the model keeps
them; every leaf of a bfloat16 DiT is bfloat16).  Going back, a bfloat16 parameter becomes a numpy
array of that type where numpy knows it (``ml_dtypes`` loaded, as JAX
does), else float32, which holds its value exactly.  Any other leaf
crosses as float32.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.gdm import DiT
from repro_torch.models.lm import LM
from repro_torch.rl.networks import QNet
from repro_torch.serving.gdm_service import GDMService


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (str(key),))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (str(i),))
    else:
        yield prefix, tree


_STACKS = (("layers",), ("encoder", "layers"))   # layer stacks, by path


def is_bfloat16(arr: np.ndarray) -> bool:
    """Whether a numpy array holds bfloat16: ``ml_dtypes``' type, or the
    2-byte void that numpy gives it where that type is not loaded."""
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                            and arr.dtype.itemsize == 2)


def _array(leaf) -> np.ndarray:
    """A leaf as a numpy array: bfloat16 as it is, any other as float32."""
    arr = np.asarray(leaf)
    return arr if is_bfloat16(arr) else np.asarray(arr, dtype=np.float32)


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A host tensor of ``_array``'s result: bfloat16 from its bits."""
    if is_bfloat16(arr):
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a parameter (bfloat16 as ``is_bfloat16`` reads
    it, or float32 where numpy lacks that type)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        kind = np.dtype("bfloat16")
    except TypeError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().copy().view(kind)


def _params_dtype(params) -> torch.dtype:
    """bfloat16 where any leaf of ``params`` is bfloat16, else float32:
    the dtype an LM holding them is built in."""
    return torch.bfloat16 if any(is_bfloat16(np.asarray(leaf))
                                 for _, leaf in _leaves(params)) \
        else torch.float32


def _stack_root(path: Tuple[str, ...]) -> Optional[Tuple[str, ...]]:
    return next((r for r in _STACKS if path[:len(r)] == r), None)


@torch.no_grad()
def _fill(model, params: Dict, stacked: Dict[Tuple[str, ...], int]) -> None:
    """Copy every leaf of ``params`` into ``model``.  A leaf under a layer
    stack (``layers``, ``encoder/layers``) is stacked along its first axis
    over ``stacked[root]`` entries: entry i of ``<root>/<rest>`` goes in at
    ``<root>.{i}.<rest>``.  Raises on a missing, extra or misshapen
    parameter."""
    targets = dict(model.named_parameters())
    filled = set()
    for path, leaf in _leaves(params):
        arr = _array(leaf)
        root = _stack_root(path)
        if root is not None:
            n = stacked.get(root, 0)
            if arr.shape[0] != n:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} stacked "
                                 f"layers, the config makes {n}")
            items = [(".".join(root + (str(i),) + path[len(root):]), arr[i])
                     for i in range(n)]
        else:
            items = [(".".join(path), arr)]
        for name, value in items:
            if name not in targets:
                raise KeyError(f"reference parameter {name!r} has no place "
                               f"in the port's {type(model).__name__}")
            p = targets[name]
            if tuple(p.shape) != value.shape:
                raise ValueError(f"{name}: shape {value.shape}, the port "
                                 f"expects {tuple(p.shape)}")
            p.copy_(from_numpy(value))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"reference params lack {missing}")


def _to_tree(model, slots: bool) -> Dict:
    """The reference's nested param tree as numpy arrays, each layer stack
    stacked along a leading axis (a tuple over pattern slots with
    ``slots``)."""
    tree: Dict = {}
    stacked: Dict[Tuple[str, ...], list] = {}
    for name, p in model.named_parameters():
        parts = tuple(name.split("."))
        value = _numpy(p)
        root = _stack_root(parts)
        if root is not None:
            rest = parts[len(root) + 1:]
            stacked.setdefault(root + rest, []).append(value)
        else:
            _put(tree, parts, value)
    for path, values in stacked.items():
        _put(tree, path, np.stack(values))
    if slots:
        for root in _STACKS:
            sub = tree
            for key in root[:-1]:
                sub = sub.get(key, {})
            if root[-1] in sub:
                sub[root[-1]] = tuple(sub[root[-1]][str(j)]
                                      for j in range(len(sub[root[-1]])))
    return tree


def dit_from_jax(params: Dict, cfg: ModelConfig, *, device=None,
                 dtype=None) -> DiT:
    """The port's DiT holding the reference's ``params`` (stacked layout),
    built in ``dtype`` (by default the params' own: :func:`_params_dtype`,
    bfloat16 for the reference's ``init_gdm(dtype=jnp.bfloat16)``)."""
    model = DiT(cfg, device=resolve_device(device),
                dtype=dtype or _params_dtype(params))
    _fill(model, params, {("layers",): cfg.num_layers})
    return model


def dit_to_jax(model: DiT) -> Dict:
    """The reference's nested, layer-stacked param tree as numpy arrays."""
    return _to_tree(model, slots=False)


def lm_from_jax(params: Dict, cfg: ModelConfig, *, device=None,
                dtype=None) -> LM:
    """The port's LM holding the reference's ``params`` (a tuple over
    pattern slots in ``layers``, each stacked over the periods), built in
    ``dtype`` (by default the params' own: :func:`_params_dtype`)."""
    model = LM(cfg, device=resolve_device(device),
               dtype=dtype or _params_dtype(params))
    _fill(model, params, {("layers",): len(model.layers),
                          ("encoder", "layers"): cfg.encoder_layers})
    return model


def lm_to_jax(model: LM) -> Dict:
    """The reference's LM param tree as numpy arrays."""
    return _to_tree(model, slots=True)


def qnet_from_jax(params: Dict, cfg, *, device=None) -> QNet:
    """The port's Q-net holding the reference's ``params``; ``cfg`` is the
    agent's :class:`~repro_torch.rl.d3ql.D3QLConfig` (widths)."""
    model = QNet(cfg.obs_dim, cfg.num_ues, cfg.num_actions,
                 lstm_units=cfg.lstm_units, fc=cfg.fc,
                 device=resolve_device(device))
    _fill(model, params, {})
    return model


def qnet_to_jax(model: QNet) -> Dict:
    """The reference's Q-net param tree as numpy arrays."""
    return _to_tree(model, slots=False)


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def service_from_jax(params: Dict, cfg: ModelConfig, *,
                     omega: Optional[np.ndarray] = None, device=None,
                     **service_kw):
    """A :class:`~repro_torch.serving.gdm_service.GDMService` serving the
    reference's ``params``; with ``omega`` it takes that quality curve
    instead of measuring its own."""
    return GDMService(model=dit_from_jax(params, cfg, device=device),
                      omega=omega, **service_kw)
