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
  [p]``.

* The D3QL Q-net params (``repro.rl.networks.qnet_init``) are a flat
  dict of layers: :func:`qnet_from_jax` returns a
  :class:`~repro_torch.rl.networks.QNet` whose ``lstm.wx`` is
  ``params["lstm"]["wx"]`` and ``fc0.w`` is ``params["fc0"]["w"]``.

:func:`dit_to_jax`, :func:`lm_to_jax` and :func:`qnet_to_jax` are the
inverses, exact.
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


@torch.no_grad()
def _fill(model, params: Dict, stacked: int) -> None:
    """Copy every leaf of ``params`` into ``model``.  A ``layers`` leaf is
    stacked along its first axis over ``stacked`` entries: entry i of
    ``layers/<rest>`` goes in at ``layers.{i}.<rest>``.  Raises on a
    missing, extra or misshapen parameter."""
    targets = dict(model.named_parameters())
    filled = set()
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[0] == "layers":
            if arr.shape[0] != stacked:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} stacked "
                                 f"layers, the config makes {stacked}")
            items = [(".".join(("layers", str(i)) + path[1:]), arr[i])
                     for i in range(stacked)]
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
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"reference params lack {missing}")


def _to_tree(model, slots: bool) -> Dict:
    """The reference's nested param tree as numpy arrays, ``layers``
    stacked along a leading axis (a tuple over pattern slots with
    ``slots``)."""
    tree: Dict = {}
    stacked: Dict[Tuple[str, ...], list] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        value = p.detach().cpu().numpy().copy()
        if parts[0] == "layers":
            stacked.setdefault(tuple(parts[2:]), []).append(value)
        else:
            _put(tree, parts, value)
    for path, values in stacked.items():
        _put(tree, ["layers", *path], np.stack(values))
    if slots:
        tree["layers"] = tuple(tree["layers"][str(j)]
                               for j in range(len(tree["layers"])))
    return tree


def dit_from_jax(params: Dict, cfg: ModelConfig, *, device=None) -> DiT:
    """The port's DiT holding the reference's ``params`` (stacked layout)."""
    model = DiT(cfg, device=resolve_device(device))
    _fill(model, params, cfg.num_layers)
    return model


def dit_to_jax(model: DiT) -> Dict:
    """The reference's nested, layer-stacked param tree as numpy arrays."""
    return _to_tree(model, slots=False)


def lm_from_jax(params: Dict, cfg: ModelConfig, *, device=None) -> LM:
    """The port's LM holding the reference's ``params`` (a tuple over
    pattern slots in ``layers``, each stacked over the periods)."""
    model = LM(cfg, device=resolve_device(device))
    _fill(model, params, len(model.layers))
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
    _fill(model, params, 0)
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
