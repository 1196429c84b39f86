"""Weights carried across from the JAX reference.

``torch`` cannot reproduce ``jax.random``, so a port that must match the
reference number for number loads the parameters the reference drew.  The
reference's GDM params are a nested dict whose ``layers`` entry is stacked
along a leading layer axis (``repro.models.gdm.stack_layer_params``);
:func:`dit_from_jax` takes that tree as numpy arrays (any array type numpy
can read) and returns a :class:`~repro_torch.models.gdm.DiT` whose
parameter ``layers.{i}.attn.wq.w`` is ``params["layers"]["attn"]["wq"]["w"]
[i]``.  :func:`dit_to_jax` is the inverse.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.gdm import DiT
from repro_torch.serving.gdm_service import GDMService


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (str(key),))
    else:
        yield prefix, tree


@torch.no_grad()
def dit_from_jax(params: Dict, cfg: ModelConfig, *, device=None) -> DiT:
    """The port's DiT holding the reference's ``params`` (stacked layout).
    Raises on a missing, extra or misshapen parameter."""
    device = resolve_device(device)
    model = DiT(cfg, device=device)
    targets = dict(model.named_parameters())
    filled = set()
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[0] == "layers":
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} stacked "
                                 f"layers, config has {cfg.num_layers}")
            items = [(".".join(("layers", str(i)) + path[1:]), arr[i])
                     for i in range(arr.shape[0])]
        else:
            items = [(".".join(path), arr)]
        for name, value in items:
            if name not in targets:
                raise KeyError(f"reference parameter {name!r} has no place "
                               "in the port's DiT")
            p = targets[name]
            if tuple(p.shape) != value.shape:
                raise ValueError(f"{name}: shape {value.shape}, the port "
                                 f"expects {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"reference params lack {missing}")
    return model


def dit_to_jax(model: DiT) -> Dict:
    """The reference's nested, layer-stacked param tree as numpy arrays."""
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
    return tree


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
