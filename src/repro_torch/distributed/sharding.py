"""Sharding rules of the closed loop's mesh paths, and the port's split and
gather.

Port of the env/batch part of ``repro.distributed.sharding``: the spec
rules (``spec_for_shape``, ``data_axes``, ``batch_spec``,
``leading_axis_spec``, ``draw_specs``, ``batch_shardings``) give the same
specs as the reference on the same mesh shapes.  A :class:`PartitionSpec`
names, for each dimension of a tensor, the mesh axis it is split over
(``None``: whole on every device), and normalises a 1-tuple of names to
the bare name, as jax's does.

On a 1-D mesh, :func:`split` cuts a tensor into its per-device shards by a
spec, each moved to its device, and :func:`gather` puts shards back in
global order on one device: the port's ``all_gather(tiled=True)``.  A
shard on the device it came from is a view; on another device, a copy.

The LM rules (``param_specs``, ``decode_state_specs``,
``input_specs_shardings``, ``logits_spec``) wait for the LM mesh slice
(ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of names, or
    ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to the mesh it splits over."""
    mesh: Any
    spec: PartitionSpec


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= _axis_size(mesh, a)
        return n
    return mesh.shape[axis]


def spec_for_shape(shape: Sequence[int], template: Tuple, mesh) -> P:
    """Right-align ``template`` onto ``shape`` with divisibility checks."""
    ndim = len(shape)
    axes: List = [None] * ndim
    t = list(template)[-ndim:] if template else []
    offset = ndim - len(t)
    for j, axis in enumerate(t):
        dim = offset + j
        if axis is None:
            continue
        if shape[dim] % _axis_size(mesh, axis) == 0:
            axes[dim] = axis
        # else: leave replicated on this dim (divisibility fallback)
    return P(*axes)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> P:
    """Shard the batch dim over (pod, data) — degrade if indivisible,
    preferring the largest divisible axis subset."""
    dp = data_axes(mesh)
    candidates: List[Tuple[str, ...]] = [dp]
    candidates += [(a,) for a in sorted(dp, key=lambda a: -_axis_size(mesh, a))]
    chosen: Tuple[str, ...] = ()
    for cand in candidates:
        if cand and batch % _axis_size(mesh, cand) == 0:
            chosen = cand
            break
    first = chosen if chosen else None
    return P(first, *([None] * extra_dims))


def leading_axis_spec(mesh, axis: str, size: int, ndim: int = 1) -> P:
    """Shard the leading dim over ``axis`` when divisible, else replicate
    (the standard degrade rule applied to env/batch stacks)."""
    if axis in mesh.axis_names and size % mesh.shape[axis] == 0:
        return P(axis, *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def draw_specs(draws: Dict[str, Any], axis: str, *, env_dim: int = 1,
               replicated: Sequence[str] = ()) -> Dict[str, P]:
    """PartitionSpecs for a fused-rollout draws dict.

    Frame draws are (T, E, ...) stacks — the env axis sits at ``env_dim``
    (1); reset draws are (E, ...) — ``env_dim=0``.  Keys in ``replicated``
    (e.g. the replay ``"sample"`` uniforms, which every shard must consume
    identically) get ``P()``.
    """
    def spec(k):
        if k in replicated:
            return P()
        return P(*([None] * env_dim), axis)
    return {k: spec(k) for k in draws}


def batch_shardings(mesh, axis: str = "batch"):
    """(sharded, replicated) :class:`NamedSharding` pair for a
    leading-batch-dim device call — the serving engine's stacked
    ``run_block_batched``."""
    return NamedSharding(mesh, P(axis)), NamedSharding(mesh, P())


# -- split and gather on a 1-D mesh ----------------------------------------------

def mesh_devices(mesh) -> List[torch.device]:
    """The devices of a 1-D mesh in shard order."""
    if mesh.devices.ndim != 1:
        raise ValueError(f"a 1-D mesh is needed, not {dict(mesh.shape)}")
    return list(mesh.devices)


def _split_dim(spec: P):
    """The one dimension ``spec`` splits, or None (replicated)."""
    dims = [d for d, a in enumerate(spec) if a is not None]
    if len(dims) > 1:
        raise ValueError(f"{spec} splits more than one dim")
    return dims[0] if dims else None


def _to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``; asynchronous only onto an accelerator (a copy
    to the host returns when it is done)."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type != "cpu")


def split(x: torch.Tensor, mesh, spec: P) -> List[torch.Tensor]:
    """``x``'s shards on a 1-D mesh: equal chunks along the dimension
    ``spec`` splits over the mesh's axis, each on its device; where
    ``spec`` splits nothing, the whole of ``x`` on every device."""
    devices = mesh_devices(mesh)
    dim = _split_dim(spec)
    if dim is None:
        return [_to(x, d) for d in devices]
    if spec[dim] != mesh.axis_names[0]:
        raise ValueError(f"{spec} names no axis of {dict(mesh.shape)}")
    if x.shape[dim] % len(devices):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {len(devices)} devices")
    return [_to(c, d) for c, d in zip(x.chunk(len(devices), dim), devices)]


def gather(shards: Sequence[torch.Tensor], spec: P,
           device) -> torch.Tensor:
    """The global tensor of ``shards`` (split by ``spec``) on ``device``:
    the shards concatenated in mesh order, or the first shard where
    ``spec`` splits nothing."""
    dim = _split_dim(spec)
    if dim is None or len(shards) == 1:
        return _to(shards[0], device)
    return torch.cat([_to(s, device) for s in shards], dim)
