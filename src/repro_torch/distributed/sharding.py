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
A cost counter (:mod:`repro_torch.distributed.op_cost`) sees shard j at
mesh position (j, 0) and is charged the ring model's bytes of each: a
split that cuts a dimension as a scatter, one that cuts none as a
broadcast, a gather as an all-gather.

The LM rules (``PARAM_RULES``, ``param_specs``, ``param_shardings``,
``input_specs_shardings``, ``decode_state_specs``, ``logits_spec``) give
the reference's specs too: a port parameter gets the spec of the
reference leaf it is a slice of (the period-stacked axis included), and a
decode-state tensor the spec of the reference path it holds.  They read
only ``mesh.shape`` and ``mesh.axis_names``.  The LM steps run the data
axes (the batch split by :func:`batch_spec`) and the model axis where the
reference writes it out under ``shard_map``: the experts of the
all-to-all MoE and the sequence blocks of the split-K decode.  The dense
layers' Megatron split over ``model``, which the reference leaves to
GSPMD and which gives the numbers of the unsharded step, stays rules
here: every device of a data shard's row computes with whole weights.

:func:`shard_rows` names the devices of an N-D mesh by (data shard, model
index), and :func:`sub_mesh` the part of a mesh that one data shard runs
on.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.op_cost import collective, place


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


# (path regex, right-aligned axis template), first match wins, as in the
# reference.  Axis entries: "model" / "data" / ("data","model") / None.
PARAM_RULES: List[Tuple[str, Tuple]] = [
    (r"embed/table$",            ("model", "data")),     # (Vpad, d)
    (r"head/w$",                 ("data", "model")),     # (d, Vpad)
    (r"patch_proj/w$",           ("data", "model")),
    (r"frame_proj/w$",           ("data", "model")),
    # attention
    (r"attn/wq/w$|attn/wk/w$|attn/wv/w$", ("data", "model")),
    (r"cross/wq/w$|cross/wk/w$|cross/wv/w$", ("data", "model")),
    (r"attn/wo/w$|cross/wo/w$",  ("model", "data")),
    (r"attn/w[qkv]/b$|cross/w[qkv]/b$", ("model",)),
    (r"attn/wo/b$|cross/wo/b$",  (None,)),
    # dense MLP
    (r"mlp/gate/w$|mlp/up/w$",   ("data", "model")),
    (r"mlp/down/w$",             ("model", "data")),
    (r"mlp/(up|down|gate)/b$",   (None,)),
    # MoE: experts over model (EP), FSDP over data on d_model dim
    (r"moe/router$",             (None, None)),
    (r"moe/gate_w$|moe/up_w$",   ("model", "data", None)),
    (r"moe/down_w$",             ("model", None, "data")),
    # mamba
    (r"mamba/in_proj/w$",        ("data", "model")),
    (r"mamba/conv_w$",           (None, "model")),
    (r"mamba/conv_b$",           ("model",)),
    (r"mamba/x_proj/w$",         ("model", None)),
    (r"mamba/dt_proj/w$",        (None, "model")),
    (r"mamba/dt_proj/b$",        ("model",)),
    (r"mamba/a_log$",            ("model", None)),
    (r"mamba/d$",                ("model",)),
    (r"mamba/out_proj/w$",       ("model", "data")),
    # xlstm
    (r"mlstm/up/w$",             ("data", "model")),
    (r"mlstm/conv_w$",           (None, "model")),
    (r"mlstm/conv_b$",           ("model",)),
    (r"mlstm/w[qkv]/w$",         ("data", "model")),
    (r"mlstm/w_if/w$",           ("model", None)),
    (r"mlstm/down/w$",           ("model", "data")),
    (r"slstm/wx/w$",             ("data", "model")),
    (r"slstm/r$",                (None, None, "model")),
    (r"slstm/up/w$",             ("data", "model")),
    (r"slstm/down/w$",           ("model", "data")),
    # norms & small vectors: replicated
    (r".*",                      ()),
]


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
    n = len(devices)
    dim = _split_dim(spec)
    at = [(j, 0) for j in range(n)]
    collective("broadcast" if dim is None else "scatter",
               x.numel() * x.element_size(), n, at)
    if dim is None:
        # on repeated devices the shards are x itself: not placed
        return [_to(x, d) for d in devices]
    if spec[dim] != mesh.axis_names[0]:
        raise ValueError(f"{spec} names no axis of {dict(mesh.shape)}")
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} devices")
    return [place(_to(c, d), p)
            for c, d, p in zip(x.chunk(n, dim), devices, at)]


def gather(shards: Sequence[torch.Tensor], spec: P,
           device) -> torch.Tensor:
    """The global tensor of ``shards`` (split by ``spec``) on ``device``:
    the shards concatenated in mesh order, or the first shard where
    ``spec`` splits nothing."""
    dim = _split_dim(spec)
    if dim is None or len(shards) == 1:
        return _to(shards[0], device)
    out = torch.cat([_to(s, device) for s in shards], dim)
    collective("all-gather", out.numel() * out.element_size(), len(shards),
               [(j, 0) for j in range(len(shards))])
    return out


# -- the LM rules -------------------------------------------------------------------

def param_specs(params, mesh) -> Dict[str, P]:
    """The reference's spec for each of the port's parameters (an LM, or a
    mapping from names to tensors): the spec of the reference leaf the
    parameter is a slice of, period-stacked axis included, so a layer's
    spec has one entry more than its tensor has dims."""
    # the LM's layers import the split-K decode, which imports this module
    from repro_torch.models.lm import reference_leaf

    named = dict(params.named_parameters()) \
        if isinstance(params, torch.nn.Module) else dict(params)
    leaves = {name: reference_leaf(name) for name in named}
    stacked: Dict[Tuple[str, ...], int] = {}      # a leaf's stacked length
    for path, period in leaves.values():
        if period is not None:
            stacked[path] = max(stacked.get(path, 0), period + 1)
    out = {}
    for name, p in named.items():
        path, period = leaves[name]
        shape = tuple(p.shape) if period is None \
            else (stacked[path],) + tuple(p.shape)
        pstr = "/".join(path)
        template = next(t for pattern, t in PARAM_RULES
                        if re.search(pattern, pstr))
        out[name] = spec_for_shape(shape, template, mesh)
    return out


def param_shardings(params, mesh) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, s)
            for k, s in param_specs(params, mesh).items()}


def input_specs_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                          *, seq_shard: bool = False) -> Dict[str, Any]:
    """NamedShardings for the train/prefill batch dict."""
    b = shape.global_batch
    out: Dict[str, Any] = {
        "tokens": NamedSharding(mesh, batch_spec(mesh, b, 1)),
        "labels": NamedSharding(mesh, batch_spec(mesh, b, 1)),
    }
    if cfg.num_patch_tokens:
        out["patch_embeds"] = NamedSharding(mesh, batch_spec(mesh, b, 2))
    if cfg.is_encdec:
        out["enc_frames"] = NamedSharding(mesh, batch_spec(mesh, b, 2))
    return out


def _state_spec(pstr: str, shp: Tuple[int, ...], tp: int, bspec) -> P:
    """The reference's rule for one decode-state leaf at path ``pstr``."""
    if re.search(r"kv/k$|kv/v$", pstr):
        # (periods, B, S, KH, D)
        if shp[3] % tp == 0:
            return P(None, bspec, None, "model", None)
        if shp[2] % tp == 0:
            return P(None, bspec, "model", None, None)
        return P(None, bspec, None, None, None)
    if re.search(r"kv/length$", pstr):
        return P(None, bspec)
    axes: List = [None] * len(shp)
    if len(shp) > 1:
        axes[1] = bspec
    # SSM / recurrent states: model over the channel dim (dim 2 of the
    # SSM state (periods, B, d_in, N), the last dim of the others)
    channel = {r"mamba/ssm$": 2, r"mamba/conv$|conv_tail$": -1,
               r"mlstm/(c|n)$": -1, r"slstm/(h|c|n|m)$": -1}
    for pattern, dim in channel.items():
        if re.search(pattern, pstr):
            if shp[dim] % tp == 0:
                axes[dim] = "model"
            break
    return P(*axes)


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       state) -> Any:
    """Specs for the port's decode state (a tuple with one dict per
    pattern slot, each tensor stacked over the periods), in its structure.

    KV caches (periods, B, S, KH, D): batch over dp when divisible; model
    axis on kv-heads if divisible, else on the sequence dim (split-K
    decode).  SSM/recurrent states: model axis on the channel dim."""
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    dp = data_axes(mesh)
    bspec = dp if len(dp) > 0 and shape.global_batch \
        % _axis_size(mesh, dp) == 0 else None

    def assign(path: str, leaf):
        if isinstance(leaf, tuple):          # a NamedTuple state
            return type(leaf)(*(assign(f"{path}/{f}", v)
                                for f, v in zip(leaf._fields, leaf)))
        if isinstance(leaf, dict):
            return {k: assign(f"{path}/{k}", v) for k, v in leaf.items()}
        return _state_spec(path, tuple(leaf.shape), tp, bspec)

    return tuple(assign(str(j), slot) for j, slot in enumerate(state))


def logits_spec(mesh, decode: bool = False, global_batch: int = 0) -> P:
    """Logits sharding: batch over dp (degraded if indivisible), vocab over
    model."""
    if global_batch:
        b = batch_spec(mesh, global_batch, extra_dims=0)
        first = b[0] if len(b) else None
    else:
        dp = data_axes(mesh)
        first = dp if dp else None
    if decode:
        return P(first, "model")
    return P(first, None, "model")


# -- the devices of an N-D mesh by data shard -------------------------------------------

def _axes(batch_axes) -> Tuple[str, ...]:
    """A batch spec entry (None, a name or a tuple of names) as a tuple."""
    if not batch_axes:
        return ()
    return (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)


def shard_rows(mesh, batch_axes=(), model_axis=None
               ) -> List[List[torch.device]]:
    """``rows[i][m]``: the device of data shard i (row-major over
    ``batch_axes``, as a spec splits a dim over a tuple of axes) and model
    index m (one entry without ``model_axis``).  Every other axis sits at
    index 0: the reference runs the same shard there again, which one
    controller runs once."""
    batch_axes = _axes(batch_axes)
    names = list(mesh.axis_names)
    sizes = [mesh.shape[a] for a in batch_axes]
    tp = mesh.shape[model_axis] if model_axis else 1
    rows = []
    for i in range(int(np.prod(sizes, dtype=int))):
        index = [0] * len(names)
        for a, c in zip(batch_axes, np.unravel_index(i, sizes)
                        if sizes else ()):
            index[names.index(a)] = int(c)
        row = []
        for m in range(tp):
            if model_axis:
                index[names.index(model_axis)] = m
            row.append(mesh.devices[tuple(index)])
        rows.append(row)
    return rows


def sub_mesh(mesh, batch_axes, i: int, model_axis: str = "model"):
    """The mesh of data shard ``i``: its row of devices over
    ``model_axis``, every other axis of size 1, under the same names."""
    row = shard_rows(mesh, batch_axes, model_axis
                     if model_axis in mesh.axis_names else None)[i]
    shape = [mesh.shape[a] if a == model_axis else 1
             for a in mesh.axis_names]
    grid = np.empty(len(row), dtype=object)
    grid[:] = row
    return type(mesh)(grid.reshape(shape), mesh.axis_names)
