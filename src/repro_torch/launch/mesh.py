"""Device meshes for the mesh paths of the closed loop and the LM.

Port of ``repro.launch.mesh``.  A :class:`Mesh` holds torch devices in the
mesh's shape with one name per axis, as ``jax.sharding.Mesh`` does, and the
port runs it from one controller: one process enqueues every shard's work
on its device, as the reference's ``shard_map`` does from one program.

Like every entry point of the port, the factories use the card unless the
caller passes ``devices``: a list of devices, which may repeat one device.
Repeating a device is the counterpart of the reference's
``--xla_force_host_platform_device_count``: several mesh positions share
one device, every split and gather runs, and the shards run one after the
other (``("cpu",) * 4`` in the CPU tests, ``cuda:0`` twice or four times on
a one-card host).

``make_production_mesh`` and ``make_mesh_from_config`` build the
reference's production topologies, (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``, over 256 or 512 devices: the
tests pass ``("meta",) * 512``, whose rules read only the mesh's shape and
names.  Only meshes whose devices repeat one device (the CPU, or
``cuda:0``) are checked; a mesh over distinct cards runs the same code
with copies between them, unchecked.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig


class Mesh:
    """``devices`` (an ndarray of ``torch.device`` in the mesh's shape) with
    one name per axis; ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def _devices(devices: Optional[Sequence]) -> list:
    """``devices`` as torch devices, or every CUDA device; never the CPU
    unless asked."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=('cpu',) * n to build a "
            "mesh over the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(devices: list, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(16, 16) ("data", "model") single pod; (2, 16, 16) ("pod", "data",
    "model") across two pods: 256 devices a pod, 512 in all."""
    return make_mesh_from_config(MULTI_POD if multi_pod else SINGLE_POD,
                                 devices=devices)


def make_mesh_from_config(cfg: MeshConfig, *,
                          devices: Optional[Sequence] = None) -> Mesh:
    return make_host_mesh(cfg.shape, cfg.axes, devices=devices)


def make_host_mesh(shape: Tuple[int, ...] = (1,),
                   axes: Tuple[str, ...] = ("data",), *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Tiny mesh over the first devices (tests, examples)."""
    avail = _devices(devices)
    n = int(np.prod(shape))
    assert n <= len(avail), (shape, len(avail))
    return _mesh(avail[:n], tuple(shape), tuple(axes))


def make_env_mesh(num_devices: Optional[int] = None, *,
                  divides: Optional[int] = None, axis: str = "env",
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh for the sharded fused rollout / fleet batch.

    ``num_devices`` defaults to every device (``devices``, or every CUDA
    device).  When ``divides`` is given (the stacked env count E or the
    serving batch width), the mesh degrades to the largest device count
    that divides it instead of failing, as the reference's does.  ``axis``
    names the single mesh axis ("env" for the rollout paths, "batch" for
    the serving batch).
    """
    avail = _devices(devices)
    n = min(num_devices or len(avail), len(avail))
    if divides is not None:
        while n > 1 and divides % n:
            n -= 1
    return _mesh(avail[:n], (n,), (axis,))


def mesh_config(mesh: Mesh) -> MeshConfig:
    return MeshConfig(tuple(mesh.devices.shape), tuple(mesh.axis_names))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pod + data)."""
    names = tuple(mesh.axis_names)
    return tuple(a for a in ("pod", "data") if a in names)
