"""Distributed layer of the port (``repro.distributed`` in the reference):
the sharding rules of the closed loop's and the LM's mesh paths, the split
and gather that run the closed loop on a 1-D mesh of torch devices, and
the LM's split-K decode (:mod:`repro_torch.distributed.flash_decode`)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    NamedSharding,
    P,
    PartitionSpec,
    batch_shardings,
    batch_spec,
    data_axes,
    draw_specs,
    gather,
    leading_axis_spec,
    mesh_devices,
    spec_for_shape,
    split,
)
