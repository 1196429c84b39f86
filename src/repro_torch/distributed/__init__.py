"""Distributed layer of the port (``repro.distributed`` in the reference):
the sharding rules of the closed loop's and the LM's mesh paths, the split
and gather that run the closed loop on a 1-D mesh of torch devices, the
LM's split-K decode (:mod:`repro_torch.distributed.flash_decode`), the
cost counter of an eager step (:mod:`repro_torch.distributed.op_cost`,
the counterpart of ``hlo_cost``) and its roofline on the H100
(:mod:`repro_torch.distributed.roofline`)."""
from repro_torch.distributed.roofline import (  # noqa: F401
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    Roofline,
    analyze,
    model_flops_estimate,
)
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
