"""Model configurations the port runs (``--arch <id>`` resolution).

Every architecture of the reference's zoo (``repro.configs.registry``):
the paper's own ``gdm-dit`` service and the ten assigned LMs, resolved
through :mod:`repro_torch.configs.registry`, which also enumerates the
(arch x shape) grid.
"""
from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    MULTI_POD,
    PREFILL_32K,
    SHAPES,
    SINGLE_POD,
    TRAIN_4K,
    MambaConfig,
    MeshConfig,
    ModelConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
    XLSTMConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ALL_ARCHS,
    ASSIGNED_ARCHS,
    cell_supported,
    get_config,
    get_shape,
    grid_cells,
)
