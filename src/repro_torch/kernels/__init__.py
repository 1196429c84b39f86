"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made in this
process: a wrapper adds one where it launches its kernel and nowhere else,
so a run can show that the main path went through the kernels.
"""
import torch

LAUNCHES = {"adaln_norm": 0, "adaln_norm_epilogue": 0, "flash_attention": 0,
            "decode_attention": 0, "rmsnorm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_operand(name: str, t, device: torch.device, shape=None, *,
                  contiguous: bool = True) -> None:
    """Raise unless ``t`` is a float32 tensor on ``device`` of ``shape``
    (and contiguous, unless the kernel takes a row stride for it)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes float32")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if not contiguous and t.stride(-1) != 1:
        raise ValueError(f"{name}: the kernel takes unit stride in the last "
                         "dimension")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
