"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made in this
process: a wrapper adds one where it launches its kernel and nowhere else,
so a run can show that the main path went through the kernels (a wrapper
that makes two launches, as the backward kernels of the scan and of adaLN
do, counts one).
"""
import torch

LAUNCHES = {"adaln_norm": 0, "adaln_norm_epilogue": 0, "flash_attention": 0,
            "decode_attention": 0, "rmsnorm": 0, "ssm_scan": 0,
            "ssm_scan_backward": 0, "adaln_norm_backward": 0,
            "adaln_norm_epilogue_backward": 0}


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


def wants_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` here."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where ``decode_attention``, since ``adaln_norm`` gained its
    backward the one kernel without one, would be asked for a gradient: a
    ctypes launch fills a fresh tensor, so autograd would see a constant
    and the graph would be cut without a word."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward (ROADMAP Queue 2 item "
            "6 lists the backward kernels); call it under torch.no_grad() "
            "or on inputs that do not require grad")
