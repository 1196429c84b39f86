"""PyTorch/CUDA port of the LEARN-GDM serving system (``repro`` is the
JAX reference it is tested against).

Subpackages mirror ``repro``: ``configs``, ``kernels`` (hand-written CUDA
kernels for Hopper and their plain PyTorch versions), ``nn``, ``models``,
``data``, ``optim``, ``checkpoint``, ``launch``, ``sim``, ``rl``, ``core``
and ``serving``.  The package imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.

Entry points run on the card by default: with ``device=None`` they use
``"cuda"`` and raise when CUDA is missing.  CPU runs must ask for
``device="cpu"``; they then take each kernel's plain version.

TF32 is switched off for both cuBLAS and cuDNN here, on import: the
reference computes in float32 throughout, and TF32 products (about three
decimal digits) would break parity with it.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
