"""Public kernel ops, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot);
a CPU tensor takes the plain PyTorch version from :mod:`repro_torch.kernels.
ref`.  There is no fallback from the card to the plain version and no knob
that selects it: the device is the only input to the choice, where the
reference's ``impl`` argument chose between Pallas and XLA.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.adaln_norm import adaln_norm_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda


def _no_path(op: str, device):
    return ValueError(f"{op}: no implementation for device {device} "
                      "(CUDA runs the kernel, the CPU the plain version)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float | None = None):
    """Causal/windowed GQA attention.  q: (B,Sq,H,D); k,v: (B,Sk,KH,D)."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    raise _no_path("flash_attention", q.device)


def adaln_norm(x, shift, scale, weight, bias, gate=None, residual=None, *,
               eps: float = 1e-5):
    """Fused DiT adaLN: LayerNorm + shift/scale modulation.

    x: (B, S, d); shift/scale/gate: (B, d) or (B, 1, d); weight/bias: (d,).
    With ``gate``+``residual`` the previous sublayer's gated residual add is
    fused in first and ``(y, new_residual)`` is returned.
    """
    b, _, d = x.shape
    shift, scale = shift.reshape(b, d), scale.reshape(b, d)
    if gate is not None:
        gate = gate.reshape(b, d)
    if x.device.type == "cuda":
        return adaln_norm_cuda(x, shift, scale, weight, bias, gate=gate,
                               residual=residual, eps=eps)
    if x.device.type == "cpu":
        return ref.adaln_norm(x, shift, scale, weight, bias, gate=gate,
                              residual=residual, eps=eps)
    raise _no_path("adaln_norm", x.device)
