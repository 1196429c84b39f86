"""Public kernel ops, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot);
a CPU tensor takes the plain PyTorch version from :mod:`repro_torch.kernels.
ref`.  There is no fallback from the card to the plain version and no knob
that selects it: the device is the only input to the choice, where the
reference's ``impl`` argument chose between Pallas and XLA.

Where autograd records (grad mode on and an input that requires grad), a
CUDA tensor goes through the kernel's ``torch.autograd.Function``
(``flash_attention``, ``rmsnorm``: :mod:`repro_torch.kernels.grad`;
``adaln_norm``, both forms, and ``ssm_scan``: forward and backward
kernels), and the CPU's plain versions are differentiated by autograd
itself.  ``decode_attention`` has no backward and refuses.
"""
from __future__ import annotations

from repro_torch.kernels import ref, wants_grad
from repro_torch.kernels.adaln_norm import adaln_norm_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.grad import AdaLNNormFn, FlashAttentionFn, RmsNormFn
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.ssm_scan import SsmScanFn, ssm_scan_cuda


def _no_path(op: str, device):
    return ValueError(f"{op}: no implementation for device {device} "
                      "(CUDA runs the kernel, the CPU the plain version)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float | None = None):
    """Causal/windowed GQA attention.  q: (B,Sq,H,D); k,v: (B,Sk,KH,D)."""
    if q.device.type == "cuda":
        if wants_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                          scale)
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
        if wants_grad(x, shift, scale, weight, bias, gate, residual):
            return AdaLNNormFn.apply(x, shift, scale, weight, bias, gate,
                                     residual, eps)
        return adaln_norm_cuda(x, shift, scale, weight, bias, gate=gate,
                               residual=residual, eps=eps)
    if x.device.type == "cpu":
        return ref.adaln_norm(x, shift, scale, weight, bias, gate=gate,
                              residual=residual, eps=eps)
    raise _no_path("adaln_norm", x.device)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None):
    """Single-token GQA cache attention.  q: (B,H,D); caches: (B,S,KH,D);
    lengths: (B,) int32."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, lengths,
                                     scale=scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    raise _no_path("decode_attention", q.device)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """Row RMSNorm over the last axis.  x: (..., D); scale: (D,)."""
    if x.device.type == "cuda":
        if wants_grad(x, scale):
            return RmsNormFn.apply(x, scale, eps)
        return rmsnorm_cuda(x, scale, eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps=eps)
    raise _no_path("rmsnorm", x.device)


def ssm_scan(u, delta, a, bmat, cmat, d, *, return_state: bool = False):
    """Selective scan from a zero state.  u, delta: (B, L, Din); a: (Din,
    N); bmat, cmat: (B, L, N); d: (Din,).  Returns y (B, L, Din), or (y,
    h_final) with ``return_state`` (the reference's ``ops.ssm_scan``
    returns y only and its prefill takes the state from ``ref.ssm_scan``;
    here both are the kernel on the card).  On the card only y carries a
    gradient, so ``return_state`` there wants grad mode off."""
    if u.device.type == "cuda":
        if wants_grad(u, delta, a, bmat, cmat, d):
            if return_state:
                raise NotImplementedError(
                    "ssm_scan: on the card the final state carries no "
                    "gradient; call the prefill under torch.no_grad()")
            return SsmScanFn.apply(u, delta, a, bmat, cmat, d)
        y, h_final, _ = ssm_scan_cuda(u, delta, a, bmat, cmat, d,
                                      return_state=return_state)
    elif u.device.type == "cpu":
        y, h_final = ref.ssm_scan(u, delta, a, bmat, cmat, d)
    else:
        raise _no_path("ssm_scan", u.device)
    return (y, h_final) if return_state else y
