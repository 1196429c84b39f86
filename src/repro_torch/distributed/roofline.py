"""Roofline terms of a counted step, on the NVIDIA H100.

Port of ``repro.distributed.roofline``.  The reference reads its three
terms from a compiled, partitioned XLA module (``hlo_cost`` for FLOPs
and bytes, ``parse_collective_bytes`` for the collectives in the HLO
text); the port has no HLO, so :func:`analyze` reads them from a
:class:`~repro_torch.distributed.op_cost.Cost`, whose ``coll_detail``
takes the place of ``parse_collective_bytes``: the collectives the port's
own seams charged, with the same ring-model factors.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power
limit, from NVIDIA's data sheet (dense, no sparsity): 67 TFLOP/s of
float32 on the CUDA cores, 989 TFLOP/s of bfloat16 on the tensor cores
(the compute term of a cell counted in that dtype), 3.35 TB/s of HBM,
and 450 GB/s a direction of NVLink (900 GB/s both ways).  A card set
below 700 W runs slower than these.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

PEAK_FLOPS = 67e12           # float32 / card (H100 SXM5, 700 W)
PEAK_BF16_FLOPS = 989e12     # bfloat16, dense tensor cores / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, one direction


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_detail: Dict[str, Dict]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    peak_memory_bytes: int = 0
    argument_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    xla_cost_analysis: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_detail: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def peak_flops(dtype=torch.float32) -> float:
    """The card's peak rate for a step computed in ``dtype``: bfloat16 on
    the tensor cores, float32 on the CUDA cores."""
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FLOPS


def analyze(cost, *, num_devices: int, model_flops_global: float = 0.0,
            argument_bytes: int = 0, dtype=torch.float32) -> Roofline:
    """The three roofline terms of one device's counted work.

    ``cost`` is the busiest mesh position's
    :class:`~repro_torch.distributed.op_cost.Cost`; ``argument_bytes`` the
    device's share of the step's arguments, by the spec rules (what the
    reference's ``memory_analysis`` reports as arguments); ``dtype`` the
    cell's, which sets the compute term's rate (:func:`peak_flops`).  The
    peak is the arguments plus the most the step's own allocations held
    at once (``temp_bytes``); ``output_bytes`` is 0 (outputs are among the
    step's allocations).  The port has no XLA, so ``xla_cost_analysis`` stays
    empty; ``kernel_detail`` holds the counter's charges by kernel."""
    compute_s = cost.flops / peak_flops(dtype)
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.coll_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    model_flops_pd = model_flops_global / max(num_devices, 1)
    useful = model_flops_pd / cost.flops if cost.flops else 0.0
    return Roofline(
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.coll_bytes,
        collective_detail={k: {"op": k, "count": int(c), "bytes": b}
                           for k, (c, b) in cost.coll_detail.items()},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops_global,
        useful_ratio=useful,
        peak_memory_bytes=int(argument_bytes + cost.peak_bytes),
        argument_bytes=int(argument_bytes),
        temp_bytes=int(cost.peak_bytes),
        output_bytes=0,
        kernel_detail={k: {"calls": int(n), "flops": f, "bytes": b}
                       for k, (n, f, b) in cost.kernels.items()},
    )


def kernel_path_memory_estimate(cfg, shape, num_devices: int = 256,
                                dtype_bytes: int = 2) -> Dict[str, float]:
    """Projected per-device HBM bytes of one step on the KERNEL path.

    The reference's formula, copied (``memory_s`` at the H100's HBM
    rate); ``dtype_bytes`` is the cell's element size (2 for bfloat16,
    the reference's default, 4 for float32).

      params read once + activations in/out per layer + KV-cache R/W +
      kernel I/O (q,k,v,o / u,dt,B,C,y) + logits — times the pass factor
      (1 fwd; 3 for train fwd+bwd; +1 remat recompute).

    Returns dict with component bytes and the projected memory term seconds.
    """
    d = cfg.d_model
    b, s = shape.global_batch, shape.seq_len
    n_dev = num_devices
    params_b = cfg.param_count() * dtype_bytes / n_dev
    out: Dict[str, float] = {"params": params_b}

    if shape.kind in ("train", "prefill"):
        passes = 4.0 if shape.kind == "train" else 1.0   # fwd+bwd+remat
        tokens_loc = b * s / n_dev
        act_io = 2 * tokens_loc * d * dtype_bytes        # in+out per layer
        kernel_io = tokens_loc * (cfg.q_dim + 2 * cfg.kv_dim + cfg.q_dim) * dtype_bytes
        layers_b = cfg.num_layers * (act_io * 6 + kernel_io) * passes
        logits_b = 2 * tokens_loc * cfg.padded_vocab() * dtype_bytes
        if shape.kind == "train":
            params_b *= 3                                # grads + opt update
            out["params"] = params_b
        out["layers"] = layers_b
        out["logits"] = logits_b
        total = params_b + layers_b + logits_b
    else:
        # decode: params + full cache read + one-row write per attn layer
        n_attn = cfg.num_layers // max(cfg.attn_every, 1)
        if cfg.family == "ssm":
            n_attn = 0
        cache_b = (n_attn * 2 * b * s * cfg.kv_dim * dtype_bytes) / n_dev
        state_b = 0.0
        if cfg.family in ("hybrid", "ssm"):
            state_b = cfg.num_layers * b * 4 * d * 16 * 4 / n_dev  # SSM states f32
        act_b = cfg.num_layers * 2 * (b / n_dev) * d * dtype_bytes * 16
        out["kv_cache"] = cache_b
        out["states"] = state_b
        total = params_b + cache_b + state_b + act_b
    out["total"] = total
    out["memory_s"] = total / HBM_BW
    return out


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D (train) / 2·N_active·D (inference), plus the
    quadratic mixer terms; N excludes the embedding lookup (not a matmul)
    but keeps the LM head (which is one).  The reference's formula, copied.

    Quadratic-in-S layers: attention layers always; mLSTM layers in
    train/prefill (the stabilized parallel form is S^2, the decode form is
    O(1)); Mamba/sLSTM are linear.  Enc-dec decode adds per-step cross
    attention over the encoder memory.
    """
    n_active = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_size * cfg.d_model        # embedding lookup
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if cfg.family == "ssm" and cfg.xlstm is not None:
        n_attn_layers = 0
        xc = cfg.xlstm
        n_quad_train = cfg.num_layers - cfg.num_layers // max(xc.slstm_every, 1)
        quad_dim = int(xc.proj_factor * cfg.d_model)    # mLSTM inner width
    else:
        n_attn_layers = cfg.num_layers // max(cfg.attn_every, 1) + cfg.encoder_layers
        n_quad_train = n_attn_layers
        quad_dim = h * hd
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        quad = 6.0 * b * s * s * quad_dim * n_quad_train  # causal-halved fwd+bwd
        return 6.0 * n_active * tokens + quad
    if shape.kind == "prefill":
        tokens = b * s
        quad = 2.0 * b * s * s * quad_dim * n_quad_train
        return 2.0 * n_active * tokens + quad
    # decode: one token per sequence attending to the full cache (attention
    # layers only — recurrent mixers are O(1) per step)
    attn = 4.0 * b * s * h * hd * n_attn_layers
    if cfg.is_encdec:
        attn += 4.0 * b * cfg.encoder_seq_len * h * hd * cfg.num_layers
    return 2.0 * n_active * b + attn
