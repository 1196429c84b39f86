"""Mechanical checkers for the paper's constraint system C1–C9.

The simulator enforces feasibility *constructively*; these checkers verify it
*independently* over recorded traces (used by property tests and by the OPT
solver's plan validation).  Each function returns a list of violation
strings (empty = satisfied).

Carried copy of ``repro.core.constraints``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class FrameRecord:
    frame: int
    poa: np.ndarray            # (U,) association at frame start (psi^t)
    mac: np.ndarray            # (U,) channel or -1
    uploaded: np.ndarray       # (U,) bool — successful uploads
    placement: np.ndarray      # (U,) BS or -1
    executed: np.ndarray       # (U,) bool — a block actually ran
    exec_node: np.ndarray      # (U,) BS where it ran (-1 if not)
    blocks_done: np.ndarray    # (U,) k_i AFTER the frame
    bs_load: np.ndarray        # (N,) W_n^t
    chain_startable: np.ndarray  # (U,) bool — uploaded in an earlier frame


class TraceRecorder:
    """Collects FrameRecords from an episode run for later validation."""

    def __init__(self):
        self.frames: List[FrameRecord] = []

    def add(self, **kw) -> None:
        self.frames.append(FrameRecord(**kw))


def check_c2_single_path(trace: TraceRecorder) -> List[str]:
    """C2: each UE executes at most one block per frame (single path step)."""
    out = []
    for fr in trace.frames:
        if fr.executed.dtype != bool:
            out.append(f"frame {fr.frame}: executed must be bool")
    return out


def check_c3_capacity(trace: TraceRecorder, w_hat: np.ndarray) -> List[str]:
    out = []
    for fr in trace.frames:
        over = np.where(fr.bs_load > w_hat)[0]
        for n in over:
            out.append(f"frame {fr.frame}: BS {n} load {fr.bs_load[n]} > {w_hat[n]}")
    return out


def check_c4_single_channel(trace: TraceRecorder) -> List[str]:
    """C4: controller assigns each UE at most one channel — (U,) encoding
    guarantees it; verify range validity instead."""
    out = []
    for fr in trace.frames:
        bad = np.where(fr.mac < -1)[0]
        for i in bad:
            out.append(f"frame {fr.frame}: UE {i} invalid channel {fr.mac[i]}")
    return out


def check_c5_no_bs_channel_reuse(trace: TraceRecorder) -> List[str]:
    """C5: among *successful* uploads, one UE per (BS, channel, frame)."""
    out = []
    for fr in trace.frames:
        ok = fr.uploaded & (fr.mac >= 0)
        pairs = {}
        for i in np.where(ok)[0]:
            key = (int(fr.poa[i]), int(fr.mac[i]))
            if key in pairs:
                out.append(f"frame {fr.frame}: BS{key[0]} ch{key[1]} used by "
                           f"UE {pairs[key]} and UE {i}")
            pairs[key] = i
    return out


def check_c6_upload_before_start(trace: TraceRecorder) -> List[str]:
    """C6: a chain's FIRST block requires an upload in an earlier frame."""
    out = []
    prev_blocks = None
    for fr in trace.frames:
        if prev_blocks is not None:
            started = (prev_blocks == 0) & (fr.blocks_done == 1) & fr.executed
            bad = started & ~fr.chain_startable
            for i in np.where(bad)[0]:
                out.append(f"frame {fr.frame}: UE {i} started without prior upload")
        prev_blocks = fr.blocks_done.copy()
    return out


def check_all(trace: TraceRecorder, w_hat: np.ndarray) -> List[str]:
    out: List[str] = []
    out += check_c2_single_path(trace)
    out += check_c3_capacity(trace, w_hat)
    out += check_c4_single_channel(trace)
    out += check_c5_no_bs_channel_reuse(trace)
    out += check_c6_upload_before_start(trace)
    return out
