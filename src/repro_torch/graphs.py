"""Captured calls, one CUDA graph per key: the port's counterpart of the
executables that ``jax.jit`` compiles and caches per shape.

A :class:`Graphs` wraps one function of tensors.  On the card its first
call at a key runs the function eagerly (which also warms up what a first
call pays once: a kernel library's build and load, cuBLAS's handle and
workspace, a table cached on first use), returns that result, and then
captures the function into a ``torch.cuda.CUDAGraph``.  Each later call at
the key copies its inputs into the graph's static inputs, outside the
graph, replays it and returns the graph's static outputs, which the next
replay at that key overwrites: callers copy what they keep.  The kernels'
launches are counted per replay (:func:`repro_torch.kernels.replayed`).

Inputs are tensors.  One that lies on the call's device is captured where
it lies, so the graph reads and writes it in place, and every later call
at that key must pass a tensor of that address, shape and strides.  One that lies elsewhere (a
pinned host staging buffer, a numpy array's tensor) is copied at each
call into a static device tensor that the graph reads.

On any other device (the CPU, meta) a call is the function's call and no
graph is kept; the keys are kept all the same, so that a caller can tell
a first call from a later one everywhere.  On the card a capture that
fails raises, and nothing gives way to the eager call; treat it as fatal
to the process, as PyTorch then leaves its caching allocator capturing
into the failed graph's pool (it stops emptying its cache).

Every capture on a device runs on one side stream, and the graphs of one
:class:`Graphs` share one memory pool, so they share the memory of their
intermediates.  That is safe because a graph keeps its static outputs
referenced as long as it lives: no later capture can take their memory,
and a replay writes only into its own outputs and into intermediates that
no live tensor holds.  The pool is taken from a graph the cache still
holds (the allocator frees a pool with its last graph), a new one when it
holds none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, Tuple

import torch

from repro_torch import kernels


@dataclasses.dataclass
class Captured:
    """One key's graph: its static inputs (the caller's own device tensors,
    or the copies it reads), static outputs, and the launches its capture
    recorded."""
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    in_place: Tuple[bool, ...]
    outputs: object
    record: list


# per CUDA device index: the side stream every capture there runs on
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device):
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    return _STREAMS[device.index]


class Graphs:
    """``fn`` captured once per key on the card (see the module's
    docstring); ``len`` counts the graphs held."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._entries: Dict[Hashable, object] = {}

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return sum(e is not None for e in self._entries.values())

    def keys(self) -> list:
        """The keys called so far, in the order of their first calls."""
        return list(self._entries)

    def entry(self, key) -> Captured:
        """The graph held at ``key``."""
        return self._entries[key]

    def clear(self) -> None:
        """Drop every key and graph: the next call at any key is a first
        call (a graph reads the tensors it captured at their addresses, so
        a caller whose function now reads other tensors clears it)."""
        self._entries.clear()

    def __call__(self, key, device, *inputs):
        device = torch.device(device)
        if device.type != "cuda":
            self._entries[key] = None
            return self.fn(*inputs)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        entry = self._entries.get(key)
        if entry is None:
            out = self.fn(*(t.to(device, non_blocking=True)
                            for t in inputs))
            self._entries[key] = self._capture(device, inputs)
            return out
        with torch.cuda.device(device):
            for static, in_place, t in zip(entry.inputs, entry.in_place,
                                           inputs):
                if in_place:
                    if (t.data_ptr(), t.shape, t.stride()) != \
                            (static.data_ptr(), static.shape, static.stride()):
                        raise ValueError(
                            "a graph reads a device input where it was "
                            "captured: pass the same memory at every call")
                else:
                    static.copy_(t, non_blocking=True)
            entry.graph.replay()
        kernels.replayed(entry.record)
        return entry.outputs

    def _capture(self, device: torch.device, inputs) -> Captured:
        in_place = tuple(t.device == device for t in inputs)
        static = tuple(
            t if here else torch.empty(t.shape, dtype=t.dtype, device=device)
            for t, here in zip(inputs, in_place))
        pool = next((e.graph.pool() for e in self._entries.values()
                     if e is not None and e.inputs[0].device == device),
                    None)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), kernels.recorded() as record, \
                torch.cuda.graph(graph, pool=pool,
                                 stream=_capture_stream(device)):
            outputs = self.fn(*static)
        return Captured(graph, static, in_place, outputs, record)
