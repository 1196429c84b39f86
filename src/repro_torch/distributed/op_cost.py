"""Per-device FLOPs, HBM bytes and collective bytes of an eager step.

Counterpart of ``repro.distributed.hlo_cost``, which parses XLA's
compiled, partitioned HLO and cannot be ported: the port runs eagerly,
so :func:`count` watches the aten ops a step dispatches (a
``TorchDispatchMode``) and gives the same three totals, per mesh
position:

  FLOPs   -- ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``,
             ``addmm``, ``baddbmm``, convolutions), as ``hlo_cost`` counts
             ``dot`` and ``convolution`` only;
  bytes   -- each op's operand bytes plus its result bytes: eagerly an op
             is one kernel, so this is the traffic the card sees, not an
             upper bound as it would be under fusion.  Allocation and
             view ops (``empty``, ``empty_strided``, ``view``,
             ``as_strided``, ...) move nothing, as ``hlo_cost``'s
             ``_ZERO_BYTE_OPS``; an in-place write into a region of a
             tensor (``index_copy_``, ``index_put_``, the scatters, as a
             KV-cache insert) moves its index and source operands and
             the region it writes, not the whole target, as
             ``hlo_cost`` charges an in-place ``dynamic-update-slice``,
             and a gather of rows (``embedding``, ``index_select``,
             ``gather``, ``index``) its indices and the rows it reads, as
             ``hlo_cost`` charges a parameter read only by a gather;
  coll    -- ring-model bytes of the collectives the port's own seams
             charge (:func:`collective`), with ``hlo_cost``'s factors.

Each hand-written kernel, and each kernel's backward, is one unit: it
charges its own formula once a call (``repro_torch.kernels.charge``),
the aten ops inside it count nothing, so a step counts the same on the
meta device, the CPU and the card.  ``Cost.kernels`` holds those charges
by kernel.  ``Cost.peak_bytes`` is the largest sum of live bytes of the
storages the step's ops and kernels made (keyed by
``untyped_storage()._cdata``, since a meta tensor's ``data_ptr()`` is 0,
and freed when the storage dies): a kernel's workspace and the
intermediates of a plain version are not in it.

**Mesh positions.**  A mesh of repeated devices (``("meta",) * 256``)
cannot tell its positions apart by device, so the steps' shard loops
tell the counter where each shard's data lives (:func:`place`): data
shard i's rows at (i, 0), model shard m of it at (i, m).  An op runs where
its operands live: at the position holding the most storage bytes of its
placed operands (the first of a tie), its results placed there too, and
at (0, 0) where they live on different data shards (the port sums the
data shards' results where the model lives: the loss, the shards'
gradients on a mesh of repeated devices, where one model serves them
all); an op with
no placed operand runs at (0, 0), where the model lives.  The backward
follows its saved activations the same way.  ``Counter.cost`` is the
busiest position's.

**Long loops on the meta device.**  A recurrence stepped in Python (the
sLSTM's, :class:`RepeatedSteps`) costs the meta device about a
millisecond an op, so xlstm-1.3b's ``prefill_32k`` would take hours.
There, under a counter, the loop runs three steps and charges the other
n - 3 as many more of its second: the second step's forward as the
counter saw it, its backward (between the gradient hooks of its output
and of the first step's), and the bytes it kept live, which are freed
with its output.  The first and the last step differ from the others
(the first has no incoming state to differentiate, the last no later
step to take its output), so three traced steps give every kind once;
``tests/test_torch_dryrun.py`` pins the shortcut's FLOPs and bytes to
the whole loop's at a short sequence, exactly; its peak is an estimate
(the steps not run hold their live bytes until the second step's output
dies, where the whole loop frees each step's at its own backward).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch import kernels

Position = Tuple[int, int]
HOME: Position = (0, 0)

_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "lift_fresh", "_unsafe_view", "detach",
                "alias"}
# read a region of their first operand, the size of their result
_REGION_READS = {"embedding", "index_select", "gather", "index"}
# in place into a region of their first operand, from their last
_REGION_WRITES = {"index_copy_", "index_put_", "_index_put_impl_",
                  "index_add_", "scatter_", "scatter_add_",
                  "scatter_reduce_"}


def _ring_bytes(op: str, nbytes: float, g: int) -> float:
    """Per-device bytes of a collective with ``nbytes`` of result on a
    ring of ``g`` devices (``hlo_cost``'s factors; a scatter or a
    broadcast from one device moves what an all-gather of the same tensor
    moves)."""
    if op in ("all-gather", "all-to-all", "scatter", "broadcast"):
        return nbytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(nbytes) * (g - 1)
    return float(nbytes)


@dataclasses.dataclass
class Cost:
    """One position's totals: ``coll_detail`` maps a collective to [count,
    bytes], ``kernels`` a kernel (or kernel backward) to [calls, flops,
    bytes] of its charges (in ``flops`` and ``bytes`` too)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_detail: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _zero_bytes(func) -> bool:
    """Allocations and views: ops whose result is a fresh, unwritten
    buffer or aliases an operand."""
    if func._overloadpacket.__name__ in _ALLOCATIONS:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _Position:
    def __init__(self):
        self.cost = Cost()
        self.live = 0
        self.by_op: Dict[str, float] = {}


class Counter:
    """The totals of a :func:`count` region, by mesh position."""

    def __init__(self):
        self.positions: Dict[Position, _Position] = {}
        self._tags = WeakTensorKeyDictionary()
        self._storages: Dict[int, Tuple[Position, int]] = {}
        self._opaque: List[Tuple[Position, list]] = []
        self._phantoms: list = []
        self._open = True
        self._mode = _Mode(self)

    # -- results -------------------------------------------------------------

    def _at(self, pos: Position) -> _Position:
        if pos not in self.positions:
            self.positions[pos] = _Position()
        return self.positions[pos]

    def busiest(self) -> Position:
        if not self.positions:
            return HOME
        return max(self.positions, key=lambda p: (
            self.positions[p].cost.flops + self.positions[p].cost.bytes
            + self.positions[p].cost.coll_bytes, -p[0], -p[1]))

    @property
    def cost(self) -> Cost:
        """The busiest position's :class:`Cost`."""
        return self._at(self.busiest()).cost

    def bytes_by_op(self, top: int = 15) -> List[Tuple[str, float]]:
        """The busiest position's bytes by aten op (and by kernel), the
        largest first: the counterpart of ``hlo_cost.bytes_by_opcode``."""
        by_op = self._at(self.busiest()).by_op
        return sorted(by_op.items(), key=lambda kv: -kv[1])[:top]

    # -- where tensors live -----------------------------------------------------

    def place(self, t: torch.Tensor, pos: Position) -> None:
        self._tags[t] = pos

    def where(self, tensors: Iterable[torch.Tensor]) -> Optional[Position]:
        """Where an op on ``tensors`` runs: (0, 0) where their placed ones
        live on different data shards; else the position holding the most
        bytes of them (their storages': a scalar broadcast to a large view
        weighs what it holds), the first of a tie; None when none is
        placed."""
        votes: Dict[Position, int] = {}
        for t in tensors:
            pos = self._tags.get(t)
            if pos is not None:
                votes[pos] = (votes.get(pos, 0)
                              + t.untyped_storage().nbytes())
        if not votes:
            return None
        if len({pos[0] for pos in votes}) > 1:
            return HOME
        return max(votes, key=votes.get)

    # -- charges --------------------------------------------------------------

    def _add(self, pos: Position, what: str, flops: float,
             nbytes: float) -> None:
        p = self._at(pos)
        p.cost.flops += flops
        p.cost.bytes += nbytes
        if nbytes:
            p.by_op[what] = p.by_op.get(what, 0.0) + nbytes

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """A kernel's call (``repro_torch.kernels.charge``)."""
        pos = self._opaque[-1][0] if self._opaque else HOME
        self._add(pos, name, flops, nbytes)
        k = self._at(pos).cost.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += nbytes

    def collective(self, op: str, nbytes: float, group: int,
                   positions: Iterable[Position]) -> None:
        moved = _ring_bytes(op, nbytes, group)
        for pos in positions:
            c = self._at(pos).cost
            c.coll_bytes += moved
            det = c.coll_detail.setdefault(op, [0.0, 0.0])
            det[0] += 1
            det[1] += moved

    # -- repeated work -----------------------------------------------------------

    def snapshot(self):
        return {pos: (p.cost.flops, p.cost.bytes, dict(p.by_op), p.live)
                for pos, p in self.positions.items()}

    def repeat(self, before, times: int) -> Dict[Position, int]:
        """Charge every position ``times`` more of what it did since
        ``before`` (a :meth:`snapshot`); returns the live bytes that work
        kept at each."""
        kept = {}
        for pos, p in list(self.positions.items()):
            flops, nbytes, by_op, live = before.get(pos, (0.0, 0.0, {}, 0))
            p.cost.flops += times * (p.cost.flops - flops)
            p.cost.bytes += times * (p.cost.bytes - nbytes)
            for k, v in list(p.by_op.items()):
                p.by_op[k] = v + times * (v - by_op.get(k, 0.0))
            kept[pos] = p.live - live
        return kept

    def hold_phantom(self, pos: Position, nbytes: int,
                     owner: torch.Tensor) -> None:
        """``nbytes`` live at ``pos`` until ``owner``'s storage dies."""
        if nbytes <= 0:
            return
        p = self._at(pos)
        p.live += nbytes
        p.cost.peak_bytes = max(p.cost.peak_bytes, p.live)
        key = object()              # kept, so that its id stays unique
        self._phantoms.append(key)
        self._storages[id(key)] = (pos, nbytes)
        weakref.finalize(owner.untyped_storage(), self._free, id(key))

    # -- live bytes -------------------------------------------------------------

    def _allocate(self, outs, ins, pos: Position) -> None:
        """Hold the storages of ``outs`` that none of ``ins`` shares."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            seen.add(key)
            n = st.nbytes()
            self._storages[key] = (pos, n)
            p = self._at(pos)
            p.live += n
            p.cost.peak_bytes = max(p.cost.peak_bytes, p.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        pos, n = self._storages.pop(key, (None, 0))
        if pos is not None and self._open:
            self._at(pos).live -= n

    # -- the kernels' hooks -------------------------------------------------------

    @contextlib.contextmanager
    def opaque(self, args, kwargs):
        """A kernel's call: nothing inside is counted; its charges go
        where its tensor arguments live."""
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self._opaque.append((self.where(ins) or HOME, ins))
        try:
            yield
        finally:
            self._opaque.pop()

    def hold(self, out) -> None:
        """The kernel call's results, allocated where it ran."""
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        pos, ins = self._opaque[-1]
        self._allocate(outs, ins, pos)
        for t in outs:
            self._tags[t] = pos

    # -- the dispatch mode's record -------------------------------------------------

    def record(self, func, args, kwargs, out) -> None:
        if self._opaque:
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        placed = self.where(ins)
        pos = placed or HOME
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out))
        nbytes = 0.0
        read = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        read += [v for k, v in (kwargs or {}).items()
                 if k != "out" and isinstance(v, torch.Tensor)]
        if packet.__name__ in _REGION_READS:
            nbytes = float(sum(map(_nbytes, read[1:]))
                           + 2 * sum(map(_nbytes, outs)))
        elif packet.__name__ in _REGION_WRITES:
            nbytes = float(sum(map(_nbytes, read[1:])) + _nbytes(read[-1]))
        elif not _zero_bytes(func):
            nbytes = float(sum(map(_nbytes, read))
                           + sum(map(_nbytes, outs)))
        self._add(pos, packet.__name__, flops, nbytes)
        self._allocate(outs, ins, pos)
        if placed is not None:
            for t in outs:
                self._tags[t] = placed

    def __enter__(self):
        kernels.METERS.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        kernels.METERS.remove(self)
        self._open = False
        return False


class _Mode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.counter.record(func, args, kwargs, out)
        return out


def count() -> Counter:
    """A context that counts what runs inside it: ``with count() as c:
    step(...)``, then ``c.cost`` (the busiest position's :class:`Cost`),
    ``c.positions`` and ``c.bytes_by_op()``."""
    return Counter()


def place(t: torch.Tensor, pos: Position) -> torch.Tensor:
    """Tell the counters in effect that ``t`` lives at mesh position
    ``pos`` = (data shard, model shard); returns ``t``."""
    for meter in kernels.METERS:
        meter.place(t, pos)
    return t


def moved(t: torch.Tensor, pos: Position) -> torch.Tensor:
    """``t`` after a move to mesh position ``pos`` (``t.to(device)``, which
    on a repeated device is ``t`` itself): placed at ``pos``, and its
    gradient, when it comes back, placed where ``t`` was, as the move's
    backward copies it back there."""
    if not kernels.METERS:
        return t
    src = where(t)
    if t.requires_grad:
        def back(g):
            place(g, src)
        t.register_hook(back)
    return place(t, pos)


class RepeatedSteps:
    """A Python loop of ``n`` identical steps (module docstring): ``run``
    is how many to execute, all ``n`` but on the meta device under a
    counter, where :meth:`step` charges the rest from the second."""

    TRACED = 3

    def __init__(self, n: int, like: torch.Tensor):
        self.n = n
        self.counter = (kernels.METERS[-1] if kernels.METERS
                        and like.device.type == "meta" and n > self.TRACED
                        else None)
        self.run = self.TRACED if self.counter is not None else n
        self.first = None

    def stand_ins(self, like: torch.Tensor) -> list:
        """Uncounted, untracked stand-ins (of ``like``'s shape) for the
        outputs of the steps not run."""
        with contextlib.ExitStack() as stack:
            for meter in list(kernels.METERS):
                stack.enter_context(meter.opaque((), {}))
            rest = like.new_empty((like.shape[0], self.n - self.run,
                                   *like.shape[1:]))
            return list(rest.unbind(1))

    def step(self, t: int, fn, out_of):
        """``fn()`` as step t; ``out_of(result)`` is the tensor the next
        step takes from it."""
        if self.counter is None or t > 1:
            return fn()
        if t == 0:
            out = fn()
            self.first = out_of(out)
            return out
        c, times = self.counter, self.n - self.TRACED
        before = c.snapshot()
        out = fn()
        mine = out_of(out)
        for pos, kept in c.repeat(before, times).items():
            c.hold_phantom(pos, times * kept, mine)
        if mine.requires_grad and self.first.requires_grad:
            start = []
            mine.register_hook(lambda g: start.append(c.snapshot()))
            self.first.register_hook(
                lambda g: c.repeat(start.pop(), times) and None)
        return out


def where(t: torch.Tensor) -> Position:
    """Where the innermost counter in effect holds ``t`` ((0, 0) when it
    was never placed, or when no counter is in effect)."""
    if not kernels.METERS:
        return HOME
    return kernels.METERS[-1].where([t]) or HOME


def collective(op: str, nbytes: float, group: int,
               positions: Iterable[Position]) -> None:
    """Charge each of ``positions`` the ring-model bytes of an ``op``
    over ``group`` devices whose result holds ``nbytes`` per device
    (nothing on a group of one: no device moves anything)."""
    if group <= 1 or not kernels.METERS:
        return
    positions = list(positions)
    for meter in kernels.METERS:
        meter.collective(op, nbytes, group, positions)
