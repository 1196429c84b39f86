"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made in this
process: a wrapper adds one where it launches its kernel and nowhere else,
so a run can show that the main path went through the kernels (a wrapper
that makes two launches, as the backward kernels of the scan and of adaLN
do, counts one).  A kernel's bfloat16 variant counts, and is charged,
under its own name (``rmsnorm_bf16``: :func:`variant`).

A cost counter (:func:`repro_torch.distributed.op_cost.count`) sees each
kernel as one unit, whichever device implements it.  Every wrapper
charges it, through :func:`launched` where it launches its kernel (the
same hook that counts the launch) or :func:`charge` where no kernel runs,
the work its formula gives (the ``work`` functions beside each wrapper:
float32 operations and the bytes each operand and result moves once);
:func:`opaque` keeps the aten ops inside a kernel's call or backward,
and the allocations they make, out of the count.  On the meta device a
kernel's call gives its outputs' shapes and runs nothing, and on the CPU
under a counter the plain version runs as one autograd node
(:func:`unlaunched`), so that a step counts the same on the meta device,
the CPU and the card.

A CUDA graph's capture runs each wrapper's Python once and launches
nothing; each replay launches every captured kernel and runs no wrapper.
So a capture runs inside :func:`recorded`, which keeps its launches out
of ``LAUNCHES`` and out of every counter, and each replay adds them
through :func:`replayed` (:mod:`repro_torch.graphs`).
"""
import contextlib
import functools

import torch

LAUNCHES = {"adaln_norm": 0, "adaln_norm_epilogue": 0, "flash_attention": 0,
            "decode_attention": 0, "rmsnorm": 0, "ssm_scan": 0,
            "ssm_scan_backward": 0, "adaln_norm_backward": 0,
            "adaln_norm_epilogue_backward": 0,
            "flash_attention_bf16": 0, "decode_attention_bf16": 0,
            "rmsnorm_bf16": 0, "ssm_scan_bf16": 0, "adaln_norm_bf16": 0,
            "adaln_norm_epilogue_bf16": 0, "ssm_scan_backward_bf16": 0}

BF16 = torch.bfloat16


def variant(name: str, t: torch.Tensor) -> str:
    """The name a call of kernel ``name`` launches and is charged under:
    ``name + "_bf16"`` where ``t``, the operand whose dtype picks the
    variant (x, q, the caches, u; adaLN's x, whatever its weight's
    dtype), is bfloat16."""
    return name + "_bf16" if t.dtype == BF16 else name


# the cost counters in effect, innermost last
# (repro_torch.distributed.op_cost.count pushes and pops them)
METERS: list = []

# the launch records being collected, innermost last (recorded)
RECORDS: list = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def charge(name: str, work) -> None:
    """One call of kernel ``name`` doing ``work`` = (flops, bytes), to
    every counter in effect."""
    for meter in METERS:
        meter.charge(name, *work)


def launched(name: str, work) -> None:
    """Where a wrapper has launched its kernel: one launch and its charge,
    or, inside :func:`recorded`, one entry of the record."""
    if RECORDS:
        RECORDS[-1].append((name, work))
        return
    LAUNCHES[name] += 1
    charge(name, work)


@contextlib.contextmanager
def recorded():
    """Collect, as a list of ``(name, work)``, the launches that wrappers
    report inside (a CUDA graph's capture, which launches nothing): they
    count in no ``LAUNCHES`` entry and charge no counter."""
    record: list = []
    RECORDS.append(record)
    try:
        yield record
    finally:
        RECORDS.pop()


def replayed(record) -> None:
    """One replay of the graph whose capture gave ``record``: each of its
    launches counted and charged as :func:`launched` does."""
    for name, work in record:
        launched(name, work)


def opaque(fn):
    """``fn``, a kernel op or a kernel's backward, as one unit to every
    counter in effect: its aten ops count nothing and allocate nothing,
    and what it returns is held as allocated where its tensor arguments
    live."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not METERS:
            return fn(*args, **kwargs)
        with contextlib.ExitStack() as stack:
            for meter in list(METERS):
                stack.enter_context(meter.opaque(args, kwargs))
            out = fn(*args, **kwargs)
            for meter in METERS:
                meter.hold(out)
        return out
    return run


def uncounted(fn):
    """``fn``, set-up work kept from every counter in effect (a table
    cached on first use, so that a step counts the same whether or not
    the cache was warm): its ops count nothing and allocate nothing."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with contextlib.ExitStack() as stack:
            for meter in list(METERS):
                stack.enter_context(meter.opaque((), {}))
            return fn(*args, **kwargs)
    return run


def unlaunched(name: str, work, inputs, plain, shapes, backward=None):
    """A kernel's call where no kernel runs: ``plain(*inputs)``, its plain
    version, on the CPU, or on the meta device empty outputs of
    ``shapes(*inputs)`` (nothing computed).  With no counter in effect
    the CPU runs the plain version as it is.  Under a counter the call is
    charged ``work`` as ``name`` and, where a gradient is wanted, is one
    autograd node whose backward charges ``backward`` = (name, work of the
    output gradients): on meta empty gradients, on the CPU the plain
    version's own.  Outputs and gradients are then contiguous, as a
    kernel writes them."""
    device = next(t.device for t in inputs if isinstance(t, torch.Tensor))
    if device.type == "cpu" and not METERS:
        return plain(*inputs)
    charge(name, work)
    if not wants_grad(*inputs):
        if device.type == "meta":
            return shapes(*inputs)
        out = _flat(plain(*inputs))
        out = tuple(o.contiguous() for o in out)
        return out if len(out) > 1 else out[0]
    return _Unlaunched.apply(
        (backward, None if device.type == "meta" else plain, shapes),
        *inputs)


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


def _contiguous(t):
    return None if t is None else t.contiguous()


class _Unlaunched(torch.autograd.Function):
    """:func:`unlaunched`'s autograd node.  Like the kernels' own
    functions, it saves its inputs (``save_for_backward``, so that a
    checkpoint can drop them and recompute them) until its backward has
    run; on the CPU that backward differentiates the plain version run
    again on them."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        ctx.set_materialize_grads(False)
        ctx.spec = spec
        ctx.save_for_backward(*inputs)          # tensors, or None
        _, plain, shapes = spec
        if plain is None:
            return shapes(*inputs)
        out = plain(*inputs)
        detached = tuple(o.detach().contiguous() for o in _flat(out))
        return detached if isinstance(out, tuple) else detached[0]

    @staticmethod
    @opaque
    def backward(ctx, *grads):
        backward, plain, _ = ctx.spec
        if backward is not None:
            charge(backward[0], backward[1](grads))
        need = ctx.needs_input_grad[1:]
        inputs = ctx.saved_tensors
        if plain is None:
            return (None,) + tuple(
                torch.empty(t.shape, dtype=t.dtype, device=t.device)
                if n else None for t, n in zip(inputs, need))
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      if isinstance(t, torch.Tensor) else t
                      for t, n in zip(inputs, need)]
            outs = _flat(plain(*leaves))
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
        return (None,) + tuple(_contiguous(next(got)) if n else None
                               for n in need)


def check_operand(name: str, t, device: torch.device, shape=None, *,
                  contiguous: bool = True,
                  dtypes=(torch.float32,)) -> None:
    """Raise unless ``t`` is a tensor of one of ``dtypes`` (the ones the
    kernel takes for this operand, given the others) on ``device`` of
    ``shape`` (and contiguous, unless the kernel takes a row stride for
    it)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        takes = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes {takes} "
                        "here")
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
