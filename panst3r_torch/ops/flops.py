"""FLOP counting and the card's peaks (counterpart of
panst3r_tpu/ops/flops.py).

``count_flops(fn, *args, **kwargs)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts the matrix products and convolutions it
dispatches (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``,
``dot``, ``convolution`` and ``convolution_backward``) with one
multiply-add as 2 FLOPs, as the JAX counter counts ``dot_general`` and
``conv_general_dilated``.  Elementwise work is ignored.

The kernels (K1-K6) launch through ctypes, which no dispatch mode sees, so
each wrapper *declares* its work with ``declare(flops)`` around its
CPU/CUDA dispatch: the declared number is added, and the aten ops inside
(its plain version on a CPU tensor) are not counted, so a count is the
same on the CPU and on the card.  The declared numbers are the JAX
package's CPU counts for the same calls (the dense matmul work of the jnp
formula).  A kernel that launches while a counter is open and nothing was
declared raises (``check_declared``, called at every launch).

The open counters live in a module-level list, not in thread-local state:
on the card, autograd runs the backward (and K5's declaration) on its own
device thread.

``PEAKS`` holds the card's published dense peaks for bounds and MFU, keyed
by the name ``torch.cuda.get_device_name`` gives; ``peaks()`` raises on any
other card rather than report against a wrong peak.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM (data sheet, dense, 700 W): FLOP/s by dtype, int8
# operations/s, HBM bytes/s; "tf32x3": f32 work done as three TF32
# tensor-core products each (the TF32 rate of 494.7 TFLOP/s over 3), the
# rate that bounds the f32 K2 and K3
H100_SXM = {"bfloat16": 989.4e12, "float32": 67e12, "int8": 1979e12,
            "tf32x3": 494.7e12 / 3, "hbm_bytes_per_s": 3.35e12}
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}

_OPEN: list = []           # open counters, shared by every thread
_LOCK = threading.Lock()


def peaks(name: str | None = None) -> dict:
    """The peak table of the card ``name`` (default: CUDA device 0)."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}: known cards are "
                       f"{sorted(PEAKS)}")
    return PEAKS[name]


def bound_ms(flops: float, nbytes: float, dtype: str, int8_ops: float = 0,
             card: str | None = None):
    """max(operations over their peak rates, bytes over the HBM rate), in
    ms, and which of the two bounds it; ``int8_ops`` run at the int8 rate,
    ``flops`` at ``dtype``'s."""
    pk = peaks(card)
    t_ops = flops / pk[dtype] + int8_ops / pk["int8"]
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mfu(flops: float, seconds: float, dtype: str = "bfloat16",
        card: str | None = None) -> float:
    """Share of the card's dense ``dtype`` peak that ``flops`` in
    ``seconds`` achieve."""
    return flops / seconds / peaks(card)[dtype]


def attention_flops(B: int, H: int, Nq: int, Nk: int, D: int) -> float:
    """The two products of dense attention, 4·B·H·Nq·Nk·D."""
    return 4.0 * B * H * Nq * Nk * D


@contextlib.contextmanager
def declare(flops: float):
    """A kernel call's work: ``flops`` is added to every open counter, and
    the aten ops dispatched inside the block are not counted."""
    with _LOCK:
        opened = list(_OPEN)
        for c in opened:
            c.total += flops
            c.depth += 1
    try:
        yield
    finally:
        with _LOCK:
            for c in opened:
                c.depth -= 1


def add_traced_only(flops: float) -> None:
    """Work that the JAX program traces but XLA removes as dead code, and
    that the JAX counter counts all the same: the port does not run it and
    adds it here, so that its counts equal the JAX package's."""
    with _LOCK:
        for c in _OPEN:
            if c.depth == 0:
                c.total += flops


def check_declared(what: str) -> None:
    """Called at each kernel launch: raise if a counter is open and the
    launch is outside every ``declare`` block (its work would count 0)."""
    with _LOCK:
        bad = [c for c in _OPEN if c.depth == 0]
    if bad:
        raise RuntimeError(f"{what} launched under count_flops without a "
                           "FLOP declaration")


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _conv_flops(out_shape, w_shape, transposed: bool, groups: int) -> float:
    """2·|out|·(input channels per group)·|window| (the JAX counter's
    conv formula)."""
    cin = w_shape[0] // groups if transposed else w_shape[1]
    return 2.0 * _numel(out_shape) * cin * _numel(w_shape[2:])


def _bound(func, args, kwargs) -> list:
    """The op's arguments in schema order, defaults filled in."""
    out = list(args)
    for a in func._schema.arguments[len(args):]:
        out.append(kwargs[a.name] if a.name in kwargs else a.default_value)
    return out


def _op_flops(func, args, kwargs, out) -> float | None:
    name = func._overloadpacket.__name__
    if name not in _COUNTED:
        return None
    a = _bound(func, args, kwargs)
    s = [getattr(x, "shape", None) for x in a]
    if name == "mm":
        return 2.0 * s[0][0] * s[0][1] * s[1][1]
    if name == "addmm":
        return 2.0 * s[1][0] * s[1][1] * s[2][1]
    if name == "bmm":
        return 2.0 * s[0][0] * s[0][1] * s[0][2] * s[1][2]
    if name == "baddbmm":
        return 2.0 * s[1][0] * s[1][1] * s[1][2] * s[2][2]
    if name == "mv":
        return 2.0 * s[0][0] * s[0][1]
    if name == "addmv":
        return 2.0 * s[1][0] * s[1][1]
    if name == "dot":
        return 2.0 * s[0][0]
    if name == "convolution":
        # (input, weight, bias, stride, padding, dilation, transposed,
        #  output_padding, groups)
        return _conv_flops(out.shape, s[1], bool(a[6]), int(a[8]))
    # convolution_backward: (grad_out, input, weight, bias_sizes, stride,
    # padding, dilation, transposed, output_padding, groups, output_mask)
    grad_out, inp, w = a[0], a[1], a[2]
    transposed, groups, mask = bool(a[7]), int(a[9]), a[10]
    window = _numel(w.shape[2:])
    total = 0.0
    if mask[0]:         # input gradient: a conv over the output channels
        cout = w.shape[1] if transposed else w.shape[0] // groups
        total += 2.0 * _numel(inp.shape) * cout * window
    if mask[1]:         # weight gradient: sums over batch and positions
        pos = inp if transposed else grad_out
        total += 2.0 * _numel(w.shape) * pos.shape[0] * _numel(pos.shape[2:])
    return total


_COUNTED = ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
            "convolution", "convolution_backward")
# matmul-class ops the counter cannot attribute: counting them as 0 would
# under-count, so they raise
_REFUSED_PARTS = ("scaled_dot_product", "flash_attention",
                  "efficient_attention", "cudnn_attention")
_REFUSED = ("_scaled_mm", "_int_mm", "addbmm")


class FlopCounter(TorchDispatchMode):
    """Counts while open (``with FlopCounter() as c: ...; c.total``)."""

    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.depth = 0

    def __enter__(self):
        with _LOCK:
            _OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            with _LOCK:
                _OPEN.remove(self)

    @contextlib.contextmanager
    def _reentered(self):
        """The mode pushed again (it is off inside its own handler),
        without entering the open list a second time."""
        TorchDispatchMode.__enter__(self)
        try:
            yield
        finally:
            TorchDispatchMode.__exit__(self, None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # Under inference mode a composite op (matmul, linear, einsum) comes
        # here whole: run its decomposition with the mode on, so that its
        # products come here too.
        if func._overloadpacket.__name__ not in _COUNTED:
            with self._reentered():
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in _REFUSED or any(r in name for r in _REFUSED_PARTS):
            raise NotImplementedError(
                f"count_flops cannot attribute aten.{name}")
        if self.depth == 0:
            fl = _op_flops(func, args, kwargs, out)
            if fl is not None:
                with _LOCK:
                    self.total += fl
        return out


def count_flops(fn, *args, **kwargs) -> float:
    """Matmul/conv FLOPs of one call ``fn(*args, **kwargs)`` (declared
    kernel work included)."""
    with FlopCounter() as c:
        fn(*args, **kwargs)
    return c.total
