"""CCM-merge memory kernels on the H100 (port of
``repro/kernels/kv_merge.py``): the online update and the
parallel-training running mean ``kv_cummean``, each a CUDA C++ kernel
with one launch for the k and the v tensor together.

The online update replaces the Pallas TPU kernel ``kv_merge_update``
(body ``_merge_kernel``) in ``repro/kernels/kv_merge.py``:
Mem(t) = (1 - a) Mem(t-1) + a h(t), with ``a`` a runtime weight (1/t
arithmetic mean, or the EMA alpha).  Its kernel is ``csrc/kv_merge.cu``;
its header says what bounds it on the card (bytes) and what the design
does about that.  ``kv_merge_update_lanes_`` launches it once for a whole
merge g_update: the k and v memories together, a weight per lane passed
by value in the launch's parameter struct (at most ``MAX_LANES``), ``h``
read through its two outer strides (so a lane-major transpose needs no
copy) and in its own dtype.  ``kv_merge_update_`` is its one-tensor,
one-weight case.

The running mean replaces the Pallas TPU kernel ``kv_cummean`` (body
``_cummean_kernel``): out[t] = (sum_{i<=t} h[i]) / (t+1) over the T axis
of an (N, T, R) view, and the reverse pass that is its gradient,
dh[t] = sum_{j>=t} g[j] / (j+1), both in float32 with one rounding.  Its
kernel is ``csrc/kv_cummean.cu``: bound by device-memory bytes (no
reuse); each thread walks T for one 16-byte column vector with a chunk
of steps' loads in flight before the running sums, and the k and v
tensors of a layer go in one launch, each read in place through its own
row and step strides.  ``kv_cummean`` is its autograd op.

Why CUDA C++ and not Triton, as both were first written: on an NVIDIA
H100 80GB HBM3 at a 700.00 W power limit a Triton launch cost ~0.035 ms
of host time through Triton's Python launcher, more than the device time
of these kernels, and the Triton running mean walked T with one load in
flight per step (0.3 of its bytes bound).  This module's launches go
through ``ctypes`` with one parameter struct each, as ``session_gather``
does.  The plain versions are ``ref.kv_merge_ref``,
``ref.kv_merge_lanes_ref``, ``ref.kv_cummean_ref`` and
``ref.kv_cummean_reverse_ref``.
"""
from __future__ import annotations

import ctypes
import numbers
import struct
from typing import List, Sequence, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kv_cummean_ref as plain_cummean
from repro_torch.kernels.ref import kv_cummean_reverse_ref as plain_reverse
from repro_torch.kernels.ref import kv_merge_lanes_ref as plain_lanes

MAX_LANES = 256

launches = 0           # kv_merge kernel launches (chip_smoke reads them)
cummean_launches = 0   # kv_cummean forward launches (one per k + v pair)
cummean_bwd_launches = 0   # kv_cummean reverse launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _MergeParams(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p * 2), ("h", ctypes.c_void_p * 2),
                ("h_s0", ctypes.c_longlong * 2),
                ("h_s1", ctypes.c_longlong * 2), ("inner", ctypes.c_longlong),
                ("outer0", ctypes.c_int), ("outer1", ctypes.c_int),
                ("n_tensors", ctypes.c_int), ("lane_axis", ctypes.c_int),
                ("n_lanes", ctypes.c_int), ("mem_bf16", ctypes.c_int),
                ("h_bf16", ctypes.c_int), ("vec", ctypes.c_int),
                ("a", ctypes.c_float * MAX_LANES)]


class _CumMeanParams(ctypes.Structure):
    _fields_ = [("h", ctypes.c_void_p * 2), ("out", ctypes.c_void_p * 2),
                ("s_n", ctypes.c_longlong * 2),
                ("s_t", ctypes.c_longlong * 2), ("R", ctypes.c_longlong),
                ("N", ctypes.c_int), ("T", ctypes.c_int),
                ("n_tensors", ctypes.c_int), ("reverse", ctypes.c_int),
                ("bf16", ctypes.c_int), ("vec", ctypes.c_int)]


_PARAMS = {"kv_merge": _MergeParams, "kv_cummean": _CumMeanParams}
_fns = {}


def _launcher(stem: str = "kv_merge"):
    """The C entry ``<stem>_launch`` of ``csrc/<stem>.cu``, after checking
    that its parameter struct has the ctypes layout's size."""
    fn = _fns.get(stem)
    if fn is None:
        lib = _build.library(stem)
        size = getattr(lib, f"{stem}_abi_size")
        size.restype = ctypes.c_int
        size.argtypes = []
        params = _PARAMS[stem]
        if size() != ctypes.sizeof(params):
            raise RuntimeError(f"{stem}: C and ctypes parameter layouts "
                               "differ")
        fn = getattr(lib, f"{stem}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(params), ctypes.c_int, ctypes.c_void_p]
        _fns[stem] = fn
    return fn


def _outer_strides(x: torch.Tensor):
    """x's strides along its first two dims (0 for a dim of size 1);
    raises unless the dims after them form one unit-stride run."""
    want, shape, stride = 1, x.shape, x.stride()
    for d in range(len(shape) - 1, 1, -1):
        if shape[d] != 1 and stride[d] != want:
            raise ValueError(f"h: the dims after the second must form one "
                             f"unit-stride run, got strides {stride}")
        want *= shape[d]
    return (stride[0] if shape[0] > 1 else 0,
            stride[1] if shape[1] > 1 else 0)


def _geometry(mems, hs, ptrs, shared: bool):
    """(outer0, outer1, inner, (h_s0, h_s1, ...), vec) of the launch.  A
    shared weight over contiguous tensors is one run of every element;
    else the tensors are (d0, d1, rest) arrays.  ``vec``: 16 bytes of the
    narrower dtype when the inner run is a multiple of that and every
    base (``ptrs``) and h stride is 16-byte aligned, else 1."""
    mem0 = mems[0]
    shape = mem0.shape
    hsz = hs[0].element_size()
    full = 16 // min(mem0.element_size(), hsz)
    if len(shape) < 2 or (shared and all(h.is_contiguous() for h in hs)):
        o0 = o1 = 1
        inner = mem0.numel()
        strides = ()
    else:
        o0, o1 = shape[0], shape[1]
        inner = mem0.numel() // (o0 * o1)
        tail = mem0.stride()[2:]          # mem is contiguous
        strides = ()
        for h in hs:
            st = h.stride()
            strides += ((st[0] if o0 > 1 else 0, st[1] if o1 > 1 else 0)
                        if st[2:] == tail else _outer_strides(h))
    ok = inner % full == 0
    for x in ptrs:
        ok = ok and x % 16 == 0
    for x in strides:
        ok = ok and x * hsz % 16 == 0
    return o0, o1, inner, strides, full if ok else 1


def _shared(a) -> bool:
    t = type(a)
    return t is float or t is int or isinstance(a, numbers.Real)


def vector_width(mems: Sequence[torch.Tensor], hs: Sequence[torch.Tensor],
                 a: Union[float, Sequence[float]]) -> int:
    """Elements per thread access that ``kv_merge_update_lanes_`` takes
    for these arguments: the full 16-byte width or the one-element
    path."""
    mems, hs = list(mems), list(hs)
    ptrs = [x.data_ptr() for x in (*mems, *hs)]
    return _geometry(mems, hs, ptrs, _shared(a))[4]


def _stream(index: int) -> int:
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(index) if get is not None \
        else torch.cuda.current_stream(index).cuda_stream


# The fields of the parameter struct before ``a``, filled in one pack.
_HEAD = struct.Struct("<4Q5q8i")
assert _HEAD.size == _MergeParams.a.offset
_ONE = struct.Struct("<f")


def kv_merge_update_lanes_(mems: Sequence[torch.Tensor],
                           hs: Sequence[torch.Tensor],
                           a: Union[float, Sequence[float]],
                           lane_axis: int = 0) -> Sequence[torch.Tensor]:
    """Launch the kernel once: mems[i] <- (1 - a) * mems[i] + a * hs[i] IN
    PLACE, in float32 with one rounding, for one or two (mem, h) pairs
    (the k and v memories).  mems: contiguous CUDA float32/bf16 tensors of
    one shape (d0, d1, ...) and dtype; hs: that shape, float32/bf16 (one
    dtype, which may differ from mem's), any strides along d0 and d1 and
    one unit-stride run over the rest.  ``a``: one host float for every
    lane, or one per lane along ``lane_axis`` (0: d0, 1: d1), at most
    ``MAX_LANES``.  Returns ``mems``.  Kept to plain comparisons and one
    struct pack: the online path is bound by the host's issue time."""
    global launches
    n = len(mems)
    if n != len(hs) or not 1 <= n <= 2:
        raise ValueError(f"1 or 2 (mem, h) pairs, got {n} mems and "
                         f"{len(hs)} hs")
    mem0, h0 = mems[0], hs[0]
    shape, mdt, hdt = mem0.shape, mem0.dtype, h0.dtype
    for x in (*mems[1:], *hs):
        if x.shape != shape:
            raise ValueError(f"mems and hs must have one shape, got "
                             f"{[tuple(y.shape) for y in (*mems, *hs)]}")
    if mdt not in _DTYPES or hdt not in _DTYPES \
            or any(m.dtype != mdt or not m.is_contiguous() for m in mems) \
            or (n == 2 and hs[1].dtype != hdt):
        raise ValueError(f"mems: contiguous, one dtype; hs: one dtype; "
                         f"float32/bf16 only, got "
                         f"{[m.dtype for m in mems]}/{[h.dtype for h in hs]}")
    if lane_axis != 0 and lane_axis != 1:
        raise ValueError(f"lane_axis must be 0 or 1, got {lane_axis}")
    shared = _shared(a)
    if not shared and (len(shape) < 2 or len(a) != shape[lane_axis]
                       or len(a) > MAX_LANES):
        raise ValueError(f"{len(a)} lane weights for lane axis {lane_axis} "
                         f"of {tuple(shape)} (at most {MAX_LANES})")
    index = mem0.get_device()
    if index < 0 or any(x.get_device() != index for x in (*mems[1:], *hs)):
        raise ValueError(f"kv_merge_update needs CUDA tensors on one "
                         f"device, got {[str(y.device) for y in (*mems, *hs)]}")
    if mem0.numel() == 0:
        return mems
    if n == 2:
        ptrs = (mem0.data_ptr(), mems[1].data_ptr(), h0.data_ptr(),
                hs[1].data_ptr())
    else:
        ptrs = (mem0.data_ptr(), 0, h0.data_ptr(), 0)
    o0, o1, inner, st, vec = _geometry(mems, hs, ptrs, shared)
    if not st:
        st = (0, 0, 0, 0)
    elif n == 1:
        st = st + (0, 0)
    p = _MergeParams()
    _HEAD.pack_into(p, 0, *ptrs, st[0], st[2], st[1], st[3], inner, o0, o1,
                    n, -1 if shared else lane_axis, 1 if shared else len(a),
                    _DTYPES[mdt], _DTYPES[hdt], vec)
    if shared:
        _ONE.pack_into(p, _HEAD.size, a)
    else:
        struct.pack_into(f"<{len(a)}f", p, _HEAD.size, *a)
    err = _launcher()(ctypes.byref(p), index, _stream(index))
    if err != 0:
        raise RuntimeError(f"kv_merge kernel launch failed: cudaError {err}")
    launches += 1
    return mems


def kv_merge_update_(mem: torch.Tensor, h: torch.Tensor,
                     a: float) -> torch.Tensor:
    """One tensor, one weight: mem <- (1 - a) * mem + a * h IN PLACE (see
    ``kv_merge_update_lanes_`` for what the tensors may be).  Returns
    ``mem``."""
    return kv_merge_update_lanes_([mem], [h], float(a))[0]




# ---------------------------------------------------------------------------
# kv_cummean: running mean over T (merge-mode parallel training)
#
# What bounds it on the H100: device-memory bytes (each input element
# read once, each output written once, 2 operations per element, no
# reuse).  T is short (16 at the paper's layout) and the columns many,
# so the work is wide and shallow: the kernel (``csrc/kv_cummean.cu``,
# whose header has the details) gives each thread one 16-byte column
# vector and issues a chunk of T steps' loads before the running sums.
# One launch takes the k and v groups of a layer, each through its own
# row and step strides, so neither the strided <COMP> groups nor a
# gradient sliced out of ``torch.cat``'s is copied.  The wrapper runs on
# every layer, forward, recompute and backward: plain comparisons and
# one struct pack.
# ---------------------------------------------------------------------------

# The kv_cummean parameter struct, filled in one pack.
_CUM = struct.Struct("<4Q5q6i")
assert _CUM.size == ctypes.sizeof(_CumMeanParams)


def _cummean_params(hs, outs, reverse: bool) -> _CumMeanParams:
    """The launch's parameter struct for the (N, T, R) inputs ``hs`` (one
    shape and dtype, checked by the caller) and their outputs, filled in
    one pack.  Raises unless each input has unit column stride.  The
    route: 16-byte accesses when R is a multiple of 16 bytes' worth and
    every base and (row, step) stride is 16-byte aligned, else the
    one-element path; the outputs are fresh allocations, aligned."""
    N, T, R = hs[0].shape
    size = hs[0].element_size()
    ptrs, s_n, s_t = [0, 0], [0, 0], [0, 0]
    aligned = R % (16 // size) == 0
    for i, h in enumerate(hs):
        st = h.stride()
        if R > 1 and st[2] != 1:
            raise ValueError(f"kv_cummean: the column axis must have unit "
                             f"stride, got strides {st}")
        ptrs[i] = h.data_ptr()
        s_n[i] = st[0] if N > 1 else 0
        s_t[i] = st[1] if T > 1 else 0
        aligned = aligned and (ptrs[i] | s_n[i] * size | s_t[i] * size) \
            % 16 == 0
    p = _CumMeanParams()
    _CUM.pack_into(p, 0, ptrs[0], ptrs[1], outs[0].data_ptr(),
                   outs[1].data_ptr() if len(outs) > 1 else 0, s_n[0],
                   s_n[1], s_t[0], s_t[1], R, N, T, len(hs),
                   1 if reverse else 0, _DTYPES[hs[0].dtype],
                   16 // size if aligned else 1)
    return p


def cummean_vector_width(hs: Sequence[torch.Tensor]) -> int:
    """Elements per thread access that ``kv_cummean_launch`` takes for
    these (N, T, R) inputs: the full 16-byte width or the one-element
    path (see ``_cummean_params``)."""
    return _cummean_params(hs, hs, False).vec


def kv_cummean_launch(hs: Sequence[torch.Tensor],
                      reverse: bool = False) -> List[torch.Tensor]:
    """Launch the kernel once over one or two tensors (the k and v groups
    of a layer): CUDA float32/bf16 (N, T, R) of one shape and dtype, unit
    column stride, any row and step strides.  Forward: running means over
    T; ``reverse``: the gradient pass.  Returns contiguous (N, T, R)
    outputs, one per input.  Kept to plain comparisons and one struct
    pack: a merge step makes 3 launches a layer."""
    global cummean_launches, cummean_bwd_launches
    n = len(hs)
    if n != 1 and n != 2:
        raise ValueError(f"kv_cummean takes 1 or 2 tensors, got {n}")
    h0 = hs[0]
    shape, dt = h0.shape, h0.dtype
    if len(shape) != 3 or (n == 2 and hs[1].shape != shape):
        raise ValueError(f"kv_cummean: the tensors must have one shape "
                         f"(N, T, R), got {[tuple(h.shape) for h in hs]}")
    if dt not in _DTYPES or (n == 2 and hs[1].dtype != dt):
        raise ValueError(f"kv_cummean: one dtype, float32/bf16 only, got "
                         f"{[h.dtype for h in hs]}")
    index = h0.get_device()
    if index < 0 or (n == 2 and hs[1].get_device() != index):
        raise ValueError(f"kv_cummean needs CUDA tensors on one device, "
                         f"got {[str(h.device) for h in hs]}")
    if shape[0] >= 2 ** 31 or shape[1] >= 2 ** 31:
        raise ValueError(f"kv_cummean: N and T must be below 2**31, got "
                         f"{tuple(shape)}")
    outs = [torch.empty(shape, dtype=dt, device=h0.device) for _ in hs]
    if h0.numel() == 0:
        return outs
    p = _cummean_params(hs, outs, reverse)
    err = _launcher("kv_cummean")(ctypes.byref(p), index, _stream(index))
    if err != 0:
        raise RuntimeError(f"kv_cummean kernel launch failed: cudaError "
                           f"{err}")
    if reverse:
        cummean_bwd_launches += 1
    else:
        cummean_launches += 1
    return outs


def _unit_columns(g: torch.Tensor) -> torch.Tensor:
    return g if g.shape[2] <= 1 or g.stride(2) == 1 else g.contiguous()


class _KVCumMean(torch.autograd.Function):
    """One forward launch over one or two tensors; the backward is one
    reverse launch over their gradients, each read through its own
    strides."""

    @staticmethod
    def forward(ctx, *hs):
        return tuple(kv_cummean_launch(hs))

    @staticmethod
    def backward(ctx, *gs):
        return tuple(kv_cummean_launch([_unit_columns(g) for g in gs],
                                       reverse=True))


def kv_cummean(*hs: torch.Tensor):
    """Differentiable running means over axis 1 of one or two (N, T, R)
    CUDA tensors of one shape and dtype, in one launch; returns a tuple
    of one output per input."""
    return _KVCumMean.apply(*hs)


def merge_cost(mems: Sequence[torch.Tensor],
               hs: Sequence[torch.Tensor]) -> tuple:
    """(FLOPs, bytes) of one merge launch over the k and v memories (what
    ``ops`` charges on the meta device): 3 FLOPs an element, the memory
    read and written and ``h`` read once."""
    n = sum(m.numel() for m in mems)
    nbytes = sum(2 * m.numel() * m.element_size() + h.numel() * h.element_size()
                 for m, h in zip(mems, hs))
    return 3.0 * n, float(nbytes)


def cummean_cost(hs: Sequence[torch.Tensor]) -> tuple:
    """(FLOPs, bytes) of one running-mean launch, forward or reverse, over
    one or two tensors: 2 FLOPs an element (the running sum, the
    division), each element read once and written once."""
    n = sum(h.numel() for h in hs)
    return 2.0 * n, float(sum(2 * h.numel() * h.element_size() for h in hs))
