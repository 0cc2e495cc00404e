"""CCM-merge memory kernels on the H100 (port of
``repro/kernels/kv_merge.py``): the online update, a CUDA C++ kernel,
and the parallel-training running mean ``kv_cummean``, in Triton.

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

Why CUDA C++ and not Triton, as this update was first written: on an
NVIDIA H100 80GB HBM3 at a 700.00 W power limit the Triton kernel took
0.0097 ms of device time per tensor, but 0.0352 ms per back-to-back
wrapper call (Triton's Python launcher), and the online path is bound by
the host's issue time.  This module's launches go through ``ctypes``
with one parameter struct, as ``session_gather`` does.  The plain
versions are ``ref.kv_merge_ref`` and ``ref.kv_merge_lanes_ref``.
"""
from __future__ import annotations

import ctypes
import numbers
import os
import struct
from typing import Sequence, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kv_cummean_ref as plain_cummean
from repro_torch.kernels.ref import kv_merge_lanes_ref as plain_lanes

MAX_LANES = 256
CUMMEAN_BLOCK = 1024

launches = 0           # kv_merge kernel launches (chip_smoke reads them)
cummean_launches = 0   # kv_cummean forward launches
cummean_bwd_launches = 0   # kv_cummean reverse launches

_cummean = None
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


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.library("kv_merge")
        lib.kv_merge_abi_size.restype = ctypes.c_int
        lib.kv_merge_abi_size.argtypes = []
        if lib.kv_merge_abi_size() != ctypes.sizeof(_MergeParams):
            raise RuntimeError("kv_merge: C and ctypes parameter layouts "
                               "differ")
        fn = lib.kv_merge_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_MergeParams), ctypes.c_int,
                       ctypes.c_void_p]
        _fn = fn
    return _fn


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
# Replaces the Pallas TPU kernel ``kv_cummean`` (body ``_cummean_kernel``)
# in ``repro/kernels/kv_merge.py``: out[t] = (sum_{i<=t} h[i]) / (t+1),
# carried in a float32 accumulator.  The TPU kernel walks T as a
# sequential grid axis; here one program owns a block of columns of one
# outer row and loops over T itself, so the accumulator stays in
# registers.  Its reverse (the gradient) is the same loop run backwards:
# dh[t] = sum_{j>=t} g[j] / (j+1).
#
# What bounds it on the H100: device-memory bytes (read each element of
# h once, write each output once; 2 operations per element).  The input
# is a (N, T, R) view with an outer and a T stride and unit column
# stride, so the <COMP> groups of a (B, S, H, D) activation are read in
# place without a gather.  The output is contiguous (N, T, R).
# ---------------------------------------------------------------------------

def _cummean_compiled():
    global _cummean
    if _cummean is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def cummean_kernel(h_ptr, o_ptr, T, R, s_n, s_t,
                           REVERSE: tl.constexpr, BLOCK: tl.constexpr):
            cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            n = tl.program_id(1).to(tl.int64)
            msk = cols < R
            src = h_ptr + n * s_n + cols
            dst = o_ptr + n * T * R + cols
            acc = tl.zeros([BLOCK], dtype=tl.float32)
            for i in range(0, T):
                if REVERSE:
                    t = T - 1 - i
                else:
                    t = i
                x = tl.load(src + t.to(tl.int64) * s_t, mask=msk).to(tl.float32)
                if REVERSE:
                    acc += x / (t + 1.0)
                    out = acc
                else:
                    acc += x
                    out = acc / (t + 1.0)
                tl.store(dst + t.to(tl.int64) * R,
                         out.to(o_ptr.dtype.element_ty), mask=msk)

        _cummean = (triton, cummean_kernel)
    return _cummean


def kv_cummean_launch(h: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Launch the Triton kernel on h (N, T, R) (CUDA, float32/bf16, unit
    column stride; any outer and T strides).  Forward: running means over
    T; ``reverse``: the gradient pass.  Returns a contiguous (N, T, R)."""
    global cummean_launches, cummean_bwd_launches
    if not h.is_cuda:
        raise ValueError("kv_cummean needs a CUDA tensor")
    if h.ndim != 3 or h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"h must be (N, T, R) float32/bf16, got "
                         f"{tuple(h.shape)} {h.dtype}")
    N, T, R = h.shape
    if R > 1 and h.stride(2) != 1:
        raise ValueError("h: the column axis must have unit stride")
    out = torch.empty((N, T, R), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    triton, kern = _cummean_compiled()
    with torch.cuda.device(h.device):
        kern[(triton.cdiv(R, CUMMEAN_BLOCK), N)](
            h, out, T, R, h.stride(0), h.stride(1), REVERSE=bool(reverse),
            BLOCK=CUMMEAN_BLOCK, num_warps=4)
    if reverse:
        cummean_bwd_launches += 1
    else:
        cummean_launches += 1
    return out


class _KVCumMean(torch.autograd.Function):
    """Forward kernel, reverse kernel as its backward."""

    @staticmethod
    def forward(ctx, h):
        return kv_cummean_launch(h, reverse=False)

    @staticmethod
    def backward(ctx, g):
        if g.shape[2] > 1 and g.stride(2) != 1:
            g = g.contiguous()
        return kv_cummean_launch(g, reverse=True)


def kv_cummean(h: torch.Tensor) -> torch.Tensor:
    """Differentiable running mean over axis 1 of h (N, T, R) (CUDA)."""
    return _KVCumMean.apply(h)
