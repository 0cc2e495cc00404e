"""CCM-merge memory kernels on the H100, in Triton (port of
``repro/kernels/kv_merge.py``): the online update ``kv_merge_update_``
and the parallel-training running mean ``kv_cummean``.

``kv_merge_update_`` replaces the Pallas TPU kernel ``kv_merge_update``
(body ``_merge_kernel``) in ``repro/kernels/kv_merge.py``:
Mem(t) = (1 - a) Mem(t-1) + a h(t), with ``a`` a runtime weight (1/t
arithmetic mean, or the EMA alpha).

What bounds it on the H100: device-memory bytes (read mem and h once,
write mem once; two operations per element).  What the design does: one
fused elementwise pass of masked 1024-element block loads, float32
arithmetic and a cast-store, written IN PLACE into ``mem`` (no second
buffer, no extra copy); ``a`` is a host float passed by value, so there
is no device read of it.  There is no reuse, shared memory or tensor-core
work to arrange, which is why Triton is the route.  Triton is imported
inside the launching function only; its cache goes to
``build/repro_torch/triton`` unless ``TRITON_CACHE_DIR`` is set.  The
plain version is ``ref.kv_merge_ref``.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kv_cummean_ref as plain_cummean
from repro_torch.kernels.ref import kv_merge_ref as plain

BLOCK = 1024
CUMMEAN_BLOCK = 1024

launches = 0           # kv_merge_update_ launches (chip_smoke reads them)
cummean_launches = 0   # kv_cummean forward launches
cummean_bwd_launches = 0   # kv_cummean reverse launches

_kernel = None
_cummean = None


def _compiled():
    global _kernel
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def merge_kernel(mem_ptr, h_ptr, n, a, BLOCK: tl.constexpr):
            offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            msk = offs < n
            m = tl.load(mem_ptr + offs, mask=msk).to(tl.float32)
            h = tl.load(h_ptr + offs, mask=msk).to(tl.float32)
            out = (1.0 - a) * m + a * h
            tl.store(mem_ptr + offs, out.to(mem_ptr.dtype.element_ty),
                     mask=msk)

        _kernel = (triton, merge_kernel)
    return _kernel


def kv_merge_update_(mem: torch.Tensor, h: torch.Tensor,
                     a: float) -> torch.Tensor:
    """Launch the Triton kernel: mem <- (1 - a) * mem + a * h IN PLACE.
    mem/h: contiguous CUDA tensors of one shape (h may have another float
    dtype); ``a`` a host float.  Returns ``mem``."""
    global launches
    if not mem.is_cuda:
        raise ValueError("kv_merge_update_ needs CUDA tensors")
    if mem.shape != h.shape or mem.device != h.device \
            or not mem.is_contiguous() or not h.is_contiguous():
        raise ValueError(f"mem {tuple(mem.shape)} and h {tuple(h.shape)}: "
                         "want contiguous tensors of one shape and device")
    if not (mem.is_floating_point() and h.is_floating_point()):
        raise ValueError(f"float tensors only, got {mem.dtype}/{h.dtype}")
    n = mem.numel()
    if n == 0:
        return mem
    triton, kern = _compiled()
    with torch.cuda.device(mem.device):
        kern[(triton.cdiv(n, BLOCK),)](mem, h, n, float(a), BLOCK=BLOCK,
                                       num_warps=4)
    launches += 1
    return mem


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
