"""CCM-merge memory update on the H100, in Triton (port of
``repro/kernels/kv_merge.py``).

Replaces the Pallas TPU kernel ``kv_merge_update`` (body ``_merge_kernel``)
in ``repro/kernels/kv_merge.py``: Mem(t) = (1 - a) Mem(t-1) + a h(t), with
``a`` a runtime weight (1/t arithmetic mean, or the EMA alpha).

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
from repro_torch.kernels.ref import kv_merge_ref as plain

BLOCK = 1024

launches = 0   # kernel launches (the count chip_smoke reads)

_kernel = None


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
