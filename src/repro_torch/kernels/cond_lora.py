"""Fused conditional-LoRA matmul on the H100 (port of
``repro/kernels/cond_lora.py``).

Replaces the Pallas TPU kernel ``cond_lora_matmul`` (body ``_kernel``) in
``repro/kernels/cond_lora.py``:
``y = x @ W (+ bias) + gate * ((x @ A^T) @ B) * scale``.  The kernel is
CUDA C++ in ``csrc/cond_lora.cu``; its header says what bounds it on the
card and what its design does about that.  This module checks the
arguments and launches it on PyTorch's current stream.  The plain
version is ``ref.cond_lora_ref``.

The kernel has two routes, chosen by dtype: bf16 operands run on the
tensor cores (TMA + ``wgmma``; ``K`` and ``N`` multiples of 8, the rank
zero-padded to 8, 16, 32 or 64 by ``pad_rank``), float32 operands on the
CUDA cores (the float32 cross-checks).  A bf16 shape the tensor-core
route cannot take raises ``ValueError``; nothing falls back.

``cond_lora`` is the differentiable entry: a ``torch.autograd.Function``
whose forward is the kernel and whose backward is three ``torch.matmul``
products (the reference gets the same cotangents from XLA's autodiff of
the jnp ``cond_linear``, outside any Pallas kernel):

    dx    = dy @ W^T + s * ((g * dy) @ B^T) @ A
    dW    = x^T @ dy                  (full training only)
    dA    = s * ((g * dy) @ B^T)^T @ x
    dB    = s * (x @ A^T)^T @ (g * dy)
    dbias = sum_rows(dy)

``dW`` is computed only when ``W`` requires a gradient
(``train_mode="full"``); under LoRA-only training ``W`` is frozen.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cond_lora_ref as plain

MAX_RANK = 64

launches = 0         # kernel launches (the count chip_smoke reads)
wgmma_launches = 0   # of them, launches of the bf16 tensor-core route
backward_calls = 0   # autograd backward passes (matmuls, not a kernel)

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.library("cond_lora").cond_lora_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


PADDED_RANKS = (8, 16, 32, 64)


def pad_rank(a: torch.Tensor, b: torch.Tensor):
    """A (r, K) and B (r, N) zero-padded to r_pad rows, the first of 8,
    16, 32, 64 that holds r (multiples of 8: the N of the tensor-core
    route's m64n8k16 rank products; the kernel has one instantiation per
    r_pad); returned unchanged when r already is one.  Zero rows add
    nothing to (x @ A^T) @ B."""
    r = a.shape[0]
    rp = next(p for p in PADDED_RANKS if p >= r)
    if rp == r:
        return a, b
    return (torch.cat([a, a.new_zeros((rp - r, a.shape[1]))]),
            torch.cat([b, b.new_zeros((rp - r, b.shape[1]))]))


def cond_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, gate: torch.Tensor, scale: float,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  x (M, K), w (K, N), a (r, K), b (r, N),
    bias (N,) or None: contiguous CUDA tensors of one dtype, float32 or
    bf16; gate (M,) float32.  Returns (M, N) in x.dtype.  bf16 takes the
    tensor-core route and needs K % 8 == 0, N % 8 == 0 and 16-byte
    aligned data; float32 takes the CUDA-core route."""
    global launches, wgmma_launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}: float32 or bf16 only")
    M, K = x.shape
    N, r = w.shape[1], a.shape[0]
    want = {"x": (M, K), "w": (K, N), "a": (r, K), "b": (r, N)}
    ops = {"x": x, "w": w, "a": a, "b": b}
    if bias is not None:
        want["bias"], ops["bias"] = (N,), bias
    for name, t in ops.items():
        if tuple(t.shape) != want[name] or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {want[name]} "
                             f"{x.dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside 1..{MAX_RANK}")
    if gate.shape != (M,) or gate.dtype != torch.float32 \
            or gate.device != x.device or not gate.is_contiguous():
        raise ValueError(f"gate: want contiguous ({M},) float32 on {x.device}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if K % 8 or N % 8:
            raise ValueError(f"cond_lora bf16: K={K} and N={N} must be "
                             "multiples of 8 (TMA's 16-byte row strides)")
        a, b = pad_rank(a, b)
        r = a.shape[0]
        for name, t in (("x", x), ("w", w), ("a", a), ("b", b),
                        ("bias", bias)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"cond_lora bf16: {name} is not 16-byte "
                                 "aligned")
    if not x.is_cuda:
        raise ValueError("cond_lora_matmul needs CUDA tensors")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    dev = x.device
    err = _launcher()(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        gate.data_ptr(), 0 if bias is None else bias.data_ptr(),
        y.data_ptr(), M, N, K, r, float(scale), int(bf16),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cond_lora kernel launch failed: "
                           + ("a TMA tensor map could not be built"
                              if err == -1 else f"cudaError {err}"))
    launches += 1
    wgmma_launches += bf16
    return y


class _CondLoRA(torch.autograd.Function):
    """Kernel forward, matmul backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w, a, b, gate, scale, bias):
        ctx.save_for_backward(x, w, a, b, gate)
        ctx.scale = scale
        ctx.has_bias = bias is not None
        return cond_lora_matmul(x, w, a, b, gate, scale, bias)

    @staticmethod
    def backward(ctx, dy):
        global backward_calls
        backward_calls += 1
        x, w, a, b, gate = ctx.saved_tensors
        s = ctx.scale
        need = ctx.needs_input_grad
        dx = dw = da = db = dbias = None
        dy32 = dy.float()
        gdy = dy32 * gate[:, None]                       # (M, N) float32
        if need[0] or need[2]:
            u = (gdy @ b.float().T) * s                  # (M, r)
            if need[0]:
                dx = (dy @ w.to(dy.dtype).T).float() + u @ a.float()
                dx = dx.to(x.dtype)
            if need[2]:
                da = (u.T @ x.float()).to(a.dtype)
        if need[1]:
            dw = x.T @ dy.to(x.dtype)                    # (K, N) in w's dtype
        if need[3]:
            db = (((x.float() @ a.float().T) * s).T @ gdy).to(b.dtype)
        if ctx.has_bias and need[6]:
            dbias = dy32.sum(0).to(dy.dtype)
        return dx, dw, da, db, None, None, dbias


def cond_lora(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, gate: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cond_lora_matmul`` under autograd: gradients reach x, a, b and
    bias, and ``w`` where it requires one (full training)."""
    return _CondLoRA.apply(x, w, a, b, gate, float(scale), bias)
