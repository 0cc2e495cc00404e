"""CCM flash attention on the H100, forward and backward (port of
``repro/kernels/ccm_attention.py``).

Replaces the Pallas TPU kernel ``ccm_flash_attention`` (body ``_kernel``)
in ``repro/kernels/ccm_attention.py``.  The kernels are CUDA C++ in
``csrc/ccm_attention.cu``; its header says what bounds them on the card
and what the design does about that.  This module checks the arguments,
passes every tensor by pointer and element strides (so q in the
reference's (B, Hq, Sq, D) layout may be a transposed view of the
model's (B, Sq, Hq, D) activations: nothing is copied or padded) and
launches on PyTorch's current stream.

``ccm_attention`` is the differentiable entry: a ``torch.autograd.Function``
whose forward launches the forward kernel (saving the per-row float32
log-sum-exp) and whose backward launches the two backward kernels.  The
TPU kernel has no backward; this one computes the gradient that the
reference gets by autodiff of its dense attend.  The plain version is
``ref.ccm_attention_ref`` (its plain backward is autograd through it).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ccm_attention_ref as plain

MAX_D = 256

launches = 0       # forward kernel launches (the count chip_smoke reads)
bwd_launches = 0   # backward launches (one dQ + one dK/dV kernel each)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


class _CcmParams(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "o", "lse", "dout", "dq",
                                   "dk", "dv", "delta", "q_idx", "q_seg",
                                   "k_idx", "k_seg", "k_comp", "k_valid")]
                + [(f"{t}_{a}", _L) for t in ("q", "k", "v", "o", "do", "dq",
                                              "dk", "dv")
                   for a in ("b", "h", "s")]
                + [(n, _L) for n in ("qm_b", "km_b")]
                + [(n, _I) for n in ("B", "Hq", "Hkv", "Sq", "Sk", "D")]
                + [("scale", ctypes.c_float)])


_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.library("ccm_attention")
        lib.ccm_attention_abi_size.restype = ctypes.c_int
        lib.ccm_attention_abi_size.argtypes = []
        if lib.ccm_attention_abi_size() != ctypes.sizeof(_CcmParams):
            raise RuntimeError("ccm_attention: C and ctypes parameter "
                               "layouts differ")
        fns = []
        for name in ("ccm_attention_fwd_launch", "ccm_attention_bwd_launch"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_CcmParams), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fns.append(fn)
        _fns = tuple(fns)
    return _fns


def _meta(x, B: int, S: int, dev, keep: List[torch.Tensor], name: str):
    """(S,) or (B, S) metadata -> (pointer, lane stride) of an int32 copy."""
    t = torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
    if t.shape not in ((S,), (B, S)):
        raise ValueError(f"{name} must be ({S},) or ({B}, {S}), got "
                         f"{tuple(t.shape)}")
    keep.append(t)
    return t.data_ptr(), (S if t.ndim == 2 and B > 1 else 0)


def _vector_ok(t: torch.Tensor) -> bool:
    """The kernels read 8 consecutive elements of a row at a time through
    (lane, head, token) strides."""
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) \
        and t.data_ptr() % 16 == 0


def _check(t: torch.Tensor, name: str, shape, dtype, dev):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != dev:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype} on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not _vector_ok(t):
        raise ValueError(f"{name}: the head dim must be contiguous, the other "
                         "strides multiples of 8 elements and the data "
                         "16-byte aligned")


def _params(q, k, v, meta, scale, keep) -> _CcmParams:
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: float32 or bf16 only")
    if D % 8 or D > MAX_D:
        raise ValueError(f"head dim {D}: a multiple of 8, <= {MAX_D}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError(f"empty attention: B={B} Sq={Sq} Sk={Sk}")
    _check(q, "q", (B, Hq, Sq, D), q.dtype, dev)
    _check(k, "k", (B, Hkv, Sk, D), q.dtype, dev)
    _check(v, "v", (B, Hkv, Sk, D), q.dtype, dev)
    q_idx, q_seg, k_idx, k_seg, k_comp, k_valid = meta
    p = _CcmParams()
    p.q_idx, qm = _meta(q_idx, B, Sq, dev, keep, "q_idx")
    p.q_seg, qm2 = _meta(q_seg, B, Sq, dev, keep, "q_seg")
    p.k_idx, km = _meta(k_idx, B, Sk, dev, keep, "k_idx")
    p.k_seg, km2 = _meta(k_seg, B, Sk, dev, keep, "k_seg")
    p.k_comp, km3 = _meta(k_comp, B, Sk, dev, keep, "k_comp")
    lanes = {km, km2, km3}
    if k_valid is not None:
        p.k_valid, km4 = _meta(k_valid, B, Sk, dev, keep, "k_valid")
        lanes.add(km4)
    if qm != qm2 or len(lanes) != 1:
        raise ValueError("q and k metadata must each be all shared (S,) or "
                         "all per-lane (B, S)")
    p.qm_b, p.km_b = qm, km
    for name, t in (("q", q), ("k", k), ("v", v)):
        _set(p, name, t)
    p.B, p.Hq, p.Hkv, p.Sq, p.Sk, p.D = B, Hq, Hkv, Sq, Sk, D
    p.scale = float(scale)
    return p


def _set(p: _CcmParams, name: str, t: torch.Tensor) -> None:
    """Pointer and (lane, head, token) strides of ``t`` into ``p``."""
    setattr(p, name, t.data_ptr())
    for a, s in zip("bhs", t.stride()[:3]):
        setattr(p, f"{name}_{a}", s)


def _launch(fn, p: _CcmParams, q: torch.Tensor, what: str) -> None:
    dev = q.device
    err = fn(ctypes.byref(p), int(q.dtype == torch.bfloat16),
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ccm_attention {what} launch failed: "
                           f"cudaError {err}")


def ccm_attention_fwd(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D):
    CUDA, one dtype (float32 or bf16), head dim contiguous, any other
    strides that are multiples of 8; metadata (S,) or (B, S).  Returns
    (o with q's strides, lse (B, Hq, Sq) float32)."""
    global launches
    if not q.is_cuda:
        raise ValueError("ccm_attention_fwd needs CUDA tensors")
    keep: List[torch.Tensor] = []
    p = _params(q, k, v, (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid),
                scale, keep)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _set(p, "o", o)
    p.lse = lse.data_ptr()
    _launch(_launchers()[0], p, q, "forward")
    launches += 1
    return o, lse


def ccm_attention_bwd(q, k, v, o, lse, do, q_idx, q_seg, k_idx, k_seg,
                      k_comp, k_valid, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the two backward kernels (dQ with Delta = rowsum(dO * O),
    then dK/dV).  Returns (dq, dk, dv) with the strides of q, k, v."""
    global bwd_launches
    if not q.is_cuda:
        raise ValueError("ccm_attention_bwd needs CUDA tensors")
    keep: List[torch.Tensor] = []
    p = _params(q, k, v, (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid),
                scale, keep)
    if not _vector_ok(do):           # a gradient may arrive as any view
        do = do.contiguous()
    _check(o, "o", q.shape, q.dtype, q.device)
    _check(do, "dout", q.shape, q.dtype, q.device)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse: want a contiguous (B, Hq, Sq) float32 tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    for name, t in (("o", o), ("do", do), ("dq", dq), ("dk", dk), ("dv", dv)):
        _set(p, name, t)
    p.dout = do.data_ptr()
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    _launch(_launchers()[1], p, q, "backward")
    bwd_launches += 1
    return dq, dk, dv


class _CcmAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid,
                scale):
        o, lse = ccm_attention_fwd(q, k, v, q_idx, q_seg, k_idx, k_seg,
                                   k_comp, k_valid, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ccm_attention_bwd(q, k, v, o, lse, do, *ctx.meta,
                                       ctx.scale)
        return (dq, dk, dv) + (None,) * 7


def ccm_attention(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp,
                  k_valid: Optional[torch.Tensor], scale: float
                  ) -> torch.Tensor:
    """The kernel under autograd: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D)
    on a CUDA device; returns o with q's strides."""
    return _CcmAttention.apply(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp,
                               k_valid, float(scale))
