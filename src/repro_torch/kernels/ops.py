"""Public kernel ops (port of ``repro/kernels/ops.py``, same signatures).

Each op dispatches on the DEVICE OF ITS TENSORS: CPU tensors take the
plain PyTorch version (``kernels/ref.py``); CUDA tensors launch the
hand-written kernel, which raises on anything it does not take.  There is
no fallback from a CUDA tensor to the plain version.

``meta`` tensors (shapes and dtypes, no data: the dry run of
`launch.dryrun`) launch nothing: the op returns empty outputs of the
kernel's shapes and dtypes (gradients too, under autograd) and charges
the kernel's FLOPs and bytes, by the formula its wrapper module keeps
(``cost``), to every `KernelCost` that `count_kernels` has made active.
The in-place ops write nothing and return their operand.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ccm_attention as _attn
from repro_torch.kernels import cond_lora as _lora
from repro_torch.kernels import decode_attention as _dattn
from repro_torch.kernels import kv_merge as _merge
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import session_gather as _sess

# op name -> (module, name of its launch counter); the ``_splitk``,
# ``_mma`` and ``_wgmma`` entries count the tensor-core routes' share of
# their kernel's launches, ``_mma_lse`` the mma.sync route's launches
# that write the log-sum-exp
_KERNELS = {"segmented_attention": (_dattn, "launches"),
            "segmented_attention_splitk": (_dattn, "splitk_launches"),
            "segmented_attention_mma": (_dattn, "mma_launches"),
            "segmented_attention_mma_lse": (_dattn, "mma_lse_launches"),
            "cond_lora": (_lora, "launches"),
            "cond_lora_wgmma": (_lora, "wgmma_launches"),
            "kv_merge_update": (_merge, "launches"),
            "ccm_attention": (_attn, "launches"),
            "ccm_attention_backward": (_attn, "bwd_launches"),
            "ccm_attention_mma": (_attn, "mma_launches"),
            "ccm_attention_backward_mma": (_attn, "bwd_mma_launches"),
            "kv_cummean": (_merge, "cummean_launches"),
            "kv_cummean_backward": (_merge, "cummean_bwd_launches"),
            "session_gather": (_sess, "gather_launches"),
            "session_scatter": (_sess, "scatter_launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last reset (CUDA tensors only)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)


class KernelCost:
    """The FLOPs and bytes the kernel ops charged on meta tensors while
    it was active (`count_kernels`): totals, and ``by_op[name]`` =
    [calls, FLOPs, bytes] per op (a backward under its op's name with
    ``_backward``)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, List[float]] = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


_ACTIVE: List[KernelCost] = []


@contextlib.contextmanager
def count_kernels(cost: Optional[KernelCost] = None):
    """Charge the kernel ops run on meta tensors inside the block to
    ``cost`` (a new `KernelCost` when None), which it yields."""
    cost = KernelCost() if cost is None else cost
    _ACTIVE.append(cost)
    try:
        yield cost
    finally:
        _ACTIVE.remove(cost)


def _charge(name: str, flops: float, nbytes: float) -> None:
    for c in _ACTIVE:
        c.add(name, flops, nbytes)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class _MetaKernel(torch.autograd.Function):
    """A differentiable kernel op on meta tensors: ``outs`` ((shape,
    dtype) pairs) come back empty and ``cost`` (FLOPs, bytes) is charged
    under ``name``; the backward charges ``backward_cost(needs_input_grad
    of the tensors)`` under ``name + "_backward"`` and gives empty
    gradients of the inputs' shapes."""

    @staticmethod
    def forward(ctx, name, outs, cost, backward_cost, *inputs):
        ctx.name, ctx.backward_cost = name, backward_cost
        ctx.specs = [(x.shape, x.dtype) for x in inputs]
        _charge(name, *cost)
        res = tuple(_empty(s, d) for s, d in outs)
        return res if len(res) > 1 else res[0]

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[4:]
        _charge(ctx.name + "_backward", *ctx.backward_cost(need))
        return (None,) * 4 + tuple(_empty(s, d) if n else None
                                   for (s, d), n in zip(ctx.specs, need))


def segmented_attention(q: torch.Tensor, segs: Sequence[Dict[str, Any]],
                        q_idx, q_seg, scale: float, lse: bool = False):
    """q (B, Sq, Hq, D) over in-place KV segments — see
    ``decode_attention`` for the segment-dict schema.  With ``lse``,
    returns (out, lse (B, Hq, Sq) float32): the rows' log-sum-exp of the
    scaled visible logits, -inf where a row sees no key."""
    if q.is_meta:
        _charge("segmented_attention", *_dattn.cost(q, segs, lse))
        out = _empty(q.shape, q.dtype)
        B, Sq, Hq, _ = q.shape
        return (out, _empty((B, Hq, Sq), torch.float32)) if lse else out
    if q.is_cuda:
        return _dattn.segmented_flash_attention(q, segs, q_idx, q_seg, scale,
                                                lse=lse)
    return _ref.segmented_attention_ref(q, segs, q_idx, q_seg, scale,
                                        lse=lse)


def cond_lora(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, gate: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M,K) @ w (K,N) (+bias) + gate * (x @ a.T @ b) * scale — fused.
    Differentiable in x, w, a, b and bias."""
    if x.is_meta:
        ts = (x, w, a, b) + (() if bias is None else (bias,))
        return _MetaKernel.apply(
            "cond_lora", [((x.shape[0], w.shape[1]), x.dtype)],
            _lora.cost(x, w, a, b, bias),
            lambda need: _lora.backward_cost(x, w, a, b, need), *ts)
    if x.is_cuda:
        return _lora.cond_lora(x, w, a, b, gate.detach().float().contiguous(),
                               scale, bias)
    return _ref.cond_lora_ref(x, w, a, b, gate, scale, bias)


def kv_merge_update(mem: torch.Tensor, h: torch.Tensor,
                    a: float) -> torch.Tensor:
    """(1 - a) * mem + a * h in float32, written IN PLACE into ``mem``
    (returned).  ``a`` is a host float."""
    if mem.is_meta:
        _charge("kv_merge_update", *_merge.merge_cost([mem], [h]))
        return mem
    if mem.is_cuda:
        return _merge.kv_merge_update_(mem, h, a)
    return mem.copy_(_ref.kv_merge_ref(mem, h, a))


def kv_merge_update_lanes(mems: Sequence[torch.Tensor],
                          hs: Sequence[torch.Tensor],
                          a: Union[float, Sequence[float]],
                          lane_axis: int = 0) -> Sequence[torch.Tensor]:
    """The whole merge g_update: ``mems[i] <- (1 - a) * mems[i] + a *
    hs[i]`` IN PLACE for the k and v memories together, in float32 with
    one rounding.  ``a`` is one host float, or one per lane along
    ``lane_axis`` (0 or 1) of the (d0, d1, ...) memories; ``hs`` may be
    strided views along d0 and d1 and of another float dtype.  One kernel
    launch on CUDA."""
    if mems[0].is_meta:
        _charge("kv_merge_update", *_merge.merge_cost(mems, hs))
        return mems
    if mems[0].is_cuda:
        return _merge.kv_merge_update_lanes_(mems, hs, a, lane_axis)
    for mem, h in zip(mems, hs):
        mem.copy_(_ref.kv_merge_lanes_ref(mem, h, a, lane_axis))
    return mems


def ccm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_info, k_info, scale: float) -> torch.Tensor:
    """Drop-in for ``models.attention.attend``: q (B, Sq, Hq, D), k/v
    (B, Sk, Hkv, D), ``KeyInfo`` metadata; returns (B, Sq, Hq, D).
    Differentiable in q, k, v.  The CUDA kernels read the (B, S, H, D)
    tensors in place through strides (no transpose copy, no padding)."""
    if q.is_meta:
        return _MetaKernel.apply(
            "ccm_attention", [(q.shape, q.dtype)], _attn.cost(q, k, v),
            lambda need: _attn.cost(q, k, v, backward=True), q, k, v)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            q_info.idx, q_info.seg, k_info.idx, k_info.seg, k_info.comp,
            k_info.valid)
    if q.is_cuda:
        return _attn.ccm_attention(*args, scale).transpose(1, 2)
    return _ref.ccm_attention_ref(*args, scale).transpose(1, 2)


def _as_3d(h: torch.Tensor, dim: int) -> torch.Tensor:
    """h as the (outer, T, inner) view the kernel reads (a copy only when
    the inner dims do not flatten to one axis)."""
    dim = dim % h.ndim
    return h.reshape(math.prod(h.shape[:dim]), h.shape[dim],
                     math.prod(h.shape[dim + 1:]))


def _meta_cummean(*hs: torch.Tensor):
    c = _merge.cummean_cost(hs)
    return _MetaKernel.apply("kv_cummean", [(h.shape, h.dtype) for h in hs],
                             c, lambda need: c, *hs)


def kv_cummean(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Running means of h along ``dim``, float32 accumulation, rounded
    once to h.dtype.  Differentiable.  On CUDA the kernel reads h as an
    (outer, T, inner) view through its strides (the inner dims must
    flatten to one unit-stride axis, else they are copied)."""
    if h.is_meta:
        return _meta_cummean(h)
    if not h.is_cuda:
        return _ref.kv_cummean_ref(h, dim)
    return _merge.kv_cummean(_as_3d(h, dim))[0].reshape(h.shape)


def kv_cummean_pair(hk: torch.Tensor, hv: torch.Tensor,
                    dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kv_cummean`` of the k and the v groups of a layer (one shape and
    dtype) in one kernel launch on CUDA, forward and backward; each is
    read through its own strides."""
    if hk.is_meta:
        return _meta_cummean(hk, hv)
    if not hk.is_cuda:
        return _ref.kv_cummean_pair_ref(hk, hv, dim)
    ok, ov = _merge.kv_cummean(_as_3d(hk, dim), _as_3d(hv, dim))
    return ok.reshape(hk.shape), ov.reshape(hv.shape)


def session_gather(slab: torch.Tensor, ids: Sequence[int],
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Arena pack: slab (S, ...), ``ids`` B host ints in [0, S) -> (B, ...)
    rows (into ``out`` when given).  Any dtype; ids out of range raise."""
    if slab.is_meta:
        rows = _empty((len(ids),) + tuple(slab.shape[1:]), slab.dtype) \
            if out is None else out
        _charge("session_gather", *_sess.cost(rows))
        return rows
    if slab.is_cuda:
        return _sess.session_gather(slab, ids, out)
    rows = _ref.session_gather_ref(slab, _sess.check_ids(ids, slab.shape[0]))
    return rows if out is None else out.copy_(rows)


def session_scatter(slab: torch.Tensor, ids: Sequence[int],
                    rows: torch.Tensor) -> torch.Tensor:
    """Arena unpack: ``slab[ids] = rows`` IN PLACE (returned).  Duplicate
    ids (pad lanes on the scratch row) race: each element of that row
    ends up holding one of their values."""
    if slab.is_meta:
        _charge("session_scatter", *_sess.cost(rows))
        return slab
    if slab.is_cuda:
        return _sess.session_scatter(slab, ids, rows)
    return _ref.session_scatter_ref(
        slab, _sess.check_ids(ids, slab.shape[0]), rows)
