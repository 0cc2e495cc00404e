"""Gradient compression for the data-parallel reduce, with error feedback
(port of ``repro/optim/grad_compress.py``).

Two codecs:
  int8  - per-tensor symmetric quantization; 4x wire reduction.
  topk  - magnitude top-k% sparsification with error feedback (Lin et
          al., Deep Gradient Compression): residuals accumulate locally so
          the update stays unbiased over time.

Trees are the port's nested dicts; None leaves (the frozen side of a
partition) stay None.  The codecs and the error-feedback step run on the
device of the gradients.  ``compressed_psum`` is the data-parallel
reduce over a process group (`launch.train` with ``dist=``); on one
device ``launch/train.py`` passes the error-feedback state through
unchanged, as the reference does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.partition import tree_map


class EFState(NamedTuple):
    residual: Any   # same structure as grads


def init_ef(grads_like: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda _, g: None if g is None else
        torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


# --- int8 codec ------------------------------------------------------------

def quantize_int8(x: torch.Tensor,
                  coll=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d): q = clip(round(x / scale), -127, 127) with
    scale = (max|x| + 1e-12) / 127, rounding half to even as
    ``jnp.round`` does.  ``coll`` (the model-axis collectives of a leaf
    split over it): the max is the whole leaf's, as the reference's is
    (its model axis stays automatic inside the data-axis reduce)."""
    amax = x.abs().max()
    if coll is not None:
        amax = coll.max(amax)
    amax = amax + 1e-12
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, one ulp away from the reference's true division
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# --- top-k codec -----------------------------------------------------------

def topk_sparsify(x: torch.Tensor, frac: float, coll=None) -> torch.Tensor:
    """Keep the top ``frac`` fraction of entries by magnitude (a dense
    mask: the wire format would transmit (indices, values); this models
    the value selection and the error it leaves behind).  Every entry at
    or above the k-th magnitude is kept, ties included, so more than k
    may survive.  ``coll`` (a leaf split over the model axis): k and the
    threshold are the whole leaf's, from every rank's top k."""
    flat = x.reshape(-1)
    n = flat.shape[0] * (coll.n if coll is not None else 1)
    k = max(int(n * frac), 1)
    top = torch.topk(flat.abs(), min(k, flat.shape[0])).values
    if coll is not None:
        top = torch.topk(coll.gather(top, 0), k).values
    thresh = top[-1]
    return x * (x.abs() >= thresh)


# --- error-feedback compress step -------------------------------------------

def compress_with_ef(grads: Any, ef: EFState, codec: str = "int8",
                     topk_frac: float = 0.01, split: Any = None):
    """Returns (compressed_grads, new_ef); compressed + new residual ==
    grads + old residual.  The residual is float32 whatever the
    gradient's dtype.  ``split`` (tensor parallelism): a tree with the
    model-axis collectives at each leaf split over that axis (None
    elsewhere), whose codec statistics then span the ranks."""

    def one(g, r, coll):
        gf = g.to(torch.float32) + r
        if codec == "int8":
            out = dequantize_int8(*quantize_int8(gf, coll))
        elif codec == "topk":
            out = topk_sparsify(gf, topk_frac, coll)
        else:
            out = gf
        return out, gf - out

    if split is None:
        split = tree_map(lambda _, g: None, grads)
    pairs = tree_map(lambda _, g, r, c: None if g is None else one(g, r, c),
                     grads, ef.residual, split)
    comp = tree_map(lambda _, p: None if p is None else p[0], pairs)
    resid = tree_map(lambda _, p: None if p is None else p[1], pairs)
    return comp, EFState(residual=resid)


def compressed_psum(grads: Any, axis_name, ef: Optional[EFState] = None,
                    codec: str = "none", topk_frac: float = 0.01,
                    split: Any = None):
    """Sum over the data-parallel axes with optional codec + error
    feedback; returns (reduced_grads, new_ef).

    ``axis_name``: the process group of the data (and pod) ranks
    (``DistContext.group(dist.batch_axes)``; on a shape-only mesh its
    counting group).  With
    ``codec="none"`` (or no ``ef``) each gradient is SUM-all-reduced as
    it is, in place; otherwise `compress_with_ef` runs first on this
    rank's gradients and residual and the compressed gradients are
    SUM-all-reduced.  A CUDA tensor goes through NCCL only
    (`distributed.context.check_backend`).  ``split``: as in
    `compress_with_ef`."""
    from repro_torch.distributed.context import all_reduce_

    def reduce(_, g):
        return None if g is None else all_reduce_(g, axis_name)

    if codec == "none" or ef is None:
        return tree_map(reduce, grads), ef
    comp, new_ef = compress_with_ef(grads, ef, codec, topk_frac, split)
    return tree_map(reduce, comp), new_ef
