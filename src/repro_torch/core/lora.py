"""Conditional LoRA (paper Eq. 4; port of ``repro/core/lora.py``).

``x' = W x + m * (DeltaW) x`` with ``m = 1(x is <COMP>)``.  A gated LoRA
projection goes to the fused kernel op ``kernels.ops.cond_lora``; without
LoRA or gate the projection is a plain ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import ops


def init_lora(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              device) -> Dict[str, torch.Tensor]:
    """A ~ N(0, 1/d_in); B = 0 so the delta starts at zero (float32)."""
    a = torch.randn((rank, d_in), generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(d_in)
    b = torch.zeros((rank, d_out), device=device, dtype=torch.float32)
    return {"a": a, "b": b}


def lora_delta(x: torch.Tensor, lora: Dict[str, torch.Tensor],
               scale: float) -> torch.Tensor:
    """(x @ A^T) @ B * scale, computed in x.dtype."""
    a = lora["a"].to(x.dtype)
    b = lora["b"].to(x.dtype)
    return ((x @ a.T) @ b) * scale


def cond_linear(x: torch.Tensor, w: torch.Tensor,
                lora: Optional[Dict[str, torch.Tensor]],
                gate: Optional[torch.Tensor],
                scale: float = 2.0,
                bias: Optional[torch.Tensor] = None,
                reduce: Optional[Callable] = None) -> torch.Tensor:
    """y = x @ W (+bias) + gate * ((x @ A^T) @ B) * scale.

    x (..., d_in); w (d_in, d_out); gate (...,) in {0., 1.}, or None for
    unconditional LoRA (the paper's "default LoRA" ablation).

    Tensor parallelism: a column-parallel shard is this call on the
    rank's columns of ``w`` and ``b`` (``a`` whole).  A row-parallel shard
    (``reduce`` given) takes the rank's rows of ``w`` and columns of
    ``a`` with ``b`` whole: ``x_s @ W_s + gate (x_s a_s^T) b`` is the
    rank's term of a sum, since ``(sum_s x_s a_s^T) b = sum_s (x_s
    a_s^T) b``; ``reduce`` completes it and the bias is added once, after.
    """
    if reduce is not None:
        y = reduce(cond_linear(x, w, lora, gate, scale))
        return y if bias is None else y + bias.to(x.dtype)
    w = w.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if lora is not None and gate is not None:
        lead = x.shape[:-1]
        y = ops.cond_lora(x.reshape(-1, x.shape[-1]), w,
                          lora["a"].to(x.dtype), lora["b"].to(x.dtype),
                          gate.reshape(-1), scale, bias=b)
        return y.reshape(*lead, w.shape[1])
    y = x @ w
    if b is not None:
        y = y + b
    if lora is not None:
        y = y + lora_delta(x, lora, scale)
    return y


def lora_scale(rank: int, alpha: float) -> float:
    return float(alpha) / float(rank)
