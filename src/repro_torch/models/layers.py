"""Shared neural building blocks (port of ``repro/models/layers.py``):
norms, RoPE, MLPs and the init helpers.

Weights keep the reference's ``(d_in, d_out)`` layout, so ``y = x @ w``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.kernels.ref import widen
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# init helpers (the reference's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """N(0, std^2) drawn in float32, then cast (as the reference does)."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), s, dtype, device)


def embed_init(gen, vocab, d, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


def init_norm(cfg: ModelConfig, d: int, device) -> Dict[str, torch.Tensor]:
    if cfg.norm == "ln":
        return {"scale": torch.ones(d, dtype=cfg.pdtype, device=device),
                "bias": torch.zeros(d, dtype=cfg.pdtype, device=device)}
    return {"scale": torch.zeros(d, dtype=cfg.pdtype, device=device)}


def init_mlp(gen, cfg: ModelConfig, d: int, f: int,
             device) -> Dict[str, torch.Tensor]:
    p = {"wi": dense_init(gen, d, f, cfg.pdtype, device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, f, cfg.pdtype, device)
    p["wo"] = dense_init(gen, f, d, cfg.pdtype, device)
    return p


# ---------------------------------------------------------------------------
# norms (fp32 statistics, cast back)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = widen(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(xf.dtype))).to(x.dtype)   # stored as (1 + scale)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = widen(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(xf.dtype) + bias.to(xf.dtype)).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "ln":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE with explicit per-token positions (CCM reassigns positions)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> float32 cos/sin (..., S, head_dim/2)."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2).  Rotate-half
    pairing (x1, x2) = split(x, 2, -1), computed in x.dtype."""
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# MLP: SwiGLU / GeGLU / GELU (tanh approximation, as the reference)
# ---------------------------------------------------------------------------

def apply_mlp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor, tp=None) -> torch.Tensor:
    """With ``tp`` (`distributed.tensor_parallel.TensorParallel`) splitting
    ``d_ff``, ``wi``/``wg`` are this rank's columns and ``wo`` its rows:
    the partial sum goes through the model-axis reduce."""
    split = tp is not None and tp.ff_split
    if split:
        x = TPX.copy_to_tp(x, tp)

    def mm(w):
        return x @ p[w].to(x.dtype)
    if cfg.activation == "swiglu":
        h = F.silu(mm("wg")) * mm("wi")
    elif cfg.activation == "geglu":
        h = F.gelu(mm("wg"), approximate="tanh") * mm("wi")
    else:
        h = F.gelu(mm("wi"), approximate="tanh")
    y = h @ p["wo"].to(x.dtype)
    return TPX.reduce_from_tp(y, tp) if split else y
