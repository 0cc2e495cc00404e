"""AdamW with global-norm clipping and warm-up/cosine schedules, from
scratch (port of ``repro/optim/adamw.py``; no ``torch.optim``).

The arithmetic is the reference's: float32 moments, the gradient clipped
by its global norm, bias correction, and each updated leaf cast back to
its own dtype (``comp_embed`` is bf16 in the LLaMA config).  The step
count and the learning rate are host numbers (float32, as the reference
computes them).  Unlike the reference, parameters and moments are
updated IN PLACE; the returned trees are the ones passed in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.optim.partition import tree_map


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    schedule: str = "cosine"       # cosine | constant
    warmup_steps: int = 20
    total_steps: int = 1000


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    f32 = np.float32
    s = f32(step)
    warm = min(s / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    if cfg.schedule == "cosine":
        frac = (s - f32(cfg.warmup_steps)) \
            / f32(max(cfg.total_steps - cfg.warmup_steps, 1))
        frac = min(max(frac, f32(0.0)), f32(1.0))
        decay = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac))
    else:
        decay = f32(1.0)
    return float(f32(cfg.lr) * f32(warm) * f32(decay))


def init_adamw(params: Any, trainable: Optional[Any] = None) -> AdamWState:
    def zeros(path, p, *m):
        if p is None or (m and not m[0]):
            return None
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    mu = tree_map(zeros, params) if trainable is None \
        else tree_map(zeros, params, trainable)
    nu = tree_map(lambda _, z: None if z is None else torch.zeros_like(z), mu)
    return AdamWState(step=0, mu=mu, nu=nu)


def global_norm(grads: Any) -> torch.Tensor:
    sq = []
    tree_map(lambda _, g: sq.append(torch.sum(g.float() ** 2))
         if g is not None else None, grads)
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: AdamWState, trainable: Optional[Any] = None):
    """Returns (params, new_state, metrics), updating params and moments
    in place.  Leaves that are None, untrainable or without moments are
    left as they are."""
    if trainable is not None:
        grads = tree_map(lambda _, g, m: g if m else None, grads, trainable)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else None
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    f32 = np.float32
    bc1 = float(f32(1) - f32(cfg.b1) ** f32(step))
    bc2 = float(f32(1) - f32(cfg.b2) ** f32(step))

    def upd(path, p, g, mu, nu):
        if p is None or g is None or mu is None:
            return
        g = g.float()
        if scale is not None:
            g = g * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
