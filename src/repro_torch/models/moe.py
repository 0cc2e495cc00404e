"""Mixture-of-Experts FFN on one device (port of ``repro/models/moe.py``:
``init_moe``, ``_route``, ``_expert_ffn``, ``_moe_local`` and
``apply_moe`` with ``dist=None``).

Token-choice routing: a float32 router, softmax over the experts, top-k,
and combine weights renormalised to sum to 1 (the Mixtral convention).
Dropless: every (token, choice) row is sorted by its expert (a stable
sort), each expert's rows run through its SwiGLU MLP, and the rows go back
to token order to be combined.

Top-k ties (equal router probabilities, as for two identical router
columns) go to the lower expert index, as ``jax.lax.top_k`` resolves
them: the port ranks by a stable descending sort.

The reference's grouped products are ``jax.lax.ragged_dot`` (plain XLA,
not a Pallas kernel).  Here they are one ``torch.matmul`` per non-empty
expert group over the sorted rows: the group sizes are read on the host
once per layer (one synchronisation), and an empty group launches
nothing.  The multi-device strategies (``ragged_tp`` across a model axis,
``ep`` with its all-to-all) come with the multi-device slice: ``dist=``
raises, whatever ``moe_impl`` says; without ``dist`` both impls run the
local path, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, d: int, f: int,
             device) -> Dict[str, torch.Tensor]:
    """Router (d, E) float32 whatever ``param_dtype`` is; expert weights
    (E, d, f) / (E, f, d) ~ N(0, 1/d_in) in ``param_dtype``, drawn one
    expert at a time (no (E, ...) float32 temporary)."""
    E = cfg.n_experts

    def ei(a, b):
        out = torch.empty((E, a, b), dtype=cfg.pdtype, device=device)
        for e in range(E):
            out[e] = L.normal(gen, (a, b), 1.0 / math.sqrt(a), cfg.pdtype,
                              device)
        return out
    return {"router": L.dense_init(gen, d, E, torch.float32, device),
            "wi": ei(d, f), "wg": ei(d, f), "wo": ei(f, d)}


def _route(cfg: ModelConfig, router_w: torch.Tensor, xf: torch.Tensor):
    """xf (N, d) -> combine weights (N, k) float32, expert ids (N, k)
    int64, the heavier choice first (ties: the lower expert id)."""
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, topi


def _expert_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                xs: torch.Tensor, sizes) -> torch.Tensor:
    """Grouped expert MLP: xs (M, d) sorted by expert, ``sizes`` the E
    group sizes (host ints).  One matmul chain per non-empty group."""
    # one view per expert, taken once: under autograd an unbind's backward
    # stacks the experts' gradients, where each p["wg"][e] would add a
    # zero tensor the size of the whole (E, d, f) weight
    wg, wi, wo = (p[k].unbind(0) for k in ("wg", "wi", "wo"))
    outs = []
    start = 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        xe = xs[start:start + n]
        h = F.silu(xe @ wg[e].to(xs.dtype)) * (xe @ wi[e].to(xs.dtype))
        outs.append(h @ wo[e].to(xs.dtype))
        start += n
    return torch.cat(outs)


def _moe_local(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               xf: torch.Tensor) -> torch.Tensor:
    """Dropless sort-based MoE: xf (N, d) -> (N, d)."""
    N, d = xf.shape
    k, E = cfg.top_k, cfg.n_experts
    topw, topi = _route(cfg, p["router"], xf)
    eids = topi.reshape(-1)                                   # (N*k,)
    order = torch.argsort(eids, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    xr = xf.repeat_interleave(k, dim=0)[order]                # (N*k, d)
    sizes = torch.bincount(eids, minlength=E).tolist()        # host sync
    y = _expert_ffn(cfg, p, xr, sizes)[inv]
    y = y.reshape(N, k, d) * topw[..., None].to(y.dtype)
    return y.sum(dim=1)


def apply_moe(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              dist=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) through the experts."""
    if dist is not None:
        raise NotImplementedError(
            f"sharded MoE (dist=, moe_impl={cfg.moe_impl!r}) comes with the "
            "multi-device slice of the port (ROADMAP queue 1 item 4)")
    B, S, d = x.shape
    return _moe_local(cfg, p, x.reshape(B * S, d)).reshape(B, S, d)
