"""Model assembly for the dense family (port of
``repro/models/transformer.py``: init, embeddings, logits).

Params keep the reference tree: a nested dict with the same key paths and
the same stacked leading layer axis (``layers/attn/wq`` is (L, d, Hq*hd)).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _init_block(gen, cfg: ModelConfig, device) -> Params:
    return {"ln1": L.init_norm(cfg, cfg.d_model, device),
            "attn": A.init_attention(gen, cfg, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)}


def _empty_stack(tree: Params, n: int) -> Params:
    """Uninitialised (n, ...) buffers shaped like one layer's tree."""
    return {k: _empty_stack(v, n) if isinstance(v, dict) else
            torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def _copy_layer(dst: Params, src: Params, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_layer(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: DeviceLike = None) -> Params:
    """Random weights with the reference init's distributions, drawn from
    a ``torch.Generator`` seeded with ``seed`` (the numbers differ from
    the reference's).  Runs on the card unless ``device="cpu"``."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r}: the port covers 'dense'")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.pdtype, dev),
                 "final_norm": L.init_norm(cfg, cfg.d_model, dev)}
    if cfg.ccm.enabled:
        p["comp_embed"] = L.normal(gen, (cfg.ccm.comp_len, cfg.d_model),
                                   0.02, cfg.pdtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    cfg.pdtype, dev)
    # one layer at a time into stacked buffers: no full-model temporaries
    for i in range(cfg.n_layers):
        blk = _init_block(gen, cfg, dev)
        if i == 0:
            p["layers"] = _empty_stack(blk, cfg.n_layers)
        _copy_layer(p["layers"], blk, i)
    return p


def layer_params(params: Params, li: int) -> Params:
    """Views of layer ``li`` of the stacked ``params["layers"]`` tree."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[li]
    return pick(params["layers"])


def embed_tokens(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
                 comp_mask: Optional[torch.Tensor] = None,
                 comp_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = p["embed"][tokens.long()].to(cfg.cdtype)
    if comp_mask is not None and "comp_embed" in p:
        ce = p["comp_embed"].to(cfg.cdtype)
        off = comp_offset if comp_offset is not None else \
            torch.zeros(tokens.shape[-1], dtype=torch.long, device=x.device)
        comp_vec = ce[off]                               # (S, d)
        cm = comp_mask[..., None].to(cfg.cdtype)
        x = x * (1 - cm) + comp_vec * cm
    if cfg.embed_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)
