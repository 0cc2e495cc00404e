"""Model assembly for the dense family (port of
``repro/models/transformer.py``: init, embeddings, logits and the CCM
parallel training forward).

Params keep the reference tree: a nested dict with the same key paths and
the same stacked leading layer axis (``layers/attn/wq`` is (L, d, Hq*hd)).
The reference's ``lax.scan`` over layers is a Python loop over views of
the stacked leaves; ``cfg.remat`` becomes ``torch.utils.checkpoint`` per
layer when gradients are on (the reference's ``jax.checkpoint``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import baselines as BL
from repro_torch.core import masks as M
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, require_dense

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
    require_dense(cfg)
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
        # sqrt(d) rounded to the compute dtype first, as the reference
        # does (jnp.asarray(d ** 0.5, cdtype)): in bf16 the product then
        # rounds as the reference's does
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype,
                             device=x.device)
    return x


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ===========================================================================
# block application (training / full sequence) and the layer stack
# ===========================================================================

def _attn_mlp_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                    q_info, k_info, comp_gate, positions,
                    merge_ctx) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["ln1"], x)
    q, k, v = A.qkv_project(cfg, lp["attn"], h, comp_gate,
                            positions if cfg.pos_embed == "rope" else None)
    if merge_ctx is not None:
        # merge mode and the baselines: dense attend over [virtual slots |
        # raw keys], as the reference does (no kernel computes it there
        # either)
        slots_fn = merge_ctx.get("slots_fn")
        if slots_fn is not None:
            mem_k, mem_v = slots_fn(k, v)
            k = torch.cat([mem_k, k], dim=1)
            v = torch.cat([mem_v, v], dim=1)
        o = A.attend_dense(q, k, v, merge_ctx["mask"], 1.0 / cfg.hd ** 0.5)
    else:
        o = A.attend(cfg, q, k, v, q_info, k_info)
    x = x + A.out_project(cfg, lp["attn"], o, comp_gate)
    h = L.apply_norm(cfg, lp["ln2"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def forward_hidden(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                   q_info=None, k_info=None, comp_gate=None, positions=None,
                   merge_ctx=None) -> torch.Tensor:
    """Run the decoder stack on embedded inputs x (B, S, d)."""
    require_dense(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(cfg.n_layers):
        body = functools.partial(
            _attn_mlp_block, cfg, layer_params(params, li), q_info=q_info,
            k_info=k_info, comp_gate=comp_gate, positions=positions,
            merge_ctx=merge_ctx)
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return x


# ===========================================================================
# CCM parallel training forward (paper Fig. 3 / Alg. 1)
# ===========================================================================

@functools.lru_cache(maxsize=None)
def _pool_index(t_steps: int, chunk_len: int, comp_len: int, tail_len: int,
                device: torch.device) -> torch.Tensor:
    """The compressive pooling table of ``segment_layout(t_steps,
    chunk_len, comp_len, tail_len)`` (the layout's only constructor),
    planned once per layout and device and kept there."""
    lay = M.segment_layout(t_steps, chunk_len, comp_len, tail_len)
    return BL.compressive_pool_index(lay.seg_ids, lay.comp_mask, t_steps,
                                     comp_len).to(device)


def train_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  layout: M.SegmentLayout,
                  logits_slice: Optional[Tuple[int, int]] = None,
                  unconditional_lora: bool = False) -> torch.Tensor:
    """One parallelized CCM forward; tokens (B, S) follow ``layout``.

    Returns logits over ``logits_slice`` (start, length), by default the
    tail (input/output) region only.  Concat mode attends through the
    CCM flash-attention kernel; merge mode builds the virtual memory
    slots (running mean through the ``kv_cummean`` kernel, or the EMA)
    and attends densely over [slots | raw keys].  The paper's baselines
    (``cfg.ccm.method`` "gisting" or "compressive", ``core/baselines``)
    take precedence over the mode, as in the reference, and attend
    densely: gisting under its own (S, S) mask, compressive over
    [mean-pooled raw slots | raw keys].
    """
    if cfg.pos_embed == "learned":
        raise NotImplementedError("learned position embeddings are not "
                                  "ported")
    dev = tokens.device
    S = layout.seq_len
    seg = layout.seg_ids.to(dev)
    comp = layout.comp_mask.to(dev)
    pos = layout.positions.to(dev)
    comp_off = M.comp_offset_array(layout.comp_mask).long().to(dev)
    use_ccm = cfg.ccm.enabled

    x = embed_tokens(cfg, params, tokens, comp if use_ccm else None,
                     comp_off)
    comp_gate = None
    if use_ccm:
        comp_gate = comp.to(cfg.cdtype)[None].expand(tokens.shape)
        if unconditional_lora:
            comp_gate = torch.ones_like(comp_gate)

    merge_ctx = None
    q_info = k_info = None
    if use_ccm and cfg.ccm.method == "gisting":
        merge_ctx = {"mask": BL.gisting_online_mask(seg, comp,
                                                    layout.t_steps),
                     "slots_fn": None}
    elif use_ccm and cfg.ccm.method == "compressive":
        raw_mask = M.intra_segment_causal(seg, comp)
        slot_mask = BL.compressive_slot_mask(seg, layout.t_steps,
                                             layout.comp_len)
        index = _pool_index(layout.t_steps, layout.chunk_len,
                            layout.comp_len, layout.tail_len, dev)
        merge_ctx = {
            "mask": torch.cat([slot_mask, raw_mask], dim=1),
            "slots_fn": functools.partial(BL.compressive_virtual_kv,
                                          index=index)}
    elif use_ccm and cfg.ccm.mode == "merge":
        raw_mask = M.intra_segment_causal(seg, comp)
        slot_mask = M.expand_slot_mask(M.merge_slot_mask(seg, layout.t_steps),
                                       layout.comp_len)
        merge_ctx = {
            "mask": torch.cat([slot_mask, raw_mask], dim=1),
            "slots_fn": functools.partial(
                M.merge_virtual_kv, comp_mask=layout.comp_mask,
                t_steps=layout.t_steps, comp_len=layout.comp_len,
                alpha=cfg.ccm.merge_alpha)}
    elif use_ccm:
        q_info = A.KeyInfo(idx=torch.arange(S, dtype=torch.int32, device=dev),
                           seg=seg, comp=comp)
        k_info = q_info
    else:
        q_info = k_info = A.plain_causal_info(S, device=dev)

    x = forward_hidden(params, cfg, x, q_info=q_info, k_info=k_info,
                       comp_gate=comp_gate, positions=pos,
                       merge_ctx=merge_ctx)
    if logits_slice is None:
        logits_slice = (S - layout.tail_len, layout.tail_len)
    start, length = logits_slice
    return lm_logits(params, cfg, x[:, start:start + length])
