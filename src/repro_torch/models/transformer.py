"""Model assembly for every family of the registry (port of
``repro/models/transformer.py``: init, embeddings, the encoder, logits and
the CCM parallel training forward).

Params keep the reference tree: a nested dict with the same key paths and
the same stacked leading layer axis (``layers/attn/wq`` is (L, d, Hq*hd)).
The reference's ``lax.scan`` over layers is a Python loop over views of
the stacked leaves; ``cfg.remat`` becomes ``torch.utils.checkpoint`` per
layer when gradients are on (the reference's ``jax.checkpoint``).  The
hybrid runs ``n_layers // attn_every`` groups of Mamba2 layers, each
followed by the one shared attention block (``params["shared_attn"]``,
with its own conditional LoRA), then the remaining Mamba2 layers; CCM
acts at those shared-attention sites.  MoE layers (family ``moe``) hold
``moe`` (``models/moe.py``) where the others hold ``mlp``.  The
encoder-decoder (``encdec``, Whisper) adds learned positions, a
bidirectional encoder over precomputed frame embeddings (every key a
<COMP> key of segment 0 at index 0, so on the card it runs the CCM
flash-attention kernel) and a cross-attention branch in every decoder
block; the VLM (``vlm``, Pixtral) projects precomputed patch embeddings
(``frontend/proj``) into the first positions.
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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, require_ported

Params = Dict[str, Any]


def _init_block(gen, cfg: ModelConfig, device) -> Params:
    if cfg.has_mamba:
        return {"ln1": L.init_norm(cfg, cfg.d_model, device),
                "mamba": SSM.init_mamba(gen, cfg, cfg.d_model, device)}
    p = {"ln1": L.init_norm(cfg, cfg.d_model, device),
         "attn": A.init_attention(gen, cfg, device),
         "ln2": L.init_norm(cfg, cfg.d_model, device)}
    if cfg.family == "moe":
        p["moe"] = MOE.init_moe(gen, cfg, cfg.d_model, cfg.d_ff, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)
    return p


def _init_enc_block(gen, cfg: ModelConfig, device) -> Params:
    return {"ln1": L.init_norm(cfg, cfg.d_model, device),
            "attn": A.init_attention(gen, cfg, device, with_lora=False),
            "ln2": L.init_norm(cfg, cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)}


def _init_cross_block(gen, cfg: ModelConfig, device) -> Params:
    """Decoder block with cross attention (Whisper): no LoRA there."""
    p = _init_block(gen, cfg, device)
    p["ln_x"] = L.init_norm(cfg, cfg.d_model, device)
    p["xattn"] = A.init_attention(gen, cfg, device, with_lora=False)
    return p


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


def _stack(init_fn, n: int) -> Params:
    """``n`` layers from ``init_fn()``, one at a time into stacked
    buffers: no full-model temporaries (one layer gains the stacked axis
    as a view, with no copy)."""
    if n == 1:
        def lead(t):
            return {k: lead(v) if isinstance(v, dict) else v[None]
                    for k, v in t.items()}
        return lead(init_fn())
    for i in range(n):
        blk = init_fn()
        if i == 0:
            out = _empty_stack(blk, n)
        _copy_layer(out, blk, i)
        del blk
    return out


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: DeviceLike = None) -> Params:
    """Random weights with the reference init's distributions, drawn from
    a ``torch.Generator`` seeded with ``seed`` (the numbers differ from
    the reference's).  Runs on the card unless ``device="cpu"``."""
    require_ported(cfg)
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
    n_pos = max(cfg.max_pos, 2048)
    if cfg.pos_embed == "learned":
        p["pos_embed"] = L.embed_init(gen, n_pos, cfg.d_model, cfg.pdtype,
                                      dev)
    init_fn = _init_cross_block if cfg.family == "encdec" else _init_block
    p["layers"] = _stack(lambda: init_fn(gen, cfg, dev), cfg.n_layers)
    if cfg.family == "hybrid":
        p["shared_attn"] = {
            "ln1": L.init_norm(cfg, cfg.d_model, dev),
            "attn": A.init_attention(gen, cfg, dev),
            "ln2": L.init_norm(cfg, cfg.d_model, dev),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, dev)}
    if cfg.family == "encdec":
        p["encoder"] = {
            "layers": _stack(lambda: _init_enc_block(gen, cfg, dev),
                             cfg.n_enc_layers),
            "final_norm": L.init_norm(cfg, cfg.d_model, dev),
            "pos_embed": L.embed_init(gen, n_pos, cfg.d_model, cfg.pdtype,
                                      dev)}
    if cfg.family == "vlm":
        p["frontend"] = {"proj": L.dense_init(gen, 1024, cfg.d_model,
                                              cfg.pdtype, dev)}
    return p


def layer_params(params: Params, li: int) -> Params:
    """Views of layer ``li`` of the stacked ``params["layers"]`` tree."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[li]
    return pick(params["layers"])


def add_learned_pos(table: torch.Tensor, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """x + table[positions], positions ((S,) or (B, S)) clipped to the
    table, as the reference's ``_add_learned_pos``."""
    pe = table[positions.clamp(0, table.shape[0] - 1).long()]
    return x + pe.to(x.dtype)


def patch_embed(cfg: ModelConfig, params: Params,
                patches: torch.Tensor) -> torch.Tensor:
    """Precomputed patch embeddings (B, P, 1024) -> (B, P, d) through
    ``frontend/proj`` in the compute dtype."""
    return patches.to(cfg.cdtype) @ params["frontend"]["proj"].to(cfg.cdtype)


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

def cross_attend(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 cross) -> torch.Tensor:
    """The decoder block's cross-attention residual (no mask, no LoRA, no
    RoPE).  ``cross``: the encoder output (B, Se, d), projected here by
    this layer's ``xattn``, or its precomputed (xk, xv) pair."""
    h = L.apply_norm(cfg, lp["ln_x"], x)
    qx, _, _ = A.qkv_project(cfg, lp["xattn"], h, None, None)
    if isinstance(cross, tuple):
        xk, xv = cross
    else:
        _, xk, xv = A.qkv_project(cfg, lp["xattn"], cross, None, None)
    ox = A.attend_dense(qx, xk, xv, None, 1.0 / cfg.hd ** 0.5)
    return x + A.out_project(cfg, lp["xattn"], ox, None)


def ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward: the experts where the layer has them."""
    if "moe" in lp:
        return MOE.apply_moe(cfg, lp["moe"], h)
    return L.apply_mlp(cfg, lp["mlp"], h)


def _attn_mlp_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                    q_info, k_info, comp_gate, positions,
                    merge_ctx, cross=None) -> torch.Tensor:
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
    if cross is not None:
        x = cross_attend(cfg, lp, x, cross)
    h = L.apply_norm(cfg, lp["ln2"], x)
    return x + ffn(cfg, lp, h)


def _mamba_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 state=None, decode: bool = False):
    h = L.apply_norm(cfg, lp["ln1"], x)
    out, new_state = SSM.apply_mamba(cfg, lp["mamba"], h, state, decode)
    return x + out, new_state


def layer_plan(cfg: ModelConfig):
    """The stack's order as ("mamba", layer) and ("site", site) steps:
    every layer of the ssm family; for the hybrid, each group of
    ``attn_every`` Mamba2 layers followed by its shared-attention site,
    then the remainder.  Dense stacks are ("attn", layer) steps."""
    if cfg.family == "ssm":
        return [("mamba", li) for li in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        g = cfg.attn_every
        n_groups = cfg.n_layers // g
        plan = []
        for gi in range(n_groups):
            plan += [("mamba", gi * g + j) for j in range(g)]
            plan.append(("site", gi))
        return plan + [("mamba", li)
                       for li in range(n_groups * g, cfg.n_layers)]
    return [("attn", li) for li in range(cfg.n_layers)]


def forward_hidden(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                   q_info=None, k_info=None, comp_gate=None, positions=None,
                   merge_ctx=None, cross=None) -> torch.Tensor:
    """Run the decoder stack on embedded inputs x (B, S, d); ``cross``
    (the encoder output) feeds the cross attention of ``encdec``."""
    require_ported(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    attn = functools.partial(_attn_mlp_block, cfg, q_info=q_info,
                             k_info=k_info, comp_gate=comp_gate,
                             positions=positions, merge_ctx=merge_ctx,
                             cross=cross)
    for kind, i in layer_plan(cfg):
        if kind == "mamba":
            lp = layer_params(params, i)

            def body(h, lp=lp):
                return _mamba_block(cfg, lp, h)[0]
        else:
            body = functools.partial(
                attn, params["shared_attn"] if kind == "site"
                else layer_params(params, i))
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return x


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, Se, d) (the
    conv frontend runs upstream, as in the reference): learned positions,
    then bidirectional layers (every key a <COMP> key at index 0 of
    segment 0, which the CCM mask lets every query see), then the final
    norm."""
    enc = params["encoder"]
    S = frames.shape[1]
    dev = frames.device
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    x = add_learned_pos(enc["pos_embed"], frames.to(cfg.cdtype), pos)
    zero = torch.zeros(S, dtype=torch.int32, device=dev)
    info = A.KeyInfo(idx=zero, seg=zero,
                     comp=torch.ones(S, dtype=torch.bool, device=dev))
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(cfg.n_enc_layers):
        body = functools.partial(
            _attn_mlp_block, cfg, layer_params(enc, li), q_info=info,
            k_info=info, comp_gate=None, positions=None, merge_ctx=None)
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return L.apply_norm(cfg, enc["final_norm"], x)


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
                  frames: Optional[torch.Tensor] = None,
                  patches: Optional[torch.Tensor] = None,
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

    ``frames`` (encdec: the encoder's input, (B, Se, d)) and ``patches``
    (vlm: (B, P, 1024) patch embeddings, projected into the first P
    positions; <COMP> positions there keep their comp embedding when CCM
    is on), as the reference takes them.
    """
    dev = tokens.device
    S = layout.seq_len
    seg = layout.seg_ids.to(dev)
    comp = layout.comp_mask.to(dev)
    pos = layout.positions.to(dev)
    comp_off = M.comp_offset_array(layout.comp_mask).long().to(dev)
    use_ccm = cfg.ccm.enabled and not cfg.is_attention_free

    x = embed_tokens(cfg, params, tokens, comp if use_ccm else None,
                     comp_off)
    if cfg.pos_embed == "learned":
        x = add_learned_pos(params["pos_embed"], x, pos)
    if patches is not None:
        pe = patch_embed(cfg, params, patches)
        xp = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        x = torch.where(comp[None, :, None], x, xp) if cfg.ccm.enabled \
            else xp
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

    cross = encode(params, cfg, frames) if cfg.family == "encdec" else None
    x = forward_hidden(params, cfg, x, q_info=q_info, k_info=k_info,
                       comp_gate=comp_gate, positions=pos,
                       merge_ctx=merge_ctx, cross=cross)
    if logits_slice is None:
        logits_slice = (S - layout.tail_len, layout.tail_len)
    start, length = logits_slice
    return lm_logits(params, cfg, x[:, start:start + length])
