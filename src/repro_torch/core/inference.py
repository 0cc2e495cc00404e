"""Online inference: g_comp / g_update / memory-conditioned decoding
(port of ``repro/core/inference.py``; every family of the registry).

Contexts c(t) are compressed into memory (never cached raw); inputs I(t)
are prefilled into a bounded KV cache attending [Mem(t), cache, I(t)];
decoding attends [Mem(t), cache, self].

The reference's ``lax.scan`` over layers is a Python loop here, and its
0-d counters are host ints (``KVCache.length``, ``MemState.slots/steps/
stream_pos``, ``OnlineState.pos``), so no step waits on the device for a
counter.  State tensors are updated IN PLACE (the cache window write, the
memory write): each function returns a new state tuple over the same
tensors, and a caller that needs an earlier state keeps a clone.

Lanes: the reference serves a batch packed from independent sessions by
``jax.vmap`` over single-session ops.  The port batches such lanes
natively through the same functions: the state's counters are int64
numpy arrays (B,), one per lane (``core.memory.per_lane``), and its
tensors lane-major ((B, L, S, ...) with ``lane_major``), as the serve
arena packs them.  Every lane then has its own RoPE positions, cache and
memory lengths (per-lane kernel metadata) and write offsets.
``valid_len`` (an int or B ints) marks ragged lanes padded up to a token
bucket: pad tokens are masked out of attention and frozen out of every
state write, and the counters advance by the valid length only.

Recurrent families: Mamba2 layers (ssm, and the hybrid's backbone) carry
an ``SSMState`` of per-layer SSD and conv states in the compute dtype,
overwritten in place layer by layer ((B, L, ...) when lane-major).  The
ssm family has no cache and no memory; the hybrid keeps both at its
shared-attention sites (``mem_layers`` of them).  A recurrent update
cannot skip pad tokens, so ``valid_len`` raises for both, and a
non-decode block must be at most ``ssm_chunk`` tokens or a multiple of
it (the reference's SSD chunking).

The encoder-decoder (Whisper) decodes with ``OnlineState.cross``, the
per-layer cross K/V of ``encode_cross`` ((L, B, Se, Hkv, hd) each; None
skips the cross attention, as a state from ``init_online_state`` does
in the reference), and adds learned positions at every embed.  The VLM
(Pixtral) takes ``prefill(patches=)``.  MoE layers run the experts
(``models/moe.py``) where the others run the MLP.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import masks as M
from repro_torch.core.memory import (Counter, MemState, init_memory,
                                     mem_layers, per_lane, uniform,
                                     update_memory)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, require_ported


class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, Smax, Hkv, hd) — compute dtype or int8
    v: torch.Tensor        # ((B, L, Smax, ...) when lane_major)
    length: Counter        # filled positions (keeps counting past Smax)
    k_scale: Optional[torch.Tensor] = None   # (L, B, Smax, Hkv) if int8
    v_scale: Optional[torch.Tensor] = None
    lane_major: bool = False

    def layer(self, x: torch.Tensor, li: int) -> torch.Tensor:
        """Layer ``li`` of a cache leaf: (B, Smax, ...)."""
        return x[:, li] if self.lane_major else x[li]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv(x: torch.Tensor):
    """per-(token, head) symmetric int8: x (..., hd) -> (q, scale)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


class SSMState(NamedTuple):
    ssm: torch.Tensor      # (L, B, H, P, N) compute dtype
    conv: torch.Tensor     # (L, B, K-1, C); both (B, L, ...) lane-major
    lane_major: bool = False

    def layer(self, x: torch.Tensor, li: int) -> torch.Tensor:
        """Layer ``li`` of a state leaf: (B, ...)."""
        return x[:, li] if self.lane_major else x[li]


class OnlineState(NamedTuple):
    cache: Optional[KVCache] = None
    mem: Optional[MemState] = None
    ssm: Optional[SSMState] = None
    cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # encdec K/V
    pos: Counter = 0       # virtual stream position


# ---------------------------------------------------------------------------
# state init
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               n_layers: Optional[int] = None,
               device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    Lc = n_layers if n_layers is not None else mem_layers(cfg)
    shape = (max(Lc, 1), batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                       v=torch.zeros(shape, dtype=torch.int8, device=dev),
                       length=0,
                       k_scale=torch.zeros(shape[:-1], device=dev),
                       v_scale=torch.zeros(shape[:-1], device=dev))
    return KVCache(k=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                   length=0)


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: DeviceLike = None) -> SSMState:
    dev = resolve_device(device)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K, C = cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state
    Ls = cfg.n_layers
    return SSMState(
        ssm=torch.zeros((Ls, batch, H, P, N), dtype=cfg.cdtype, device=dev),
        conv=torch.zeros((Ls, batch, max(K - 1, 1), C), dtype=cfg.cdtype,
                         device=dev))


def init_online_state(cfg: ModelConfig, batch: int, max_cache_len: int,
                      mem_slots: Optional[int] = None,
                      device: DeviceLike = None) -> OnlineState:
    require_ported(cfg)
    dev = resolve_device(device)
    ssm = init_ssm_state(cfg, batch, dev) if cfg.has_mamba else None
    if cfg.family == "ssm":
        return OnlineState(ssm=ssm, pos=0)
    mem = init_memory(cfg, batch, mem_slots, device=dev) \
        if cfg.ccm.enabled else None
    return OnlineState(cache=init_cache(cfg, batch, max_cache_len, device=dev),
                       mem=mem, ssm=ssm, pos=0)


# ---------------------------------------------------------------------------
# attention over [mem | cache | self] for a block of new tokens
# ---------------------------------------------------------------------------

def _attend_online(cfg, q, k_new, v_new, self_info: A.KeyInfo,
                   q_info: A.KeyInfo, mem_kv=None, mem_valid=None,
                   cache_kv=None, cache_len=None, cache_scales=None,
                   cache_layer=None, cache_lane_major=False, impl=None):
    """q over [mem?, cache(:length)?, self] KV segments read IN PLACE;
    with ``cache_layer`` the stacked cache is read at that layer.  Lengths
    are host ints or per-lane (B,) int32 tensors."""
    segs = []
    if mem_kv is not None:
        segs.append(A.KVSegment(k=mem_kv[0], v=mem_kv[1], length=mem_valid))
    if cache_kv is not None:
        ks, vs = cache_scales if cache_scales is not None else (None, None)
        segs.append(A.KVSegment(k=cache_kv[0], v=cache_kv[1],
                                length=cache_len, k_scale=ks, v_scale=vs,
                                layer=cache_layer,
                                lane_major=cache_lane_major))
    segs.append(A.KVSegment(k=k_new, v=v_new, info=self_info))
    return A.attend_segments(cfg, q, segs, q_info, impl=impl)


# ---------------------------------------------------------------------------
# attention-stack pass over new tokens (prefill / decode / compress)
# ---------------------------------------------------------------------------

def _lane_len(c: Counter, B: int, dev):
    """Counter -> a host int when every lane shares it, else the (B,)
    int32 tensor of per-lane values the attention kernel reads."""
    u = uniform(c)
    if u is not None:
        return u
    return torch.as_tensor(per_lane(c, B), dtype=torch.int32, device=dev)


def _positions(pos: Counter, rel: torch.Tensor, B: int) -> torch.Tensor:
    """RoPE positions: ``pos`` + the block's relative offsets ``rel``
    ((S,) or (B, S)); (B, S) when the lanes differ."""
    u = uniform(pos)
    if u is not None:
        return rel + u
    p = torch.as_tensor(per_lane(pos, B), device=rel.device)
    return rel + p[:, None]


def _stack_pass(params, cfg: ModelConfig, x, positions, *, comp_gate,
                q_info, self_info, state: OnlineState, write_to_cache: bool,
                collect_comp: Optional[int], decode: bool = False,
                impl=None, valid_len=None):
    """Runs the layer stack (`transformer.layer_plan`) over a block of new
    tokens.

    Attention layers (dense, moe, encdec, vlm) and shared-attention sites
    (hybrid; site ``gi`` reads and writes cache and memory layer ``gi``)
    attend [mem | cache | self], then (encdec, with ``state.cross``) the
    layer's cross K/V; Mamba2 layers run on ``state.ssm`` (chunked SSD,
    or the recurrence when ``decode``) and overwrite its layer IN PLACE.
    Every plan starts with a Mamba2 layer where it has one, so a block
    the SSD chunking refuses raises before any state is written.
    Returns (x, new_cache, comp_kv); comp_kv is the (L, B, m, Hkv, hd)
    pair of <COMP> keys/values per attention layer when ``collect_comp``
    (the first <COMP> row of the block; the group is its last m rows) is
    given.  ``valid_len`` (ragged lanes): cache writes past it are frozen
    and the length counter advances by it instead of the padded block
    length.
    """
    cache, mem, ssm, cross = state.cache, state.mem, state.ssm, state.cross
    B, S = x.shape[:2]
    dev = x.device
    mem_valid = _lane_len(mem.valid_len(cfg.ccm.comp_len), B, dev) \
        if mem is not None else None
    quant = cache is not None and cache.quantized
    cache_len = _lane_len(cache.length, B, dev) if cache is not None \
        else None
    write = write_to_cache and cache is not None
    plan = M.plan_block_write(cache.length, S, cache.k.shape[2], valid_len,
                              device=dev) if write else None
    comp_k, comp_v = [], []
    for kind, li in T.layer_plan(cfg):
        if kind == "mamba":
            st = {"ssm": ssm.layer(ssm.ssm, li),
                  "conv": ssm.layer(ssm.conv, li)}
            x, new = T._mamba_block(cfg, T.layer_params(params, li), x, st,
                                    decode)
            st["ssm"].copy_(new["ssm"])
            st["conv"].copy_(new["conv"])
            continue
        lp = params["shared_attn"] if kind == "site" \
            else T.layer_params(params, li)
        hn = L.apply_norm(cfg, lp["ln1"], x)
        q, k_new, v_new = A.qkv_project(
            cfg, lp["attn"], hn, comp_gate,
            positions if cfg.pos_embed == "rope" else None)
        o = _attend_online(
            cfg, q, k_new, v_new, self_info, q_info,
            mem_kv=(mem.layer(mem.k, li), mem.layer(mem.v, li))
            if mem is not None else None,
            mem_valid=mem_valid,
            cache_kv=(cache.k, cache.v) if cache is not None else None,
            cache_len=cache_len,
            cache_scales=(cache.k_scale, cache.v_scale) if quant else None,
            cache_layer=li if cache is not None else None,
            cache_lane_major=cache is not None and cache.lane_major,
            impl=impl)
        x = x + A.out_project(cfg, lp["attn"], o, comp_gate)
        if cross is not None:
            x = T.cross_attend(cfg, lp, x, (cross[0][li], cross[1][li]))
        hn = L.apply_norm(cfg, lp["ln2"], x)
        x = x + T.ffn(cfg, lp, hn)
        if write:
            if quant:
                qk, sk = quantize_kv(k_new)
                qv, sv = quantize_kv(v_new)
                blocks = ((cache.k, qk), (cache.v, qv),
                          (cache.k_scale, sk), (cache.v_scale, sv))
            else:
                blocks = ((cache.k, k_new), (cache.v, v_new))
            for buf, blk in blocks:
                M.apply_block_write(cache.layer(buf, li), blk, plan)
        if collect_comp is not None:
            comp_k.append(k_new[:, collect_comp:])
            comp_v.append(v_new[:, collect_comp:])

    new_cache = cache
    if write:
        adv = S if valid_len is None else valid_len
        new_cache = cache._replace(length=cache.length + adv)
    comp_kv = (torch.stack(comp_k), torch.stack(comp_v)) \
        if collect_comp is not None else None
    return x, new_cache, comp_kv


def _no_ragged(cfg: ModelConfig, valid_len, what: str) -> None:
    if cfg.has_mamba and valid_len is not None:
        raise ValueError(
            f"ragged {what} (valid_len) unsupported for {cfg.family!r}: "
            "recurrent state updates cannot skip pad tokens")


# ---------------------------------------------------------------------------
# public online ops
# ---------------------------------------------------------------------------

def _embed_block(cfg: ModelConfig, params, tokens: torch.Tensor,
                 positions: torch.Tensor, comp_mask=None,
                 comp_offset=None) -> torch.Tensor:
    """Token embeddings, plus the learned positions where the config has
    them (``positions`` (S,) or (B, S))."""
    x = T.embed_tokens(cfg, params, tokens, comp_mask, comp_offset)
    if cfg.pos_embed == "learned":
        x = T.add_learned_pos(params["pos_embed"], x, positions)
    return x


def _self_info(idx: torch.Tensor, comp: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> A.KeyInfo:
    return A.KeyInfo(idx=idx, seg=torch.ones_like(idx), comp=comp,
                     valid=valid)


def _valid_lanes(valid_len, B: int, dev) -> torch.Tensor:
    """(B,) int64 tensor of per-lane valid lengths."""
    return torch.as_tensor(per_lane(valid_len, B), device=dev)


def ingest_context(params, cfg: ModelConfig, state: OnlineState,
                   chunk_tokens: torch.Tensor,
                   valid_len: Optional[Counter] = None) -> OnlineState:
    """Online step for a new context c(t): compress it (g_comp: the model
    runs over [c(t) | <COMP>^m] with the conditional LoRA firing at the
    <COMP> rows) and fold the <COMP> KV into memory (g_update).  The raw
    context KV is NOT cached.  The block attends [mem | cache | self].

    ``valid_len`` (ragged lanes): the chunk is padded up to a token bucket
    and only the first ``valid_len`` tokens of each lane are real.  Pad
    tokens are masked out of attention, the <COMP> group keeps the RoPE
    positions of the unpadded layout, and the counters advance by
    ``valid_len + m``: the state equals ingesting the unpadded chunk.

    The ssm family has no attention to compress: the context only runs
    through the Mamba2 layers and advances their state."""
    B, lc = chunk_tokens.shape
    _no_ragged(cfg, valid_len, "ingest")
    if cfg.family == "ssm":
        x = _embed_block(cfg, params, chunk_tokens, _positions(
            state.pos, torch.arange(lc, device=chunk_tokens.device), B))
        _stack_pass(params, cfg, x, None, comp_gate=None, q_info=None,
                    self_info=None, state=state, write_to_cache=False,
                    collect_comp=None)
        return state._replace(pos=state.pos + lc)
    m = cfg.ccm.comp_len
    dev = chunk_tokens.device
    S = lc + m
    ar = torch.arange(S, device=dev)
    comp_mask = ar >= lc
    comp_off = torch.clamp(ar - lc, min=0)
    tokens = torch.cat([chunk_tokens, chunk_tokens.new_zeros((B, m))], dim=1)
    if valid_len is None:
        rel, k_valid, consumed = ar, None, S
    else:
        # <COMP> tokens sit at padded rows [lc, S) but carry the unpadded
        # stream positions [vl, vl + m), as in training
        vl = _valid_lanes(valid_len, B, dev)
        rel = torch.where(comp_mask, vl[:, None] + (ar - lc), ar)
        k_valid = M.lane_valid(S, valid_len, tail_start=lc, device=dev)
        consumed = valid_len + m
    positions = _positions(state.pos, rel, B)
    x = _embed_block(cfg, params, tokens, positions, comp_mask, comp_off)
    comp_gate = comp_mask.to(cfg.cdtype)[None].expand(B, S)
    info = _self_info(ar.to(torch.int32), comp_mask, k_valid)
    x, _, comp_kv = _stack_pass(
        params, cfg, x, positions, comp_gate=comp_gate, q_info=info,
        self_info=info, state=state, write_to_cache=False, collect_comp=lc)
    new_mem = update_memory(cfg, state.mem, comp_kv[0], comp_kv[1], consumed)
    return state._replace(mem=new_mem, pos=state.pos + consumed)


def prefill(params, cfg: ModelConfig, state: OnlineState,
            tokens: torch.Tensor, impl: Optional[str] = None,
            full_logits: bool = False,
            valid_len: Optional[Counter] = None,
            patches: Optional[torch.Tensor] = None):
    """Process input I(t) attending [Mem(t), cache, self-causal]; its KV
    is cached.  Returns (logits, new_state) — last position only unless
    ``full_logits``.

    ``valid_len`` (ragged lanes): tokens beyond it are bucket padding —
    masked out of attention, frozen out of the KV cache and excluded from
    the counters.  Logits at pad positions are garbage, so a ragged call
    needs ``full_logits`` and the caller slices by its valid length.

    ``patches`` (vlm, (B, P, 1024)): projected patch embeddings replace
    the first P positions' token embeddings.  The block must hold them
    (P <= S; the reference's concatenation would change the block's
    length otherwise): a shorter block raises ValueError before any state
    is written."""
    B, S = tokens.shape
    _no_ragged(cfg, valid_len, "prefill")
    if patches is not None and patches.shape[1] > S:
        raise ValueError(
            f"prefill of {S} tokens with {patches.shape[1]} patches: the "
            f"block must hold the patch positions (n_frontend_tokens "
            f"{cfg.n_frontend_tokens}) and its text")
    if valid_len is not None and not full_logits:
        raise ValueError(
            "ragged prefill (valid_len) requires full_logits=True: the "
            "last padded position is masked; slice logits[:, :valid_len]")
    ar = torch.arange(S, device=tokens.device)
    positions = _positions(state.pos, ar, B)
    k_valid = None if valid_len is None \
        else M.lane_valid(S, valid_len, device=tokens.device)
    adv = S if valid_len is None else valid_len
    x = _embed_block(cfg, params, tokens, positions)
    if patches is not None:
        pe = T.patch_embed(cfg, params, patches)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    info = _self_info(ar.to(torch.int32),
                      torch.zeros_like(ar, dtype=torch.bool), k_valid)
    x, new_cache, _ = _stack_pass(
        params, cfg, x, positions, comp_gate=None, q_info=info,
        self_info=info, state=state, write_to_cache=True, collect_comp=None,
        impl=impl, valid_len=valid_len)
    logits = T.lm_logits(params, cfg, x if full_logits else x[:, -1:])
    return logits, state._replace(cache=new_cache, pos=state.pos + adv)


def decode_step(params, cfg: ModelConfig, state: OnlineState,
                tokens: torch.Tensor, impl: Optional[str] = None):
    """One-token decode attending [Mem, cache, self]. tokens (B, 1).  The
    self keys carry index 2**30 + i, past every cached index.  Mamba2
    layers take the per-token recurrence."""
    B, S = tokens.shape
    ar = torch.arange(S, device=tokens.device)
    positions = _positions(state.pos, ar, B)
    x = _embed_block(cfg, params, tokens, positions)
    info = _self_info((ar + 2 ** 30).to(torch.int32),
                      torch.zeros_like(ar, dtype=torch.bool))
    x, new_cache, _ = _stack_pass(
        params, cfg, x, positions, comp_gate=None, q_info=info,
        self_info=info, state=state, write_to_cache=True, collect_comp=None,
        decode=True, impl=impl)
    logits = T.lm_logits(params, cfg, x)
    return logits, state._replace(cache=new_cache, pos=state.pos + S)


def encode_cross(params, cfg: ModelConfig, frames: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whisper: run the encoder once over ``frames`` (B, Se, d) and
    project its output by every decoder layer's ``xattn``: the per-layer
    cross K/V, (L, B, Se, Hkv, hd) each, for ``OnlineState.cross``."""
    enc = T.encode(params, cfg, frames)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        xa = T.layer_params(params, li)["xattn"]
        # the weights alone (no biases), as the reference projects here
        _, k, v = A.qkv_project(cfg, {n: xa[n] for n in ("wq", "wk", "wv",
                                                         "wo")},
                                enc, None, None)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def generate(params, cfg: ModelConfig, state: OnlineState,
             prompt: torch.Tensor, max_new: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             impl: Optional[str] = None) -> torch.Tensor:
    """Greedy / temperature sampling: prefill ``prompt`` then decode.
    Returns (B, max_new) int32 tokens.  Temperature sampling draws from
    ``generator`` (a fresh one seeded with 0 on the logits' device when
    None)."""
    logits, state = prefill(params, cfg, state, prompt, impl=impl)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = [tok]
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=logits.device)
        generator.manual_seed(0)
    for _ in range(max_new - 1):
        lg, state = decode_step(params, cfg, state, tok[:, None], impl=impl)
        lg = lg[:, -1]
        if temperature > 0:
            probs = torch.softmax(lg.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        tok = nxt.to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)
