"""Online inference: g_comp / g_update / memory-conditioned decoding
(port of ``repro/core/inference.py``, dense family).

Contexts c(t) are compressed into memory (never cached raw); inputs I(t)
are prefilled into a bounded KV cache attending [Mem(t), cache, I(t)];
decoding attends [Mem(t), cache, self].

The reference's ``lax.scan`` over layers is a Python loop here, and its
0-d counters are host ints (``KVCache.length``, ``MemState.slots/steps/
stream_pos``, ``OnlineState.pos``), so no step waits on the device for a
counter.  State tensors are updated IN PLACE (the cache window write, the
memory write): each function returns a new state tuple over the same
tensors, and a caller that needs an earlier state keeps a clone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import masks as M
from repro_torch.core.memory import MemState, init_memory, mem_layers, update_memory
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, Smax, Hkv, hd) — compute dtype or int8
    v: torch.Tensor
    length: int            # filled positions (keeps counting past Smax)
    k_scale: Optional[torch.Tensor] = None   # (L, B, Smax, Hkv) if int8
    v_scale: Optional[torch.Tensor] = None

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


class OnlineState(NamedTuple):
    cache: Optional[KVCache] = None
    mem: Optional[MemState] = None
    pos: int = 0           # virtual stream position


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


def init_online_state(cfg: ModelConfig, batch: int, max_cache_len: int,
                      mem_slots: Optional[int] = None,
                      device: DeviceLike = None) -> OnlineState:
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r}: the port covers 'dense'")
    dev = resolve_device(device)
    mem = init_memory(cfg, batch, mem_slots, device=dev) \
        if cfg.ccm.enabled else None
    return OnlineState(cache=init_cache(cfg, batch, max_cache_len, device=dev),
                       mem=mem, pos=0)


# ---------------------------------------------------------------------------
# attention over [mem | cache | self] for a block of new tokens
# ---------------------------------------------------------------------------

def _attend_online(cfg, q, k_new, v_new, self_info: A.KeyInfo,
                   q_info: A.KeyInfo, mem_kv=None, mem_valid=None,
                   cache_kv=None, cache_len=None, cache_scales=None,
                   cache_layer=None, impl=None):
    """q over [mem?, cache(:length)?, self] KV segments read IN PLACE;
    with ``cache_layer`` the stacked cache is read at that layer."""
    segs = []
    if mem_kv is not None:
        segs.append(A.KVSegment(k=mem_kv[0], v=mem_kv[1], length=mem_valid))
    if cache_kv is not None:
        ks, vs = cache_scales if cache_scales is not None else (None, None)
        segs.append(A.KVSegment(k=cache_kv[0], v=cache_kv[1],
                                length=cache_len, k_scale=ks, v_scale=vs,
                                layer=cache_layer))
    segs.append(A.KVSegment(k=k_new, v=v_new, info=self_info))
    return A.attend_segments(cfg, q, segs, q_info, impl=impl)


# ---------------------------------------------------------------------------
# attention-stack pass over new tokens (prefill / decode / compress)
# ---------------------------------------------------------------------------

def _attn_stack_pass(params, cfg: ModelConfig, x, positions, *,
                     comp_gate, q_info, self_info, state: OnlineState,
                     write_to_cache: bool, collect_comp: Optional[int],
                     impl=None):
    """Runs the dense layer stack over a block of new tokens.

    Returns (x, new_cache, comp_kv); comp_kv is the (L, B, m, Hkv, hd)
    pair of <COMP> keys/values when ``collect_comp`` (the first <COMP> row
    of the block; the group is its last m rows) is given.
    """
    cache, mem = state.cache, state.mem
    mem_valid = mem.valid_len(cfg.ccm.comp_len) if mem is not None else None
    quant = cache is not None and cache.quantized
    comp_k, comp_v = [], []
    for li in range(cfg.n_layers):
        lp = T.layer_params(params, li)
        hn = L.apply_norm(cfg, lp["ln1"], x)
        q, k_new, v_new = A.qkv_project(
            cfg, lp["attn"], hn, comp_gate,
            positions if cfg.pos_embed == "rope" else None)
        o = _attend_online(
            cfg, q, k_new, v_new, self_info, q_info,
            mem_kv=(mem.k[li], mem.v[li]) if mem is not None else None,
            mem_valid=mem_valid,
            cache_kv=(cache.k, cache.v) if cache is not None else None,
            cache_len=cache.length if cache is not None else None,
            cache_scales=(cache.k_scale, cache.v_scale) if quant else None,
            cache_layer=li if cache is not None else None, impl=impl)
        x = x + A.out_project(cfg, lp["attn"], o, comp_gate)
        hn = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], hn)
        if write_to_cache:
            at = cache.length
            if quant:
                qk, sk = quantize_kv(k_new)
                qv, sv = quantize_kv(v_new)
                M.layer_window_write(cache.k, qk, li, at)
                M.layer_window_write(cache.v, qv, li, at)
                M.layer_window_write(cache.k_scale, sk, li, at)
                M.layer_window_write(cache.v_scale, sv, li, at)
            else:
                M.layer_window_write(cache.k, k_new, li, at)
                M.layer_window_write(cache.v, v_new, li, at)
        if collect_comp is not None:
            comp_k.append(k_new[:, collect_comp:])
            comp_v.append(v_new[:, collect_comp:])

    new_cache = cache
    if write_to_cache and cache is not None:
        new_cache = cache._replace(length=cache.length + x.shape[1])
    comp_kv = (torch.stack(comp_k), torch.stack(comp_v)) \
        if collect_comp is not None else None
    return x, new_cache, comp_kv


# ---------------------------------------------------------------------------
# public online ops
# ---------------------------------------------------------------------------

def _self_info(idx: torch.Tensor, comp: torch.Tensor) -> A.KeyInfo:
    return A.KeyInfo(idx=idx, seg=torch.ones_like(idx), comp=comp)


def ingest_context(params, cfg: ModelConfig, state: OnlineState,
                   chunk_tokens: torch.Tensor) -> OnlineState:
    """Online step for a new context c(t): compress it (g_comp: the model
    runs over [c(t) | <COMP>^m] with the conditional LoRA firing at the
    <COMP> rows) and fold the <COMP> KV into memory (g_update).  The raw
    context KV is NOT cached.  The block attends [mem | cache | self]."""
    B, lc = chunk_tokens.shape
    m = cfg.ccm.comp_len
    dev = chunk_tokens.device
    S = lc + m
    ar = torch.arange(S, device=dev)
    comp_mask = ar >= lc
    comp_off = torch.clamp(ar - lc, min=0)
    tokens = torch.cat([chunk_tokens, chunk_tokens.new_zeros((B, m))], dim=1)
    positions = state.pos + ar
    x = T.embed_tokens(cfg, params, tokens, comp_mask, comp_off)
    comp_gate = comp_mask.to(cfg.cdtype)[None].expand(B, S)
    info = _self_info(ar.to(torch.int32), comp_mask)
    x, _, comp_kv = _attn_stack_pass(
        params, cfg, x, positions, comp_gate=comp_gate, q_info=info,
        self_info=info, state=state, write_to_cache=False, collect_comp=lc)
    new_mem = update_memory(cfg, state.mem, comp_kv[0], comp_kv[1], S)
    return state._replace(mem=new_mem, pos=state.pos + S)


def prefill(params, cfg: ModelConfig, state: OnlineState,
            tokens: torch.Tensor, impl: Optional[str] = None,
            full_logits: bool = False):
    """Process input I(t) attending [Mem(t), cache, self-causal]; its KV
    is cached.  Returns (logits, new_state) — last position only unless
    ``full_logits``."""
    B, S = tokens.shape
    ar = torch.arange(S, device=tokens.device)
    positions = state.pos + ar
    x = T.embed_tokens(cfg, params, tokens)
    info = _self_info(ar.to(torch.int32), torch.zeros_like(ar, dtype=torch.bool))
    x, new_cache, _ = _attn_stack_pass(
        params, cfg, x, positions, comp_gate=None, q_info=info,
        self_info=info, state=state, write_to_cache=True, collect_comp=None,
        impl=impl)
    logits = T.lm_logits(params, cfg, x if full_logits else x[:, -1:])
    return logits, state._replace(cache=new_cache, pos=state.pos + S)


def decode_step(params, cfg: ModelConfig, state: OnlineState,
                tokens: torch.Tensor, impl: Optional[str] = None):
    """One-token decode attending [Mem, cache, self]. tokens (B, 1).  The
    self keys carry index 2**30 + i, past every cached index."""
    B, S = tokens.shape
    ar = torch.arange(S, device=tokens.device)
    positions = state.pos + ar
    x = T.embed_tokens(cfg, params, tokens)
    info = _self_info((ar + 2 ** 30).to(torch.int32),
                      torch.zeros_like(ar, dtype=torch.bool))
    x, new_cache, _ = _attn_stack_pass(
        params, cfg, x, positions, comp_gate=None, q_info=info,
        self_info=info, state=state, write_to_cache=True, collect_comp=None,
        impl=impl)
    logits = T.lm_logits(params, cfg, x)
    return logits, state._replace(cache=new_cache, pos=state.pos + S)


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
