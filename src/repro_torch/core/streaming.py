"""Streaming inference: sliding window + attention sink + CCM (paper Fig. 9;
port of ``repro/core/streaming.py``).

StreamingLLM keeps [sink | recent window] and *drops* evicted tokens; CCM
instead *compresses* the evicted block into the compressed memory with a
forward pass of only the m <COMP> tokens attending [Mem, evicted-block KV]
(O(m) compute per eviction, reusing the KV already in the window).  When
the concat memory itself is full, the oldest <COMP> group is dropped
first (`core.memory.evict_oldest`).

Positions are the monotone virtual-stream ids, as in the reference.
With ``dist=`` (a mesh that splits the model, or a
`distributed.tensor_parallel.TensorParallel` rank) the params are the
rank's shard and the window and memory hold its KV heads
(``stream_state_pspecs``).
Every family but the recurrent ones streams; the encoder-decoder's
stream has no cross attention (the reference's stream state has no
cross K/V), and its chunks take learned positions through ``prefill``.

As in ``core.inference``, counters (``win_len``, ``pos`` and the memory's)
are host ints, or int64 numpy arrays (B,) with one value per lane, and
tensors are updated IN PLACE.  Since every counter is on the host, the
lanes whose window would overflow are known before any launch: an
eviction (the compression pass and the window shift) runs on exactly those
lanes, and every other lane's tensors and counters stay bit-exact.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import inference as I
from repro_torch.core.memory import (Counter, MemState, evict_oldest,
                                     init_memory, mem_layers, per_lane,
                                     recompress_memory, update_memory)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.models.config import ModelConfig, require_ported


class StreamState(NamedTuple):
    win_k: torch.Tensor     # (L, B, W, Hkv, hd); (B, L, W, ...) lane-major
    win_v: torch.Tensor
    win_len: Counter        # filled window rows
    mem: MemState
    pos: Counter            # virtual stream position
    lane_major: bool = False

    @property
    def batch(self) -> int:
        return self.win_k.shape[0 if self.lane_major else 1]


def init_stream_state(cfg: ModelConfig, batch: int,
                      device: DeviceLike = None) -> StreamState:
    require_ported(cfg)
    if cfg.has_mamba:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}): no streaming path in the "
            "reference (its compress_from_kv reads attention KV that "
            "Mamba2 layers lack)")
    dev = resolve_device(device)
    c = cfg.ccm
    shape = (max(mem_layers(cfg), 1), batch, c.stream_window,
             cfg.n_kv_heads, cfg.hd)
    return StreamState(
        win_k=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        win_v=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        win_len=0, mem=init_memory(cfg, batch, c.stream_mem_slots,
                                   device=dev),
        pos=0)


# ---------------------------------------------------------------------------
# compression from cached KV (no re-embedding of evicted tokens)
# ---------------------------------------------------------------------------

def compress_from_kv(params, cfg: ModelConfig, mem: MemState,
                     blk_k: torch.Tensor, blk_v: torch.Tensor,
                     pos0: Counter, impl: Optional[str] = None,
                     dist=None) -> MemState:
    """Run the m <COMP> tokens through the stack (the conditional LoRA on
    every row) attending [mem | block | self], then fold their KV into the
    memory (dropping the oldest group first on lanes whose memory is full).

    blk_k/blk_v: (L, B, cc, Hkv, hd), or (B, L, cc, ...) when ``mem`` is
    lane-major: the KV of the evicted tokens, read in place through its
    strides (a slice of the window needs no copy).  ``pos0``: the <COMP>
    rows' first stream position, shared or per lane.  The <COMP> rows
    take ``comp_embed`` alone (no learned position, no token), and the
    pass sees no cross K/V, as in the reference."""
    m = cfg.ccm.comp_len
    B = blk_k.shape[0 if mem.lane_major else 1]
    dev = blk_k.device
    tp = TPX.tp_of(cfg, dist)
    params = FS.view(params, cfg, dist)
    off = torch.arange(m, device=dev)
    x = params["comp_embed"].to(cfg.cdtype)[:m][None].expand(B, m, -1)
    info = I._self_info(off.to(torch.int32),
                        torch.ones(m, dtype=torch.bool, device=dev))
    block = I.KVCache(k=blk_k, v=blk_v, length=blk_k.shape[2],
                      lane_major=mem.lane_major)
    _, _, (hk, hv) = I._stack_pass(
        params, cfg, x.contiguous(), I._positions(pos0, off, B),
        comp_gate=torch.ones((B, m), dtype=cfg.cdtype, device=dev),
        q_info=info, self_info=info, state=I.OnlineState(cache=block, mem=mem),
        write_to_cache=False, collect_comp=0, impl=impl, tp=tp)
    full = np.asarray(mem.slots) >= mem.max_slots(m)
    if full.any():
        mem = evict_oldest(mem, m, None if full.all() else full)
    return update_memory(cfg, mem, hk, hv, m)


def _compress_lanes(params, cfg: ModelConfig, mem: MemState, blk_k, blk_v,
                    pos0: Counter, ids: np.ndarray, impl,
                    dist=None) -> MemState:
    """`compress_from_kv` on the lanes ``ids`` only: their memory and
    block rows are packed, compressed and written back in place."""
    B = blk_k.shape[0 if mem.lane_major else 1]
    ax = 0 if mem.lane_major else 1
    t = torch.as_tensor(ids, device=mem.k.device)
    names = ("slots", "steps", "stream_pos")
    sub = mem._replace(k=mem.k.index_select(ax, t),
                       v=mem.v.index_select(ax, t),
                       **{n: per_lane(getattr(mem, n), B)[ids] for n in names})
    sub = compress_from_kv(params, cfg, sub, blk_k.index_select(ax, t),
                           blk_v.index_select(ax, t), per_lane(pos0, B)[ids],
                           impl, dist)
    mem.k.index_copy_(ax, t, sub.k)
    mem.v.index_copy_(ax, t, sub.v)
    counters = {}
    for n in names:
        c = per_lane(getattr(mem, n), B)
        c[ids] = getattr(sub, n)
        counters[n] = c
    return mem._replace(**counters)


# ---------------------------------------------------------------------------
# streaming step
# ---------------------------------------------------------------------------

def _shift_window(x: torch.Tensor, sink: int, cc: int, lane_major: bool,
                  ids: Optional[np.ndarray]) -> None:
    """Move window rows [sink+cc, W) left by cc and zero the last cc rows,
    IN PLACE, on every lane (``ids`` None) or on lanes ``ids``.  Source and
    destination overlap, so the move copies front to back in blocks of at
    most cc rows, each block disjoint from its source."""
    views = [x] if ids is None else \
        [x[int(b)] if lane_major else x[:, int(b)] for b in ids]
    for v in views:
        ax = v.ndim - 3                          # (..., W, Hkv, hd)
        W = v.shape[ax]
        for j in range(sink, W - cc, cc):
            n = min(cc, W - cc - j)
            v.narrow(ax, j, n).copy_(v.narrow(ax, j + cc, n))
        v.narrow(ax, W - cc, cc).zero_()


def _evict_once(params, cfg: ModelConfig, s: StreamState, ccm_on: bool,
                impl: Optional[str], lanes=None, dist=None) -> StreamState:
    """One eviction on every lane, or on the (B,) bool ``lanes``: compress
    the block behind the sink into memory (ccm_on) or drop it (the
    StreamingLLM baseline), shift the window left by ``stream_chunk`` and
    advance the counters.  The block is read before the shift, and the
    compression takes ``pos0 = s.pos``; ``pos`` then advances by m (only
    when ccm_on) and ``win_len`` falls by cc."""
    c = cfg.ccm
    cc, sink = c.stream_chunk, c.stream_sink
    ids = None if lanes is None else np.flatnonzero(lanes)
    mem = s.mem
    if ccm_on:
        blk_k = s.win_k[:, :, sink:sink + cc]
        blk_v = s.win_v[:, :, sink:sink + cc]
        mem = compress_from_kv(params, cfg, mem, blk_k, blk_v, s.pos, impl,
                               dist) if ids is None else \
            _compress_lanes(params, cfg, mem, blk_k, blk_v, s.pos, ids, impl,
                            dist)
    for x in (s.win_k, s.win_v):
        _shift_window(x, sink, cc, s.lane_major, ids)
    if lanes is None:
        step = 1
    else:
        step = np.asarray(lanes, np.int64)
        win_len, pos = per_lane(s.win_len, s.batch), per_lane(s.pos, s.batch)
        s = s._replace(win_len=win_len, pos=pos)
    return s._replace(win_len=s.win_len - cc * step, mem=mem,
                      pos=s.pos + (c.comp_len * step if ccm_on else 0))


def eviction_pending(cfg: ModelConfig, st: StreamState,
                     incoming: Counter) -> np.ndarray:
    """Per-lane "compression pending" flag (a host bool, or (B,) bools for
    per-lane counters or lengths): would ingesting ``incoming`` real
    tokens overflow the window?  On ragged lanes ``incoming`` is the valid
    length, not the padded width."""
    return np.asarray(st.win_len + np.asarray(incoming, np.int64)) \
        > cfg.ccm.stream_window


def stream_step(params, cfg: ModelConfig, st: StreamState,
                chunk_tokens: torch.Tensor, ccm_on: bool = True,
                valid_len: Optional[Counter] = None,
                impl: Optional[str] = None, dist=None
                ) -> Tuple[torch.Tensor, StreamState]:
    """Process ``c`` new tokens (B, c): evict on the lanes whose window
    would overflow, then prefill the chunk into the window attending
    [Mem | sink + window | self] (no gate).  Returns per-token logits
    (B, c, V) and the state (its tensors written in place).

    ccm_on=False reproduces the StreamingLLM baseline (evict = drop), with
    the same KV budget (paper Fig. 8).

    ``valid_len`` (ragged lanes, an int or B ints): the chunk is padded up
    to a token bucket and only the first ``valid_len`` tokens are real.
    Pad tokens are masked out of attention, frozen out of the window
    write, and excluded from the counters and the eviction trigger.

    The layer loop is ``core.inference.prefill``'s, with the window as its
    KV cache.  ``dist``: as in ``core.inference.prefill`` (the logits are
    then the rank's vocabulary block); an ``ep`` MoE split keeps every
    assignment here (`tensor_parallel.dropless`), as the reference's
    stream step, whose MoE takes no ``dist``."""
    B, c = chunk_tokens.shape
    cc = cfg.ccm.stream_chunk
    sink = cfg.ccm.stream_sink
    W = cfg.ccm.stream_window
    # one eviction of cc tokens per step keeps the window bounded only if
    # the chunk is at most cc tokens and the block fits behind the sink
    if c > cc:
        raise ValueError(
            f"stream_step chunk ({c} tokens) exceeds stream_chunk ({cc}): "
            "one eviction per step cannot keep the window bounded; split "
            "the input into chunks of at most cfg.ccm.stream_chunk")
    if sink + cc > W:
        raise ValueError(
            f"stream_sink ({sink}) + stream_chunk ({cc}) exceeds "
            f"stream_window ({W}): the eviction block does not fit")
    dist = TPX.dropless(TPX.tp_of(cfg, dist))
    params = FS.view(params, cfg, dist)
    pending = eviction_pending(cfg, st, c if valid_len is None
                               else valid_len)
    if pending.any():
        st = _evict_once(params, cfg, st, ccm_on, impl,
                         None if pending.all() else pending, dist)
    window = I.KVCache(k=st.win_k, v=st.win_v, length=st.win_len,
                       lane_major=st.lane_major)
    logits, out = I.prefill(
        params, cfg, I.OnlineState(cache=window, mem=st.mem, pos=st.pos),
        chunk_tokens, impl=impl, full_logits=True, valid_len=valid_len,
        dist=dist)
    return logits, st._replace(win_len=out.cache.length, pos=out.pos)


# ---------------------------------------------------------------------------
# lane-batched streaming step (serve engine)
# ---------------------------------------------------------------------------

def stream_step_lanes(params, cfg: ModelConfig, st: StreamState,
                      chunk_tokens: torch.Tensor, lengths=None
                      ) -> Tuple[torch.Tensor, StreamState]:
    """Serve-batch streaming step over N lanes packed from independent
    sessions (lane-major tensors, per-lane counters: the arena-gather
    layout seen through `launch.serve.to_lanes`).  ``chunk_tokens`` is
    (N, 1, c) and ``lengths`` (N,) the ragged valid lengths (None: every
    lane's chunk is real).  Returns logits (N, 1, c, V) and the state.

    The reference gates a vmapped eviction on "any lane pending" and
    re-selects the other lanes' state.  Here the pending lanes are known
    on the host, so the compression and the window shift run on exactly
    those lanes (`stream_step`); the other lanes are never touched."""
    tk = chunk_tokens.reshape(chunk_tokens.shape[0], chunk_tokens.shape[-1])
    vl = None if lengths is None \
        else np.asarray(lengths, np.int64).reshape(-1)
    logits, st = stream_step(params, cfg, st, tk, valid_len=vl)
    return logits[:, None], st


def recompress_memory_lanes(cfg: ModelConfig, mem: MemState, group: int,
                            do) -> MemState:
    """Masked per-lane memory recompression over N lanes (the arena-gather
    layout: lane-major tensors, per-lane counters).

    ``do`` (N,) bool selects the lanes to recompress
    (`core.memory.recompress_memory` at ratio ``group``); the selected
    lanes are packed, recompressed and written back IN PLACE, so every
    other lane's tensors and counters stay bit-exact.  A batch with no
    selected lane returns ``mem`` untouched."""
    if not mem.lane_major:
        raise ValueError("recompress_memory_lanes takes lane-major memory")
    N = mem.k.shape[0]
    do = np.asarray(do, dtype=bool).reshape(N)
    if not do.any():
        return mem
    sel = torch.as_tensor(np.flatnonzero(do), device=mem.k.device)
    sub = MemState(k=mem.k[sel], v=mem.v[sel],
                   slots=per_lane(mem.slots, N)[do],
                   steps=per_lane(mem.steps, N)[do],
                   stream_pos=per_lane(mem.stream_pos, N)[do],
                   lane_major=True)
    sub = recompress_memory(cfg, sub, group)
    mem.k[sel] = sub.k
    mem.v[sel] = sub.v
    slots = per_lane(mem.slots, N)
    slots[do] = sub.slots
    return mem._replace(slots=slots)
