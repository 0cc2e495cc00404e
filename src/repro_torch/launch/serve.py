"""Multi-tenant session steps for the serve engine (port of
``repro/launch/serve.py``, the single-device arena steps).

The reference vmaps the single-session ops over a batch packed from many
independent sessions.  The port runs such a batch natively: the packed
state (arena layout: every tensor leaf ``(B,) + row``, every counter an
int64 array (B,)) is viewed lane-major with the inner batch axis folded
away (``to_lanes``), and ``core.inference`` carries one counter per lane
through the same layer loop a single session (B=1) takes.  The arena
gather and scatter are the hand-written ``session_gather`` /
``session_scatter`` kernels (``kernels/ops.py``) on the card.

Not ported here: the batched single-stream step builders, ``stream``
sessions (the streaming slice) and ``make_sharded_arena_step`` (the
multi-device slice).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import inference as I
from repro_torch.core import streaming as STR
from repro_torch.models.config import ModelConfig

# the state leaves each op writes; the arena step scatters only these
# (ingest never writes the KV cache, query never writes the memory)
_WRITES = {"ingest": ("mem", "pos"), "query": ("cache", "pos")}


def ragged_family(cfg: ModelConfig) -> bool:
    """Whether masked token lanes are supported: attention archs only —
    SSM/hybrid recurrent scans cannot skip pad tokens."""
    return cfg.family not in ("ssm", "hybrid")


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, L, 1, ...) -> (B, L, ...): drop the template's inner batch."""
    return x.reshape(x.shape[:2] + x.shape[3:])


def _unfold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:2] + (1,) + x.shape[2:])


def to_lanes(state: I.OnlineState) -> I.OnlineState:
    """Packed arena rows -> the lane-major lane state ``core.inference``
    takes (views of the same tensors, the same counter arrays)."""
    c, m = state.cache, state.mem
    cache = None if c is None else I.KVCache(
        k=_fold(c.k), v=_fold(c.v), length=c.length,
        k_scale=None if c.k_scale is None else _fold(c.k_scale),
        v_scale=None if c.v_scale is None else _fold(c.v_scale),
        lane_major=True)
    mem = None if m is None else m._replace(k=_fold(m.k), v=_fold(m.v),
                                            lane_major=True)
    return state._replace(cache=cache, mem=mem)


def from_lanes(state: I.OnlineState) -> I.OnlineState:
    """The inverse of `to_lanes` (views again)."""
    c, m = state.cache, state.mem
    cache = None if c is None else I.KVCache(
        k=_unfold(c.k), v=_unfold(c.v), length=c.length,
        k_scale=None if c.k_scale is None else _unfold(c.k_scale),
        v_scale=None if c.v_scale is None else _unfold(c.v_scale))
    mem = None if m is None else m._replace(k=_unfold(m.k), v=_unfold(m.v),
                                            lane_major=False)
    return state._replace(cache=cache, mem=mem)


def session_vmap(cfg: ModelConfig, op: str, ragged: bool = False) -> Callable:
    """Lane-batched session op over packed arena rows:
    (params, state (B, ...), tokens (B, 1, l), lengths (B,)).

    'ingest' -> state; 'query' -> (logits (B, 1, l, V), state).  Query is
    a prefill of I(t) over [Mem, cache, self] with per-token logits.  The
    returned state shares the input's tensors (written in place).

    ``ragged``: each lane's tokens are padded up to a shared token bucket
    and ``lengths`` carries the per-lane valid lengths; pad tokens are
    masked out of attention and frozen out of every state write, so a
    padded lane equals the request run unpadded.  With ``ragged=False``
    the lengths are ignored (exact-length batches)."""
    if ragged and not ragged_family(cfg):
        raise ValueError(
            f"ragged session batching unsupported for family {cfg.family!r}")
    if op == "stream":
        raise NotImplementedError(
            "stream sessions come with the streaming slice of the port")
    if op not in _WRITES:
        raise ValueError(f"unknown session op {op!r}")

    def fn(params, state, tokens, lengths):
        lanes = to_lanes(state)
        dev = lanes.cache.k.device
        tk = torch.as_tensor(np.asarray(tokens), device=dev)
        tk = tk.reshape(tk.shape[0], tk.shape[-1])
        vl = np.asarray(lengths, np.int64).reshape(-1) if ragged else None
        if op == "ingest":
            return from_lanes(I.ingest_context(params, cfg, lanes, tk,
                                               valid_len=vl))
        logits, new = I.prefill(params, cfg, lanes, tk, full_logits=True,
                                valid_len=vl)
        return logits[:, None], from_lanes(new)
    return fn


def make_arena_step(cfg: ModelConfig, op: str,
                    ragged: bool = False) -> Callable:
    """Arena step:
    (params, slabs, ids (B,), tokens (B,1,l), lengths (B,)) ->
    (logits-or-None, slabs).

    ``slabs`` is the arena's state tree (`serve.arena`); ``ids`` the
    batch's B slot rows as host ints (the scratch row for pad lanes);
    ``tokens`` the (B, 1, token_len) bucket-padded lanes and ``lengths``
    the per-lane valid lengths.  'query' returns logits
    (B, 1, token_len, V); rows past a lane's valid length are masked-lane
    garbage the engine slices off.

    The batch's rows are gathered (``session_gather`` kernel), the op
    runs on the packed lanes, and only the leaves the op wrote are
    scattered back (``session_scatter`` kernel) into the same slabs."""
    from repro_torch.serve.arena import gather_rows, scatter_rows
    vf = session_vmap(cfg, op, ragged)
    writes = _WRITES[op]

    def fn(params, slabs, ids, tokens, lengths):
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        state = gather_rows(slabs, ids)
        if op == "ingest":
            out, new = None, vf(params, state, tokens, lengths)
        else:
            out, new = vf(params, state, tokens, lengths)
        for name in writes:
            if name == "pos":
                slabs.pos[ids] = np.asarray(new.pos)
            else:
                scatter_rows(getattr(slabs, name), ids, getattr(new, name))
        return out, slabs
    return fn


def recompress_arena_slots(mem_slabs, ids, cfg: ModelConfig, group: int):
    """Arena-resident memory recompression: gather the ``ids`` rows of
    the slabs' `MemState` subtree, collapse every ``group`` consecutive
    filled <COMP> groups per lane (`core.memory.recompress_memory`,
    masked per lane via `streaming.recompress_memory_lanes`), and scatter
    the shrunk memories back.  No model parameters are touched.  Lanes
    whose memory would not shrink (fewer than two filled groups, or pad
    lanes on the scratch row) are left bit-exact.  Returns ``mem_slabs``
    (updated in place)."""
    from repro_torch.serve.arena import gather_rows, scatter_rows
    ids = [int(i) for i in np.asarray(ids).reshape(-1)]
    mem = gather_rows(mem_slabs, ids)
    lanes = mem._replace(k=_fold(mem.k), v=_fold(mem.v), lane_major=True)
    # shrink only when it frees at least one group: ceil(g/r) < g
    do = -(-lanes.slots // group) < lanes.slots
    new = STR.recompress_memory_lanes(cfg, lanes, group, do)
    new = new._replace(k=_unfold(new.k), v=_unfold(new.v), lane_major=False)
    return scatter_rows(mem_slabs, ids, new)


def cow_clone_slots(slabs, src_ids, dst_ids):
    """Copy-on-write break: clone the ``src_ids`` rows of every slab leaf
    into the freshly allocated ``dst_ids`` rows.  The slabs are updated in
    place, so EVERY source row is gathered before any destination is
    written (a destination may be another pair's source).  Returns
    ``slabs``.  The only sanctioned way to make a shared row writable."""
    from repro_torch.serve.arena import gather_rows, scatter_rows
    rows = gather_rows(slabs, [int(i) for i in np.asarray(src_ids)])
    return scatter_rows(slabs, [int(i) for i in np.asarray(dst_ids)], rows)


def make_null_step(cfg: ModelConfig, op: str, ragged: bool = False
                   ) -> Callable:
    """Control-plane-only arena step with `make_arena_step`'s call
    contract but NO model compute: zero logits of the contract shape and
    the slabs untouched (for driving the scheduler, arena, session and
    admission objects through long traces)."""
    del ragged

    def fn(params, slabs, ids, tokens, lengths):
        del params, ids, lengths
        if op == "ingest":
            return None, slabs
        B, _, L = np.asarray(tokens).shape
        return np.zeros((B, 1, L, cfg.vocab_size), np.float32), slabs
    return fn
