"""Serving step builders (port of ``repro/launch/serve.py``): the
single-batch online steps (prefill, decode, ingest, stream), on one
device or with ``dist=`` over a ``(data, model)`` mesh, and the
multi-tenant arena steps, on one device or one arena shard per device of
a session mesh.

The reference vmaps the single-session ops over a batch packed from many
independent sessions.  The port runs such a batch natively: the packed
state (arena layout: every tensor leaf ``(B,) + row``, every counter an
int64 array (B,)) is viewed lane-major with the inner batch axis folded
away (``to_lanes``), and ``core.inference`` carries one counter per lane
through the same layer loop a single session (B=1) takes.  The arena
gather and scatter are the hand-written ``session_gather`` /
``session_scatter`` kernels (``kernels/ops.py``) on the card.

Session ops: ``ingest`` and ``query`` over ``OnlineState`` rows,
``stream`` over ``StreamState`` rows (`core.streaming.stream_step_lanes`:
the eviction runs on the lanes whose window overflows, and on no other).

``make_sharded_arena_step`` runs the arena step per shard of a session
mesh (`launch.mesh.make_session_mesh`): shard ``s``'s gather -> op ->
scatter on its own row block, with its own replica of the params, on
mesh device ``s``; no tensor crosses devices.

``dist=`` builders (``make_prefill_step``, ``make_decode_step``,
``make_ingest_step``, ``make_stream_step``): the reference jits the op
with in/out shardings from ``serve_specs`` and GSPMD splits the model.
Here each rank runs the op on its shards (`ShardedStep`), with the model
split over the ``model`` axis by `distributed.tensor_parallel` (every
family) and the batch over the data axes; logits come
back as the rank's rows and vocabulary block, as the reference's
``logit_spec`` lays them out (``ShardedStep.gather_logits`` gives the
whole).  With ``batch_sharded=False`` every data rank holds the whole
batch, and an ``ep`` MoE reckons its capacity per block of ``B S /
n_data`` rows, as the reference's ``shard_map`` splits them
(`tensor_parallel.replicated_rows`).  With ``shard_cache_seq=True`` the
cache's sequence lies over the data axes; with the batch split over
them too, each op gathers the rows of the tokens and of the batch-split
state leaves, runs on the whole batch and keeps its own (`DataRows`).
Under ZeRO-3
(``sharding_strategy="fsdp"``) ``place`` stores the params by
``param_spec`` (`distributed.fsdp`), and the op gathers each layer's
leaves and cuts them to the tensor-parallel local layout as it runs:
the states keep their specs, which split KV heads over the model axis
whatever the strategy.  Without ``dist`` a builder returns the op
itself (no jit).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import inference as I
from repro_torch.core import streaming as STR
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.distributed.context import DistContext, divisible
from repro_torch.models.config import ModelConfig

# the state leaves each op writes; the arena step scatters only these
# (ingest never writes the KV cache, query never writes the memory; both
# advance the Mamba2 states of the recurrent families, None elsewhere)
_WRITES = {"ingest": ("mem", "ssm", "pos"), "query": ("cache", "ssm", "pos"),
           "stream": ("win_k", "win_v", "win_len", "mem", "pos")}


def ragged_family(cfg: ModelConfig) -> bool:
    """Whether masked token lanes are supported: attention archs only —
    SSM/hybrid recurrent scans cannot skip pad tokens."""
    return not cfg.has_mamba


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, L, 1, ...) -> (B, L, ...): drop the template's inner batch."""
    return x.reshape(x.shape[:2] + x.shape[3:])


def _unfold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:2] + (1,) + x.shape[2:])


def to_lanes(state):
    """Packed arena rows (``OnlineState`` or ``StreamState``) -> the
    lane-major lane state ``core.inference`` / ``core.streaming`` take
    (views of the same tensors, the same counter arrays)."""
    m = state.mem
    mem = None if m is None else m._replace(k=_fold(m.k), v=_fold(m.v),
                                            lane_major=True)
    if isinstance(state, STR.StreamState):
        return state._replace(win_k=_fold(state.win_k),
                              win_v=_fold(state.win_v), mem=mem,
                              lane_major=True)
    c, r = state.cache, state.ssm
    cache = None if c is None else I.KVCache(
        k=_fold(c.k), v=_fold(c.v), length=c.length,
        k_scale=None if c.k_scale is None else _fold(c.k_scale),
        v_scale=None if c.v_scale is None else _fold(c.v_scale),
        lane_major=True)
    ssm = None if r is None else I.SSMState(
        ssm=_fold(r.ssm), conv=_fold(r.conv), lane_major=True)
    return state._replace(cache=cache, mem=mem, ssm=ssm)


def from_lanes(state):
    """The inverse of `to_lanes` (views again)."""
    m = state.mem
    mem = None if m is None else m._replace(k=_unfold(m.k), v=_unfold(m.v),
                                            lane_major=False)
    if isinstance(state, STR.StreamState):
        return state._replace(win_k=_unfold(state.win_k),
                              win_v=_unfold(state.win_v), mem=mem,
                              lane_major=False)
    c, r = state.cache, state.ssm
    cache = None if c is None else I.KVCache(
        k=_unfold(c.k), v=_unfold(c.v), length=c.length,
        k_scale=None if c.k_scale is None else _unfold(c.k_scale),
        v_scale=None if c.v_scale is None else _unfold(c.v_scale))
    ssm = None if r is None else I.SSMState(ssm=_unfold(r.ssm),
                                            conv=_unfold(r.conv))
    return state._replace(cache=cache, mem=mem, ssm=ssm)


def serve_specs(cfg: ModelConfig, dist: DistContext, *,
                batch_sharded: bool = True, shard_cache_seq: bool = False):
    """(the online state's spec tree, the tokens' spec), as the
    reference's."""
    state_specs = SH.online_state_pspecs(
        cfg, dist, batch_sharded=batch_sharded,
        shard_cache_seq=shard_cache_seq)
    tok_spec = SH.P(dist.batch_axes if batch_sharded else None, None)
    return state_specs, tok_spec


class ShardedStep:
    """The port's counterpart of the reference's ``_jit_with_specs``: an
    online op run by every rank on its shards, with ``dist``.

    ``place(params, state)`` cuts the whole params (``fsdp.shard_model``:
    the tensor-parallel local layout, or the ZeRO-3 blocks under
    ``fsdp``) and the whole state (by the state specs:
    ``online_state_pspecs`` / ``stream_state_pspecs``) into this rank's
    shards; the call takes them, the GLOBAL tokens (cut to the rank's
    rows by the tokens' spec) and returns the rank's logits (its rows,
    its vocabulary block) and state.  A tensor argument after the tokens
    (a prefill's ``patches``) is cut to the rank's rows as the tokens
    are.  The reference's jit re-places its arguments at every call; the
    port's ops write the state in place, so it is placed once and passed
    back as it comes out.  The ``ssm`` state is cut by the batch alone,
    ``cross`` by the batch and the KV heads (``online_state_pspecs``).
    ``gather_state`` / ``gather_logits`` give the whole (collectives:
    every rank calls them)."""

    def __init__(self, fn: Callable, cfg: ModelConfig, dist: DistContext,
                 state_specs, tok_spec):
        self.fn, self.cfg, self.dist = fn, cfg, dist
        self.state_specs, self.tok_spec = state_specs, tok_spec
        vocab = dist.model_axis \
            if divisible(cfg.vocab_size, dist.n_model) else None
        self.logit_spec = SH.P(tok_spec[0], None, vocab)

    def __call__(self, params, state, tokens, *args, **kw):
        kw = {k: self._rows(v) for k, v in kw.items()}
        return self.fn(params, state, *self.rows(tokens, *args), **kw)

    def rows(self, tokens, *args) -> tuple:
        """This rank's rows of the global tokens and of each tensor
        argument after them, as a call cuts them."""
        return (TPX.shard_by_spec(tokens, self.tok_spec, self.dist),) \
            + tuple(self._rows(a) for a in args)

    def _rows(self, x):
        if not isinstance(x, torch.Tensor):
            return x
        return TPX.shard_by_spec(x, SH.P(self.tok_spec[0]), self.dist)

    def place(self, params, state):
        return (FS.shard_model(params, self.cfg, self.dist),
                TPX.map_by_spec(lambda x, sp: TPX.shard_by_spec(
                    x, sp, self.dist), state, self.state_specs))

    def gather_state(self, state):
        return TPX.map_by_spec(lambda x, sp: TPX.gather_by_spec(
            x, sp, self.dist), state, self.state_specs)

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return TPX.gather_by_spec(logits, self.logit_spec, self.dist)


def _with_specs(fn: Callable, cfg: ModelConfig, dist: DistContext,
                batch_sharded: bool = True, shard_cache_seq: bool = False,
                params_shapes=None) -> ShardedStep:
    del params_shapes        # the layout is a function of (cfg, mesh)
    TPX.require_tp_family(cfg, dist.n_model)
    state_specs, tok_spec = serve_specs(cfg, dist,
                                        batch_sharded=batch_sharded,
                                        shard_cache_seq=shard_cache_seq)
    return ShardedStep(fn, cfg, dist, state_specs, tok_spec)


class DataRows:
    """The sequence-sharded cache with the batch split
    (``shard_cache_seq=True, batch_sharded=True``): the data axes hold
    the cache's sequence blocks, and the rows of the tokens, of the
    memory's k/v and of the ``ssm`` and ``cross`` leaves
    (``online_state_pspecs``).  ``run`` gathers those rows over the data
    axes, runs the op on the whole batch as ``batch_sharded=False`` runs
    it, and keeps this rank's rows of its logits and of those leaves; the
    cache's blocks and the counters pass as they are.  ``coll``: the
    collectives over the data axes (``n`` ranks, this one ``rank``);
    ``specs``: the state's spec tree (``online_state_pspecs``)."""

    def __init__(self, coll, rank: int, n: int, specs):
        self.coll, self.rank, self.n, self.specs = coll, rank, n, specs

    @classmethod
    def of(cls, cfg: ModelConfig, dist: DistContext) -> "DataRows":
        axes = dist.batch_axes
        return cls(TPX.axis_collectives(dist, axes), dist.rank_in(axes),
                   dist.n_data, SH.online_state_pspecs(
                       cfg, dist, batch_sharded=True, shard_cache_seq=True))

    def _state(self, state, fn):
        """``fn(x, dim)`` on each leaf whose spec splits its batch dim."""
        return TPX.map_by_spec(
            lambda x, sp: fn(x, 1) if sp is not None and len(sp) > 1
            and sp[1] is not None else x, state, self.specs)

    def whole(self, x, dim: int = 0):
        return x if x is None else self.coll.gather(x, dim)

    def mine(self, x, dim: int = 0):
        return TPX._block(x, dim, self.n, self.rank)

    def run(self, op: Callable, state, tokens, *extra):
        """``op(state, tokens, *extra)`` (a state, or (logits, state)) on
        the gathered rows; ``extra`` are row tensors (or None)."""
        out = op(self._state(state, self.whole), self.whole(tokens),
                 *[self.whole(x) for x in extra])
        if isinstance(out, I.OnlineState):
            return self._state(out, self.mine)
        return self.mine(out[0]), self._state(out[1], self.mine)


def _op_dists(cfg: ModelConfig, dist: Optional[DistContext],
              spec_kw) -> Callable:
    """A builder's () -> (the ``dist`` its op runs with, the sequence-
    sharded cache's `core.inference.SeqShard` or None, the `DataRows`
    that gather the batch or None), taken at the step's first call: the
    model axis's and the data axes' groups are collectives every rank
    joins there.  Where every data rank holds the whole batch the op runs
    with `tensor_parallel.replicated_rows`.

    ``shard_cache_seq=True`` splits the cache's sequence over the data
    axes.  With ``batch_sharded=False`` every data rank holds the whole
    batch; with ``batch_sharded=True`` the rows of the tokens and the
    memory lie over the same axes, and the op gathers them (`DataRows`),
    as the reference's GSPMD does under its specs."""
    if dist is None:
        return lambda: (None, None, None)
    rows = spec_kw.get("batch_sharded", True)
    seq = spec_kw.get("shard_cache_seq", False)
    got = []

    def get():
        if not got:
            got.append((dist if rows and not seq
                        else TPX.replicated_rows(cfg, dist),
                        I.SeqShard.of(dist, seq),
                        DataRows.of(cfg, dist) if rows and seq else None))
        return got[0]
    return get


def _on_rows(rows: Optional[DataRows], op: Callable, state, tokens, *extra):
    return op(state, tokens, *extra) if rows is None \
        else rows.run(op, state, tokens, *extra)


def make_prefill_step(cfg: ModelConfig, dist: Optional[DistContext] = None,
                      impl: Optional[str] = None, **spec_kw) -> Callable:
    """(params, state, tokens, patches=None) -> (logits, state):
    ``core.inference.prefill`` (last-position logits).  With
    ``shard_cache_seq=True`` the prefill over the sequence-sharded cache
    (``prefill(seq_shard=)``), on the whole batch (gathered over the data
    axes where ``batch_sharded=True``, `DataRows`)."""
    dists = _op_dists(cfg, dist, spec_kw)

    def fn(params, state, tokens, patches=None):
        op, seq, rows = dists()
        return _on_rows(rows, lambda st, tk, pt: I.prefill(
            params, cfg, st, tk, impl=impl, patches=pt, dist=op,
            seq_shard=seq), state, tokens, patches)

    if dist is None:
        return fn
    return _with_specs(fn, cfg, dist, **spec_kw)


def make_decode_step(cfg: ModelConfig, dist: Optional[DistContext] = None,
                     **spec_kw) -> Callable:
    """(params, state, tokens (B, 1)) -> (logits, state).  With
    ``shard_cache_seq=True`` (the reference's long-context cell) the
    sequence-sharded decode (``core.inference.decode_step(seq_shard=)``),
    on the whole batch as in `make_prefill_step`."""
    dists = _op_dists(cfg, dist, spec_kw)

    def fn(params, state, tokens):
        op, seq, rows = dists()
        return _on_rows(rows, lambda st, tk: I.decode_step(
            params, cfg, st, tk, dist=op, seq_shard=seq), state, tokens)

    if dist is None:
        return fn
    return _with_specs(fn, cfg, dist, **spec_kw)


def make_ingest_step(cfg: ModelConfig, dist: Optional[DistContext] = None,
                     **spec_kw) -> Callable:
    """(params, state, tokens) -> state: ``core.inference.ingest_context``
    (over the sequence-sharded cache with ``shard_cache_seq=True``, on
    the whole batch as in `make_prefill_step`)."""
    dists = _op_dists(cfg, dist, spec_kw)

    def fn(params, state, tokens):
        op, seq, rows = dists()
        return _on_rows(rows, lambda st, tk: I.ingest_context(
            params, cfg, st, tk, dist=op, seq_shard=seq), state, tokens)

    if dist is None:
        return fn
    return _with_specs(fn, cfg, dist, **spec_kw)


def make_stream_step(cfg: ModelConfig, dist: Optional[DistContext] = None,
                     batch_sharded: bool = True) -> Callable:
    """Single-batch streaming step: (params, st, tokens (B, c)) ->
    (logits (B, c, V), st), one user stream per batch (shared counters).
    With ``dist``: a `ShardedStep` over ``stream_state_pspecs`` (the
    window's and the memory's KV heads on the model axis); the
    encoder-decoder and the VLM stream as text-only decoders, as on one
    device."""
    def fn(params, st, tokens):
        return STR.stream_step(params, cfg, st, tokens, dist=dist)

    if dist is None:
        return fn
    TPX.require_tp_family(cfg, dist.n_model)
    tok = SH.P(dist.batch_axes if batch_sharded else None, None)
    return ShardedStep(fn, cfg, dist,
                       SH.stream_state_pspecs(cfg, dist, batch_sharded), tok)


def session_vmap(cfg: ModelConfig, op: str, ragged: bool = False) -> Callable:
    """Lane-batched session op over packed arena rows:
    (params, state (B, ...), tokens (B, 1, l), lengths (B,)).

    'ingest' -> state; 'query' / 'stream' -> (logits (B, 1, l, V), state).
    Query is a prefill of I(t) over [Mem, cache, self] with per-token
    logits; stream is `core.streaming.stream_step_lanes` (eviction on the
    lanes whose window overflows, then the chunk into the window).  The
    returned state shares the input's tensors (written in place).

    ``ragged``: each lane's tokens are padded up to a shared token bucket
    and ``lengths`` carries the per-lane valid lengths; pad tokens are
    masked out of attention and frozen out of every state write, so a
    padded lane equals the request run unpadded.  With ``ragged=False``
    the lengths are ignored (exact-length batches)."""
    if ragged and not ragged_family(cfg):
        raise ValueError(
            f"ragged session batching unsupported for family {cfg.family!r}")
    if op not in _WRITES:
        raise ValueError(f"unknown session op {op!r}")

    def fn(params, state, tokens, lengths):
        lanes = to_lanes(state)
        dev = params["embed"].device
        tk = torch.as_tensor(np.asarray(tokens), device=dev)
        vl = np.asarray(lengths, np.int64).reshape(-1) if ragged else None
        if op == "stream":
            logits, new = STR.stream_step_lanes(params, cfg, lanes, tk,
                                                lengths=vl)
            return logits, from_lanes(new)
        tk = tk.reshape(tk.shape[0], tk.shape[-1])
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
    scattered back (``session_scatter`` kernel) into the same slabs.  On
    a placed arena (`serve.arena.ShardedSlabs`) the ids must lie in one
    shard, whose row block the step reads and writes."""
    from repro_torch.serve.arena import gather_rows, route, scatter_rows
    vf = session_vmap(cfg, op, ragged)
    writes = _WRITES[op]

    def fn(params, slabs, ids, tokens, lengths):
        rows, ids = route(slabs, np.asarray(ids).reshape(-1))
        state = gather_rows(rows, ids)
        if op == "ingest":
            out, new = None, vf(params, state, tokens, lengths)
        else:
            out, new = vf(params, state, tokens, lengths)
        for name in writes:
            scatter_rows(getattr(rows, name), ids, getattr(new, name))
        return out, slabs
    return fn


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (the kernels launch on the
    current device's stream); nothing to do on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def replicate_params(params, devices: Sequence[torch.device]) -> List:
    """One copy of ``params`` per device (the same tensors wherever a leaf
    already lives on that device)."""
    from repro_torch.optim.partition import tree_map
    return [tree_map(lambda _, x: x if x is None or x.device == dev
                     else x.to(dev), params) for dev in devices]


def make_sharded_arena_step(cfg: ModelConfig, op: str, mesh,
                            ragged: bool = False) -> Callable:
    """`make_arena_step` partitioned over the SESSION axis: one arena
    shard (contiguous row block, `serve.arena`) per device of the 1-D
    ``mesh`` (axis ``"shards"``, `launch.mesh.make_session_mesh`).

    Call contract:
    (params, slabs, ids (S, B), tokens (S, B, 1, l), lengths (S, B)) ->
    (S per-shard logits (B, 1, l, V), each on its shard's device, or None
    for ingest; slabs).

    ``slabs`` are the arena's `ShardedSlabs` (shard ``s``'s block on
    ``mesh.devices[s]``); ``ids`` row ``s`` holds shard ``s``'s LOCAL row
    indices (``SessionArena.local_row``: every shard's scratch row is
    ``slots_per_shard``), NOT global slot ids; ``params`` is one replica
    per mesh device (`replicate_params`).  Each shard runs `make_arena_step`'s gather -> op ->
    scatter on its own block with its own replica, on its own device, so
    the step moves no tensor between devices (the serve engine's
    ``serve_cross_shard_moves_total`` stays 0).  Every shard runs, an
    empty sub-batch as pad lanes on its scratch row, as the reference's
    ``shard_map`` program does; on several cards the per-shard launches
    overlap, since each device's queue runs on its own."""
    step = make_arena_step(cfg, op, ragged)
    devices = tuple(mesh.devices)

    def fn(params, slabs, ids, tokens, lengths):
        if len(slabs.blocks) != len(devices):
            raise ValueError(f"slabs of {len(slabs.blocks)} row blocks on "
                             f"a mesh of {len(devices)} devices")
        outs = []
        for s, dev in enumerate(devices):
            with on_device(dev):
                out, _ = step(params[s], slabs.blocks[s], ids[s],
                              tokens[s], lengths[s])
            outs.append(out)
        return (None if op == "ingest" else outs), slabs
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
