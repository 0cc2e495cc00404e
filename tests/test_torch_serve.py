"""Port parity for the serve slice: the arena step, the pressure and COW
arena helpers, and the whole `ServeEngine` on identical traffic, against
``repro`` on shared weights (tiny config, float32, CPU); stream sessions
(the stream arena step and the engine's stream op) against ``repro``'s
arena step and its single-session ``stream_step``.

Tolerances: logits and float state leaves atol 1e-4 (float32; the port
batches lanes natively where the reference vmaps single-session ops, so
sums run in another order).  int8 cache values may differ by one
quantum where rounding sits on a tie (|dq| <= 1), their scales atol
1e-6.  Counters, slots, verdicts and metric counters must be equal.  Stream
logits and float state atol 1e-5; a stream row offloaded and restored,
and every stream lane with no eviction pending, must come back bit-equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as JST
from repro.launch import serve as JSRV
from repro.models import transformer as JT
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro.obs import ManualClock as JClock, Observability as JObs
from repro.serve import PressurePolicy as JPolicy, ServeEngine as JEngine
from repro.serve.arena import SessionArena as JArena
from repro_torch.core import streaming as PST
from repro_torch.kernels import ops as POPS
from repro_torch.launch import serve as PSRV
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.obs import ManualClock as PClock, Observability as PObs
from repro_torch.params import params_from_numpy
from repro_torch.serve import PressurePolicy as PPolicy
from repro_torch.serve import ServeEngine as PEngine
from repro_torch.serve.arena import SessionArena as PArena

ATOL = 1e-4
CACHE = 8


def _cfgs(mode="concat", cache_dtype="bfloat16"):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32", kv_cache_dtype=cache_dtype)
    cc = dict(comp_len=2, max_steps=4, mode=mode)
    return JCfg(**base, ccm=JCCM(**cc)), PCfg(**base, ccm=PCCM(**cc))


@functools.lru_cache(maxsize=1)
def _numpy_params():
    """JAX init, then LoRA b and comp_embed randomized (the reference
    initialises b = 0, which would leave the gate untested)."""
    jc, _ = _cfgs()
    p = jax.tree.map(np.asarray, jax.jit(JT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), jc))
    rs = np.random.default_rng(1)
    for lw in p["layers"]["attn"]["lora"].values():
        lw["b"] = rs.normal(0, 0.1, lw["b"].shape).astype(np.float32)
    p["comp_embed"] = rs.normal(0, 0.5, p["comp_embed"].shape
                                ).astype(np.float32)
    return p


def _params(pc):
    p = _numpy_params()
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, pc, "cpu")


# (reference path, port path) of every slab leaf
_TENSORS = (("cache", "k"), ("cache", "v"), ("cache", "k_scale"),
            ("cache", "v_scale"), ("mem", "k"), ("mem", "v"))
_COUNTERS = (("cache", "length"), ("mem", "slots"), ("mem", "steps"),
             ("mem", "stream_pos"), ("pos",))


def _get(tree, path):
    for name in path:
        tree = getattr(tree, name)
    return tree


def _fill_slabs(jc, pc, n_slots, rs, counters):
    """The same random arena in both packages: float leaves normal, int8
    values in [-127, 127] with positive scales, per-row counters."""
    ja = JArena.for_online(jc, n_slots, CACHE)
    pa = PArena.for_online(pc, n_slots, CACHE, device="cpu")
    jslabs = ja.slabs
    for path in _TENSORS:
        t = _get(pa.slabs, path)
        if t is None:
            continue
        if t.dtype == torch.int8:
            a = rs.integers(-127, 128, t.shape).astype(np.float32)
        elif path[1].endswith("scale"):
            a = rs.uniform(0.01, 0.05, t.shape).astype(np.float32)
        else:
            a = rs.normal(size=t.shape).astype(np.float32)
        t.copy_(torch.from_numpy(a))
        jslabs = _replace(jslabs, path,
                          jnp.asarray(a, _get(jslabs, path).dtype))
    for path, vals in zip(_COUNTERS, counters):
        arr = np.asarray(vals, np.int64)
        _get(pa.slabs, path)[:] = arr
        jslabs = _replace(jslabs, path, jnp.asarray(arr, jnp.int32))
    return jslabs, pa.slabs


def _replace(tree, path, value):
    if len(path) == 1:
        return tree._replace(**{path[0]: value})
    return tree._replace(**{path[0]: _replace(getattr(tree, path[0]),
                                              path[1:], value)})


def _compare_slabs(jslabs, pslabs, rows):
    for path in _TENSORS:
        t = _get(pslabs, path)
        if t is None:
            continue
        j = np.asarray(_get(jslabs, path), np.float32)[rows]
        p = t.float().numpy()[rows]
        if t.dtype == torch.int8:
            assert np.abs(j - p).max() <= 1, path
        else:
            np.testing.assert_allclose(
                p, j, atol=1e-6 if path[1].endswith("scale") else ATOL,
                rtol=0, err_msg=str(path))
    for path in _COUNTERS:
        np.testing.assert_array_equal(
            _get(pslabs, path)[rows], np.asarray(_get(jslabs, path))[rows],
            err_msg=str(path))


# rows 0..3 are data rows, 4 the scratch row.  Lanes sit at different
# counters: caches 0..8 full (the cache_len-8 ones overhang), memories
# 0..4 groups (4 = full: the concat write clamps)
_ROW_COUNTERS = ([0, 3, 6, 8, 2], [0, 1, 4, 2, 0], [0, 1, 5, 3, 2],
                 [0, 7, 40, 19, 5], [0, 10, 46, 27, 7])
_CASES = [("ingest", True, "concat", "bfloat16"),
          ("ingest", False, "merge", "bfloat16"),
          ("ingest", True, "merge", "int8"),
          ("ingest", False, "concat", "int8"),
          ("query", True, "concat", "int8"),
          ("query", False, "concat", "bfloat16"),
          ("query", True, "merge", "bfloat16"),
          ("query", False, "merge", "int8")]


@pytest.mark.parametrize("op,ragged,mode,cache_dtype", _CASES,
                         ids=["-".join((o, "ragged" if r else "exact", m, c))
                              for o, r, m, c in _CASES])
def test_arena_step_matches_reference(op, ragged, mode, cache_dtype):
    jc, pc = _cfgs(mode, cache_dtype)
    jp, pp = _params(pc)
    rs = np.random.default_rng(7)
    jslabs, pslabs = _fill_slabs(jc, pc, 4, rs, _ROW_COUNTERS)
    ids = [2, 0, 3, 4, 4]                  # two pad lanes on scratch
    l = 4
    toks = rs.integers(0, 128, (5, 1, l)).astype(np.int32)
    lengths = np.array([4, 1, 3, l, l] if ragged else [l] * 5, np.int32)
    jout, jslabs = JSRV.make_arena_step(jc, op, ragged)(
        jp, jslabs, jnp.asarray(ids, jnp.int32), jnp.asarray(toks),
        jnp.asarray(lengths))
    pout, pslabs = PSRV.make_arena_step(pc, op, ragged)(
        pp, pslabs, ids, toks, lengths)
    if op == "query":
        assert tuple(pout.shape) == (5, 1, l, 128)
        for i in range(3):                 # real lanes, valid rows
            np.testing.assert_allclose(
                pout[i, 0, :lengths[i]].numpy(),
                np.asarray(jout)[i, 0, :lengths[i]], atol=ATOL, rtol=0)
    else:
        assert pout is None and jout is None
    _compare_slabs(jslabs, pslabs, [0, 1, 2, 3])


def test_cow_clone_and_recompress_arena_slots():
    """cow_clone_slots with a destination that is another pair's source
    (every source is read before any write), and recompress_arena_slots
    over lanes that do and do not shrink, pad lanes included."""
    jc, pc = _cfgs()
    rs = np.random.default_rng(8)
    jslabs, pslabs = _fill_slabs(jc, pc, 4, rs, _ROW_COUNTERS)
    src, dst = [1, 2], [2, 3]
    jslabs = JSRV.cow_clone_slots(jslabs, jnp.asarray(src, jnp.int32),
                                  jnp.asarray(dst, jnp.int32))
    pslabs = PSRV.cow_clone_slots(pslabs, src, dst)
    _compare_slabs(jslabs, pslabs, [0, 1, 2, 3, 4])
    ids = [3, 0, 2, 4]
    jmem = JSRV.recompress_arena_slots(jslabs.mem, jnp.asarray(ids, jnp.int32),
                                       cfg=jc, group=2)
    before = pslabs.mem.k.clone()
    pmem = PSRV.recompress_arena_slots(pslabs.mem, ids, cfg=pc, group=2)
    _compare_slabs(jslabs._replace(mem=jmem), pslabs._replace(mem=pmem),
                   [0, 1, 2, 3])
    assert torch.equal(pmem.k[1], before[1])          # not in ids
    assert torch.equal(pmem.k[0], before[0])          # 0 groups: no shrink


# ---------------------------------------------------------------------------
# the engine on identical traffic
# ---------------------------------------------------------------------------

def _engines(async_offload=False, **kw):
    jc, pc = _cfgs()
    jp, pp = _params(pc)
    common = dict(n_slots=3, cache_len=16, batch_buckets=(1, 2, 4),
                  aging=4, **kw)
    je = JEngine(jp, jc, obs=JObs(clock=JClock()),
                 pressure_policy=JPolicy(capacity_tokens=22), **common)
    pe = PEngine(pp, pc, obs=PObs(clock=PClock()), device="cpu",
                 async_offload=async_offload,
                 pressure_policy=PPolicy(capacity_tokens=22), **common)
    return je, pe


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 128, n).astype(np.int32)


def _verdict(v):
    return (type(v).__name__, getattr(v, "reason", None), v.shard,
            len(getattr(v, "shed_victims", ())))


def _state(eng):
    mgr = eng._mgr["online"]
    return ({sid: (s.slot, s.n_offloads, s.mem_groups, s.resident)
             for sid, s in sorted(mgr.sessions.items())},
            [list(f) for f in mgr.arena._free],
            dict(sorted(mgr.arena._refs.items())))


_TIMING = ("seconds", "bandwidth", "lateness", "latency")


def _counters(eng):
    snap = eng.metrics_snapshot()["metrics"]
    return {name: fam["values"] for name, fam in snap.items()
            if fam["type"] == "counter" and name != "offload_bytes_total"
            and not any(t in name for t in _TIMING)}


def _drive(eng):
    """3 tenants, 7 sessions on 3 slots (LRU offload + restore), ragged
    ingests and queries, a fork, a prefix-cache hit and enough memory
    growth for the pressure ladder to recompress."""
    verdicts, trace, reqs = [], [], []

    def sub(fn, *a):
        v = fn(*a)
        verdicts.append(_verdict(v))
        reqs.append(v.request)

    def run():
        eng.run()
        trace.append(_state(eng))

    for i, sid in enumerate("abcde"):
        eng.create_session(sid, tenant=f"t{i % 3}")
    for i, sid in enumerate("abcde"):
        sub(eng.ingest, sid, _toks(i, [5, 3, 8, 6, 2][i]))
    run()
    for i, sid in enumerate("ace"):
        sub(eng.query, sid, _toks(10 + i, [3, 4, 1][i]))
    run()
    verdicts.append(_verdict(eng.fork_session("a", "af")))
    sub(eng.ingest, "af", _toks(20, 7))
    sub(eng.query, "a", _toks(21, 2))
    run()
    prefix = _toks(30, 6)
    eng.create_session("p1", tenant="t2", prefix_tokens=prefix)
    run()
    eng.create_session("p2", tenant="t2", prefix_tokens=prefix)
    sub(eng.query, "p2", _toks(31, 3))
    run()
    for rnd in range(3):
        for i, sid in enumerate("abcd"):
            sub(eng.ingest, sid, _toks(40 + 4 * rnd + i, 3 + i))
        run()
    sub(eng.query, "b", _toks(60, 5))
    run()
    return verdicts, trace, reqs


@pytest.mark.parametrize("async_offload", [False, True],
                         ids=["sync", "async"])
def test_engine_matches_reference(async_offload):
    je, pe = _engines(async_offload)
    jv, jt, jr = _drive(je)
    pv, pt, pr = _drive(pe)
    assert pv == jv
    assert pt == jt                       # slots, offloads, free-lists
    assert len(pr) == len(jr)
    for a, b in zip(jr, pr):
        assert (a.done, a.shed, b.done, b.shed) == (b.done, b.shed) * 2
        if a.result is None:
            assert b.result is None
        else:
            np.testing.assert_allclose(b.result, a.result, atol=ATOL, rtol=0)
    assert _counters(pe) == _counters(je)
    snap = pe.metrics_snapshot()["metrics"]
    offl = {v["labels"]["dir"]: v["value"]
            for v in snap["offload_sessions_total"]["values"]}
    assert offl["offload"] > 0 and offl["restore"] > 0
    assert snap["serve_prefix_dedup_hits_total"]["values"][0]["value"] >= 1
    levers = {v["labels"]["lever"]: v["value"]
              for v in snap["pressure_decisions_total"]["values"]}
    assert levers.get("recompress", 0) > 0
    assert int(snap["serve_fork_total"]["values"][0]["value"]) == 1
    assert pe._mgr["online"].arena.consistency_errors() == []
    # distinct step shapes per op: what the reference's jit caches count
    # (its caches may hold extra entries for argument placement changes)
    want = {}
    for op, *_ in je._seen_shapes:
        want[op] = want.get(op, 0) + 1
    assert pe.compile_stats() == want


# ---------------------------------------------------------------------------
# control plane: seeded event traces through both engines, null steps
# ---------------------------------------------------------------------------

class _TraceRunner:
    """Applies `simulation.random_events` traces to one engine (the
    subset of `simulation.ServeSimulation`'s rules the comparison needs:
    sessions are created on first use, closed sids stay closed, and
    caller-contract errors are skipped the same way in both engines)."""

    def __init__(self, eng):
        self.eng, self.closed = eng, set()

    def _ensure(self, sid, tenant):
        if sid in self.eng._kind:
            return True
        if sid in self.closed:
            return False
        self.eng.create_session(sid, tenant=tenant)
        return True

    def apply(self, ev):
        eng, kind = self.eng, ev[0]
        out = None
        if kind == "create" and len(ev) == 4:
            _, sid, tenant, plen = ev
            if sid not in eng._kind and sid not in self.closed:
                toks = (np.arange(plen, dtype=np.int32) * 7 + plen) % 101
                eng.create_session(sid, tenant=tenant, prefix_tokens=toks)
        elif kind == "fork":
            _, parent, child = ev
            if (parent in eng._kind and child not in eng._kind
                    and child not in eng._pending_forks
                    and child not in self.closed and parent != child):
                out = _verdict(eng.fork_session(parent, child))
        elif kind == "submit":
            _, sid, op, length, prio, tenant = ev[:6]
            if self._ensure(sid, tenant) and not (
                    op == "query"
                    and eng._cached.get(sid, 0) + length > eng.cache_len):
                out = _verdict(getattr(eng, op)(
                    sid, np.zeros(length, np.int32), priority=prio))
        elif kind == "run":
            eng.run(max_batches=ev[1])
        elif kind == "offload":
            out = eng.offload_session(ev[1]).status
        elif kind == "close":
            if ev[1] in eng._kind:
                out = eng.close_session(ev[1]).status
                self.closed.add(ev[1])
        mgr = eng._mgr["online"]
        return (out, _state(eng), mgr.arena.consistency_errors(),
                eng.admission.queued_tokens(), len(eng.admission.backlog))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_null_step_traces_match_reference(seed):
    from simulation import FORK_SIDS, PREFIX_LENS, random_events

    jc, pc = _cfgs()
    kw = dict(n_slots=3, cache_len=64, batch_buckets=(1, 2, 4),
              token_buckets=(2, 4, 8, 16), aging=4, max_resident=2)
    je = JEngine(None, jc, step_factory=JSRV.make_null_step,
                 obs=JObs(clock=JClock()), **kw)
    pe = PEngine(None, pc, step_factory=PSRV.make_null_step,
                 obs=PObs(clock=PClock()), device="cpu", **kw)
    jd, pd = _TraceRunner(je), _TraceRunner(pe)
    events = random_events(np.random.RandomState(seed), 80,
                           fork_sids=FORK_SIDS, prefix_lens=PREFIX_LENS)
    events.append(("run", 50))
    for ev in events:
        want, got = jd.apply(ev), pd.apply(ev)
        assert got == want, ev
        assert got[2] == []


# ---------------------------------------------------------------------------
# activation planning under shared rows: two reference faults the port
# fixes (ROADMAP §3)
# ---------------------------------------------------------------------------

def _prefix_pin_full_batch(eng):
    """A full batch whose max_resident evictions pick a session attached
    to a prefix-cache row: the reference's planner never drops that
    pin, frees no slot for it and raises ArenaFull out of run()."""
    sids = [f"s{i}" for i in range(9)]
    for sid in sids:
        eng.create_session(sid)
    eng.create_session("p1", prefix_tokens=np.arange(4, dtype=np.int32))
    eng.run()
    eng.create_session("p2", prefix_tokens=np.arange(4, dtype=np.int32))
    for sid in sids:
        eng.ingest(sid, np.zeros(3, np.int32))
    eng.run()
    for sid in sids[:3] + sids[4:]:
        eng.ingest(sid, np.zeros(3, np.int32))
    eng.run()


def _fork_siblings_full_batch(eng):
    """A full batch holding a resident fork parent and its child: the
    reference reserves a copy-on-write slot for BOTH sharers (one more
    row than the arena has) and raises ArenaFull."""
    sids = [f"s{i}" for i in range(7)]
    for sid in sids:
        eng.create_session(sid)
        eng.ingest(sid, np.zeros(3, np.int32))
    eng.run()
    eng.fork_session("s6", "f")
    eng.run()
    for sid in ["s6", "f"] + sids[:6]:
        eng.query(sid, np.zeros(2, np.int32))
    eng.run()


@pytest.mark.parametrize("scenario", [_prefix_pin_full_batch,
                                      _fork_siblings_full_batch],
                         ids=["prefix-pin", "fork-siblings"])
def test_full_batch_over_shared_rows_is_served(scenario):
    from repro.serve.arena import ArenaFull as JArenaFull

    jc, pc = _cfgs()
    kw = dict(n_slots=8, cache_len=64, batch_buckets=(1, 2, 4, 8),
              token_buckets=(4, 8))
    je = JEngine(None, jc, step_factory=JSRV.make_null_step, **kw)
    with pytest.raises(JArenaFull):
        scenario(je)
    pe = PEngine(None, pc, step_factory=PSRV.make_null_step, device="cpu",
                 **kw)
    scenario(pe)
    assert pe.queue_depth() == 0
    assert pe._mgr["online"].arena.consistency_errors() == []
    snap = pe.metrics_snapshot()["metrics"]
    assert sum(v["value"] for v in snap["serve_requests_total"]["values"]) \
        > 0


# ---------------------------------------------------------------------------
# stream sessions
# ---------------------------------------------------------------------------

STREAM_ATOL = 1e-5
_jstream = jax.jit(JST.stream_step, static_argnums=(1,))


def _stream_cfgs(mode="concat"):
    """A 16-token window with a 2-token sink, chunks of 4, 4 memory
    groups (the reference's stream-engine tests)."""
    s = dict(stream_window=16, stream_sink=2, stream_chunk=4,
             stream_mem_slots=4)
    jc, pc = _cfgs(mode)
    return (jc.replace(ccm=dataclasses.replace(jc.ccm, **s)),
            pc.replace(ccm=dataclasses.replace(pc.ccm, **s)))


def _stream_arenas(jc, pc, jp, pp, warm):
    """Both packages' stream arenas, row i warmed by chunks of the token
    counts ``warm[i]`` (the scratch row last); returns the slabs and the
    port's warm states."""
    from repro_torch.serve.arena import tree_map
    jslabs = JArena.for_stream(jc, len(warm)).slabs
    pa = PArena.for_stream(pc, len(warm), device="cpu")
    states = []
    for i, w in enumerate(warm):
        js = JST.init_stream_state(jc, 1)
        ps = PST.init_stream_state(pc, 1, device="cpu")
        for j, n in enumerate(w):
            t = _toks(100 * i + j, n)[None]
            _, js = _jstream(jp, jc, js, jnp.asarray(t))
            _, ps = PST.stream_step(pp, pc, ps, torch.from_numpy(t))
        jslabs = jax.tree.map(lambda s, r: s.at[i].set(r), jslabs, js)
        pa.write_slot(i, ps)
        states.append(tree_map(lambda x: x.clone()
                               if isinstance(x, torch.Tensor) else x, ps))
    return jslabs, pa.slabs, states


_STREAM_TENSORS = (("win_k",), ("win_v",), ("mem", "k"), ("mem", "v"))
_STREAM_COUNTERS = (("win_len",), ("pos",), ("mem", "slots"),
                    ("mem", "steps"), ("mem", "stream_pos"))


@pytest.mark.parametrize("ragged", [False, True], ids=["exact", "ragged"])
def test_stream_arena_step_gates_eviction_per_lane(ragged):
    """One stream arena step over staggered rows: row 0 evicts with a
    full memory (its oldest group drops), row 3 holds 14 of 16 window
    rows (it evicts on 4 more tokens, not on 2 in the ragged case), rows
    1 and 2 do not evict, and a pad lane runs on the scratch row.  Logits
    and every slab leaf match the reference's arena step; rows with no
    eviction keep their memory bit-equal; in the ragged case each lane
    also equals its unpadded run alone."""
    jc, pc = _stream_cfgs()
    jp, pp = _params(pc)
    jslabs, pslabs, states = _stream_arenas(
        jc, pc, jp, pp, [[4] * 8, [4], [], [4, 4, 4, 2]])
    ids = [3, 0, 1, 2, 4]
    toks = _toks(9, (5, 1, 4))
    lengths = np.array([2, 4, 3, 1, 4] if ragged else [4] * 5, np.int32)
    mem_before = pslabs.mem.k.clone()
    jout, jslabs = JSRV.make_arena_step(jc, "stream", ragged)(
        jp, jslabs, jnp.asarray(ids, jnp.int32), jnp.asarray(toks),
        jnp.asarray(lengths))
    pout, pslabs = PSRV.make_arena_step(pc, "stream", ragged)(
        pp, pslabs, ids, toks, lengths)
    assert tuple(pout.shape) == (5, 1, 4, 128)
    for i in range(4):
        np.testing.assert_allclose(
            pout[i, 0, :lengths[i]].numpy(),
            np.asarray(jout)[i, 0, :lengths[i]], atol=STREAM_ATOL, rtol=0)
    for path in _STREAM_TENSORS:
        np.testing.assert_allclose(
            _get(pslabs, path).numpy()[:4],
            np.asarray(_get(jslabs, path))[:4], atol=STREAM_ATOL, rtol=0,
            err_msg=str(path))
    for path in _STREAM_COUNTERS:
        np.testing.assert_array_equal(
            _get(pslabs, path)[:4], np.asarray(_get(jslabs, path))[:4],
            err_msg=str(path))
    evicted = [0] if ragged else [0, 3]
    assert list(pslabs.mem.slots[:4]) == [4, 0, 0, 0 if ragged else 1]
    for row in {0, 1, 2, 3} - set(evicted):
        assert torch.equal(pslabs.mem.k[row], mem_before[row])
    if ragged:
        for lane, row in enumerate(ids[:4]):
            vl = int(lengths[lane])
            want, st = PST.stream_step(
                pp, pc, states[row],
                torch.from_numpy(toks[lane, :, :vl]))
            np.testing.assert_allclose(pout[lane, 0, :vl].numpy(),
                                       want[0].numpy(), atol=STREAM_ATOL,
                                       rtol=0)
            assert (st.win_len, st.pos, st.mem.slots) == (
                pslabs.win_len[row], pslabs.pos[row],
                pslabs.mem.slots[row])


def test_stream_batch_without_overflow_runs_no_compression(monkeypatch):
    """The compression pass is the only gated (conditional-LoRA) op of a
    stream step: a batch where no lane's window overflows makes no
    ``cond_lora`` call and leaves every memory bit-equal; one pending
    lane makes one call per projection and layer."""
    jc, pc = _stream_cfgs()
    jp, pp = _params(pc)
    _, pslabs, _ = _stream_arenas(jc, pc, jp, pp, [[4, 4], [4], [4] * 4])
    calls = []
    real = POPS.cond_lora

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(POPS, "cond_lora", counting)
    step = PSRV.make_arena_step(pc, "stream", True)
    mem_before = pslabs.mem.k.clone()
    step(pp, pslabs, [0, 1], _toks(3, (2, 1, 4)), np.array([4, 4]))
    assert calls == [] and torch.equal(pslabs.mem.k, mem_before)
    step(pp, pslabs, [0, 1, 2], _toks(4, (3, 1, 4)), np.array([4, 4, 4]))
    m = pc.ccm.comp_len
    assert calls == [m] * (4 * pc.n_layers)       # one lane's <COMP> rows
    assert list(pslabs.mem.slots[:3]) == [0, 0, 1]


def _stream_engine(pc, pp, **kw):
    common = dict(n_slots=1, cache_len=8, stream_slots=2,
                  batch_buckets=(1, 2), device="cpu")
    common.update(kw)
    return PEngine(pp, pc, **common)


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_engine_stream_sessions_match_reference(mode):
    """Three stream sessions on two stream slots (LRU offload and restore
    of stream rows), eight ragged chunks of 1-4 tokens each (token
    buckets), so the windows overflow at different steps in different
    lanes of a batch.  Every answer equals the reference's
    ``stream_step`` of the session alone on the same weights."""
    jc, pc = _stream_cfgs(mode)
    jp, pp = _params(pc)
    eng = _stream_engine(pc, pp)
    sids = ["a", "b", "c"]
    for sid in sids:
        eng.create_session(sid, kind="stream")
    rs = np.random.default_rng(5)
    chunks = {sid: [_toks(10 * i + r, int(rs.integers(1, 5)))
                    for r in range(8)] for i, sid in enumerate(sids)}
    reqs = {sid: [] for sid in sids}
    for r in range(8):
        for sid in sids[r % 3:] + sids[:r % 3]:
            reqs[sid].append(eng.stream(sid, chunks[sid][r]).request)
        eng.run()
    for sid in sids:
        st = JST.init_stream_state(jc, 1)
        for t, req in zip(chunks[sid], reqs[sid]):
            lg, st = _jstream(jp, jc, st, jnp.asarray(t)[None])
            assert req.done
            np.testing.assert_allclose(req.result, np.asarray(lg[0]),
                                       atol=STREAM_ATOL, rtol=0)
    snap = eng.metrics_snapshot()["metrics"]
    moved = {v["labels"]["dir"]: v["value"]
             for v in snap["offload_sessions_total"]["values"]}
    assert moved["offload"] > 0 and moved["restore"] > 0
    assert eng._mgr["stream"].arena.consistency_errors() == []


def test_engine_stream_replay_matches_reference():
    """Two stream sessions on one stream slot with a cost model that
    always prefers recompute: every switch drops the other session's row
    and replays its history into the slot (the replay pads each request
    as live traffic does, clamped to ``stream_chunk``).  Token buckets
    above the chunk size exercise the scheduler's stream cap: every
    stream step runs at 4 tokens.  The answers equal the reference's
    ``stream_step`` of each session alone."""
    from repro_torch.serve import OffloadCostModel
    jc, pc = _stream_cfgs()
    jp, pp = _params(pc)
    eng = _stream_engine(pc, pp, stream_slots=1, batch_buckets=(1,),
                         token_buckets=(8, 16),
                         offload_cost_model=OffloadCostModel(
                             host_bandwidth=1.0))
    rs = np.random.default_rng(6)
    chunks = {sid: [_toks(20 * i + r, int(rs.integers(1, 5)))
                    for r in range(6)] for i, sid in enumerate("ab")}
    reqs = {sid: [] for sid in "ab"}
    for sid in "ab":
        eng.create_session(sid, kind="stream")
    for r in range(6):
        for sid in "ab":
            reqs[sid].append(eng.stream(sid, chunks[sid][r]).request)
            eng.run()
    for sid in "ab":
        st = JST.init_stream_state(jc, 1)
        for t, req in zip(chunks[sid], reqs[sid]):
            lg, st = _jstream(jp, jc, st, jnp.asarray(t)[None])
            np.testing.assert_allclose(req.result, np.asarray(lg[0]),
                                       atol=STREAM_ATOL, rtol=0)
    snap = eng.metrics_snapshot()["metrics"]
    decisions = {v["labels"]["decision"]: v["value"]
                 for v in snap["offload_decisions_total"]["values"]}
    assert decisions.get("recompute", 0) >= 5
    assert {tl for op, _, tl, _ in eng._seen_shapes if op == "stream"} \
        == {4}


def test_stream_batches_capped_by_stream_arena():
    """A stream batch must fit the (smaller) stream arena even when the
    online arena is larger."""
    _, pc = _stream_cfgs()
    _, pp = _params(pc)
    eng = _stream_engine(pc, pp, n_slots=8, batch_buckets=(1, 2, 4, 8))
    reqs = []
    for s in range(3):
        eng.create_session(f"t{s}", kind="stream")
        reqs.append(eng.stream(f"t{s}", _toks(60 + s, 4)).request)
    eng.run()
    assert all(r.done and r.result.shape == (4, 128) for r in reqs)
    snap = eng.metrics_snapshot()["metrics"]
    lanes = {v["labels"]["kind"]: v["value"]
             for v in snap["serve_lanes_total"]["values"]}
    batches = {v["labels"]["kind"]: v["value"]
               for v in snap["serve_batches_total"]["values"]}
    assert batches["stream"] >= 2 and lanes["stream"] <= 2 * batches["stream"]


_GUARDS = {
    "ingest-on-stream": lambda e: e.ingest("s", _toks(0, 3)),
    "stream-on-online": lambda e: e.stream("o", _toks(0, 3)),
    "chunk-over-quantum": lambda e: e.stream("s", _toks(0, 5)),
    "block-over-window": lambda e: _stream_engine(
        e.cfg.replace(ccm=dataclasses.replace(e.cfg.ccm, stream_window=4)),
        e.params),
}


@pytest.mark.parametrize("case", list(_GUARDS))
def test_stream_session_guards(case):
    """A stream session refuses ingest (and an online session stream), a
    chunk longer than ``stream_chunk`` is refused at submit, and an
    eviction block that cannot fit behind the sink at construction."""
    _, pc = _stream_cfgs()
    _, pp = _params(pc)
    eng = _stream_engine(pc, pp)
    eng.create_session("s", kind="stream")
    eng.create_session("o")
    with pytest.raises(ValueError):
        _GUARDS[case](eng)
    assert eng.queue_depth() == 0


def test_stream_row_offload_restore_is_bit_exact():
    """A stream session's row (window, memory and counters) offloaded to
    the host and restored comes back bit-equal, and the session goes on
    streaming from it."""
    from repro_torch.serve.arena import tree_leaves
    _, pc = _stream_cfgs()
    _, pp = _params(pc)
    eng = _stream_engine(pc, pp)
    eng.create_session("u", kind="stream")
    for r in range(6):
        eng.stream("u", _toks(r, 4))
    eng.run()
    mgr = eng._mgr["stream"]
    before = mgr.arena.read_slot(mgr.sessions["u"].slot)
    assert before.mem.slots == 2 and before.win_len == 16
    assert eng.offload_session("u").status == "offloaded"
    assert not mgr.sessions["u"].resident
    mgr.activate_batch(["u"])
    after = mgr.arena.read_slot(mgr.sessions["u"].slot)
    for a, b in zip(tree_leaves(before), tree_leaves(after)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    req = eng.stream("u", _toks(9, 4)).request
    eng.run()
    assert req.done and np.isfinite(req.result).all()


def test_null_stream_step_shapes():
    """The control-plane step of a stream op: zero logits of the contract
    shape (B, 1, l, V), the slabs untouched."""
    _, pc = _stream_cfgs()
    arena = PArena.for_stream(pc, 2, device="cpu")
    before = arena.slabs.win_k.clone()
    out, slabs = PSRV.make_null_step(pc, "stream", True)(
        None, arena.slabs, [0, 2], np.zeros((2, 1, 3), np.int32),
        np.array([3, 1]))
    assert out.shape == (2, 1, 3, 128) and not out.any()
    assert slabs is arena.slabs and torch.equal(slabs.win_k, before)
