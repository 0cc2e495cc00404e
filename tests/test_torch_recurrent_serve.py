"""The recurrent families in the serve slice against ``repro``: the arena
step over packed rows that carry the Mamba2 ``ssm``/``conv`` leaves (and,
for the ssm family, no cache and no memory), the whole ``ServeEngine`` on
identical traffic (exact-length batches, LRU offload and restore, a fork
broken copy-on-write), and a bf16 witness of where a batched session's
gap to the same session alone comes from.  mamba2-370m and zamba2-1.2b at
the registry's smoke sizes (helpers and weights of
``tests/test_torch_recurrent.py``).

Tolerances: float32 logits and float state leaves atol 1e-4 (the port
batches lanes natively where the reference vmaps single-session ops);
counters, slots, verdicts and metric counters equal.  The bf16 witness
states its factor at the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as JI
from repro.launch import serve as JSRV
from repro.obs import ManualClock as JClock, Observability as JObs
from repro.serve import ServeEngine as JEngine
from repro.serve.arena import SessionArena as JArena
from repro_torch.core import inference as PI
from repro_torch.launch import serve as PSRV
from repro_torch.obs import ManualClock as PClock, Observability as PObs
from repro_torch.serve import ServeEngine as PEngine
from repro_torch.serve.arena import SessionArena as PArena
from test_torch_recurrent import ATOL, _cfgs, _params, _toks
from test_torch_serve import _counters, _state, _verdict

_ingest = jax.jit(JI.ingest_context, static_argnums=(1,))
_prefill = jax.jit(JI.prefill, static_argnums=(1,),
                   static_argnames=("full_logits",))

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
CACHE = 16
_TENSORS = (("cache", "k"), ("cache", "v"), ("mem", "k"), ("mem", "v"),
            ("ssm", "ssm"), ("ssm", "conv"))
_COUNTERS = (("cache", "length"), ("mem", "slots"), ("mem", "steps"),
             ("mem", "stream_pos"), ("pos",))


def _get(tree, path):
    for name in path:
        tree = None if tree is None else getattr(tree, name)
    return tree


def _replace(tree, path, value):
    if len(path) == 1:
        return tree._replace(**{path[0]: value})
    return tree._replace(**{path[0]: _replace(getattr(tree, path[0]),
                                              path[1:], value)})


def _fill_slabs(jc, pc, n_slots, rs):
    """The same random arena in both packages: float leaves normal (the
    SSD state at 0.3), per-row counters (caches 0..7 full, memories 0..3
    groups)."""
    ja = JArena.for_online(jc, n_slots, CACHE)
    pa = PArena.for_online(pc, n_slots, CACHE, device="cpu")
    jslabs, n = ja.slabs, n_slots + 1
    for path in _TENSORS:
        t = _get(pa.slabs, path)
        if t is None:
            assert _get(jslabs, path) is None, path
            continue
        a = rs.normal(0, 0.3 if path[1] == "ssm" else 1.0,
                      t.shape).astype(np.float32)
        t.copy_(torch.from_numpy(a))
        jslabs = _replace(jslabs, path, jnp.asarray(a))
    for path in _COUNTERS:
        t = _get(pa.slabs, path)
        if t is None:
            continue
        hi = {"length": 8, "slots": 4, "steps": 4}.get(path[-1], 40)
        arr = rs.integers(0, hi, n).astype(np.int64)
        t[:] = arr
        jslabs = _replace(jslabs, path, jnp.asarray(arr, jnp.int32))
    return jslabs, pa.slabs


def _compare_slabs(jslabs, pslabs, rows):
    for path in _TENSORS:
        t = _get(pslabs, path)
        if t is None:
            continue
        np.testing.assert_allclose(
            t.float().numpy()[rows],
            np.asarray(_get(jslabs, path), np.float32)[rows], atol=ATOL,
            rtol=0, err_msg=str(path))
    for path in _COUNTERS:
        t = _get(pslabs, path)
        if t is not None:
            np.testing.assert_array_equal(
                t[rows], np.asarray(_get(jslabs, path))[rows],
                err_msg=str(path))


@pytest.mark.parametrize("op", ["ingest", "query"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arena_step_matches_reference(arch, op):
    """Lanes at different counters (positions, cache lengths, memory
    groups) and two pad lanes on the scratch row; exact lengths."""
    jc, pc = _cfgs(arch)
    jp, pp = _params(arch, pc)
    rs = np.random.default_rng(7)
    jslabs, pslabs = _fill_slabs(jc, pc, 4, rs)
    ids = [2, 0, 3, 4, 4]
    l = 6 if op == "ingest" else 4
    toks = rs.integers(0, pc.vocab_size, (5, 1, l)).astype(np.int32)
    lengths = np.full(5, l, np.int32)
    jout, jslabs = JSRV.make_arena_step(jc, op)(
        jp, jslabs, jnp.asarray(ids, jnp.int32), jnp.asarray(toks),
        jnp.asarray(lengths))
    pout, pslabs = PSRV.make_arena_step(pc, op)(pp, pslabs, ids, toks,
                                                lengths)
    if op == "query":
        assert tuple(pout.shape) == (5, 1, l, pc.vocab_size)
        np.testing.assert_allclose(pout[:3].numpy(), np.asarray(jout)[:3],
                                   atol=ATOL, rtol=0)
    else:
        assert pout is None and jout is None
    _compare_slabs(jslabs, pslabs, [0, 1, 2, 3])


def _drive(eng, V):
    """5 sessions on 3 slots (LRU offload and restore), contexts of 6 and
    4 tokens (exact-length batches), a fork of a resident session, then
    queries of 3 and 5 tokens."""
    verdicts, trace, reqs = [], [], []

    def sub(fn, *a):
        v = fn(*a)
        verdicts.append(_verdict(v))
        reqs.append(v.request)

    def run():
        eng.run()
        trace.append(_state(eng))

    sids = "abcde"
    for i, sid in enumerate(sids):
        eng.create_session(sid, tenant=f"t{i % 2}")
    for r in range(2):
        for i, sid in enumerate(sids):
            sub(eng.ingest, sid, _toks(10 * r + i, [6, 4][(i + r) % 2], V))
        run()
    mgr = eng._mgr["online"]
    parent = next(s for s in sids if mgr.sessions[s].resident)
    verdicts.append(_verdict(eng.fork_session(parent, "f")))
    run()
    for i, sid in enumerate([parent, "f"] + [s for s in sids if s != parent]):
        sub(eng.query, sid, _toks(30 + i, [3, 5][i % 2], V))
    run()
    return verdicts, trace, reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    jc, pc = _cfgs(arch)
    jp, pp = _params(arch, pc)
    kw = dict(n_slots=3, cache_len=CACHE, batch_buckets=(1, 2), aging=4)
    je = JEngine(jp, jc, obs=JObs(clock=JClock()), **kw)
    pe = PEngine(pp, pc, obs=PObs(clock=PClock()), device="cpu", **kw)
    assert not pe.ragged
    jv, jt, jr = _drive(je, pc.vocab_size)
    pv, pt, pr = _drive(pe, pc.vocab_size)
    assert pv == jv
    assert pt == jt                       # slots, offloads, free-lists
    assert len(pr) == len(jr) == 16
    for a, b in zip(jr, pr):
        assert (a.done, b.done) == (True, True)
        if a.result is None:
            assert b.result is None
        else:
            np.testing.assert_allclose(b.result, a.result, atol=ATOL, rtol=0)
    assert _counters(pe) == _counters(je)
    snap = pe.metrics_snapshot()["metrics"]
    offl = {v["labels"]["dir"]: v["value"]
            for v in snap["offload_sessions_total"]["values"]}
    assert offl["offload"] > 0 and offl["restore"] > 0
    assert int(snap["serve_fork_total"]["values"][0]["value"]) == 1
    assert pe._mgr["online"].arena.consistency_errors() == []


def _witness_runs(arch, n=8):
    """Session 0 of ``n`` (2 contexts of 6 tokens, a 4-token query):
    its query logits run alone (B=1) in float32 and in bf16 through
    ``ingest_context``/``prefill``, and in bf16 as lane 0 of an
    ``n``-lane arena step batch, in each package."""
    V = _cfgs(arch)[1].vocab_size
    ctx = [_toks(50 + s, (n, 6), V) for s in range(2)]
    qry = _toks(60, (n, 4), V)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, pc = _cfgs(arch, compute_dtype=dtype)
        jp, pp = _params(arch, pc)          # float32 weights in both
        js = JI.init_online_state(jc, 1, CACHE)
        ps = PI.init_online_state(pc, 1, CACHE, device="cpu")
        for c in ctx:
            js = _ingest(jp, jc, js, jnp.asarray(c[:1]))
            ps = PI.ingest_context(pp, pc, ps, torch.from_numpy(c[:1]))
        jl, _ = _prefill(jp, jc, js, jnp.asarray(qry[:1]), full_logits=True)
        pl, _ = PI.prefill(pp, pc, ps, torch.from_numpy(qry[:1]),
                           full_logits=True)
        out[("ref", dtype, "alone")] = np.asarray(jl[0], np.float32)
        out[("port", dtype, "alone")] = pl[0].float().numpy()
        if dtype == "float32":
            continue
        ids = list(range(n))
        ja = JArena.for_online(jc, n, CACHE)
        pa = PArena.for_online(pc, n, CACHE, device="cpu")
        jslabs, pslabs = ja.slabs, pa.slabs
        lens = np.full(n, 6, np.int32)
        for c in ctx:
            _, jslabs = JSRV.make_arena_step(jc, "ingest")(
                jp, jslabs, jnp.asarray(ids, jnp.int32),
                jnp.asarray(c[:, None]), jnp.asarray(lens))
            _, pslabs = PSRV.make_arena_step(pc, "ingest")(
                pp, pslabs, ids, c[:, None], lens)
        jl, _ = JSRV.make_arena_step(jc, "query")(
            jp, jslabs, jnp.asarray(ids, jnp.int32),
            jnp.asarray(qry[:, None]), jnp.asarray(np.full(n, 4, np.int32)))
        pl, _ = PSRV.make_arena_step(pc, "query")(
            pp, pslabs, ids, qry[:, None], np.full(n, 4))
        out[("ref", dtype, "batch")] = np.asarray(jl[0, 0], np.float32)
        out[("port", dtype, "batch")] = pl[0, 0].float().numpy()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_batch_gap_is_rounding_not_a_lane_leak(arch):
    """In bf16, session 0 alone (A) and as lane 0 of an 8-lane batch (B)
    each lie some distance from the same session in float32 (F).  A
    lane leak would put B much farther from F than A; bf16 rounding
    carried through the recurrence puts both at about the same distance.
    Held: for each package, d(B, F) <= 2 d(A, F) and d(A, F) <= 2 d(B, F)
    (distances as max|.| over the logits), and the port's batch and alone
    runs each lie within 8 bf16 ulps of max|logit| of the reference's
    (``test_torch_recurrent_online.py``'s bf16 rule), and the port's
    d(A, F) within 2x of the reference's own: the bf16 distance is the
    reference's numerics, not the port's."""
    out = _witness_runs(arch)
    d = {}
    for pkg in ("ref", "port"):
        f = out[(pkg, "float32", "alone")]
        for how in ("alone", "batch"):
            d[pkg, how] = float(np.abs(out[(pkg, "bfloat16", how)] - f).max())
        assert d[pkg, "alone"] > 0                # bf16 rounds
        assert d[pkg, "batch"] <= 2 * d[pkg, "alone"], d
        assert d[pkg, "alone"] <= 2 * d[pkg, "batch"], d
    assert d["port", "alone"] <= 2 * d["ref", "alone"], d
    assert d["ref", "alone"] <= 2 * d["port", "alone"], d
    for how in ("batch", "alone"):
        want = out[("ref", "bfloat16", how)]
        gap = np.abs(out[("port", "bfloat16", how)] - want).max()
        assert gap <= 8 * 2.0 ** -7 * np.abs(want).max(), (how, gap, d)
