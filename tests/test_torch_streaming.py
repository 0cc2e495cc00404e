"""Port parity for the streaming slice: ``evict_oldest``,
``compress_from_kv``, ``stream_step`` (CCM and the StreamingLLM baseline,
concat and merge) and ``stream_step_lanes``, on shared weights, against
``repro`` (tiny config, float32, CPU; the reference's ``attn_impl``
'dense', its jnp segmented path).

Tolerances: ``evict_oldest`` is a copy, so atol 0.  Logits and float
state leaves atol 1e-5 (float32 sums in another order).  Counters must be
equal, and lanes with no eviction pending must come out of a lane-batched
step bit-equal to their input memory.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory as JMEM
from repro.core import streaming as JS
from repro.models import transformer as JT
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro_torch.core import memory as PMEM
from repro_torch.core import streaming as PS
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.params import params_from_numpy

ATOL = 1e-5
# the setting of tests/test_memory_state.py's streaming test: 192 tokens
# in chunks of 8 through a 32-token window fill the 4-group memory
WIDE = dict(stream_window=32, stream_sink=2, stream_chunk=8,
            stream_mem_slots=4)
# the serve tests' setting: a 16-token window, chunks of 4
NARROW = dict(stream_window=16, stream_sink=2, stream_chunk=4,
              stream_mem_slots=4)

_step = jax.jit(JS.stream_step, static_argnums=(1,),
                static_argnames=("ccm_on", "impl", "evict"))
_compress = jax.jit(JS.compress_from_kv, static_argnums=(1,))


def _cfgs(mode="concat", stream=WIDE):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32")
    cc = dict(comp_len=2, max_steps=4, mode=mode, **stream)
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


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


def _t(x, lane_major=False):
    """A port tensor as float32 numpy in the reference's layer-major
    layout."""
    x = x.float().numpy()
    return np.swapaxes(x, 0, 1) if lane_major else x


def _close(j, p, atol=ATOL):
    np.testing.assert_allclose(p, np.asarray(j, np.float32), atol=atol,
                               rtol=0)


def _compare_mem(jm, pm, atol=ATOL):
    _close(jm.k, _t(pm.k, pm.lane_major), atol)
    _close(jm.v, _t(pm.v, pm.lane_major), atol)
    for n in ("slots", "steps", "stream_pos"):
        want = np.asarray(getattr(jm, n))
        np.testing.assert_array_equal(
            np.broadcast_to(getattr(pm, n), want.shape), want, err_msg=n)


def _compare_stream(js, ps, atol=ATOL):
    _close(js.win_k, _t(ps.win_k, ps.lane_major), atol)
    _close(js.win_v, _t(ps.win_v, ps.lane_major), atol)
    assert int(js.win_len) == ps.win_len and int(js.pos) == ps.pos
    _compare_mem(js.mem, ps.mem, atol)


# ---------------------------------------------------------------------------
# evict_oldest and compress_from_kv
# ---------------------------------------------------------------------------

def _memories(mode, B, slots, seed, lane_major=False):
    """The same random memory in both packages."""
    jc, pc = _cfgs(mode)
    m = jc.ccm.comp_len
    M = (jc.ccm.stream_mem_slots if mode == "concat" else 1) * m
    rs = np.random.default_rng(seed)
    k, v = (rs.normal(size=(2, B, M, 2, 16)).astype(np.float32)
            for _ in range(2))
    jm = JMEM.MemState(k=jnp.asarray(k), v=jnp.asarray(v),
                       slots=jnp.int32(slots), steps=jnp.int32(slots + 1),
                       stream_pos=jnp.int32(7 * slots))
    # copies: the port writes in place, and the reference may read the
    # numpy buffers without a copy
    pk, pv = (torch.tensor(np.swapaxes(a, 0, 1) if lane_major else a)
              for a in (k, v))
    pm = PMEM.MemState(k=pk, v=pv, slots=slots, steps=slots + 1,
                       stream_pos=7 * slots, lane_major=lane_major)
    return jc, pc, jm, pm


@pytest.mark.parametrize("mode,lane_major", [("concat", False),
                                             ("concat", True),
                                             ("merge", False)],
                         ids=["concat-layer-major", "concat-lane-major",
                              "merge"])
def test_evict_oldest_matches_reference(mode, lane_major):
    jc, pc, jm, pm = _memories(mode, 3, 3 if mode == "concat" else 1, 0,
                               lane_major)
    m = jc.ccm.comp_len
    want = JMEM.evict_oldest(jm, m)
    got = PMEM.evict_oldest(pm, m)
    assert got.k is pm.k                         # in place
    _compare_mem(want, got, atol=0)


def test_evict_oldest_on_some_lanes():
    """Per-lane counters and a lane mask: the selected lanes equal the
    reference's eviction of each lane alone, the others stay bit-exact."""
    jc, pc, jm, pm = _memories("concat", 3, 0, 1, lane_major=True)
    m = jc.ccm.comp_len
    pm = pm._replace(slots=np.array([4, 2, 0]))
    before = pm.k.clone()
    got = PMEM.evict_oldest(pm, m, lanes=np.array([True, False, True]))
    np.testing.assert_array_equal(got.slots, [3, 2, 0])
    assert torch.equal(got.k[1], before[1])
    for b in (0, 2):
        lane = jm._replace(k=jm.k[:, b:b + 1], v=jm.v[:, b:b + 1])
        want = JMEM.evict_oldest(lane, m)
        _close(want.k[:, 0], got.k[b].numpy(), atol=0)
        _close(want.v[:, 0], got.v[b].numpy(), atol=0)


@pytest.mark.parametrize("mode,slots", [("concat", 2), ("concat", 4),
                                        ("merge", 1)],
                         ids=["concat", "concat-full", "merge"])
def test_compress_from_kv_matches_reference(mode, slots):
    """The <COMP> pass over [mem | block | self] and the memory update,
    through the memory-full branch (``evict_oldest``) in concat-full."""
    jc, pc, jm, pm = _memories(mode, 2, slots, 2)
    jp, pp = _params(pc)
    rs = np.random.default_rng(3)
    blk = [rs.normal(size=(2, 2, 8, 2, 16)).astype(np.float32)
           for _ in range(2)]
    want = _compress(jp, jc, jm, jnp.asarray(blk[0]), jnp.asarray(blk[1]),
                     jnp.int32(40))
    got = PS.compress_from_kv(pp, pc, pm, torch.from_numpy(blk[0]),
                              torch.from_numpy(blk[1]), 40)
    _compare_mem(want, got)


# ---------------------------------------------------------------------------
# stream_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["concat", "merge"])
@pytest.mark.parametrize("ccm_on", [True, False], ids=["ccm", "baseline"])
def test_stream_step_matches_reference(mode, ccm_on):
    """24 chunks of 8 tokens: the window overflows from the 5th chunk on,
    and with CCM the concat memory fills (4 groups) and then drops its
    oldest group at every eviction.  Logits every step, every state leaf
    at the end."""
    jc, pc = _cfgs(mode)
    jp, pp = _params(pc)
    toks = _toks(4, (2, 192))
    js = JS.init_stream_state(jc, 2)
    ps = PS.init_stream_state(pc, 2, device="cpu")
    for i in range(0, 192, 8):
        jl, js = _step(jp, jc, js, jnp.asarray(toks[:, i:i + 8]),
                       ccm_on=ccm_on)
        pl, ps = PS.stream_step(pp, pc, ps, torch.from_numpy(toks[:, i:i + 8]),
                                ccm_on=ccm_on)
        _close(jl, pl.numpy())
        assert ps.win_len == int(js.win_len) <= 32
    _compare_stream(js, ps)
    assert ps.mem.slots == ((4 if mode == "concat" else 1) if ccm_on else 0)


@pytest.mark.parametrize("stream,width", [(WIDE, 9), (
    dict(WIDE, stream_window=8), 4)], ids=["chunk-over-quantum",
                                             "block-over-window"])
def test_stream_step_guards(stream, width):
    _, pc = _cfgs(stream=stream)
    _, pp = _params(pc)
    st = PS.init_stream_state(pc, 1, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        PS.stream_step(pp, pc, st, torch.zeros((1, width), dtype=torch.int32))


def test_make_stream_step_matches_stream_step():
    """The single-batch builder runs `stream_step`; a sharded build
    (``dist=``) on a mesh of one rank places the whole state and runs the
    same step, bit for bit (meshes that split the model are
    ``tests/test_torch_tp_online.py``)."""
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch import serve as PSRV
    _, pc = _cfgs()
    _, pp = _params(pc)
    toks = torch.from_numpy(_toks(5, (2, 8)))
    a, b, c = (PS.init_stream_state(pc, 2, device="cpu") for _ in range(3))
    want, a = PS.stream_step(pp, pc, a, toks)
    got, b = PSRV.make_stream_step(pc)(pp, b, toks)
    assert torch.equal(got, want) and torch.equal(b.win_k, a.win_k)
    assert (b.win_len, b.pos) == (8, 8)

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    step = PSRV.make_stream_step(pc, dist=DistContext(mesh=Mesh()))
    pl, c = step.place(pp, c)
    got, c = step(pl, c, toks)
    assert torch.equal(got, want) and torch.equal(c.win_k, a.win_k)
    assert (c.win_len, c.pos) == (8, 8)


def test_init_stream_state_needs_a_device(monkeypatch):
    _, pc = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.init_stream_state(pc, 1)
    st = PS.init_stream_state(pc, 2, device="cpu")
    assert tuple(st.win_k.shape) == (2, 2, 32, 2, 16)
    assert tuple(st.mem.k.shape) == (2, 2, 8, 2, 16)
    assert (st.win_len, st.pos, st.mem.slots) == (0, 0, 0)


# ---------------------------------------------------------------------------
# lane-batched steps (the serve engine's stream op)
# ---------------------------------------------------------------------------

def _warm(jc, pc, jp, pp, chunks, seed):
    """One session in both packages after ``chunks`` (token counts)."""
    js = JS.init_stream_state(jc, 1)
    ps = PS.init_stream_state(pc, 1, device="cpu")
    for j, n in enumerate(chunks):
        t = _toks(seed * 100 + j, (1, n))
        _, js = _step(jp, jc, js, jnp.asarray(t))
        _, ps = PS.stream_step(pp, pc, ps, torch.from_numpy(t))
    return js, ps


def _stack(states):
    """B=1 port sessions -> N lanes: lane-major tensors, per-lane
    counters (the arena-gather layout seen through ``to_lanes``)."""
    def t(get):
        return torch.stack([get(s)[:, 0] for s in states])

    def c(get):
        return np.array([get(s) for s in states], np.int64)
    mem = PMEM.MemState(k=t(lambda s: s.mem.k), v=t(lambda s: s.mem.v),
                        slots=c(lambda s: s.mem.slots),
                        steps=c(lambda s: s.mem.steps),
                        stream_pos=c(lambda s: s.mem.stream_pos),
                        lane_major=True)
    return PS.StreamState(win_k=t(lambda s: s.win_k),
                          win_v=t(lambda s: s.win_v),
                          win_len=c(lambda s: s.win_len), mem=mem,
                          pos=c(lambda s: s.pos), lane_major=True)


def _lane(st, i):
    """Lane ``i`` of a lane-batched port state, as a B=1 layer-major
    state."""
    def t(x):
        return x[i][:, None]
    mem = st.mem
    return PS.StreamState(
        win_k=t(st.win_k), win_v=t(st.win_v), win_len=int(st.win_len[i]),
        pos=int(st.pos[i]),
        mem=PMEM.MemState(k=t(mem.k), v=t(mem.v), slots=int(mem.slots[i]),
                          steps=int(mem.steps[i]),
                          stream_pos=int(mem.stream_pos[i])))


@pytest.mark.parametrize("mode", ["concat", "merge"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "masked"])
def test_stream_step_lanes_matches_reference(mode, compact):
    """Staggered lanes: lane 0 evicts with a full memory (its oldest group
    drops), lane 3 evicts for the first time, lanes 1 and 2 do not evict.
    Each lane matches the reference's lane-batched step (in its compact
    and its masked form) and the pending lanes alone were touched."""
    jc, pc = _cfgs(mode, NARROW)
    jp, pp = _params(pc)
    warm = [[4] * 8, [4], [], [4] * 4]
    pairs = [_warm(jc, pc, jp, pp, w, i) for i, w in enumerate(warm)]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[j for j, _ in pairs])
    pst = _stack([p for _, p in pairs])
    keep = {n: getattr(pst, n).clone() for n in ("win_k", "win_v")}
    keep.update(mem_k=pst.mem.k.clone(), mem_v=pst.mem.v.clone())
    ctr = {n: getattr(pst.mem, n).copy() for n in ("slots", "steps",
                                                   "stream_pos")}
    win_len, pos = pst.win_len.copy(), pst.pos.copy()
    toks = _toks(99, (4, 1, 4))
    pending = PS.eviction_pending(pc, pst, np.full(4, 4))
    assert list(pending) == [True, False, False, True]
    jl, jnew = JS.stream_step_lanes(jp, jc, jst, jnp.asarray(toks),
                                    compact=compact)
    pl, pnew = PS.stream_step_lanes(pp, pc, pst, torch.from_numpy(toks))
    assert tuple(pl.shape) == (4, 1, 4, 128)
    for i in range(4):
        _close(jl[i], pl[i].numpy())
        _compare_stream(jax.tree.map(lambda a: a[i], jnew), _lane(pnew, i))
    for i in (1, 2):                              # no eviction: untouched
        assert torch.equal(pnew.mem.k[i], keep["mem_k"][i])
        assert torch.equal(pnew.mem.v[i], keep["mem_v"][i])
        for n, c in ctr.items():
            assert getattr(pnew.mem, n)[i] == c[i]
        assert pnew.pos[i] == pos[i] + 4
        # the window only gained the chunk's rows
        wl = win_len[i]
        for n in ("win_k", "win_v"):
            assert torch.equal(getattr(pnew, n)[i][:, :wl], keep[n][i][:, :wl])
    if mode == "concat":
        assert list(pnew.mem.slots) == [4, 0, 0, 1]


def test_stream_ragged_lanes_match_unpadded():
    """Ragged lanes padded to a 4-token bucket: the eviction fires on the
    valid length (lane 0 holds 14 rows: 2 more fit, the padded 4 would
    not), and every lane equals its unpadded run alone, in the port and
    in the reference.  atol 1e-5 (the reference's own padded-vs-unpadded
    check fails at 2e-6 in its float32)."""
    jc, pc = _cfgs("concat", NARROW)
    jp, pp = _params(pc)
    warm = [[4, 4, 4, 2], [4] * 4, [3]]
    pairs = [_warm(jc, pc, jp, pp, w, 10 + i) for i, w in enumerate(warm)]
    pst = _stack([p for _, p in pairs])
    toks = _toks(77, (3, 1, 4))
    vls = np.array([2, 4, 1])
    assert list(PS.eviction_pending(pc, pst, vls)) == [False, True, False]
    pl, pnew = PS.stream_step_lanes(pp, pc, pst, torch.from_numpy(toks),
                                    lengths=vls)
    for i, (js, ps) in enumerate(pairs):
        vl = int(vls[i])
        t = toks[i][:, :vl]
        jl1, js1 = _step(jp, jc, js, jnp.asarray(t))
        pl1, ps1 = PS.stream_step(pp, pc, ps, torch.from_numpy(t))
        lane = _lane(pnew, i)
        _close(pl1[0].numpy(), pl[i, 0, :vl].numpy())
        _close(jl1[0], pl[i, 0, :vl].numpy())
        for n in ("win_k", "win_v"):
            _close(getattr(ps1, n).numpy(), getattr(lane, n).numpy())
        _compare_stream(js1, lane)
        assert (lane.win_len, lane.pos, lane.mem.slots) == \
            (ps1.win_len, ps1.pos, ps1.mem.slots)
