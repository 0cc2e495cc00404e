"""Port parity for the serve slice's arena layer: the session gather /
scatter kernel ops (their plain versions, which the CPU path runs)
against the reference's Pallas kernels in interpret mode, the arena's
allocator and pack/unpack, ragged block writes and memory recompression.

Tolerances: gather/scatter are pure copies, held bit-exact (atol 0).
Ragged writes are copies too (bit-exact).  Recompression is a float32
mean over at most ``group`` groups, computed with another summation
order: atol 1e-6; lanes and groups it must not touch are bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.core import memory as JMEM
from repro.core import streaming as JSTR
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro_torch.core import masks as PM
from repro_torch.core import memory as PMEM
from repro_torch.core import streaming as PSTR
from repro_torch.kernels import ops as pops
from repro_torch.kernels import session_gather as psess
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.serve.arena import ArenaFull, SessionArena, online_template

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}


def _slab(rs, shape, dtype):
    """The same slab for both: values exact in every dtype."""
    a = rs.integers(-100, 100, shape).astype(np.float32) / 4
    if dtype == "int8":
        a = rs.integers(-127, 128, shape).astype(np.float32)
    return jnp.asarray(a, _JDT[dtype]), torch.from_numpy(a).to(_TDT[dtype])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("row", [(37,), (2, 1, 4, 2, 8)],
                         ids=["2d", "5d"])
def test_session_gather_matches_pallas(dtype, row):
    rs = np.random.default_rng(0)
    S = 6
    js, ts = _slab(rs, (S,) + row, dtype)
    for ids in ([0, S - 1, 2], [3, 3, 0, 3], [S - 1]):   # dup ids gather
        want = jops.session_gather(js, jnp.asarray(ids, jnp.int32),
                                   interpret=True)
        got = pops.session_gather(ts, ids)
        assert got.dtype == ts.dtype and tuple(got.shape) == (len(ids),) + row
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(
            _np(got), _np(jref.session_gather_ref(js, jnp.asarray(ids))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("row", [(37,), (2, 1, 4, 2, 8)],
                         ids=["2d", "5d"])
def test_session_scatter_matches_pallas(dtype, row):
    """ids 0 and S-1 (the scratch row); the duplicate ids all land on the
    scratch row, so every other row is checked exactly."""
    rs = np.random.default_rng(1)
    S = 6
    js, ts = _slab(rs, (S,) + row, dtype)
    jr, tr = _slab(rs, (5,) + row, dtype)
    ids = [0, 2, S - 1, S - 1, S - 1]
    want = jops.session_scatter(js, jnp.asarray(ids, jnp.int32), jr,
                                interpret=True)
    got = pops.session_scatter(ts, ids, tr)
    assert got is ts                                 # in place
    np.testing.assert_array_equal(_np(got)[:S - 1], _np(want)[:S - 1])
    scratch = _np(got)[S - 1]
    assert any(np.array_equal(scratch, _np(tr)[i]) for i in (2, 3, 4))


def test_session_ops_validate_ids_and_shapes():
    slab = torch.zeros(4, 3)
    with pytest.raises(IndexError):
        pops.session_gather(slab, [0, 4])
    with pytest.raises(IndexError):
        pops.session_scatter(slab, [-1], torch.zeros(1, 3))
    # the card's wrapper refuses CPU tensors: no silent plain fallback
    with pytest.raises(ValueError, match="CUDA"):
        psess.session_gather(slab, [0])
    with pytest.raises(ValueError, match="CUDA"):
        psess.session_scatter(slab, [0], torch.zeros(1, 3))
    out = torch.empty(2, 3)
    assert pops.session_gather(torch.arange(12.).reshape(4, 3), [3, 1],
                               out=out) is out
    assert out[0].tolist() == [9.0, 10.0, 11.0]


# ---------------------------------------------------------------------------
# ragged writes and lane validity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("at,vl", [(0, 3), (5, 3), (6, 4), (7, 2), (9, 1),
                                   (3, 0)])
def test_ragged_block_write_matches_reference(at, vl):
    """Writes inside the buffer, overhanging its end (rows that fit are
    kept, no clamp-shift) and wholly past it."""
    rs = np.random.default_rng(2)
    buf = rs.normal(size=(2, 8, 3)).astype(np.float32)
    blk = rs.normal(size=(2, 4, 3)).astype(np.float32)
    want = np.asarray(JM.ragged_block_write(jnp.asarray(buf), jnp.asarray(blk),
                                            at, vl, axis=1))
    np.testing.assert_array_equal(
        np.asarray(jref.ragged_block_write_ref(jnp.asarray(buf),
                                               jnp.asarray(blk), at, vl,
                                               axis=1)), want)
    got = PM.ragged_block_write(torch.from_numpy(buf.copy()),
                                torch.from_numpy(blk), at, vl, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("at", [0, 3, 6, 9])
def test_layer_window_write_both_routes(ragged, at):
    """Unragged: clamp-shift at the buffer's end, like
    dynamic_update_slice.  Ragged: the rows that fit, no shift.  Per-lane
    starts and valid lengths in the lane-major layout give each lane what
    a single-lane write gives it."""
    rs = np.random.default_rng(3)
    buf = rs.normal(size=(2, 3, 8, 2)).astype(np.float32)   # (L, B, S, H)
    blk = rs.normal(size=(3, 4, 2)).astype(np.float32)
    vl = 3 if ragged else None
    want = np.asarray(JM.layer_window_write(jnp.asarray(buf), jnp.asarray(blk),
                                            1, at, vl))
    got = PM.layer_window_write(torch.from_numpy(buf.copy()),
                                torch.from_numpy(blk), 1, at, vl)
    np.testing.assert_array_equal(got.numpy(), want)
    # lanes: lane b starts at at + b with valid length vl - b (ragged)
    lanes = np.ascontiguousarray(buf.transpose(1, 0, 2, 3))  # (B, L, S, H)
    ats = np.array([at, at + 1, at + 2])
    vls = np.array([3, 2, 1]) if ragged else None
    got = PM.layer_window_write(torch.from_numpy(lanes.copy()),
                                torch.from_numpy(blk), 1, ats, vls,
                                lane_major=True)
    for b in range(3):
        one = np.asarray(JM.layer_window_write(
            jnp.asarray(buf[:, b:b + 1]), jnp.asarray(blk[b:b + 1]), 1,
            int(ats[b]), None if vls is None else int(vls[b])))
        np.testing.assert_array_equal(got[b].numpy(), one[:, 0])


def test_lane_valid_matches_reference():
    for vl, tail in ((3, None), (0, 5), (7, 4)):
        want = np.asarray(JM.lane_valid(7, jnp.asarray(vl), tail))
        np.testing.assert_array_equal(PM.lane_valid(7, vl, tail).numpy(),
                                      want)
    per = PM.lane_valid(7, np.array([1, 5]), tail_start=6)
    assert per.shape == (2, 7)
    np.testing.assert_array_equal(
        per[1].numpy(), np.asarray(JM.lane_valid(7, jnp.asarray(5), 6)))


# ---------------------------------------------------------------------------
# memory recompression
# ---------------------------------------------------------------------------

def _cfgs():
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32")
    cc = dict(comp_len=2, max_steps=6)
    return JCfg(**base, ccm=JCCM(**cc)), PCfg(**base, ccm=PCCM(**cc))


@pytest.mark.parametrize("slots,group", [(5, 2), (6, 3), (1, 2), (4, 1)])
def test_recompress_memory_matches_reference(slots, group):
    jc, pc = _cfgs()
    rs = np.random.default_rng(4)
    k = rs.normal(size=(2, 3, 12, 2, 16)).astype(np.float32)
    v = rs.normal(size=k.shape).astype(np.float32)
    jm = JMEM.MemState(k=jnp.asarray(k), v=jnp.asarray(v),
                       slots=jnp.asarray(slots, jnp.int32),
                       steps=jnp.asarray(7, jnp.int32),
                       stream_pos=jnp.asarray(70, jnp.int32))
    want = JMEM.recompress_memory(jc, jm, group)
    pm = PMEM.MemState(k=torch.from_numpy(k.copy()),
                       v=torch.from_numpy(v.copy()), slots=slots, steps=7,
                       stream_pos=70)
    got = PMEM.recompress_memory(pc, pm, group)
    assert got.slots == int(want.slots) and got.steps == 7 \
        and got.stream_pos == 70
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-6,
                               rtol=0)


def test_recompress_memory_lanes_matches_reference():
    """Per-lane slots; unselected lanes come back bit-exact."""
    jc, pc = _cfgs()
    rs = np.random.default_rng(5)
    N = 4
    k = rs.normal(size=(N, 2, 1, 12, 2, 16)).astype(np.float32)
    v = rs.normal(size=k.shape).astype(np.float32)
    slots = np.array([5, 1, 6, 4])
    do = np.array([True, False, True, False])
    jm = JMEM.MemState(k=jnp.asarray(k), v=jnp.asarray(v),
                       slots=jnp.asarray(slots, jnp.int32),
                       steps=jnp.asarray([3, 4, 5, 6], jnp.int32),
                       stream_pos=jnp.asarray([9, 8, 7, 6], jnp.int32))
    want = JSTR.recompress_memory_lanes(jc, jm, 2, jnp.asarray(do))
    lanes = PMEM.MemState(
        k=torch.from_numpy(k.copy()).reshape(N, 2, 12, 2, 16),
        v=torch.from_numpy(v.copy()).reshape(N, 2, 12, 2, 16),
        slots=slots.copy(), steps=np.array([3, 4, 5, 6]),
        stream_pos=np.array([9, 8, 7, 6]), lane_major=True)
    got = PSTR.recompress_memory_lanes(pc, lanes, 2, do)
    np.testing.assert_array_equal(got.slots, np.asarray(want.slots))
    np.testing.assert_array_equal(got.steps, [3, 4, 5, 6])
    wk = np.asarray(want.k).reshape(N, 2, 12, 2, 16)
    np.testing.assert_allclose(got.k.numpy(), wk, atol=1e-6, rtol=0)
    for b in (1, 3):                                  # bit-exact
        np.testing.assert_array_equal(got.k[b].numpy(),
                                      k[b].reshape(2, 12, 2, 16))
        np.testing.assert_array_equal(got.v[b].numpy(),
                                      v[b].reshape(2, 12, 2, 16))


# ---------------------------------------------------------------------------
# the arena: allocator, refcounts, write guard, pack/unpack
# ---------------------------------------------------------------------------

def _arena(n_slots=3, n_shards=1):
    _, pc = _cfgs()
    return SessionArena.for_online(pc, n_slots, cache_len=8,
                                   n_shards=n_shards, device="cpu")


def test_arena_layout_and_pack_unpack_roundtrip():
    arena = _arena()
    tmpl = online_template(_cfgs()[1], 8)
    assert tuple(arena.slabs.cache.k.shape) == (4,) + tuple(tmpl.cache.k.shape)
    assert arena.slabs.pos.shape == (4,) and arena.slabs.pos.dtype == np.int64
    assert arena.state_bytes == sum(
        x.numel() * x.element_size()
        for x in (tmpl.cache.k, tmpl.cache.v, tmpl.mem.k, tmpl.mem.v))
    a, b = arena.alloc(), arena.alloc()
    st = arena.pack([a, b])
    st.cache.k.normal_()
    st.mem.v.normal_()
    st = st._replace(pos=np.array([5, 9]))
    arena.unpack([a, b], st)
    back = arena.pack([b, a])
    assert torch.equal(back.cache.k[0], st.cache.k[1])
    assert list(back.pos) == [9, 5]
    one = arena.read_slot(a)
    assert one.pos == 5 and torch.equal(one.mem.v, st.mem.v[0])
    arena.reset_slots([a])
    assert arena.slabs.pos[a] == 0 and not arena.slabs.mem.v[a].any()
    assert arena.slabs.pos[b] == 9
    assert arena.consistency_errors() == []


def test_arena_refcounts_and_write_guard():
    arena = _arena()
    s = arena.alloc()
    arena.incref(s)
    assert arena.shared(s) and arena.shared_slots() == [s]
    with pytest.raises(RuntimeError, match="shared rows"):
        arena.unpack([s], arena.pack([s]))
    errs = arena.consistency_errors()
    assert len(errs) == 1 and "shared-row write" in errs[0]
    assert arena.free(s) == 1 and arena.free(s) == 0
    assert arena.n_free == 3
    arena.alloc(), arena.alloc(), arena.alloc()
    with pytest.raises(ArenaFull):
        arena.alloc()


def test_arena_shard_geometry():
    arena = _arena(n_slots=4, n_shards=2)
    assert arena.n_rows == 6
    assert list(arena.shard_slots(1)) == [3, 4]
    assert arena.pad_slot_of(1) == 5 and arena.pad_slot == 2
    assert arena.shard_of(4) == 1 and arena.local_row(4) == 1
    assert arena.alloc(1) == 3
    assert arena.metrics_sample()["shards"][1]["live"] == 1
    assert arena.consistency_errors() == []
