"""Port parity for ``core/memory.update_memory`` (g_update) against
``repro``: concat mode past the slot capacity (the reference's clamped
write: the newest group overwrites the last slot) and merge mode with
the 1/t arithmetic mean and an EMA ``merge_alpha``.

Per-lane counters (a batch packed from sessions at different t, with
lane-major or layer-major memory) are held against the reference run on
each lane alone; merge mode makes one kernel op call per g_update and
hands it the caller's ``h`` uncopied.

Tolerance: memory k/v atol 1e-6 — float32 on both sides; the port's merge
kernel op computes (1 - a) * mem + a * h in float32 as the reference does
for a float32 memory.  Counters must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory as JM
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro_torch.core import memory as PM
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg


def _cfgs(mode, alpha=None, max_steps=3):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32")
    cc = dict(comp_len=2, max_steps=max_steps, mode=mode, merge_alpha=alpha)
    return JCfg(**base, ccm=JCCM(**cc)), PCfg(**base, ccm=PCCM(**cc))


def _compare(jm, pm):
    np.testing.assert_allclose(np.asarray(jm.k), pm.k.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(jm.v), pm.v.numpy(), atol=1e-6,
                               rtol=0)
    assert (int(jm.slots), int(jm.steps), int(jm.stream_pos)) \
        == (pm.slots, pm.steps, pm.stream_pos)


@pytest.mark.parametrize("mode,alpha", [("concat", None), ("merge", None),
                                        ("merge", 0.25)])
def test_update_memory_matches_reference(mode, alpha):
    jc, pc = _cfgs(mode, alpha)
    B = 2
    jm = JM.init_memory(jc, B)
    pm = PM.init_memory(pc, B, device="cpu")
    assert tuple(jm.k.shape) == tuple(pm.k.shape)
    rs = np.random.default_rng(0)
    for t in range(1, 6):               # T = 5 > max_steps = 3 slots
        hk, hv = rs.normal(size=(2, 2, B, 2, 2, 16)).astype(np.float32)
        n = 10 + t
        jm = JM.update_memory(jc, jm, jnp.asarray(hk), jnp.asarray(hv),
                              jnp.asarray(n))
        pm = PM.update_memory(pc, pm, torch.from_numpy(hk),
                              torch.from_numpy(hv), n)
        _compare(jm, pm)
    if mode == "concat":
        assert pm.slots == pm.max_slots(2) == 3
        np.testing.assert_array_equal(pm.k[:, :, 4:6].numpy(), hk)


def test_memory_valid_len_and_init_shape():
    _, pc = _cfgs("merge")
    pm = PM.init_memory(pc, 3, device="cpu")
    assert tuple(pm.k.shape) == (2, 3, 2, 2, 16)
    assert pm.valid_len(2) == 0 and pm.max_slots(2) == 1


def _lanes_state(pc, rs, B, steps, lane_major):
    """A float32 merge memory of B lanes with random contents and the
    given per-lane steps, as a port MemState in either layout."""
    L, m, H, hd = 2, 2, 2, 16
    k, v = rs.normal(size=(2, L, B, m, H, hd)).astype(np.float32)
    steps = np.asarray(steps, np.int64)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if lane_major:
        tk, tv = (x.transpose(0, 1).contiguous() for x in (tk, tv))
    pm = PM.MemState(k=tk, v=tv, slots=np.ones(B, np.int64), steps=steps,
                     stream_pos=steps * 10, lane_major=lane_major)
    return k, v, pm


@pytest.mark.parametrize("alpha", [None, 0.25])
@pytest.mark.parametrize("lane_major", [True, False])
def test_update_memory_per_lane_steps_match_reference(lane_major, alpha):
    """Lanes at t = 1, 2, 3, 5 (per-lane a_t), two updates in a row,
    against ``repro.core.memory.update_memory`` on each lane alone.
    Layer-major memory with per-lane steps used to be refused."""
    jc, pc = _cfgs("merge", alpha)
    rs = np.random.default_rng(4)
    B, steps = 4, [0, 1, 2, 4]
    k, v, pm = _lanes_state(pc, rs, B, steps, lane_major)
    jms = [JM.MemState(k=jnp.asarray(k[:, b:b + 1]),
                       v=jnp.asarray(v[:, b:b + 1]),
                       slots=jnp.asarray(1), steps=jnp.asarray(steps[b]),
                       stream_pos=jnp.asarray(steps[b] * 10))
           for b in range(B)]
    for _ in range(2):
        hk, hv = rs.normal(size=(2,) + k.shape).astype(np.float32)
        n = np.arange(B) + 20
        pm = PM.update_memory(pc, pm, torch.from_numpy(hk),
                              torch.from_numpy(hv), n)
        jms = [JM.update_memory(jc, jm, jnp.asarray(hk[:, b:b + 1]),
                                jnp.asarray(hv[:, b:b + 1]),
                                jnp.asarray(n[b])) for b, jm in enumerate(jms)]
        for b, jm in enumerate(jms):
            for got, want in ((pm.lane(b, pm.k), jm.k), (pm.lane(b, pm.v),
                                                         jm.v)):
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(want)[:, 0],
                                           atol=1e-6, rtol=0)
            assert (int(pm.steps[b]), int(pm.stream_pos[b])) \
                == (int(jm.steps), int(jm.stream_pos))


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("lane_major", [False, True])
def test_merge_update_is_one_op_call_on_the_callers_h(monkeypatch,
                                                      lane_major, per_lane):
    """Every merge g_update is exactly one ``kv_merge_update_lanes`` call
    (k and v together), whatever the layout and whether the lanes share
    t, and the h it receives is the caller's storage (no copy, no cast)."""
    _, pc = _cfgs("merge")
    rs = np.random.default_rng(9)
    B = 3
    k, _, pm = _lanes_state(pc, rs, B, [1, 2, 5] if per_lane else [2] * B,
                            lane_major)
    if not per_lane:
        pm = pm._replace(steps=2, slots=1, stream_pos=20)
    calls = []
    real = PM.ops.kv_merge_update_lanes

    def spy(mems, hs, a, lane_axis=0):
        calls.append((mems, hs, a, lane_axis))
        return real(mems, hs, a, lane_axis)

    def refuse(*args, **kw):
        raise AssertionError("the one-tensor op was called")

    monkeypatch.setattr(PM.ops, "kv_merge_update_lanes", spy)
    monkeypatch.setattr(PM.ops, "kv_merge_update", refuse)
    hk, hv = (torch.from_numpy(x) for x in
              rs.normal(size=(2,) + k.shape).astype(np.float32))
    for t in range(2):
        PM.update_memory(pc, pm, hk, hv, 11)
        assert len(calls) == t + 1
    mems, hs, a, axis = calls[0]
    assert mems[0] is pm.k and mems[1] is pm.v
    assert axis == (0 if lane_major else 1)
    assert isinstance(a, float) != per_lane
    for got, caller in zip(hs, (hk, hv)):
        assert got.untyped_storage().data_ptr() \
            == caller.untyped_storage().data_ptr()
        assert got.dtype == caller.dtype
