"""Session-sharded serving in the port: the cases of
``tests/test_sharded_serve.py`` (sharded arena layout, per-shard
scheduler pops, placement and wrong-shard routing, the mesh checks, the
shard gauges, and multi-shard against single-shard bit-exactness, both
as a loop over shards and on a session mesh of 4 CPU "devices"), then
the port against the reference on the same numpy weights and traffic:
the 2-shard loop in this process, and the 4-shard mesh against the
reference's ``shard_map`` engine run in a subprocess with 4 forced host
devices.

Tolerance against the reference: logits atol 1e-4 (float32; the port
batches lanes natively where the reference vmaps single-session ops, as
``tests/test_torch_serve.py`` states).  Inside the port, every sharded
answer is bit-equal to the 1-shard engine's.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.launch import serve as SRV
from repro_torch.launch.mesh import make_session_mesh
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.params import params_from_numpy
from repro_torch.serve.arena import ArenaFull, SessionArena, tree_leaves
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
MODEL = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, compute_dtype="float32")


@pytest.fixture(scope="module")
def cfgs():
    cc = dict(comp_len=2, max_steps=4)
    return JCfg(**MODEL, ccm=JCCM(**cc)), PCfg(**MODEL, ccm=PCCM(**cc))


@pytest.fixture(scope="module")
def cfg(cfgs):
    return cfgs[1]


@pytest.fixture(scope="module")
def params(cfgs):
    """The reference's init (PRNGKey 0), for both packages."""
    jp = JT.init_lm(jax.random.PRNGKey(0), cfgs[0])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfgs[1],
                                 device="cpu")


def _toks(key, n, vocab=128):
    return np.random.default_rng(key).integers(0, vocab, n).astype(np.int32)


# ---------------------------------------------------------------------------
# arena: sharded layout
# ---------------------------------------------------------------------------

def test_sharded_arena_layout(cfg):
    arena = SessionArena.for_online(cfg, n_slots=6, cache_len=16,
                                    n_shards=2, device="cpu")
    assert arena.slots_per_shard == 3
    assert list(arena.shard_slots(0)) == [0, 1, 2]
    assert arena.pad_slot_of(0) == 3
    assert list(arena.shard_slots(1)) == [4, 5, 6]
    assert arena.pad_slot_of(1) == 7
    assert tree_leaves(arena.slabs)[0].shape[0] == 8
    for s in (0, 1):
        for slot in arena.shard_slots(s):
            assert arena.shard_of(slot) == s
        assert arena.local_row(arena.pad_slot_of(s)) == 3
    got = [arena.alloc(1) for _ in range(3)]
    assert got == [4, 5, 6]
    with pytest.raises(ArenaFull, match="shard 1"):
        arena.alloc(1)
    assert arena.shard_free(0) == 3 and arena.shard_free(1) == 0
    assert arena.alloc(0) == 0
    arena.free(5)
    assert arena.shard_free(1) == 1 and arena.alloc(1) == 5
    assert not arena.consistency_errors()
    sample = arena.metrics_sample()
    assert len(sample["shards"]) == 2
    assert sample["shards"][1]["live"] == 3


def test_sharded_arena_rejects_indivisible(cfg):
    with pytest.raises(ValueError):
        SessionArena.for_online(cfg, n_slots=5, cache_len=16, n_shards=2,
                                device="cpu")


def test_single_shard_arena_matches_seed_layout(cfg):
    arena = SessionArena.for_online(cfg, n_slots=3, cache_len=16,
                                    device="cpu")
    assert arena.n_shards == 1 and arena.slots_per_shard == 3
    assert arena.pad_slot == 3 and arena.pad_slot_of(0) == 3
    assert tree_leaves(arena.slabs)[0].shape[0] == 4
    assert [arena.alloc() for _ in range(3)] == [0, 1, 2]


def test_placed_arena_routes_rows_to_their_block(cfg):
    """Under a mesh each shard's block (slots + scratch) is a tensor of
    its own on its device; pack / unpack / reset route global ids to the
    owning block, and a batch spanning shards is refused."""
    from repro_torch.distributed.sharding import arena_placement
    mesh = make_session_mesh(2, device="cpu")
    arena = SessionArena.for_online(cfg, n_slots=4, cache_len=16,
                                    n_shards=2, device="cpu",
                                    place=arena_placement(mesh))
    blocks = arena.slabs.blocks
    assert len(blocks) == 2 and arena.devices == mesh.devices
    assert all(b.cache.k.shape[0] == 3 for b in blocks)
    assert blocks[0].cache.k.data_ptr() != blocks[1].cache.k.data_ptr()
    row = arena.read_slot(4)
    row = row._replace(cache=row.cache._replace(
        k=torch.ones_like(row.cache.k)), pos=7)
    arena.write_slot(4, row)                     # shard 1, local row 1
    assert bool((blocks[1].cache.k[1] == 1).all())
    assert int(blocks[1].pos[1]) == 7 and not bool(blocks[0].cache.k.any())
    with pytest.raises(ValueError, match="span shards"):
        arena.pack([0, 4])
    arena.reset_slots([4])
    assert not bool(blocks[1].cache.k.any()) and int(blocks[1].pos[1]) == 0


# ---------------------------------------------------------------------------
# scheduler: sharded pops
# ---------------------------------------------------------------------------

def _submit(sch, sid, kind, n, shard, **kw):
    req = sch.make_request(sid, kind, np.zeros(n, np.int32), **kw)
    req.shard = shard
    return sch.enqueue(req)


def test_sharded_pop_common_bucket_and_empty_shards():
    sch = Scheduler(batch_buckets=(1, 2, 4), token_buckets=(8,))
    for sid in "abc":
        _submit(sch, sid, "ingest", 8, 0)
    _submit(sch, "d", "ingest", 8, 2)
    sb = sch.next_sharded_batches(4)
    assert sb.kind == "ingest" and sb.token_len == 8
    assert sb.bucket == 4 and len(sb.shards) == 4
    assert [len(s.requests) for s in sb.shards] == [3, 0, 1, 0]
    assert all(s.bucket == 4 for s in sb.shards)
    assert [r.sid for r in sb.requests] == ["a", "b", "c", "d"]
    assert sb.n_requests == 4 and sch.next_sharded_batches(4) is None


def test_sharded_pop_per_shard_and_total_caps():
    sch = Scheduler(batch_buckets=(1, 2, 4, 8), token_buckets=(4,))
    for i in range(4):
        _submit(sch, f"a{i}", "ingest", 4, 0)
        _submit(sch, f"b{i}", "ingest", 4, 1)
    sb = sch.next_sharded_batches(2, per_shard_cap=2, max_total=3)
    assert [len(s.requests) for s in sb.shards] == [2, 1]
    assert sch._round == 1
    sb2 = sch.next_sharded_batches(2, per_shard_cap={"ingest": 2},
                                   max_total={"ingest": 8})
    assert [len(s.requests) for s in sb2.shards] == [2, 2]


def test_sharded_pop_tenant_caps_apply_globally():
    sch = Scheduler(batch_buckets=(1, 2, 4), token_buckets=(4,))
    for i, shard in enumerate((0, 0, 1, 1)):
        _submit(sch, f"t{i}", "ingest", 4, shard, tenant="t0")
    _submit(sch, "u", "ingest", 4, 1, tenant="t1")
    sb = sch.next_sharded_batches(2, tenant_lane_caps={"t0": 2})
    assert len([r for r in sb.requests if r.tenant == "t0"]) == 2
    assert "u" in [r.sid for r in sb.requests]


def test_sharded_pop_rejects_out_of_range_shard():
    sch = Scheduler(batch_buckets=(1, 2), token_buckets=(4,))
    _submit(sch, "a", "ingest", 4, 3)
    with pytest.raises(ValueError, match="shard 3"):
        sch.next_sharded_batches(2)


# ---------------------------------------------------------------------------
# engine: placement, verdict routing, wrong-shard no-ops (loop path)
# ---------------------------------------------------------------------------

def _null_engine(cfg, n_shards, n_slots=4, **kw):
    return ServeEngine(None, cfg, n_slots=n_slots, cache_len=32,
                       n_shards=n_shards, step_factory=SRV.make_null_step,
                       batch_buckets=(1, 2, 4), token_buckets=(4, 8),
                       device="cpu", **kw)


def test_placement_least_loaded_and_explicit(cfg):
    eng = _null_engine(cfg, 2)
    assert [eng.create_session(f"s{i}") for i in range(4)] == [0, 1, 0, 1]
    assert eng.shard_of("s2") == 0
    eng.close_session("s0")
    assert eng.create_session("s4") == 0
    assert eng.create_session("s5", shard=1) == 1
    with pytest.raises(ValueError):
        eng.create_session("s6", shard=2)


def test_verdict_carries_owning_shard(cfg):
    eng = _null_engine(cfg, 2)
    eng.create_session("a")
    eng.create_session("b")
    va = eng.ingest("a", _toks(0, 4))
    vb = eng.ingest("b", _toks(1, 4))
    assert va.shard == eng.shard_of("a") == 0
    assert vb.shard == eng.shard_of("b") == 1
    assert va.request.shard == 0 and vb.request.shard == 1


def test_wrong_shard_close_and_offload_are_structured_noops(cfg):
    eng = _null_engine(cfg, 2)
    eng.create_session("a")
    eng.ingest("a", _toks(0, 4))
    eng.run()
    wrong = (eng.shard_of("a") + 1) % 2
    res = eng.offload_session("a", shard=wrong)
    assert res.status == "wrong-shard" and res.sid == "a"
    assert eng._mgr["online"].sessions["a"].resident
    res = eng.close_session("a", shard=wrong)
    assert res.status == "wrong-shard" and "a" in eng._kind
    assert eng.offload_session("a", shard=eng.shard_of("a")).status \
        == "offloaded"
    assert eng.close_session("a", shard=0).status == "closed"
    assert "a" not in eng._kind


def test_mesh_requires_matching_shards_and_stock_steps(cfg):
    class FakeMesh:
        axis_names = ("data",)
        shape = {"data": 2}
    with pytest.raises(ValueError, match="shards"):
        ServeEngine(None, cfg, n_slots=4, mesh=FakeMesh(),
                    step_factory=SRV.make_null_step, device="cpu")
    mesh = make_session_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        ServeEngine(None, cfg, n_slots=4, mesh=mesh, n_shards=4,
                    device="cpu")
    with pytest.raises(ValueError, match="step_factory"):
        ServeEngine(None, cfg, n_slots=4, mesh=mesh,
                    step_factory=SRV.make_null_step, device="cpu")
    with pytest.raises(ValueError):
        make_session_mesh(0, device="cpu")


def test_sharded_gauges_render_in_prometheus(cfg):
    eng = _null_engine(cfg, 2)
    for i in range(3):
        eng.create_session(f"s{i}")
        eng.ingest(f"s{i}", _toks(i, 4))
    eng.run()
    text = eng.metrics_prometheus()
    assert 'serve_shard_occupancy{arena="online",shard="0"}' in text
    assert 'serve_shard_resident_sessions{arena="online",shard="1"}' in text
    assert 'serve_shard_queue_depth{shard="0"}' in text
    assert "serve_cross_shard_moves_total 0" in text


# ---------------------------------------------------------------------------
# bit-exactness inside the port, and the port against the reference
# ---------------------------------------------------------------------------

def _drive(engine_cls, params, cfg, n_shards, mesh=None, n_sessions=4,
           n_slots=4, **kw):
    eng = engine_cls(params, cfg, n_slots=n_slots, cache_len=32,
                     n_shards=n_shards, mesh=mesh, batch_buckets=(1, 2, 4),
                     token_buckets=(4, 8), **kw)
    for i in range(n_sessions):
        eng.create_session(f"s{i}")
    reqs, k = [], 0
    for _ in range(2):
        for i in range(n_sessions):
            reqs.append(eng.ingest(f"s{i}", _toks(k, 8)).request)
            k += 1
        for i in range(n_sessions):
            reqs.append(eng.query(f"s{i}", _toks(k, 3 + i % 2)).request)
            k += 1
        eng.run()
    return eng, reqs


def _results(reqs):
    assert all(r.done for r in reqs)
    return [None if r.result is None else np.asarray(r.result)
            for r in reqs]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def _healthy(eng, n_shards, n_sessions):
    assert eng._m_cross_shard.value == 0
    assert [eng.shard_of(f"s{i}") for i in range(n_sessions)] \
        == [i % n_shards for i in range(n_sessions)]
    errs = eng._mgr["online"].arena.consistency_errors()
    assert not errs, errs


def test_multi_shard_loop_path_bit_exact_vs_single(params, cfgs):
    """The same mixed ragged traffic through a 1-shard and a 2-shard
    engine (loop path): every logit row bit-equal; then the 2-shard
    engine against the reference's on the same weights and traffic."""
    jp, pp = params
    e1, r1 = _drive(ServeEngine, pp, cfgs[1], 1, device="cpu")
    e2, r2 = _drive(ServeEngine, pp, cfgs[1], 2, device="cpu")
    _assert_equal(_results(r2), _results(r1))
    _healthy(e2, 2, 4)
    _, jr = _drive(JEngine, jp, cfgs[0], 2)
    for a, b in zip(_results(r2), _results(jr)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


_REF_MESH = """
import sys
import jax, numpy as np
from repro.models.config import ModelConfig, CCMConfig
from repro.models import transformer as T
from repro.serve.engine import ServeEngine
from repro.launch.mesh import make_session_mesh
assert jax.device_count() == 4
cfg = ModelConfig({model}, ccm=CCMConfig(comp_len=2, max_steps=4))
params = T.init_lm(jax.random.PRNGKey(0), cfg)
def toks(key, n):
    return np.random.default_rng(key).integers(0, 128, n).astype(np.int32)
eng = ServeEngine(params, cfg, n_slots=8, cache_len=32,
                  mesh=make_session_mesh(4), batch_buckets=(1, 2, 4),
                  token_buckets=(4, 8))
for i in range(8):
    eng.create_session(f"s{{i}}")
reqs, k = [], 0
for _ in range(2):
    for i in range(8):
        reqs.append(eng.ingest(f"s{{i}}", toks(k, 8)).request)
        k += 1
    for i in range(8):
        reqs.append(eng.query(f"s{{i}}", toks(k, 3 + i % 2)).request)
        k += 1
    eng.run()
assert eng._m_cross_shard.value == 0
out = {{f"r{{i}}": np.asarray(r.result) for i, r in enumerate(reqs)
       if r.result is not None}}
np.savez(sys.argv[1], **out)
print("SAVED", len(reqs))
"""


def test_mesh_engine_bit_exact_vs_single_shard(params, cfgs, tmp_path):
    """A 4-shard engine on a session mesh of 4 CPU devices against the
    1-shard engine on the same traffic (bit-equal, placement
    [0, 1, 2, 3, 0, 1, 2, 3], no cross-shard move), each shard's rows
    in its own block on its own mesh device, also across an offload and
    restore; then against the reference's 4-device ``shard_map`` engine
    (a subprocess with 4 forced host devices)."""
    jp, pp = params
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    model = ", ".join(f"{k}={v!r}" for k, v in MODEL.items())
    ref = subprocess.Popen([sys.executable, "-c",
                            textwrap.dedent(_REF_MESH.format(model=model)),
                            str(out)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        mesh = make_session_mesh(4, device="cpu")
        e1, r1 = _drive(ServeEngine, pp, cfgs[1], 1, n_sessions=8,
                        n_slots=8, device="cpu")
        e4, r4 = _drive(ServeEngine, pp, cfgs[1], 4, mesh=mesh,
                        n_sessions=8, n_slots=8, device="cpu")
        _assert_equal(_results(r4), _results(r1))
        _healthy(e4, 4, 8)
        arena = e4._mgr["online"].arena
        assert arena.devices == mesh.devices
        assert [b.cache.k.shape[0] for b in arena.slabs.blocks] == [3] * 4
        row = arena.read_slot(e4._mgr["online"].sessions["s0"].slot)
        assert e4.offload_session("s0").status == "offloaded"
        e4._mgr["online"].activate_batch(["s0"])       # restore
        again = arena.read_slot(e4._mgr["online"].sessions["s0"].slot)
        for a, b in zip(tree_leaves(row), tree_leaves(again)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) \
                else a == b
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    want = np.load(out)
    got = {f"r{i}": x for i, x in enumerate(_results(r4)) if x is not None}
    assert sorted(got) == sorted(want.files) and len(got) == 16
    for k, x in got.items():
        np.testing.assert_allclose(x, want[k], atol=ATOL, rtol=0)


def test_mesh_engine_forks_prefixes_and_recompresses(params, cfgs):
    """The control plane's row operations on a placed arena — a prefix
    hit, a fork and its copy-on-write break, LRU offload and restore, a
    pressure recompression, each routed to the owning shard's block —
    against the same 2-shard engine as a loop over one slab (the same
    control plane, so the same decisions): every answer bit-equal, no
    cross-shard move, the arena consistent."""
    from repro_torch.serve import PressurePolicy
    _, pp = params

    def drive(**kw):
        eng = ServeEngine(pp, cfgs[1], n_slots=4, cache_len=32,
                          batch_buckets=(1, 2, 4), token_buckets=(4, 8),
                          pressure_policy=PressurePolicy(
                              capacity_tokens=10 ** 6),
                          device="cpu", **kw)
        prefix = _toks(99, 8)
        for i in range(4):
            eng.create_session(f"s{i}", prefix_tokens=prefix
                               if i == 0 else None)
        eng.run()                     # s0's prefix: compressed, cached
        eng.create_session("s4", prefix_tokens=prefix)       # a hit
        for r in range(2):
            for i in range(5):
                eng.ingest(f"s{i}", _toks(10 * r + i, 6 + i % 3))
            eng.run()
        assert eng.pressure.relieve(cfgs[1].ccm.comp_len) > 0
        assert any(d["lever"] == "recompress"
                   for d in eng.pressure.decisions)
        eng.fork_session("s1", "f1")
        eng.run()
        reqs = [eng.query(s, _toks(50 + i, 4)).request
                for i, s in enumerate(["s0", "s1", "f1", "s2", "s3", "s4"])]
        eng.run()
        assert eng._m_cross_shard.value == 0
        assert not eng._mgr["online"].arena.consistency_errors()
        return eng, _results(reqs)

    _, want = drive(n_shards=2)
    e2, got = drive(mesh=make_session_mesh(2, device="cpu"))
    _assert_equal(got, want)
    snap = e2.metrics_snapshot()["metrics"]
    moved = {v["labels"]["dir"]: v["value"]
             for v in snap["offload_sessions_total"]["values"]}
    assert moved["offload"] > 0 and moved["restore"] > 0
    assert snap["serve_prefix_dedup_hits_total"]["values"][0]["value"] >= 1
    assert snap["serve_fork_total"]["values"][0]["value"] == 1
    assert sum(v["value"] for v in snap["serve_cow_breaks_total"]["values"])


# the shrunk counterexample of tests/test_fork_properties.py::
# test_property_fork_traces_uphold_invariants (--hypothesis-seed=4): a
# prefix-cached row pinned on shard 0 while a full batch of queries pops
_PIN_EVENTS = [("submit", "s0", "ingest", 1, 0, "t0"),
               ("submit", "s0", "query", 1, 1, "t0"),
               ("submit", "s3", "query", 1, 1, "t0"),
               ("create", "s1", "t1", 4),
               ("submit", "s0", "ingest", 1, 0, "t0"),
               ("submit", "s0", "ingest", 1, 0, "t0"),
               ("submit", "s1", "query", 1, 0, "t1"),
               ("submit", "s2", "query", 1, 0, "t2")]


def _pin_trace(engine_cls, make_null_step, cfg, n_shards, **kw):
    eng = engine_cls(None, cfg, n_slots=4, cache_len=64, aging=0,
                     batch_buckets=(1, 2, 4), token_buckets=(2, 4, 8, 16),
                     n_shards=n_shards, step_factory=make_null_step, **kw)
    reqs = []
    for ev in _PIN_EVENTS:
        if ev[0] == "create":                # as tests/simulation.py does
            _, sid, tenant, plen = ev
            eng.create_session(sid, tenant=tenant, prefix_tokens=(
                np.arange(plen, dtype=np.int32) * 7 + plen) % 101)
            continue
        _, sid, op, n, prio, tenant = ev
        if eng.shard_of(sid) is None:
            eng.create_session(sid, tenant=tenant)
        reqs.append(getattr(eng, op)(sid, np.zeros(n, np.int32),
                                     priority=prio).request)
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("n_shards", [1, 2])
def test_prefix_pin_counterexample_is_served(cfgs, n_shards):
    """The reference raises ArenaFull out of ``run`` (a copy-on-write
    break, or a new session, finds its shard full of batch sessions and
    a row the prefix cache alone keeps alive); the port drops that pin
    as a last resort and serves every request, its arena consistent."""
    from repro.launch.serve import make_null_step as jnull
    from repro.serve.arena import ArenaFull as JArenaFull
    with pytest.raises(JArenaFull):
        _pin_trace(JEngine, jnull, cfgs[0], n_shards)
    eng, reqs = _pin_trace(ServeEngine, SRV.make_null_step, cfgs[1],
                           n_shards, device="cpu")
    assert all(r.done for r in reqs) and len(reqs) == 7
    mgr = eng._mgr["online"]
    assert not mgr.arena.consistency_errors()
    assert eng._m_cross_shard.value == 0
    assert {s.shard for s in mgr.sessions.values()} \
        == set(range(n_shards))
