"""The sequence-sharded prefill and ingest (``shard_cache_seq=True``,
``batch_sharded=False``): each data rank holds one of ``n_data``
contiguous blocks of the KV cache's sequence axis, attends its block with
the segmented kernel's log-sum-exp, the blocks combine over the data
axes, and each rank writes the rows of a new block that fall in its
range.

In one ``gloo`` world of 4 ranks (``distributed.elastic.launch_world``)
on the meshes (2, 1) (two replicas of it, sliced from a (2, 2, 1) mesh),
(4, 1) and (2, 2), the port's ``make_ingest_step``,
``make_prefill_step``, ``make_decode_step`` and
``generate(seq_shard=True)`` run the dense family (concat, merge, an int8
cache), zamba2 (the Mamba2 state whole on every rank), whisper (its
cross K/V), pixtral (a prefill with ``patches``) and phi3.5-moe under
``ragged_tp``, at their smoke sizes, from one 64-token cache of random
K/V cut in blocks, through one chain of steps: an ingest over a cache 40
long, a prefill block that crosses a rank edge (rows 28-37) and a decode
step, a prefill at length 0, a prefill that clamps at the buffer's end
(length 60: rows 54-63) and a decode step past it, then ``generate``.
Each step is held against the reference's UNSHARDED ops on the whole
cache (one subprocess): the logits, every state leaf gathered (each
rank's cache rows included) and the tokens.  The dense concat chain is
also held against the reference's own sharded jit
(``make_*_step(dist, shard_cache_seq=True, batch_sharded=False)`` on
``make_debug_mesh``, 4 forced host devices) on each of the three meshes:
it runs under jax 0.9.0, and departs from the reference's unsharded op
in one place, a decode whose write starts past the buffer's end, where
the sharded jit drops the write that the unsharded op clamps onto the
last row (the port clamps).

With the batch split too (``shard_cache_seq=True, batch_sharded=True``:
the cache's sequence and the rows of the tokens and the memory over the
same data axes), the same chain at B4 from a B4 cache (dense at (2, 1),
dense with an int8 cache at (4, 1), phi3.5-moe under ``ep`` at (2, 2))
against the reference's own sharded jit with that layout (the same
dropped write past the buffer's end set aside), and bit-equal to the
port's ranks under ``batch_sharded=False``.

In one process: the union of the ranks' write plans
(``SeqShard.cache_plan``) against the unsharded ``plan_block_write`` over
a grid of lengths, block sizes and rank counts; the refusals (ragged
lanes, a lane-major cache); the builders under ``batch_sharded=True``
on a shape-only mesh.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_tp_online.py``; generated tokens are equal.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed.elastic import launch_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
CACHE = 64
DENSE = dict(name="d", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128)
# model -> (config module, overrides of its smoke config); None: DENSE
MODELS = {"dense": (None, {}), "zamba2": ("zamba2_12b", {}),
          "whisper": ("whisper_tiny", {}), "pixtral": ("pixtral_12b", {}),
          "phi35_moe": ("phi35_moe", {"moe_impl": "ragged_tp"}),
          "phi35_ep": ("phi35_moe", {"moe_impl": "ep"})}
# chain -> (model, kv cache dtype, CCM mode): one reference run each
CHAINS = {"dense": ("dense", "bfloat16", "concat"),
          "dense-merge": ("dense", "bfloat16", "merge"),
          "dense-int8": ("dense", "int8", "concat"),
          "zamba2": ("zamba2", "bfloat16", "concat"),
          "whisper": ("whisper", "bfloat16", "concat"),
          "pixtral": ("pixtral", "bfloat16", "concat"),
          "phi35_moe": ("phi35_moe", "bfloat16", "concat"),
          "phi35_ep": ("phi35_ep", "bfloat16", "concat")}
# case -> (mesh, chain)
CASES = {"dense-2x1": ((2, 1), "dense"), "dense-4x1": ((4, 1), "dense"),
         "dense-2x2": ((2, 2), "dense"),
         "dense-merge-4x1": ((4, 1), "dense-merge"),
         "dense-int8-4x1": ((4, 1), "dense-int8"),
         "zamba2-2x2": ((2, 2), "zamba2"),
         "whisper-2x1": ((2, 1), "whisper"),
         "pixtral-2x2": ((2, 2), "pixtral"),
         "phi35_moe-2x2": ((2, 2), "phi35_moe")}
# the batch split too (batch_sharded=True), at B4: case -> (mesh, chain)
ROWS = 4
ROW_CASES = {"dense-rows-2x1": ((2, 1), "dense"),
             "dense-int8-rows-4x1": ((4, 1), "dense-int8"),
             "phi35_ep-rows-2x2": ((2, 2), "phi35_ep")}
# the chain: (step name, op, cache length set before it or None)
STEPS = (("ingest", "ingest", 40), ("edge", "prefill", 28),
         ("edge_decode", "decode", None), ("zero", "prefill", 0),
         ("clamp", "prefill", 60), ("clamp_decode", "decode", None))
N_GEN = 3
SE = 12                                   # Whisper's frames


def port_cfg(chain):
    import dataclasses
    import importlib

    from repro_torch.models.config import CCMConfig, ModelConfig
    model, kvd, mode = CHAINS[chain]
    mod, over = MODELS[model]
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if mod is None:
        cfg = ModelConfig(**DENSE, **kw, ccm=CCMConfig(comp_len=2,
                                                       max_steps=4))
    else:
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").smoke(
            **kw).replace(**over)
    return cfg.replace(kv_cache_dtype=kvd, ccm=dataclasses.replace(
        cfg.ccm, mode=mode))


def _inputs():
    """The reference's init per model (perturbed: the LoRA b factors are
    zero at init), each chain's random cache, and the token blocks,
    frames and patches, as numpy."""
    import jax

    from repro.models import transformer as JT
    from repro_torch.core import inference as I
    params = {}
    for i, model in enumerate(MODELS):
        chain = next(c for c, v in CHAINS.items() if v[0] == model)
        cfg = _ref_cfg(chain)
        p = JT.init_lm(jax.random.PRNGKey(30 + i), cfg)
        leaves, tdef = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(40 + i), len(leaves))
        p = tdef.unflatten([x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
                            for x, k in zip(leaves, keys)])
        params[model] = jax.tree.map(np.array, p)
    rng = np.random.default_rng(0)

    def cache(chain, b):
        c = I.init_online_state(port_cfg(chain), b, CACHE,
                                device="cpu").cache
        if c.quantized:
            out = dict(k=rng.integers(-127, 128, c.k.shape).astype(np.int8),
                       v=rng.integers(-127, 128, c.v.shape).astype(np.int8),
                       k_scale=rng.uniform(0.002, 0.02, c.k_scale.shape),
                       v_scale=rng.uniform(0.002, 0.02, c.v_scale.shape))
        else:
            out = dict(k=rng.standard_normal(c.k.shape),
                       v=rng.standard_normal(c.v.shape))
        return {k: v.astype(np.float32) if v.dtype != np.int8 else v
                for k, v in out.items()}
    used = {ch for _, ch in CASES.values()}
    caches = {chain: cache(chain, 1) for chain in CHAINS if chain in used}
    t = {"ctx": rng.integers(0, 128, (1, 6)),
         "prompt": rng.integers(0, 128, (1, 10)),
         "tok": rng.integers(0, 128, (1, 1)),
         "prompt2": rng.integers(0, 128, (1, 3)),
         "frames": rng.standard_normal((1, SE, 64)),
         "patches": rng.standard_normal((1, 8, 1024))}
    # the batch-split chains' B4 caches and tokens
    for _, chain in ROW_CASES.values():
        caches[chain, ROWS] = cache(chain, ROWS)
    t.update(ctx4=rng.integers(0, 128, (ROWS, 6)),
             prompt4=rng.integers(0, 128, (ROWS, 10)),
             tok4=rng.integers(0, 128, (ROWS, 1)))
    t = {k: v.astype(np.int32) if v.dtype.kind == "i"
         else v.astype(np.float32) for k, v in t.items()}
    return params, caches, t


def _ref_cfg(chain):
    import dataclasses
    import importlib

    from repro.models.config import CCMConfig, ModelConfig
    model, kvd, mode = CHAINS[chain]
    mod, over = MODELS[model]
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if mod is None:
        cfg = ModelConfig(**DENSE, **kw, ccm=CCMConfig(comp_len=2,
                                                       max_steps=4))
    else:
        cfg = importlib.import_module(f"repro.configs.{mod}").smoke(
            **kw).replace(**over)
    return cfg.replace(kv_cache_dtype=kvd, ccm=dataclasses.replace(
        cfg.ccm, mode=mode))


_REF = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import inference as I
from repro.launch import serve as S
from repro.launch.mesh import make_debug_mesh, make_dist
sys.path.insert(0, {tests!r})
from test_torch_seq_shard import (CASES, CHAINS, ROW_CASES, STEPS, N_GEN,
                                  _ref_cfg)
assert jax.device_count() == 4
params_all, caches, t = pickle.load(open(sys.argv[1], "rb"))
t = {{k: jnp.asarray(v) for k, v in t.items()}}
np_ = lambda x: None if x is None else np.asarray(x)
# distinct buffers: the builders donate the state
fresh = lambda st: jax.tree.map(lambda x: jnp.array(np.asarray(x)), st)

def state_np(st):
    d = dict(pos=int(st.pos), k=np_(st.cache.k), v=np_(st.cache.v),
             length=int(st.cache.length))
    if st.cache.k_scale is not None:
        d.update(k_scale=np_(st.cache.k_scale), v_scale=np_(st.cache.v_scale))
    if st.mem is not None:
        d.update(mem_k=np_(st.mem.k), mem_v=np_(st.mem.v),
                 slots=int(st.mem.slots), steps=int(st.mem.steps),
                 stream_pos=int(st.mem.stream_pos))
    if st.ssm is not None:
        d.update(ssm=np_(st.ssm.ssm), conv=np_(st.ssm.conv))
    if st.cross is not None:
        d.update(xk=np_(st.cross[0]), xv=np_(st.cross[1]))
    return d

def initial(cfg, params, chain, b=1):
    st = I.init_online_state(cfg, b, {cache})
    c = {{k: jnp.asarray(v) for k, v in caches[chain if b == 1
                                              else (chain, b)].items()}}
    st = st._replace(cache=st.cache._replace(**c))
    if cfg.family == "encdec":
        st = st._replace(cross=I.encode_cross(params, cfg, t["frames"]))
    return st

def chain_run(cfg, params, st, ing, pre, dec, gen=True, sfx=""):
    res = {{}}
    for name, op, n in STEPS:
        if n is not None:
            st = st._replace(cache=st.cache._replace(
                length=jnp.asarray(n, jnp.int32)))
        lg = None
        if op == "ingest":
            st = ing(params, st, t["ctx" + sfx])
        elif op == "prefill" and name == "edge" and cfg.family == "vlm":
            lg, st = pre(params, st, t["prompt"], t["patches"])
        elif op == "prefill":
            lg, st = pre(params, st, t["prompt" + sfx])
        else:
            lg, st = dec(params, st, t["tok" + sfx])
        res[name] = dict(logits=np_(lg), state=state_np(st))
    if gen:
        res["gen"] = np_(I.generate(params, cfg, st, t["prompt2"], N_GEN))
    return res

out = {{}}
for chain in sorted({{ch for _, ch in CASES.values()}}):
    model = CHAINS[chain][0]
    cfg = _ref_cfg(chain)
    params = jax.tree.map(jnp.asarray, params_all[model])
    ing = jax.jit(lambda p, s, x: I.ingest_context(p, cfg, s, x))
    pre = jax.jit(lambda p, s, x, pt=None: I.prefill(p, cfg, s, x,
                                                     patches=pt))
    dec = jax.jit(lambda p, s, x: I.decode_step(p, cfg, s, x))
    out[chain] = chain_run(cfg, params, initial(cfg, params, chain), ing,
                           pre, dec)
# the reference's own sequence-sharded builders (GSPMD)
cfg = _ref_cfg("dense")
params = jax.tree.map(jnp.asarray, params_all["dense"])
for shape in {meshes}:
    dist = make_dist(make_debug_mesh(*shape))
    kw = dict(shard_cache_seq=True, batch_sharded=False)
    steps = [S.make_ingest_step(cfg, dist, **kw),
             S.make_prefill_step(cfg, dist, **kw),
             S.make_decode_step(cfg, dist, **kw)]
    ing, pre, dec = [lambda p, s, *a, f=f: f(p, fresh(s), *a)
                     for f in steps]
    out[("gspmd", shape)] = chain_run(cfg, params,
                                      initial(cfg, params, "dense"), ing,
                                      pre, dec, gen=False)
# ... and with the batch split over the same data axes
for case, (shape, chain) in ROW_CASES.items():
    cfg = _ref_cfg(chain)
    params = jax.tree.map(jnp.asarray, params_all[CHAINS[chain][0]])
    dist = make_dist(make_debug_mesh(*shape))
    kw = dict(shard_cache_seq=True, batch_sharded=True)
    steps = [S.make_ingest_step(cfg, dist, **kw),
             S.make_prefill_step(cfg, dist, **kw),
             S.make_decode_step(cfg, dist, **kw)]
    ing, pre, dec = [lambda p, s, *a, f=f: f(p, fresh(s), *a)
                     for f in steps]
    out[("rows", case)] = chain_run(cfg, params,
                                    initial(cfg, params, chain, {rows}), ing,
                                    pre, dec, gen=False, sfx="4")
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path):
    src = textwrap.dedent(_REF.format(
        tests=os.path.join(REPO, "tests"), cache=CACHE, rows=ROWS,
        meshes=sorted({CASES[c][0] for c in CASES
                       if CASES[c][1] == "dense"})))
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", src, str(inp), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _np(x):
    return None if x is None else x.detach().numpy().copy()


def state_np(st):
    d = dict(pos=int(st.pos), k=_np(st.cache.k), v=_np(st.cache.v),
             length=int(st.cache.length))
    if st.cache.k_scale is not None:
        d.update(k_scale=_np(st.cache.k_scale), v_scale=_np(st.cache.v_scale))
    if st.mem is not None:
        d.update(mem_k=_np(st.mem.k), mem_v=_np(st.mem.v),
                 slots=int(st.mem.slots), steps=int(st.mem.steps),
                 stream_pos=int(st.mem.stream_pos))
    if st.ssm is not None:
        d.update(ssm=_np(st.ssm.ssm), conv=_np(st.ssm.conv))
    if st.cross is not None:
        d.update(xk=_np(st.cross[0]), xv=_np(st.cross[1]))
    return d


def _mesh(shape, dev):
    """A (data, model) ``DistContext`` of ``shape`` in the world of 4: a
    (2, 1) mesh is one of two replicas sliced from a (2, 2, 1) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    if shape[0] * shape[1] == 4:
        return make_dist(make_debug_mesh(*shape, device=dev))
    mesh = init_device_mesh(dev.type, (2,) + shape,
                            mesh_dim_names=("replica", "data", "model"))
    return make_dist(mesh["data", "model"])


def _world(dev, params_all, caches, t):
    """Every rank runs each case on its shards; rank 0 returns the
    gathered results."""
    tt = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    meshes, out = {}, {}
    for case, (shape, chain) in CASES.items():
        if shape not in meshes:
            meshes[shape] = _mesh(shape, dev)
        out[case] = _chain(meshes[shape], params_all, caches, tt, chain)
    for case, (shape, chain) in ROW_CASES.items():
        for rows in (True, False):
            out[case, rows] = _chain(meshes[shape], params_all, caches, tt,
                                     chain, rows)
    return out


def _chain(dist, params_all, caches, tt, chain, rows=None):
    """The chain on this rank's shards: B1 with ``batch_sharded=False``
    and then ``generate`` (``rows`` None), or B4 with ``batch_sharded=
    rows``."""
    from repro_torch.core import inference as I
    from repro_torch.launch import serve as SRV
    from repro_torch.params import params_from_numpy

    dev = tt["ctx"].device
    cfg = port_cfg(chain)
    params = params_from_numpy(params_all[CHAINS[chain][0]], cfg, device=dev)
    kw = dict(shard_cache_seq=True, batch_sharded=bool(rows))
    ing = SRV.make_ingest_step(cfg, dist, **kw)
    pre = SRV.make_prefill_step(cfg, dist, **kw)
    dec = SRV.make_decode_step(cfg, dist, **kw)
    b, sfx = (1, "") if rows is None else (ROWS, "4")
    st = I.init_online_state(cfg, b, CACHE, device=dev)
    st = st._replace(cache=st.cache._replace(
        **{k: torch.from_numpy(v.copy())
           for k, v in caches[chain if b == 1 else (chain, b)].items()}))
    if cfg.family == "encdec":
        st = st._replace(cross=I.encode_cross(params, cfg, tt["frames"]))
    pl, st = pre.place(params, st)
    assert st.cache.k.shape[2] == CACHE // dist.n_data   # its block
    res = {}
    for name, op, n in STEPS:
        if n is not None:
            st = st._replace(cache=st.cache._replace(length=n))
        lg = None
        if op == "ingest":
            st = ing(pl, st, tt["ctx" + sfx])
        elif op == "prefill" and name == "edge" and cfg.family == "vlm":
            lg, st = pre(pl, st, tt["prompt"], tt["patches"])
        elif op == "prefill":
            lg, st = pre(pl, st, tt["prompt" + sfx])
        else:
            lg, st = dec(pl, st, tt["tok" + sfx])
        res[name] = dict(logits=None if lg is None
                         else _np(pre.gather_logits(lg)),
                         state=state_np(pre.gather_state(st)))
    if rows is None:
        res["gen"] = _np(I.generate(pl, cfg, st, tt["prompt2"], N_GEN,
                                    dist=dist, seq_shard=True))
    return res


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= REL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _same_chain(got, want, what, skip=()):
    for name, _, _ in STEPS:
        g, w = got[name], want[name]
        if w["logits"] is not None:
            close(g["logits"], w["logits"], f"{what} {name} logits")
        assert set(g["state"]) == set(w["state"]), (what, name)
        for k, v in w["state"].items():
            if (name, k) in skip:
                continue
            if isinstance(v, int):
                assert g["state"][k] == v, (what, name, k, g["state"][k], v)
            else:
                close(g["state"][k], v, f"{what} {name} {k}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_shard")
    params, caches, t = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, caches, t)))
    ref, ref_out = _reference(inp, tmp)
    try:
        got = launch_world(4, _world, params, caches, t, device="cpu",
                           timeout=600)
        _, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    return got, pickle.loads(ref_out.read_bytes()), caches


@pytest.mark.parametrize("case", list(CASES))
def test_seq_sharded_chain_matches_unsharded_reference(results, case):
    got, want, _ = results
    shape, chain = CASES[case]
    _same_chain(got[case], want[chain], case)
    np.testing.assert_array_equal(got[case]["gen"], want[chain]["gen"])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][1] == "dense"])
def test_seq_sharded_chain_matches_reference_sharded_jit(results, case):
    """Every step against the reference's sharded jit, but for the one
    place it departs from its own unsharded op: a decode whose write
    starts past the buffer's end (``clamp_decode``, length 70 of 64).
    The unsharded ``dynamic_update_slice`` clamps it onto the last row;
    the sharded jit drops it (jax 0.9.0's partitioned update), and the
    port keeps the unsharded clamp."""
    got, want, _ = results
    g, w = got[case], want[("gspmd", CASES[case][0])]
    one = want["dense"]
    last = ("clamp_decode", "clamp")
    _same_chain(g, w, case, skip={(last[0], "k"), (last[0], "v")})
    for k in ("k", "v"):
        close(g[last[0]]["state"][k][:, :, :-1],
              w[last[0]]["state"][k][:, :, :-1], f"{case} {last[0]} {k}")
        np.testing.assert_array_equal(w[last[0]]["state"][k][:, :, -1],
                                      w[last[1]]["state"][k][:, :, -1])
        assert (one[last[0]]["state"][k][:, :, -1]
                != one[last[1]]["state"][k][:, :, -1]).all()
        close(g[last[0]]["state"][k], one[last[0]]["state"][k],
              f"{case} {last[0]} {k} (unsharded)")


def _clamp_decode_aside(g, w, what):
    """The rows below the last of the clamped decode's cache leaves: the
    reference's sharded jit drops a write that starts past the buffer's
    end (``test_seq_sharded_chain_matches_reference_sharded_jit``)."""
    last = STEPS[-1][0]
    leaves = [k for k in ("k", "v", "k_scale", "v_scale")
              if k in w[last]["state"]]
    for k in leaves:
        close(g[last]["state"][k][:, :, :-1], w[last]["state"][k][:, :, :-1],
              f"{what} {last} {k}")
    return {(last, k) for k in leaves}


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_seq_sharded_rows_chain_matches_reference_sharded_jit(results,
                                                              case):
    """With the batch split over the data axes too, every step of the B4
    chain against the reference's sharded jit under the same layout (the
    one departure of that jit set aside as above)."""
    got, want, _ = results
    g, w = got[case, True], want[("rows", case)]
    _same_chain(g, w, case, skip=_clamp_decode_aside(g, w, case))


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_seq_sharded_rows_chain_equals_the_replicated_batch(results, case):
    """The batch split (each op gathers the rows over the data axes and
    keeps its own) gives bit for bit what every data rank holding the
    whole batch gives."""
    got, _, _ = results
    g, w = got[case, True], got[case, False]
    for name, _, _ in STEPS:
        if w[name]["logits"] is not None:
            np.testing.assert_array_equal(g[name]["logits"],
                                          w[name]["logits"])
        for k, v in w[name]["state"].items():
            np.testing.assert_array_equal(g[name]["state"][k], v,
                                          f"{case} {name} {k}")


def test_chain_crosses_an_edge_and_clamps(results):
    """The chain's writes land where the cases say: rows 28-37 (across
    the edges at 32 of (2, 1) and (4, 1)) and the clamp at 54-63; every
    row no step wrote keeps the random cache's value."""
    got, _, caches = results
    before = caches["dense"]["k"]
    run = got["dense-4x1"]
    names = [s[0] for s in STEPS]
    for name, rows in (("edge", range(28, 38)), ("clamp", range(54, 64))):
        k = run[name]["state"]["k"]
        prev = run[names[names.index(name) - 1]]["state"]["k"]
        changed = np.nonzero((k != prev).any(axis=(0, 1, 3, 4)))[0]
        assert changed.tolist() == list(rows), name
    np.testing.assert_array_equal(run["ingest"]["state"]["k"], before)
    untouched = [r for r in range(CACHE) if not (r < 10 or 28 <= r <= 38
                                                 or r >= 54)]
    np.testing.assert_array_equal(
        run["clamp_decode"]["state"]["k"][:, :, untouched],
        before[:, :, untouched])


# ---------------------------------------------------------------------------
# host only: the write plan, the refusals
# ---------------------------------------------------------------------------

def _plan_rows(plan, blk, lanes=1):
    """A ``BlockWrite``'s (lane, buffer row, block row) triples over a
    block of ``lanes`` lanes."""
    if plan is None:
        return []
    if plan.start is not None:
        return [(b, plan.start + j, j) for b in range(lanes)
                for j in range(plan.count)]
    return [(int(b), int(r), int(j))
            for b, r, j in zip(plan.lanes, plan.rows, plan.src)]


@pytest.mark.parametrize("n,blk", [(1, 8), (2, 8), (3, 5), (4, 16)])
def test_seq_shard_write_plans_cover_the_unsharded_write(n, blk):
    """For every length (past the buffer's end included) and block size
    S (up to past the whole buffer), the ranks' writes together are the
    unsharded write, each row of each of the 2 lanes once, and no rank
    writes outside its block; each rank's valid length is its share of
    the unsharded one."""
    from repro_torch.core import inference as I
    from repro_torch.core import masks as M
    total, lanes = n * blk, 2
    cache = I.KVCache(k=torch.zeros(1, lanes, blk, 1, 8),
                      v=torch.zeros(1, lanes, blk, 1, 8), length=0)
    for length in range(0, total + 6):
        for S in range(1, total + 3):
            want = _plan_rows(M.plan_block_write(length, S, total), total,
                              lanes)
            got, seen = [], 0
            for r in range(n):
                c = cache._replace(length=length)
                valid, plan = I.SeqShard(None, r, n).cache_plan(c, S)
                seen += valid
                assert 0 <= valid <= blk
                rows = _plan_rows(plan, blk, lanes)
                assert all(0 <= x < blk for _, x, _ in rows), (length, S, r)
                got += [(b, x + r * blk, j) for b, x, j in rows]
            assert sorted(got) == sorted(want), (length, S)
            assert seen == min(length, total), (length, S)


def test_seq_shard_refuses_ragged_and_lane_major():
    from repro_torch.core import inference as I
    seq = I.SeqShard(None, 0, 2)
    cache = I.KVCache(k=torch.zeros(1, 2, 8, 1, 8),
                      v=torch.zeros(1, 2, 8, 1, 8), length=3)
    with pytest.raises(ValueError, match="ragged"):
        seq.cache_plan(cache, 4, valid_len=2)
    with pytest.raises(ValueError, match="lane-major"):
        seq.cache_plan(cache._replace(lane_major=True), 4)
    with pytest.raises(ValueError, match="shared length"):
        seq.cache_plan(cache._replace(length=np.array([3, 4])), 4)


@pytest.mark.parametrize("builder", ["make_prefill_step", "make_ingest_step",
                                     "make_decode_step"])
def test_seq_shard_with_batch_sharded_builds(builder):
    """``shard_cache_seq=True`` with the batch split over the same data
    axes builds: a step whose specs put the cache's sequence and the
    tokens' and the memory's rows over the data axes."""
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch import serve as SRV
    from repro_torch.models.config import ModelConfig

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 1}

    cfg = ModelConfig(**DENSE)
    step = getattr(SRV, builder)(cfg, DistContext(mesh=Mesh()),
                                 shard_cache_seq=True)
    assert isinstance(step, SRV.ShardedStep)
    assert step.tok_spec[0] == "data"
    assert step.state_specs.cache.k[1:3] == (None, "data")
    assert step.state_specs.mem.k[1] == "data"


def test_segmented_lse_on_a_block_with_a_row_that_sees_no_key():
    """``ops.segmented_attention(lse=True)`` on a bf16 block of Sq > 2 rows
    (the mma.sync route's inputs; its plain version on the CPU): a lane
    that sees no key gives exactly 0 with lse -inf, and the others' lse
    is the float64 log-sum-exp of their visible scaled logits."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(5)
    B, Sq, H, D, C = 2, 5, 4, 16, 7

    def rn(*shape):
        return torch.randn(shape, generator=g).bfloat16()
    q, ck, cv = rn(B, Sq, H, D), rn(B, C, H, D), rn(B, C, H, D)
    sk, sv = rn(B, Sq, H, D), rn(B, Sq, H, D)
    ar = torch.arange(Sq, dtype=torch.int32)
    qi = torch.stack([ar, torch.full_like(ar, -5)])     # lane 1: no key
    segs = [dict(k=ck, v=cv, length=torch.tensor([C, 0])),
            dict(k=sk, v=sv, idx=ar, seg=torch.ones_like(ar),
                 comp=torch.zeros(Sq, dtype=torch.bool))]
    scale = D ** -0.5
    out, lse = ops.segmented_attention(q, segs, qi, torch.ones_like(qi),
                                       scale, lse=True)
    assert out.dtype == torch.bfloat16 and lse.shape == (B, H, Sq)
    assert bool((out[1] == 0).all()) and bool(torch.isneginf(lse[1]).all())
    k = torch.cat([ck[0], sk[0]]).double()               # (C + Sq, H, D)
    logits = torch.einsum("qhd,khd->hqk", q[0].double(), k) * scale
    vis = torch.cat([torch.ones(Sq, C, dtype=torch.bool),
                     ar[None, :] <= ar[:, None]], 1)     # (Sq, C + Sq)
    want = torch.logsumexp(logits.masked_fill(~vis, -torch.inf), -1)
    assert (lse[0].double() - want).abs().max() <= 1e-5 * want.abs().max()
