"""The online path under tensor parallelism, in the port against the
reference, in one ``gloo`` world of 4 ranks on mesh (2, 2)
(``distributed.elastic.launch_world``; the batch over ``data``, the
model over ``model``) against the reference's ``dist=`` builders on
``make_debug_mesh(2, 2)`` (a subprocess with 4 forced host devices):

- ``make_ingest_step`` (twice), ``make_prefill_step``,
  ``make_decode_step`` and ``generate``, with bf16 and int8 caches
  (concat) and in merge mode: the logits (gathered over the rows and the
  vocabulary blocks), the KV cache, its int8 scales and the memory
  (gathered over the rows and the KV heads), the counters, and the
  generated tokens;
- ``make_stream_step(dist=)`` through window evictions and a full
  memory: every chunk's logits and the final window and memory;
- the sequence-sharded decode (``shard_cache_seq=True``,
  ``batch_sharded=False``): each data rank holds half of a 64-token
  cache, full (the new token's write clamps at the buffer's end, as the
  reference's) and 40 long, against the reference's UNSHARDED
  ``decode_step`` on the whole cache: the logits and the cache after.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_distributed.py``; generated tokens are equal.
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
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
MODEL = dict(name="d", family="dense", n_layers=2, d_model=64, n_heads=8,
             n_kv_heads=4, d_ff=128, vocab_size=128, compute_dtype="float32")
SEQ_MODEL = dict(name="d", family="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                 compute_dtype="float32")
STREAM = dict(stream_window=24, stream_chunk=8, stream_sink=2,
              stream_mem_slots=2)
# case -> (mode, kv cache dtype)
ONLINE = {"concat-bf16": ("concat", "bfloat16"),
          "concat-int8": ("concat", "int8"),
          "merge": ("merge", "bfloat16")}
SEQ_LENGTHS = (64, 40)


def _inputs():
    """The reference's init (perturbed: the LoRA b factors are zero at
    init), token blocks and the sequence-sharded decode's cache, as
    numpy."""
    import jax

    from repro.models import transformer as JT
    from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg

    def init(kw, seed):
        p = JT.init_lm(jax.random.PRNGKey(seed),
                       JCfg(**kw, ccm=JCCM(comp_len=2, max_steps=4)))
        leaves, tdef = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(seed + 7), len(leaves))
        p = tdef.unflatten([x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
                            for x, k in zip(leaves, keys)])
        return jax.tree.map(np.asarray, p)

    rng = np.random.default_rng(0)
    tokens = {"ctx": rng.integers(0, 128, (2, 6)),
              "ctx2": rng.integers(0, 128, (2, 5)),
              "prompt": rng.integers(0, 128, (2, 5)),
              "tok": rng.integers(0, 128, (2, 1)),
              "prompt2": rng.integers(0, 128, (2, 3)),
              "stream": rng.integers(0, 128, (6, 2, 8)),
              "seq_ctx": rng.integers(0, 128, (1, 6)),
              "seq_k": rng.standard_normal((2, 1, 64, 2, 16)),
              "seq_v": rng.standard_normal((2, 1, 64, 2, 16))}
    tokens = {k: v.astype(np.int32) if v.dtype.kind == "i"
              else v.astype(np.float32) for k, v in tokens.items()}
    return {"online": init(MODEL, 0), "seq": init(SEQ_MODEL, 1)}, tokens


_REF = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import inference as I
from repro.core import streaming as STR
from repro.launch import serve as S
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.models.config import CCMConfig, ModelConfig
assert jax.device_count() == 4
params_all, t = pickle.load(open(sys.argv[1], "rb"))
t = {{k: jnp.asarray(v) for k, v in t.items()}}
dist = make_dist(make_debug_mesh(2, 2))
np_ = lambda x: None if x is None else np.asarray(x)
# distinct buffers: the builders donate the state, and init's zero
# leaves may share one
fresh = lambda st: jax.tree.map(lambda x: jnp.array(np.asarray(x)), st)

def state_np(st):
    c, m = st.cache, st.mem
    return dict(k=np_(c.k), v=np_(c.v), k_scale=np_(c.k_scale),
                v_scale=np_(c.v_scale), length=int(c.length),
                mem_k=np_(m.k), mem_v=np_(m.v), slots=int(m.slots),
                steps=int(m.steps), stream_pos=int(m.stream_pos),
                pos=int(st.pos))

out = {{}}
params = jax.tree.map(jnp.asarray, params_all["online"])
for case, (mode, kvd) in {online}.items():
    cfg = ModelConfig(**{model}, kv_cache_dtype=kvd,
                      ccm=CCMConfig(comp_len=2, max_steps=4, mode=mode))
    ing, pre = S.make_ingest_step(cfg, dist), S.make_prefill_step(cfg, dist)
    dec = S.make_decode_step(cfg, dist)
    st = ing(params, fresh(I.init_online_state(cfg, 2, 32)), t["ctx"])
    st = ing(params, st, t["ctx2"])
    lp, st = pre(params, st, t["prompt"])
    ld, st = dec(params, st, t["tok"])
    gen = I.generate(params, cfg, st, t["prompt2"], 4)
    out[case] = dict(prefill=np_(lp), decode=np_(ld), gen=np_(gen),
                     state=state_np(st))

cfg = ModelConfig(**{model}, ccm=CCMConfig(comp_len=2, max_steps=4,
                                           **{stream}))
step = S.make_stream_step(cfg, params, dist)
st = fresh(STR.init_stream_state(cfg, 2))
logits = []
for c in t["stream"]:
    lg, st = step(params, st, c)
    logits.append(np_(lg))
out["stream"] = dict(logits=logits, win_k=np_(st.win_k), win_v=np_(st.win_v),
                     win_len=int(st.win_len), mem_k=np_(st.mem.k),
                     mem_v=np_(st.mem.v), slots=int(st.mem.slots),
                     pos=int(st.pos))

cfg = ModelConfig(**{seq_model}, ccm=CCMConfig(comp_len=2, max_steps=4))
params = jax.tree.map(jnp.asarray, params_all["seq"])
st0 = I.ingest_context(params, cfg, I.init_online_state(cfg, 1, 64),
                       t["seq_ctx"])
for n in {seq_lengths}:
    st = st0._replace(cache=st0.cache._replace(
        k=t["seq_k"], v=t["seq_v"], length=jnp.asarray(n, jnp.int32)))
    ld, st2 = jax.jit(lambda p, s, x: I.decode_step(p, cfg, s, x))(
        params, st, jnp.ones((1, 1), jnp.int32))
    out[("seq", n)] = dict(before=state_np(st), logits=np_(ld),
                           after=state_np(st2))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path):
    src = textwrap.dedent(_REF.format(
        online=ONLINE, model=MODEL, stream=STREAM, seq_model=SEQ_MODEL,
        seq_lengths=SEQ_LENGTHS))
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


def _state_np(st):
    c, m = st.cache, st.mem
    return dict(k=_np(c.k), v=_np(c.v), k_scale=_np(c.k_scale),
                v_scale=_np(c.v_scale), length=int(c.length),
                mem_k=_np(m.k), mem_v=_np(m.v), slots=int(m.slots),
                steps=int(m.steps), stream_pos=int(m.stream_pos),
                pos=int(st.pos))


def _world(dev, params_all, t, seq_states):
    """Every rank runs each case on its shards; rank 0 returns the
    gathered results."""
    from repro_torch.core import inference as I
    from repro_torch.core import streaming as STR
    from repro_torch.core.memory import MemState
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.params import params_from_numpy

    dist = make_dist(make_debug_mesh(2, 2, device=dev))
    tt = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    out = {}
    for case, (mode, kvd) in ONLINE.items():
        cfg = PCfg(**MODEL, kv_cache_dtype=kvd,
                   ccm=PCCM(comp_len=2, max_steps=4, mode=mode))
        params = params_from_numpy(params_all["online"], cfg, device=dev)
        ing = SRV.make_ingest_step(cfg, dist)
        pre = SRV.make_prefill_step(cfg, dist)
        dec = SRV.make_decode_step(cfg, dist)
        pl, st = ing.place(params, I.init_online_state(cfg, 2, 32,
                                                       device=dev))
        st = ing(pl, st, tt["ctx"])
        st = ing(pl, st, tt["ctx2"])
        lp, st = pre(pl, st, tt["prompt"])
        ld, st = dec(pl, st, tt["tok"])
        res = dict(prefill=_np(pre.gather_logits(lp)),
                   decode=_np(dec.gather_logits(ld)),
                   state=_state_np(dec.gather_state(st)))
        rows = SH.P(dist.batch_axes, None)
        gen = I.generate(pl, cfg, st, TPX.shard_by_spec(tt["prompt2"], rows,
                                                        dist), 4, dist=dist)
        res["gen"] = _np(TPX.gather_by_spec(gen, rows, dist))
        out[case] = res

    cfg = PCfg(**MODEL, ccm=PCCM(comp_len=2, max_steps=4, **STREAM))
    params = params_from_numpy(params_all["online"], cfg, device=dev)
    step = SRV.make_stream_step(cfg, dist)
    pl, st = step.place(params, STR.init_stream_state(cfg, 2, device=dev))
    logits = []
    for c in tt["stream"]:
        lg, st = step(pl, st, c)
        logits.append(_np(step.gather_logits(lg)))
    st = step.gather_state(st)
    out["stream"] = dict(logits=logits, win_k=_np(st.win_k),
                         win_v=_np(st.win_v), win_len=int(st.win_len),
                         mem_k=_np(st.mem.k), mem_v=_np(st.mem.v),
                         slots=int(st.mem.slots), pos=int(st.pos))

    cfg = PCfg(**SEQ_MODEL, ccm=PCCM(comp_len=2, max_steps=4))
    params = params_from_numpy(params_all["seq"], cfg, device=dev)
    dec = SRV.make_decode_step(cfg, dist, shard_cache_seq=True,
                               batch_sharded=False)
    for n, b in seq_states.items():
        ten = {k: torch.from_numpy(v.copy()) for k, v in b.items()
               if isinstance(v, np.ndarray)}
        st = I.OnlineState(
            cache=I.KVCache(k=ten["k"], v=ten["v"], length=b["length"]),
            mem=MemState(k=ten["mem_k"], v=ten["mem_v"], slots=b["slots"],
                         steps=b["steps"], stream_pos=b["stream_pos"]),
            pos=b["pos"])
        pl, st = dec.place(params, st)
        assert st.cache.k.shape[2] == 32         # this rank's half
        ld, st = dec(pl, st, torch.ones((1, 1), dtype=torch.long))
        out[("seq", n)] = dict(logits=_np(dec.gather_logits(ld)),
                               after=_state_np(dec.gather_state(st)))
    return out


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= REL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _same_state(got, want, what):
    for k, w in want.items():
        if w is None:
            assert got[k] is None, (what, k)
        elif isinstance(w, int):
            assert got[k] == w, (what, k, got[k], w)
        else:
            close(got[k], w, f"{what} {k}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_online")
    params, t = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, t)))
    ref, ref_out = _reference(inp, tmp)
    try:
        _, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    want = pickle.loads(ref_out.read_bytes())
    seq_states = {n: want[("seq", n)]["before"] for n in SEQ_LENGTHS}
    got = launch_world(4, _world, params, t, seq_states, device="cpu",
                       timeout=600)
    return got, want


@pytest.mark.parametrize("case", sorted(ONLINE))
def test_tp_online_builders_match_reference(results, case):
    got, want = results
    g, w = got[case], want[case]
    close(g["prefill"], w["prefill"], f"{case} prefill logits")
    close(g["decode"], w["decode"], f"{case} decode logits")
    _same_state(g["state"], w["state"], f"{case} state")
    np.testing.assert_array_equal(g["gen"], w["gen"])


def test_tp_stream_step_matches_reference(results):
    got, want = results
    g, w = got["stream"], want["stream"]
    assert len(g["logits"]) == len(w["logits"]) == 6
    for i, (a, b) in enumerate(zip(g["logits"], w["logits"])):
        close(a, b, f"stream chunk {i} logits")
    for k in ("win_k", "win_v", "mem_k", "mem_v"):
        close(g[k], w[k], f"stream {k}")
    for k in ("win_len", "slots", "pos"):
        assert g[k] == w[k], k
    assert w["slots"] == 2            # the memory filled and evicted


@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_seq_sharded_decode_matches_unsharded_reference(results, length):
    got, want = results
    g, w = got[("seq", length)], want[("seq", length)]
    close(g["logits"], w["logits"], f"seq {length} logits")
    _same_state(g["after"], w["after"], f"seq {length} state after")
