"""The online path of the recurrent, encoder-decoder and VLM families
split over the ``model`` axis, in the port against the reference, in one
``gloo`` world of 4 ranks (``distributed.elastic.launch_world``) on
meshes (2, 2) and (1, 4), against the reference's ``dist=`` builders on
``make_debug_mesh`` (one subprocess, 4 forced host devices), from the
smoke configs of ``tests/test_torch_tp_families.py`` with the same
weights:

- ``make_ingest_step``, ``make_prefill_step``, ``make_decode_step`` and
  ``generate`` for mamba2 (its vocabulary split, and whole at an odd
  size), zamba2, whisper (its state's cross K/V from the reference's
  ``encode_cross``; the 6/6-head variant in the "replicated" regime on
  (1, 4)) and pixtral ("kv" on (2, 2), "query" on (1, 4)): the logits
  (gathered over the rows and the vocabulary blocks), every state leaf
  (the KV cache and memory gathered over the rows and the KV heads, the
  Mamba2 states over the rows, the cross K/V over both) and the tokens;
- Whisper's ``encode_cross(dist=)`` against the reference's
  ``encode_cross`` (which takes no ``dist``), gathered over the KV heads;
- Pixtral's prefill with ``patches`` through the port's builder against
  the reference's ``prefill(dist, patches=)`` under a plain ``jax.jit``:
  the reference's builder refuses a ``patches`` argument (its jit has
  in_shardings for three), and GSPMD's math is the unsharded model's;
- ``make_stream_step(dist=)`` for whisper and pixtral (text-only
  decoders, as on one device) through one eviction;
- the sequence-sharded decode (``shard_cache_seq=True``,
  ``batch_sharded=False``) of zamba2 on (2, 2): the Mamba2 state whole on
  every rank, each data rank half of a 64-token cache, full and 40 long,
  against the reference's UNSHARDED ``decode_step``, as
  ``tests/test_torch_tp_online.py`` holds the dense family's.

In one process (no world): the rank loop of a ``LocalGroup`` against the
unsharded model for each family and regime (the training forward, the
loss and every gradient, full training; the online path, the stream step
for whisper and pixtral).

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_tensor_parallel.py``; generated tokens are equal.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.core import masks as PM
from repro_torch.distributed.elastic import launch_world
from test_torch_tp_families import LAYOUT, MODELS, REL, close, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SE = 12
STREAM = dict(stream_window=24, stream_chunk=8, stream_sink=2,
              stream_mem_slots=2)
N_STREAM = 4                          # chunks of 8: one eviction
# case -> (mesh, model)
ONLINE = {"mamba2-2x2": ((2, 2), "mamba2"),
          "mamba2_odd-2x2": ((2, 2), "mamba2_odd"),
          "zamba2-2x2": ((2, 2), "zamba2"),
          "whisper-2x2": ((2, 2), "whisper"),
          "whisper6-1x4": ((1, 4), "whisper6"),
          "pixtral-2x2": ((2, 2), "pixtral"),
          "pixtral-1x4": ((1, 4), "pixtral")}
STREAMS = ("whisper-2x2", "pixtral-2x2")
SEQ_LENGTHS = (64, 40)


def _ref_cfg(model):
    import importlib
    mod, over = MODELS[model]
    return importlib.import_module(f"repro.configs.{mod}").smoke(
        compute_dtype="float32", param_dtype="float32").replace(**over)


def _inputs():
    """The reference's init per model (perturbed), token blocks, frames,
    patches and the sequence-sharded decode's cache, as numpy."""
    import jax

    from repro.models import transformer as JT
    params = {}
    for i, model in enumerate(MODELS):
        p = JT.init_lm(jax.random.PRNGKey(10 + i), _ref_cfg(model))
        leaves, tdef = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(20 + i), len(leaves))
        p = tdef.unflatten([x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
                            for x, k in zip(leaves, keys)])
        params[model] = jax.tree.map(np.array, p)
    rng = np.random.default_rng(0)
    t = {"ctx": rng.integers(0, 255, (2, 6)),
         "prompt": rng.integers(0, 255, (2, 10)),
         "tok": rng.integers(0, 255, (2, 1)),
         "prompt2": rng.integers(0, 255, (2, 3)),
         "stream": rng.integers(0, 255, (N_STREAM, 2, 8)),
         "seq_ctx": rng.integers(0, 255, (1, 6)),
         "frames": rng.standard_normal((2, SE, 64)),
         "frames6": rng.standard_normal((2, SE, 96)),
         "patches": rng.standard_normal((2, 8, 1024)),
         "seq_k": rng.standard_normal((2, 1, 64, 4, 16)),
         "seq_v": rng.standard_normal((2, 1, 64, 4, 16))}
    return params, {k: v.astype(np.int32) if v.dtype.kind == "i"
                    else v.astype(np.float32) for k, v in t.items()}


_REF = """
import importlib, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import inference as I
from repro.core import streaming as STR
from repro.launch import serve as S
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.models.config import CCMConfig
assert jax.device_count() == 4
params_all, t = pickle.load(open(sys.argv[1], "rb"))
t = {{k: jnp.asarray(v) for k, v in t.items()}}
np_ = lambda x: None if x is None else np.asarray(x)
# distinct buffers: the builders donate the state, and init's zero
# leaves may share one
fresh = lambda st: jax.tree.map(lambda x: jnp.array(np.asarray(x)), st)

def cfg_of(model, **ccm):
    mod, over = {models}[model]
    cfg = importlib.import_module("repro.configs." + mod).smoke(
        compute_dtype="float32", param_dtype="float32").replace(**over)
    if ccm:
        cfg = cfg.replace(ccm=CCMConfig(comp_len=2, max_steps=4, **ccm))
    return cfg

def state_np(st):
    d = dict(pos=int(st.pos))
    if st.cache is not None:
        d.update(k=np_(st.cache.k), v=np_(st.cache.v),
                 length=int(st.cache.length))
    if st.mem is not None:
        d.update(mem_k=np_(st.mem.k), mem_v=np_(st.mem.v),
                 slots=int(st.mem.slots), steps=int(st.mem.steps),
                 stream_pos=int(st.mem.stream_pos))
    if st.ssm is not None:
        d.update(ssm=np_(st.ssm.ssm), conv=np_(st.ssm.conv))
    if st.cross is not None:
        d.update(xk=np_(st.cross[0]), xv=np_(st.cross[1]))
    return d

out = {{}}
cfg = cfg_of("zamba2")
params = jax.tree.map(jnp.asarray, params_all["zamba2"])
st0 = I.ingest_context(params, cfg, I.init_online_state(cfg, 1, 64),
                       t["seq_ctx"])
for n in {seq_lengths}:
    st = st0._replace(cache=st0.cache._replace(
        k=t["seq_k"], v=t["seq_v"], length=jnp.asarray(n, jnp.int32)))
    ld, st2 = jax.jit(lambda p, s, x: I.decode_step(p, cfg, s, x))(
        params, st, jnp.ones((1, 1), jnp.int32))
    out[("seq", n)] = dict(before=state_np(st), logits=np_(ld),
                           after=state_np(st2))
# the sequence-sharded decode's states go to the test first: its world
# starts while the rest runs here
pickle.dump({{n: out[("seq", n)]["before"] for n in {seq_lengths}}},
            open(sys.argv[3] + ".part", "wb"))
os.replace(sys.argv[3] + ".part", sys.argv[3])
for key, (shape, model) in {online}.items():
    dist = make_dist(make_debug_mesh(*shape))
    cfg = cfg_of(model)
    params = jax.tree.map(jnp.asarray, params_all[model])
    frames = t["frames6" if model == "whisper6" else "frames"]
    st0 = I.init_online_state(cfg, 2, 24)
    res = {{}}
    if cfg.family == "encdec":
        cross = I.encode_cross(params, cfg, frames)
        res["cross"] = (np_(cross[0]), np_(cross[1]))
        st0 = st0._replace(cross=cross)
    ing, pre = S.make_ingest_step(cfg, dist), S.make_prefill_step(cfg, dist)
    dec = S.make_decode_step(cfg, dist)
    st = ing(params, fresh(st0), t["ctx"])
    lp, st = pre(params, st, t["prompt"])
    ld, st = dec(params, st, t["tok"])
    res.update(prefill=np_(lp), decode=np_(ld), state=state_np(st),
               gen=np_(I.generate(params, cfg, st, t["prompt2"], 3)))
    if cfg.family == "vlm":
        st = ing(params, fresh(st0), t["ctx"])
        lp, st = jax.jit(lambda p, s, tk, pt: I.prefill(
            p, cfg, s, tk, dist, patches=pt))(params, st, t["prompt"],
                                              t["patches"])
        res["patches"] = dict(logits=np_(lp), state=state_np(st))
    if key in {streams}:
        scfg = cfg_of(model, **{stream})
        step = S.make_stream_step(scfg, params, dist)
        st = fresh(STR.init_stream_state(scfg, 2))
        logits = []
        for c in t["stream"]:
            lg, st = step(params, st, c)
            logits.append(np_(lg))
        res["stream"] = dict(logits=logits, win_k=np_(st.win_k),
                             win_v=np_(st.win_v), mem_k=np_(st.mem.k),
                             mem_v=np_(st.mem.v), slots=int(st.mem.slots),
                             win_len=int(st.win_len), pos=int(st.pos))
    out[key] = res

pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path):
    src = textwrap.dedent(_REF.format(
        models=MODELS, online=ONLINE, streams=STREAMS, stream=STREAM,
        seq_lengths=SEQ_LENGTHS))
    out, seq = tmp_path / "ref.pkl", tmp_path / "ref_seq.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", src, str(inp), str(out),
                             str(seq)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out, seq


def _np(x):
    return None if x is None else x.detach().numpy().copy()


def state_np(st):
    d = dict(pos=int(st.pos))
    if st.cache is not None:
        d.update(k=_np(st.cache.k), v=_np(st.cache.v),
                 length=int(st.cache.length))
    if st.mem is not None:
        d.update(mem_k=_np(st.mem.k), mem_v=_np(st.mem.v),
                 slots=int(st.mem.slots), steps=int(st.mem.steps),
                 stream_pos=int(st.mem.stream_pos))
    if st.ssm is not None:
        d.update(ssm=_np(st.ssm.ssm), conv=_np(st.ssm.conv))
    if st.cross is not None:
        d.update(xk=_np(st.cross[0]), xv=_np(st.cross[1]))
    return d


def _state_of(d):
    """An ``OnlineState`` from `state_np`'s dict (numpy -> torch)."""
    from repro_torch.core import inference as I
    from repro_torch.core.memory import MemState

    def t(k):
        return torch.from_numpy(d[k].copy())
    cache = mem = ssm = cross = None
    if "k" in d:
        cache = I.KVCache(k=t("k"), v=t("v"), length=d["length"])
    if "mem_k" in d:
        mem = MemState(k=t("mem_k"), v=t("mem_v"), slots=d["slots"],
                       steps=d["steps"], stream_pos=d["stream_pos"])
    if "ssm" in d:
        ssm = I.SSMState(ssm=t("ssm"), conv=t("conv"))
    if "xk" in d:
        cross = (t("xk"), t("xv"))
    return I.OnlineState(cache=cache, mem=mem, ssm=ssm, cross=cross,
                         pos=d["pos"])


def _world(dev, params_all, t, seq_states):
    """Every rank runs each case on its shards; rank 0 returns the
    gathered results."""
    from repro_torch.core import inference as I
    from repro_torch.core import streaming as STR
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.params import params_from_numpy

    tt = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    meshes, out = {}, {}
    for key, (shape, model) in ONLINE.items():
        if shape not in meshes:
            meshes[shape] = make_dist(make_debug_mesh(*shape, device=dev))
        dist = meshes[shape]
        cfg = port_cfg(model)
        params = params_from_numpy(params_all[model], cfg, device=dev)
        ing = SRV.make_ingest_step(cfg, dist)
        pre = SRV.make_prefill_step(cfg, dist)
        dec = SRV.make_decode_step(cfg, dist)
        pl, st0 = ing.place(params, I.init_online_state(cfg, 2, 24,
                                                        device=dev))
        res = {}
        rows = SH.P(dist.batch_axes, None, None)
        if cfg.family == "encdec":
            frames = tt["frames6" if model == "whisper6" else "frames"]
            xk, xv = I.encode_cross(pl, cfg, TPX.shard_by_spec(
                frames, rows, dist), dist=dist)
            st0 = st0._replace(cross=(xk, xv))
            whole = dec.gather_state(st0).cross
            res["cross"] = (_np(whole[0]), _np(whole[1]))

        def fresh():
            return TPX.map_by_spec(lambda x, _: x.clone(), st0, None)
        st = ing(pl, fresh(), tt["ctx"])
        lp, st = pre(pl, st, tt["prompt"])
        ld, st = dec(pl, st, tt["tok"])
        res.update(prefill=_np(pre.gather_logits(lp)),
                   decode=_np(dec.gather_logits(ld)),
                   state=state_np(dec.gather_state(st)))
        toks = SH.P(dist.batch_axes, None)
        gen = I.generate(pl, cfg, st, TPX.shard_by_spec(tt["prompt2"], toks,
                                                        dist), 3, dist=dist)
        res["gen"] = _np(TPX.gather_by_spec(gen, toks, dist))
        if cfg.family == "vlm":
            st = ing(pl, fresh(), tt["ctx"])
            lp, st = pre(pl, st, tt["prompt"], tt["patches"])
            res["patches"] = dict(logits=_np(pre.gather_logits(lp)),
                                  state=state_np(pre.gather_state(st)))
        if key in STREAMS:
            scfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, **STREAM))
            step = SRV.make_stream_step(scfg, dist)
            spl, sst = step.place(params, STR.init_stream_state(
                scfg, 2, device=dev))
            logits = []
            for c in tt["stream"]:
                lg, sst = step(spl, sst, c)
                logits.append(_np(step.gather_logits(lg)))
            sst = step.gather_state(sst)
            res["stream"] = dict(
                logits=logits, win_k=_np(sst.win_k), win_v=_np(sst.win_v),
                mem_k=_np(sst.mem.k), mem_v=_np(sst.mem.v),
                slots=int(sst.mem.slots), win_len=int(sst.win_len),
                pos=int(sst.pos))
        out[key] = res

    cfg = port_cfg("zamba2")
    params = params_from_numpy(params_all["zamba2"], cfg, device=dev)
    dist = meshes[(2, 2)]
    dec = SRV.make_decode_step(cfg, dist, shard_cache_seq=True,
                               batch_sharded=False)
    for n, before in seq_states.items():
        pl, st = dec.place(params, _state_of(before))
        assert st.cache.k.shape[2] == 32         # this rank's half
        assert st.ssm.ssm.shape == before["ssm"].shape     # whole
        ld, st = dec(pl, st, torch.ones((1, 1), dtype=torch.long))
        out[("seq", n)] = dict(logits=_np(dec.gather_logits(ld)),
                               after=state_np(dec.gather_state(st)))
    return out


def same_state(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, (what, k, got[k], w)
        else:
            close(got[k], w, f"{what} {k}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families_online")
    params, t = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, t)))
    ref, ref_out, ref_seq = _reference(inp, tmp)
    try:
        # the world starts once the reference has written the sequence-
        # sharded decode's states, and runs beside the rest of it
        deadline = time.monotonic() + 900
        while not ref_seq.exists() and ref.poll() is None:
            assert time.monotonic() < deadline, "reference timed out"
            time.sleep(0.2)
        got = None
        if ref_seq.exists():
            got = launch_world(4, _world, params, t,
                               pickle.loads(ref_seq.read_bytes()),
                               device="cpu", timeout=600)
        _, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    return got, pickle.loads(ref_out.read_bytes())


@pytest.mark.parametrize("case", list(ONLINE))
def test_tp_family_online_builders_match_reference(results, case):
    got, want = results
    g, w = got[case], want[case]
    close(g["prefill"], w["prefill"], f"{case} prefill logits")
    close(g["decode"], w["decode"], f"{case} decode logits")
    same_state(g["state"], w["state"], f"{case} state")
    np.testing.assert_array_equal(g["gen"], w["gen"])
    assert ("ssm" in w["state"]) == (ONLINE[case][1] in ("mamba2",
                                                         "mamba2_odd",
                                                         "zamba2"))


@pytest.mark.parametrize("case", ["whisper-2x2", "whisper6-1x4"])
def test_tp_encode_cross_matches_reference(results, case):
    got, want = results
    for i, name in enumerate(("k", "v")):
        close(got[case]["cross"][i], want[case]["cross"][i],
              f"{case} cross {name}")


@pytest.mark.parametrize("case", ["pixtral-2x2", "pixtral-1x4"])
def test_tp_patches_prefill_matches_reference(results, case):
    got, want = results
    g, w = got[case]["patches"], want[case]["patches"]
    close(g["logits"], w["logits"], f"{case} patches prefill logits")
    same_state(g["state"], w["state"], f"{case} patches state")
    # the patches changed the answer
    assert np.abs(w["logits"] - want[case]["prefill"]).max() > 1e-3


@pytest.mark.parametrize("case", STREAMS)
def test_tp_family_stream_step_matches_reference(results, case):
    got, want = results
    g, w = got[case]["stream"], want[case]["stream"]
    assert len(g["logits"]) == len(w["logits"]) == N_STREAM
    for i, (a, b) in enumerate(zip(g["logits"], w["logits"])):
        close(a, b, f"{case} stream chunk {i} logits")
    for k in ("win_k", "win_v", "mem_k", "mem_v"):
        close(g[k], w[k], f"{case} stream {k}")
    for k in ("win_len", "slots", "pos"):
        assert g[k] == w[k], (case, k)
    assert w["slots"] == 1            # one eviction compressed


@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_tp_hybrid_seq_sharded_decode_matches_unsharded(results, length):
    got, want = results
    g, w = got[("seq", length)], want[("seq", length)]
    close(g["logits"], w["logits"], f"seq {length} logits")
    same_state(g["after"], w["after"], f"seq {length} state after")


# ---------------------------------------------------------------------------
# in one process: the rank loop against the unsharded model
# ---------------------------------------------------------------------------

def rank_state(st, tp):
    """A rank's copy of an online or stream state: its block of the KV
    heads (dim 3 of the cache, its scales, the window, the memory and the
    cross K/V) in the "kv" regime, else those whole; the Mamba2 states
    whole (each rank writes its own copy in place)."""
    from repro_torch.core.streaming import StreamState

    def cut(x):
        if x is None:
            return None
        if tp is None or tp.attn != "kv":
            return x.clone()
        h = x.shape[3] // tp.n
        return x.narrow(3, tp.rank * h, h).clone()
    m = st.mem
    mem = None if m is None else m._replace(k=cut(m.k), v=cut(m.v))
    if isinstance(st, StreamState):
        return st._replace(win_k=cut(st.win_k), win_v=cut(st.win_v), mem=mem)
    c, s = st.cache, st.ssm
    return st._replace(
        cache=None if c is None else c._replace(
            k=cut(c.k), v=cut(c.v), k_scale=cut(c.k_scale),
            v_scale=cut(c.v_scale)),
        mem=mem,
        ssm=None if s is None else s._replace(ssm=s.ssm.clone(),
                                              conv=s.conv.clone()),
        cross=None if st.cross is None else tuple(cut(x) for x in st.cross))


LOCAL = [("mamba2", 2), ("mamba2", 4), ("mamba2_odd", 2), ("zamba2", 2),
         ("zamba2", 4), ("whisper", 2), ("whisper", 4), ("whisper6", 4),
         ("pixtral", 2), ("pixtral", 4)]


@pytest.mark.parametrize("model,n", LOCAL)
def test_local_group_family_ranks_match_unsharded(model, n):
    """The n ranks of a ``LocalGroup`` on their shards give the unsharded
    model's training logits, loss and every gradient (gathered; full
    training), then its online path: ``encode_cross`` (the rank's cross
    heads), an ingest, a prefill (Pixtral's with patches), a decode step
    and ``generate``; the stream step through an eviction for whisper
    and pixtral."""
    from repro_torch.core import inference as PI
    from repro_torch.core import streaming as STR
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP
    from repro_torch.optim.losses import next_token_loss

    cfg = port_cfg(model).replace(train_mode="full")
    layout = PM.segment_layout(*LAYOUT)
    gen = torch.Generator().manual_seed(3)
    params = PP.tree_map(
        lambda _, x: x + 0.02 * torch.randn(x.shape, generator=gen),
        T.init_lm(cfg, 0, device="cpu"))
    tok = torch.randint(0, cfg.vocab_size, (2, layout.seq_len), generator=gen)
    mask = torch.ones(2, layout.tail_len - 1)
    frames = torch.randn(2, SE, cfg.d_model, generator=gen)
    patches = torch.randn(2, 8, 1024, generator=gen)
    extra = {"encdec": {"frames": frames},
             "vlm": {"patches": patches}}.get(cfg.family, {})
    ctx, prompt, chunks = (
        torch.randint(0, cfg.vocab_size, shape, generator=gen)
        for shape in ((2, 6), (2, 10), (N_STREAM, 2, 8)))
    st0 = PI.init_online_state(cfg, 2, 24, device="cpu")
    scfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, **STREAM))
    streams = cfg.family in ("encdec", "vlm")

    def run(p, tp):
        leaves = [x.detach().clone().requires_grad_(True)
                  for _, x in PP.leaves(p)]
        it = iter(leaves)
        p = PP.tree_map(lambda _, x: next(it), p)
        lg = T.train_forward(p, cfg, tok, layout, dist=tp, **extra)
        loss = next_token_loss(lg, tok[:, -layout.tail_len:], mask, tp=tp)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = PP.tree_map(lambda _, x: next(it), p)
        with torch.no_grad():
            st = rank_state(st0, tp)
            cross = None
            if cfg.family == "encdec":
                cross = PI.encode_cross(p, cfg, frames, dist=tp)
                st = st._replace(cross=cross)
            st = PI.ingest_context(p, cfg, st, ctx, dist=tp)
            lp, st = PI.prefill(p, cfg, st, prompt, full_logits=True,
                                patches=extra.get("patches"), dist=tp)
            ld, st = PI.decode_step(p, cfg, st, prompt[:, :1], dist=tp)
            g = PI.generate(p, cfg, st, prompt[:, :3], 3, dist=tp)
            sl = []
            if streams:
                sst = rank_state(STR.init_stream_state(scfg, 2,
                                                       device="cpu"), tp)
                for c in chunks:
                    lg_s, sst = STR.stream_step(p, scfg, sst, c, dist=tp)
                    sl.append(PI.gather_vocab(lg_s, cfg, tp))
                assert int(sst.mem.slots) == 1
        return (PI.gather_vocab(lg.detach(), cfg, tp), loss.detach(), grads,
                PI.gather_vocab(lp, cfg, tp), PI.gather_vocab(ld, cfg, tp),
                g, sl, cross)

    want = run(params, None)
    group = TPX.LocalGroup(n)
    ranks = TPX.local_ranks(cfg, group)

    def one(r):
        tp = ranks[r]
        out = run(TPX.shard_params(params, cfg, tp), tp)
        cross = out[7]
        if cross is not None and tp.attn == "kv":
            cross = tuple(tp.coll.gather(x, 3) for x in cross)
        return out[:2] + (TPX.gather_params(out[2], cfg, tp),) + out[3:7] \
            + (cross,)

    for lg, loss, g, lp, ld, toks, sl, cross in group.run(one):
        close(lg, want[0], f"{model} logits")
        close(loss, want[1], f"{model} loss")
        for (path, a), (_, b) in zip(PP.leaves(g), PP.leaves(want[2])):
            close(a, b, f"{model} grad {'/'.join(path)}")
        close(lp, want[3], f"{model} prefill logits")
        close(ld, want[4], f"{model} decode logits")
        assert torch.equal(toks, want[5]), model
        for a, b in zip(sl, want[6]):
            close(a, b, f"{model} stream logits")
        assert len(sl) == len(want[6]) == (N_STREAM if streams else 0)
        if cross is not None:
            for a, b in zip(cross, want[7]):
                close(a, b, f"{model} cross K/V")
