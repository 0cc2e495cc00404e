"""The dense model zoo through the port's normal paths, against ``repro``:
SmolLM-360M (GQA 3:1, tied head), Qwen2-0.5B (GQA 7:1, QKV bias, rope
theta 1e6, tied head), CodeQwen1.5-7B (QKV bias, bf16 params, LoRA-only
training) and Gemma-2B (MQA, hd 32 at smoke size, GeGLU, scaled and
tied embeddings), each at its registry ``smoke(compute_dtype="float32")``.

Every path runs the same weights in both packages: the reference's
``init_lm`` draws them, LoRA ``b`` and ``comp_embed`` are then drawn at
random (``b = 0`` at init would leave the gate untested), and
``params_from_numpy`` carries them to the port.  The reference runs its
default ``attn_impl="dense"`` (jnp attend); the port runs its kernel ops,
whose CPU versions are the plain ones.

Tolerances (float32 on the CPU): training logits, loss, gradients and
the updated leaves and moments 1e-4 x max|reference| per tensor (as
``tests/test_torch_train.py``); online and stream logits and float state
leaves atol 1e-4 (``tests/test_torch_inference.py``); the serve engine's
answers atol 1e-4 against each session run alone.  Counters must be
equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import inference as JI
from repro.core import masks as JM
from repro.core import streaming as JS
from repro.data.synthetic import sample_kv_batch as jsample
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import partition as JP
from repro_torch.configs import registry as PR
from repro_torch.core import inference as PI
from repro_torch.core import masks as PM
from repro_torch.core import streaming as PS
from repro_torch.launch import train as PTR
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.optim import partition as PP
from repro_torch.params import params_from_numpy
from repro_torch.serve import ServeEngine

DENSE = ["smollm-360m", "qwen2-0.5b", "codeqwen1.5-7b", "gemma-2b"]
REL, ATOL = 1e-4, 1e-4
T_STEPS, LC, M, TAIL, B = 4, 8, 2, 8, 2
# tests/test_torch_streaming.py's setting: chunks of 8 through a
# 32-token window, so the 5th chunk evicts
STREAM = dict(stream_window=32, stream_sink=2, stream_chunk=8,
              stream_mem_slots=4)

_ingest = jax.jit(JI.ingest_context, static_argnums=(1,))
_prefill = jax.jit(JI.prefill, static_argnums=(1,))
_decode = jax.jit(JI.decode_step, static_argnums=(1,))
_stream = jax.jit(JS.stream_step, static_argnums=(1,))


def _cfgs(arch, mode="concat", **ccm):
    """The arch's smoke config in float32, in both packages."""
    out = []
    for reg in (JR, PR):
        c = reg.get_config(arch, smoke=True, compute_dtype="float32")
        out.append(c.replace(ccm=dataclasses.replace(c.ccm, mode=mode,
                                                     **ccm)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    jc, _ = _cfgs(arch)
    p = jax.tree.map(np.asarray, jax.jit(JT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), jc))
    rs = np.random.default_rng(1)
    for lw in p["layers"]["attn"]["lora"].values():
        lw["b"] = rs.normal(0, 0.1, lw["b"].shape).astype(lw["b"].dtype)
    ce = p["comp_embed"]
    p["comp_embed"] = rs.normal(0, 0.5, ce.shape).astype(ce.dtype)
    return p


def _params(arch, pc):
    p = _numpy_params(arch)
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, pc, "cpu")


def _toks(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _rel(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def test_the_zoo_covers_every_dense_config_of_the_registry():
    dense = [a for a in PR.ASSIGNED if PR.get_config(a).family == "dense"]
    assert sorted(dense) == sorted(DENSE)


# ---------------------------------------------------------------------------
# training: train_forward, loss and gradients, one AdamW step
# ---------------------------------------------------------------------------

def _layouts():
    return (JM.segment_layout(T_STEPS, LC, M, TAIL),
            PM.segment_layout(T_STEPS, LC, M, TAIL))


def _batch(seed):
    jl, _ = _layouts()
    jb = jsample(jax.random.PRNGKey(seed), jl, B)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _flat(tree):
    return {"/".join(p): x.detach().float().numpy().copy()
            for p, x in PP.leaves(tree)}


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
            for path, x in flat}


@pytest.mark.parametrize("arch", DENSE)
def test_train_forward_matches_reference(arch):
    jc, pc = _cfgs(arch)
    jp, pp = _params(arch, pc)
    jl, pl = _layouts()
    jb, pb = _batch(1)
    want = jax.jit(lambda p, t: JT.train_forward(p, jc, t, jl))(
        jp, jb["tokens"])
    got = PT.train_forward(pp, pc, pb["tokens"], pl)
    assert tuple(got.shape) == (B, TAIL, pc.vocab_size)
    _rel(got.detach(), want, "logits")


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_reference(arch):
    """``train_mode`` as the config says: full for SmolLM, Qwen2 and
    Gemma (every leaf trains), LoRA-only for CodeQwen."""
    jc, pc = _cfgs(arch)
    jp, pp = _params(arch, pc)
    jl, pl = _layouts()
    jb, pb = _batch(3)
    jtp, jfp = JP.partition(jp, JTR.trainable_mask_for(jc, jp))
    fn = jax.jit(lambda tp, fp, b: jax.value_and_grad(JTR._loss_fn)(
        tp, fp, jc, jl, b, None))
    want_loss, want = fn(jtp, jfp, jb)
    want = _jflat(want)
    tp, fp = PP.partition(pp, PTR.trainable_mask_for(pc, pp))
    leaves = PP.leaves(tp)
    for _, x in leaves:
        x.requires_grad_(True)
    loss = PTR._loss_fn(tp, fp, pc, pl, pb)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    _rel(loss.item(), float(want_loss), "loss")
    got = {"/".join(p): g.float().numpy() for (p, _), g in zip(leaves, grads)}
    assert set(got) == set(want)
    n_lora = 9                    # 4 projections x (a, b) + comp_embed
    assert len(got) == (n_lora if pc.train_mode == "lora" else
                        len(_flat(pp)))
    if pc.qkv_bias and pc.train_mode == "full":
        assert "layers/attn/bq" in got
    for k in got:
        assert np.abs(want[k]).max() > 0, k
        _rel(got[k], want[k], k)


@pytest.mark.parametrize("arch", DENSE)
def test_one_adamw_step_matches_reference(arch):
    jc, pc = _cfgs(arch)
    jp, pp = _params(arch, pc)
    jl, pl = _layouts()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01)
    jstep = jax.jit(JTR.make_train_step(jc, jl, JA.AdamWConfig(**ocfg)))
    pstep = PTR.make_train_step(pc, pl, PA.AdamWConfig(**ocfg))
    jtp, jfp = JP.partition(jp, JTR.trainable_mask_for(jc, jp))
    ptp, pfp = PP.partition(pp, PTR.trainable_mask_for(pc, pp))
    jopt, popt = JA.init_adamw(jtp), PA.init_adamw(ptp)
    before, frozen0 = _flat(ptp), _flat(pfp)
    jb, pb = _batch(10)
    jtp, jopt, jm, _ = jstep(jtp, jfp, jopt, jb, None)
    ptp, popt, pm, _ = pstep(ptp, pfp, popt, pb, None)
    _rel(pm["loss"].item(), float(jm["loss"]), "loss")
    _rel(pm["grad_norm"].item(), float(jm["grad_norm"]), "grad norm")
    assert popt.step == int(jopt.step) == 1
    for moment in ("mu", "nu"):
        w, g = _jflat(getattr(jopt, moment)), _flat(getattr(popt, moment))
        for k, v in g.items():
            _rel(v, w[k], f"{moment} {k}")
    # Adam's first step moves an element by lr * g / (|g| + eps): where the
    # reference gradient (mu / (1 - b1)) is not 0 but lies within the
    # gradient tolerance (REL x max|g|) of it, float32 noise in g decides
    # the sign of that element's step, so it may differ by up to 2 lr
    # there; every other element is held to REL x max|leaf|.
    want, got = _jflat(jtp), _flat(ptp)
    grads = {k: v / 0.1 for k, v in _jflat(jopt.mu).items()}
    assert set(got) == set(want) == set(grads)
    for k, v in got.items():
        g = np.abs(grads[k])
        loose = (g > 0) & (g <= REL * g.max())
        tol = REL * np.abs(want[k]).max() + 2 * ocfg["lr"] * loose
        assert (np.abs(v - want[k]) <= tol).all(), k
        assert not np.array_equal(v, before[k]), k        # it moved
    for k, v in _flat(pfp).items():
        assert np.array_equal(v, frozen0[k]), k


# ---------------------------------------------------------------------------
# the online path: ingests, prefill, decode steps
# ---------------------------------------------------------------------------

def _compare_state(js, ts):
    assert int(js.pos) == ts.pos
    jm, tm = js.mem, ts.mem
    _close(jm.k, tm.k)
    _close(jm.v, tm.v)
    assert (int(jm.slots), int(jm.steps), int(jm.stream_pos)) \
        == (tm.slots, tm.steps, tm.stream_pos)
    assert int(js.cache.length) == ts.cache.length
    _close(js.cache.k, ts.cache.k)
    _close(js.cache.v, ts.cache.v)


@pytest.mark.parametrize("mode", ["concat", "merge"])
@pytest.mark.parametrize("arch", DENSE)
def test_online_path_matches_reference(arch, mode):
    """2 ingests of 8 tokens, a 6-token prefill and 3 decode steps into a
    16-token cache: logits and every state leaf after every call."""
    jc, pc = _cfgs(arch, mode)
    jp, pp = _params(arch, pc)
    V = pc.vocab_size
    js = JI.init_online_state(jc, B, 16)
    ts = PI.init_online_state(pc, B, 16, device="cpu")
    for i in range(2):
        chunk = _toks(20 + i, (B, LC), V)
        js = _ingest(jp, jc, js, jnp.asarray(chunk))
        ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(chunk))
        _compare_state(js, ts)
    prompt = _toks(30, (B, 6), V)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt))
    tl, ts = PI.prefill(pp, pc, ts, torch.from_numpy(prompt))
    assert tuple(tl.shape) == (B, 1, V)
    _close(jl, tl)
    _compare_state(js, ts)
    for i in range(3):
        tok = _toks(40 + i, (B, 1), V)
        jl, js = _decode(jp, jc, js, jnp.asarray(tok))
        tl, ts = PI.decode_step(pp, pc, ts, torch.from_numpy(tok))
        _close(jl, tl)
        _compare_state(js, ts)
    assert ts.mem.slots == (2 if mode == "concat" else 1)
    assert ts.cache.length == 9


# ---------------------------------------------------------------------------
# streaming across an eviction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["concat", "merge"])
@pytest.mark.parametrize("arch", DENSE)
def test_stream_step_across_an_eviction_matches_reference(arch, mode):
    """6 chunks of 8 tokens through a 32-token window: the 5th and 6th
    chunks evict (compress the oldest block into the memory).  Logits
    every step, every state leaf at the end."""
    jc, pc = _cfgs(arch, mode, **STREAM)
    jp, pp = _params(arch, pc)
    toks = _toks(4, (B, 48), pc.vocab_size)
    js = JS.init_stream_state(jc, B)
    ps = PS.init_stream_state(pc, B, device="cpu")
    evictions = 0
    for i in range(0, 48, 8):
        evictions += bool(PS.eviction_pending(pc, ps, 8))
        jl, js = _stream(jp, jc, js, jnp.asarray(toks[:, i:i + 8]))
        pl, ps = PS.stream_step(pp, pc, ps, torch.from_numpy(toks[:, i:i + 8]))
        _close(jl, pl)
        assert ps.win_len == int(js.win_len) <= 32
    assert evictions == 2 and ps.mem.steps == int(js.mem.steps) == 2
    _close(js.win_k, ps.win_k)
    _close(js.win_v, ps.win_v)
    _close(js.mem.k, ps.mem.k)
    _close(js.mem.v, ps.mem.v)
    assert (int(js.pos), int(js.mem.slots), int(js.mem.stream_pos)) == \
        (ps.pos, ps.mem.slots, ps.mem.stream_pos)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_serve_engine_drain_matches_sessions_alone(arch):
    """3 sessions on 2 slots of ``ServeEngine(device="cpu")`` (LRU offload
    and restore), 2 ragged contexts and one query each; every answer
    against the same session run alone (B=1) through the online path."""
    _, pc = _cfgs(arch)
    _, pp = _params(arch, pc)
    V = pc.vocab_size
    eng = ServeEngine(pp, pc, n_slots=2, cache_len=16,
                      batch_buckets=(1, 2), device="cpu")
    sids = ["a", "b", "c"]
    ctx = {s: [_toks(50 + 3 * i + r, 5 + 2 * i + r, V) for r in range(2)]
           for i, s in enumerate(sids)}
    qry = {s: _toks(60 + i, 3 + i, V) for i, s in enumerate(sids)}
    for s in sids:
        eng.create_session(s)
    for r in range(2):
        for s in sids:
            eng.ingest(s, ctx[s][r])
        eng.run()
    reqs = {s: eng.query(s, qry[s]).request for s in sids}
    eng.run()
    moved = {v["labels"]["dir"]: v["value"] for v in eng.metrics_snapshot()[
        "metrics"]["offload_sessions_total"]["values"]}
    assert moved["offload"] > 0 and moved["restore"] > 0
    for s in sids:
        st = PI.init_online_state(pc, 1, 16, device="cpu")
        for c in ctx[s]:
            st = PI.ingest_context(pp, pc, st, torch.from_numpy(c)[None])
        want, _ = PI.prefill(pp, pc, st, torch.from_numpy(qry[s])[None],
                             full_logits=True)
        req = reqs[s]
        assert req.done and req.result.shape == (len(qry[s]), V)
        np.testing.assert_allclose(req.result, want[0].numpy(), atol=ATOL,
                                   rtol=0)
