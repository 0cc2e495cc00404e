"""The encoder-decoder family (whisper-tiny) through the port's paths,
against ``repro``, and the helpers the VLM and MoE files share.

Whisper at its registry ``smoke`` in float32: 2 + 2 layers,
MHA 4 x 16, LayerNorm, GELU, learned positions.  Every path runs the same
weights in both packages: the reference's ``init_lm`` draws them, LoRA
``b`` and ``comp_embed`` are then drawn at random (``b = 0`` at init
would leave the gate untested), and ``params_from_numpy`` carries them.
Frames (the encoder's precomputed input, 12 per lane) and patches come
from numpy seeds.

Covered here: ``encode`` (every key a <COMP> key at index 0 of segment 0),
``encode_cross``, the cross block in ``forward_hidden``,
``train_forward`` with its loss and the gradient of every leaf (encoder
included), one AdamW step through ``make_train_step``, the online path
with ``OnlineState.cross`` in concat and merge with every state leaf,
ragged ``valid_len``, ``generate``, ``stream_step`` across an eviction,
the serve engine on a trace against the reference's engine, and the
reference behaviour the port keeps: sessions in the engine carry no
cross K/V, so an engine answer equals the session alone with ``cross``
None, in both packages.

Tolerances (float32 on the CPU), as ``tests/test_torch_zoo.py``:
training logits, loss and gradients 1e-4 x max|reference| per tensor;
online and stream logits and float state leaves atol 1e-4; the engine's
answers atol 1e-4.  Counters, tokens, verdicts and traces equal.
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
from repro.obs import ManualClock as JClock, Observability as JObs
from repro.optim import adamw as JA
from repro.optim import partition as JP
from repro.serve import PressurePolicy as JPolicy, ServeEngine as JEngine
from repro_torch.configs import registry as PR
from repro_torch.core import inference as PI
from repro_torch.core import masks as PM
from repro_torch.core import streaming as PS
from repro_torch.launch import train as PTR
from repro_torch.models import transformer as PT
from repro_torch.obs import ManualClock as PClock, Observability as PObs
from repro_torch.optim import adamw as PA
from repro_torch.optim import partition as PP
from repro_torch.params import params_from_numpy
from repro_torch.serve import PressurePolicy as PPolicy
from repro_torch.serve import ServeEngine as PEngine
from test_torch_serve import _counters, _drive as _serve_drive
from test_torch_zoo import STREAM, _close, _flat, _jflat, _rel, _toks

REL, ATOL = 1e-4, 1e-4
T_STEPS, LC, TAIL, B, SE = 2, 8, 8, 2, 12
WHISPER = "whisper-tiny"

_ingest = jax.jit(JI.ingest_context, static_argnums=(1,))
_prefill = jax.jit(JI.prefill, static_argnums=(1,),
                   static_argnames=("full_logits",))
_decode = jax.jit(JI.decode_step, static_argnums=(1,))
_stream = jax.jit(JS.stream_step, static_argnums=(1,))
_encode_cross = jax.jit(JI.encode_cross, static_argnums=(1,))
_generate = jax.jit(JI.generate, static_argnums=(1, 4))


def cfgs(arch, mode="concat", **kw):
    """The arch's smoke config in float32, compute and params (``kw``:
    config fields, or CCMConfig fields), in both packages.  (bf16 params
    would round every gradient of a bf16 leaf to bf16 in both packages;
    ``tests/test_torch_params.py`` carries the bf16 trees.)"""
    ccm = {k: kw.pop(k) for k in list(kw)
           if k in {f.name for f in dataclasses.fields(JR.get_config(
               arch).ccm)}}
    out = []
    for reg in (JR, PR):
        c = reg.get_config(arch, smoke=True, compute_dtype="float32",
                           param_dtype="float32")
        out.append(c.replace(ccm=dataclasses.replace(c.ccm, mode=mode,
                                                     **ccm), **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def numpy_params(arch):
    jc, _ = cfgs(arch)
    p = jax.tree.map(np.asarray, jax.jit(JT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), jc))
    rs = np.random.default_rng(1)
    for lw in p["layers"]["attn"]["lora"].values():
        lw["b"] = rs.normal(0, 0.1, lw["b"].shape).astype(lw["b"].dtype)
    ce = p["comp_embed"]
    p["comp_embed"] = rs.normal(0, 0.5, ce.shape).astype(ce.dtype)
    return p


def params(arch, pc):
    p = numpy_params(arch)
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, pc, "cpu")


def extra_inputs(cfg, seed, batch=B):
    """The family's non-token input as numpy: frames (encdec) or patches
    (vlm), else {}."""
    rs = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rs.normal(0, 1, (batch, SE, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rs.normal(0, 1, (batch, cfg.n_frontend_tokens,
                                            1024)).astype(np.float32)}
    return {}


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def layouts():
    return (JM.segment_layout(T_STEPS, LC, 2, TAIL),
            PM.segment_layout(T_STEPS, LC, 2, TAIL))


def batch(cfg, seed):
    """A training batch (tokens, loss mask and the family's input)."""
    jl, _ = layouts()
    jb = {k: np.asarray(v) for k, v in
          jsample(jax.random.PRNGKey(seed), jl, B).items()}
    jb.update(extra_inputs(cfg, seed + 100))
    return _both(jb)


# ---------------------------------------------------------------------------
# training: train_forward, loss and every gradient, one AdamW step
# ---------------------------------------------------------------------------

def check_train_forward(arch, mode="concat"):
    jc, pc = cfgs(arch, mode)
    jp, pp = params(arch, pc)
    jl, pl = layouts()
    jb, pb = batch(pc, 1)
    kw_j = {k: v for k, v in jb.items() if k in ("frames", "patches")}
    kw_p = {k: v for k, v in pb.items() if k in ("frames", "patches")}
    want = jax.jit(lambda p, t, kw: JT.train_forward(p, jc, t, jl, **kw))(
        jp, jb["tokens"], kw_j)
    got = PT.train_forward(pp, pc, pb["tokens"], pl, **kw_p)
    assert tuple(got.shape) == (B, TAIL, pc.vocab_size)
    _rel(got.detach(), want, "logits")


def check_gradients(arch, train_mode, mode="concat", zero=()):
    """Loss and the gradient of every trainable leaf (``train_mode``)
    through both packages' ``_loss_fn``; every gradient must be nonzero
    somewhere, except the leaves ``zero``, whose gradient is 0 in exact
    arithmetic: there both packages' must lie within 1e-6 x the largest
    gradient element of the tree (float32 rounding around 0 is not
    compared element by element)."""
    jc, pc = cfgs(arch, mode, train_mode=train_mode)
    jp, pp = params(arch, pc)
    jl, pl = layouts()
    jb, pb = batch(pc, 3)
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
    assert len(got) == (9 if train_mode == "lora" else len(_flat(pp)))
    top = max(np.abs(g).max() for g in want.values())
    for k in got:
        if k in zero:
            for g in (got[k], want[k]):
                assert np.abs(g).max() <= 1e-6 * top, k
            continue
        assert np.abs(want[k]).max() > 0, k
        _rel(got[k], want[k], k)
    return got


def check_adamw_step(arch):
    """One AdamW step with the config's own ``train_mode``: loss, grad
    norm, moments and updated leaves (the first-step sign rule of
    ``tests/test_torch_zoo.py``), frozen leaves unchanged."""
    jc, pc = cfgs(arch)
    jp, pp = params(arch, pc)
    jl, pl = layouts()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01)
    jstep = jax.jit(JTR.make_train_step(jc, jl, JA.AdamWConfig(**ocfg)))
    pstep = PTR.make_train_step(pc, pl, PA.AdamWConfig(**ocfg))
    jtp, jfp = JP.partition(jp, JTR.trainable_mask_for(jc, jp))
    ptp, pfp = PP.partition(pp, PTR.trainable_mask_for(pc, pp))
    jopt, popt = JA.init_adamw(jtp), PA.init_adamw(ptp)
    frozen0 = _flat(pfp)
    jb, pb = batch(pc, 10)
    jtp, jopt, jm, _ = jstep(jtp, jfp, jopt, jb, None)
    ptp, popt, pm, _ = pstep(ptp, pfp, popt, pb, None)
    _rel(pm["loss"].item(), float(jm["loss"]), "loss")
    _rel(pm["grad_norm"].item(), float(jm["grad_norm"]), "grad norm")
    want, got = _jflat(jtp), _flat(ptp)
    grads = {k: v / 0.1 for k, v in _jflat(jopt.mu).items()}
    assert set(got) == set(want) == set(grads)
    for k, v in got.items():
        g = np.abs(grads[k])
        loose = (g > 0) & (g <= REL * g.max())
        tol = REL * np.abs(want[k]).max() + 2 * ocfg["lr"] * loose
        assert (np.abs(v - want[k]) <= tol).all(), k
    for k, v in _flat(pfp).items():
        assert np.array_equal(v, frozen0[k]), k


# ---------------------------------------------------------------------------
# the online path
# ---------------------------------------------------------------------------

def compare_state(js, ts):
    """Counters equal; memory, cache (and cross K/V) leaves atol 1e-4."""
    assert int(js.pos) == ts.pos
    jm, tm = js.mem, ts.mem
    _close(jm.k, tm.k)
    _close(jm.v, tm.v)
    assert (int(jm.slots), int(jm.steps), int(jm.stream_pos)) \
        == (tm.slots, tm.steps, tm.stream_pos)
    assert int(js.cache.length) == ts.cache.length
    _close(js.cache.k, ts.cache.k)
    _close(js.cache.v, ts.cache.v)
    assert (js.cross is None) == (ts.cross is None)
    if ts.cross is not None:
        _close(js.cross[0], ts.cross[0])
        _close(js.cross[1], ts.cross[1])


def start_states(arch, jc, pc, jp, pp, batch=B, cache=24, seed=7):
    """Fresh states, with the encoder's cross K/V for encdec."""
    js = JI.init_online_state(jc, batch, cache)
    ts = PI.init_online_state(pc, batch, cache, device="cpu")
    if pc.family == "encdec":
        jx, px = _both(extra_inputs(pc, seed, batch))
        js = js._replace(cross=_encode_cross(jp, jc, jx["frames"]))
        ts = ts._replace(cross=PI.encode_cross(pp, pc, px["frames"]))
    return js, ts


def prompt_kw(pc, seed, batch=B):
    """The prefill's patches for vlm (both packages), else {}."""
    if pc.family != "vlm":
        return {}, {}
    return _both(extra_inputs(pc, seed, batch))


def check_online(arch, mode):
    """2 ingests of 8 tokens, a 10-token prefill (vlm: over 8 patches)
    and 3 decode steps into a 24-token cache: logits and every state leaf
    after every call."""
    jc, pc = cfgs(arch, mode)
    jp, pp = params(arch, pc)
    V = pc.vocab_size
    js, ts = start_states(arch, jc, pc, jp, pp)
    compare_state(js, ts)
    for i in range(2):
        chunk = _toks(20 + i, (B, LC), V)
        js = _ingest(jp, jc, js, jnp.asarray(chunk))
        ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(chunk))
        compare_state(js, ts)
    prompt = _toks(30, (B, 10), V)
    kj, kp = prompt_kw(pc, 31)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt), **kj)
    tl, ts = PI.prefill(pp, pc, ts, torch.from_numpy(prompt), **kp)
    assert tuple(tl.shape) == (B, 1, V)
    _close(jl, tl)
    compare_state(js, ts)
    for i in range(3):
        tok = _toks(40 + i, (B, 1), V)
        jl, js = _decode(jp, jc, js, jnp.asarray(tok))
        tl, ts = PI.decode_step(pp, pc, ts, torch.from_numpy(tok))
        _close(jl, tl)
        compare_state(js, ts)
    assert ts.mem.slots == (2 if mode == "concat" else 1)
    assert ts.cache.length == 13


def check_ragged(arch):
    """A padded ingest (5 of 8 tokens real) and a padded prefill (7 of
    10 real, full logits): the valid rows' logits and every state leaf
    against the reference's ragged calls."""
    jc, pc = cfgs(arch)
    jp, pp = params(arch, pc)
    V = pc.vocab_size
    js, ts = start_states(arch, jc, pc, jp, pp)
    chunk = _toks(50, (B, LC), V)
    js = _ingest(jp, jc, js, jnp.asarray(chunk), valid_len=5)
    ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(chunk), valid_len=5)
    compare_state(js, ts)
    prompt = _toks(51, (B, 10), V)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt), valid_len=7,
                      full_logits=True)
    tl, ts = PI.prefill(pp, pc, ts, torch.from_numpy(prompt), valid_len=7,
                        full_logits=True)
    _close(np.asarray(jl)[:, :7], tl[:, :7])
    compare_state(js, ts)
    assert ts.pos == 5 + pc.ccm.comp_len + 7


def check_generate(arch):
    """Greedy tokens after one ingest: equal in both packages."""
    jc, pc = cfgs(arch)
    jp, pp = params(arch, pc)
    V = pc.vocab_size
    js, ts = start_states(arch, jc, pc, jp, pp)
    chunk = _toks(60, (B, LC), V)
    js = _ingest(jp, jc, js, jnp.asarray(chunk))
    ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(chunk))
    prompt = _toks(61, (B, 6), V)
    want = _generate(jp, jc, js, jnp.asarray(prompt), 5)
    got = PI.generate(pp, pc, ts, torch.from_numpy(prompt), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# streaming across an eviction
# ---------------------------------------------------------------------------

def check_stream(arch, mode):
    """6 chunks of 8 tokens through a 32-token window: the 5th and 6th
    evict.  Logits every step, every state leaf at the end."""
    jc, pc = cfgs(arch, mode, **STREAM)
    jp, pp = params(arch, pc)
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
    for a, b in ((js.win_k, ps.win_k), (js.win_v, ps.win_v),
                 (js.mem.k, ps.mem.k), (js.mem.v, ps.mem.v)):
        _close(a, b)
    assert (int(js.pos), int(js.mem.slots), int(js.mem.stream_pos)) == \
        (ps.pos, ps.mem.slots, ps.mem.stream_pos)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

def engines(arch):
    """Both packages' engines on the arch's smoke weights, in the setting
    of ``tests/test_torch_serve.py``: 3 slots of a 16-token cache, ragged
    token buckets, a prefix cache and the pressure ladder."""
    jc, pc = cfgs(arch)
    jp, pp = params(arch, pc)
    common = dict(n_slots=3, cache_len=16, batch_buckets=(1, 2, 4), aging=4)
    je = JEngine(jp, jc, obs=JObs(clock=JClock()),
                 pressure_policy=JPolicy(capacity_tokens=22), **common)
    pe = PEngine(pp, pc, obs=PObs(clock=PClock()), device="cpu",
                 pressure_policy=PPolicy(capacity_tokens=22), **common)
    return je, pe


def check_engine(arch):
    """``tests/test_torch_serve.py``'s trace (7 sessions over 3 tenants
    on 3 slots, ragged ingests and queries, LRU offload and restore, a
    fork, a prefix-cache hit, a pressure recompression) through both
    engines: verdicts, slot traces, answers and counters."""
    je, pe = engines(arch)
    assert pe.ragged
    jv, jt, jr = _serve_drive(je)
    pv, pt, pr = _serve_drive(pe)
    assert pv == jv
    assert pt == jt
    assert len(pr) == len(jr)
    for a, b in zip(jr, pr):
        assert (a.done, a.shed) == (b.done, b.shed)
        if a.result is None:
            assert b.result is None
        else:
            np.testing.assert_allclose(b.result, a.result, atol=ATOL, rtol=0)
    assert _counters(pe) == _counters(je)
    snap = pe.metrics_snapshot()["metrics"]
    offl = {v["labels"]["dir"]: v["value"]
            for v in snap["offload_sessions_total"]["values"]}
    assert offl["offload"] > 0 and offl["restore"] > 0
    assert pe._mgr["online"].arena.consistency_errors() == []
    return je, pe


# ---------------------------------------------------------------------------
# whisper's own tests
# ---------------------------------------------------------------------------

def test_encode_and_encode_cross_match_reference():
    """The encoder alone (bidirectional: every frame sees every frame)
    and the per-layer cross K/V (L, B, Se, Hkv, hd)."""
    jc, pc = cfgs(WHISPER)
    jp, pp = params(WHISPER, pc)
    jx, px = _both(extra_inputs(pc, 5))
    want = jax.jit(JT.encode, static_argnums=(1,))(jp, jc, jx["frames"])
    got = PT.encode(pp, pc, px["frames"])
    assert tuple(got.shape) == (B, SE, pc.d_model)
    _close(want, got)
    jk, jv = _encode_cross(jp, jc, jx["frames"])
    pk, pv = PI.encode_cross(pp, pc, px["frames"])
    assert tuple(pk.shape) == (pc.n_layers, B, SE, pc.n_kv_heads, pc.hd)
    _close(jk, pk)
    _close(jv, pv)
    # bidirectional: the first frame's encoding depends on the last frame
    f2 = px["frames"].clone()
    f2[:, -1] += 1.0
    assert not torch.allclose(PT.encode(pp, pc, f2)[:, 0], got[:, 0])


def test_cross_block_in_forward_hidden_matches_reference():
    """The decoder stack with the encoder output as ``cross`` (each layer
    projects it through its ``xattn``), plain causal self-attention."""
    jc, pc = cfgs(WHISPER)
    jp, pp = params(WHISPER, pc)
    rs = np.random.default_rng(6)
    x = rs.normal(0, 1, (B, 9, pc.d_model)).astype(np.float32)
    enc = rs.normal(0, 1, (B, SE, pc.d_model)).astype(np.float32)
    from repro.models import attention as JA_
    from repro_torch.models import attention as PA_
    want = jax.jit(lambda p, x, e: JT.forward_hidden(
        p, jc, x, q_info=JA_.plain_causal_info(9),
        k_info=JA_.plain_causal_info(9), positions=jnp.arange(9),
        cross=e))(jp, jnp.asarray(x), jnp.asarray(enc))
    info = PA_.plain_causal_info(9)
    got = PT.forward_hidden(pp, pc, torch.from_numpy(x), q_info=info,
                            k_info=info, positions=torch.arange(9),
                            cross=torch.from_numpy(enc))
    _close(want, got)


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_train_forward_with_frames_matches_reference(mode):
    check_train_forward(WHISPER, mode)


def test_loss_and_every_gradient_match_reference():
    """Full training (whisper's ``train_mode``): every leaf, the encoder,
    its positions and the cross attention included."""
    got = check_gradients(WHISPER, "full")
    for k in ("encoder/pos_embed", "encoder/layers/attn/wq", "pos_embed",
              "layers/xattn/wk", "layers/ln_x/bias"):
        assert k in got, k


def test_one_adamw_step_matches_reference():
    check_adamw_step(WHISPER)


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_online_path_with_cross_matches_reference(mode):
    check_online(WHISPER, mode)


def test_ragged_online_calls_match_reference():
    check_ragged(WHISPER)


def test_generate_matches_reference():
    check_generate(WHISPER)


def test_stream_step_across_an_eviction_matches_reference():
    check_stream(WHISPER, "concat")


def test_engine_matches_reference():
    check_engine(WHISPER)


def test_engine_sessions_decode_without_cross_as_the_reference():
    """The reference's arena builds its states with
    ``init_online_state`` (no cross K/V), so a whisper session in either
    engine is a text-only decoder: its answer equals the session run
    alone with ``cross`` None, in each package, and differs from the same
    session with the encoder's cross K/V."""
    jc, pc = cfgs(WHISPER)
    jp, pp = params(WHISPER, pc)
    V = pc.vocab_size
    ctx, qry = _toks(70, LC, V), _toks(71, 5, V)
    out = {}
    for name, eng in zip(("ref", "port"), engines(WHISPER)):
        eng.create_session("s")
        eng.ingest("s", ctx)
        eng.run()
        req = eng.query("s", qry).request
        eng.run()
        out[name] = req.result
    js = JI.init_online_state(jc, 1, 16)
    ts = PI.init_online_state(pc, 1, 16, device="cpu")
    assert js.cross is None and ts.cross is None
    js = _ingest(jp, jc, js, jnp.asarray(ctx)[None])
    ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(ctx)[None])
    jl, _ = _prefill(jp, jc, js, jnp.asarray(qry)[None], full_logits=True)
    tl, _ = PI.prefill(pp, pc, ts, torch.from_numpy(qry)[None],
                       full_logits=True)
    np.testing.assert_allclose(out["ref"], np.asarray(jl[0]), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["port"], tl[0].numpy(), atol=ATOL,
                               rtol=0)
    _, px = _both(extra_inputs(pc, 72, 1))
    with_x = ts._replace(cross=PI.encode_cross(pp, pc, px["frames"]))
    xl, _ = PI.prefill(pp, pc, with_x, torch.from_numpy(qry)[None],
                       full_logits=True)
    assert np.abs(xl[0].numpy() - out["port"]).max() > 100 * ATOL


def test_stream_compression_adds_no_learned_position():
    """``compress_from_kv`` embeds its <COMP> rows as ``comp_embed``
    alone, in the reference and in the port: the memory it writes does
    not change when the learned position table does."""
    jc, pc = cfgs(WHISPER, **STREAM)
    jp, pp = params(WHISPER, pc)
    rs = np.random.default_rng(8)
    blk = rs.normal(0, 1, (pc.n_layers, B, 8, pc.n_kv_heads, pc.hd)).astype(
        np.float32)
    outs = []
    for scale in (1.0, 3.0):
        p2 = dict(pp, pos_embed=pp["pos_embed"] * scale)
        mem = PS.init_stream_state(pc, B, device="cpu").mem
        outs.append(PS.compress_from_kv(p2, pc, mem, torch.from_numpy(blk),
                                        torch.from_numpy(blk), 40).k)
        jp2 = dict(jp, pos_embed=jp["pos_embed"] * scale)
        jmem = JS.init_stream_state(jc, B).mem
        want = jax.jit(JS.compress_from_kv, static_argnums=(1,))(
            jp2, jc, jmem, jnp.asarray(blk), jnp.asarray(blk),
            jnp.int32(40)).k
        _close(want, outs[-1])
    assert torch.equal(outs[0], outs[1])
