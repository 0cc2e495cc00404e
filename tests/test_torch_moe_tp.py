"""The MoE family split over the ``model`` axis, in the port against the
reference: ``phi35_moe.smoke`` (top-2, full training) and
``llama4_maverick.smoke`` (top-1, LoRA), float32 params, under each
``moe_impl`` (``ragged_tp``: each expert's ``d_ff`` over the model axis;
``ep``: the experts over it, with the capacity-bounded all-to-all), on
meshes (1, 2), (2, 2) and (1, 4), in ``gloo`` worlds of 2 and 4 ranks
(``distributed.elastic.launch_world``) against the reference on
``make_debug_mesh`` (one subprocess a model, 4 forced host devices),
from the same weights and inputs, `skew`-ed so that ``ep`` drops: one
AdamW step of ``jit_train_step`` (the loss, every updated trainable leaf
and both AdamW moments, gathered to whole leaves); ``ep`` must drop
(the port's count, ``models.moe.EP_DROPS``) and its loss differ from
the reference's ``dist=None`` one.  ``tests/test_torch_moe_tp_online.py``
holds the online builders and the stream step the same way.

Also ``apply_moe(dist=)`` alone at the shape of the reference's
``tests/test_distributed.py::test_moe_tp_ep_equivalence``, against the
reference's on ``make_debug_mesh(2, 2)``.

In one process (no world): the rank loop of a ``LocalGroup`` against the
unsharded model for both strategies (the training forward, the loss and
every gradient, full training; the online path), ``ep`` held to
``models.moe.moe_ep_unsharded`` (the dropless path under ``ep``'s keep
mask), whose gradients an n-fold expert gradient would miss; the
capacity rule against a direct count; the split's refusals.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_tensor_parallel.py``; under top-1 the router's
gradient is 0 in exact arithmetic, and both sides' rounding noise is
held within 1e-6 x the largest gradient.
"""
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import masks as PM
from repro_torch.distributed.elastic import launch_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
LAYOUT = (4, 8, 2, 8)                # t_steps, chunk, comp_len, tail
B = 8
# eps 1e-6: the first step's update lr g / (|g| + eps) would amplify the
# float32 rounding of a near-zero gradient element by up to lr / eps
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6, eps=1e-6)
MODELS = {"phi35_moe": "full", "llama4_maverick": "lora"}
IMPLS = ("ragged_tp", "ep")
MESHES = ((1, 2), (2, 2), (1, 4))
CASES = {f"{m}-{impl}-{a}x{b}": ((a, b), m, impl)
         for m in MODELS for impl in IMPLS for a, b in MESHES}
STREAM = dict(stream_window=24, stream_chunk=8, stream_sink=2,
              stream_mem_slots=2)
N_STREAM = 4                          # chunks of 8: one eviction


def _cfg_kw(model):
    return dict(compute_dtype="float32", param_dtype="float32",
                train_mode=MODELS[model])


def _port_cfg(model, impl, **ccm):
    import importlib

    from repro_torch.models.config import CCMConfig
    mod = importlib.import_module(f"repro_torch.configs.{model}")
    return mod.smoke(**_cfg_kw(model)).replace(
        moe_impl=impl, ccm=CCMConfig(comp_len=2, max_steps=4, **ccm))


def _inputs():
    """Per model the reference's init, perturbed (every LoRA factor gets
    a gradient) and skewed (`skew`: ``ep`` drops on every mesh); a
    training batch whose row 0 loses loss positions; online and stream
    tokens; as numpy."""
    import jax

    from repro.core import masks as JM
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    params, batches = {}, {}
    for i, model in enumerate(MODELS):
        cfg = _ref_cfg(model, "ragged_tp")
        p = JT.init_lm(jax.random.PRNGKey(i), cfg)
        leaves, tdef = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(7 + i), len(leaves))
        p = tdef.unflatten([x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
                            for x, k in zip(leaves, keys)])
        b = jsample(jax.random.PRNGKey(1), JM.segment_layout(*LAYOUT), B)
        b = {k: np.array(v) for k, v in b.items()}
        b["tokens"] = b["tokens"] % cfg.vocab_size
        b["loss_mask"][0, :3] = 0
        batches[model] = b
        params[model] = skew(model, jax.tree.map(np.array, p), b["tokens"])
    rng = np.random.default_rng(0)
    toks = {"ctx": rng.integers(0, 256, (2, 6)),
            "prompt": rng.integers(0, 256, (2, 5)),
            "tok": rng.integers(0, 256, (2, 1)),
            "stream": rng.integers(0, 256, (N_STREAM, 2, 8)),
            "x": rng.standard_normal((8, 16, 64))}
    toks = {k: v.astype(np.int32) if v.dtype.kind == "i"
            else v.astype(np.float32) for k, v in toks.items()}
    return params, batches, toks


def skew(model, params, tokens):
    """``params`` (as numpy, the reference's tree) with the router
    columns of experts 0 and 1 turned toward each layer's mean MoE input
    (recorded through the port's unsharded training forward over
    ``tokens``), so that most tokens pick them and the first owner's
    buffer overflows under ``ep``."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.params import params_from_numpy
    cfg = _port_cfg(model, "ragged_tp")
    means = []
    route = MOE._route

    def record(c, w, xf):
        means.append(xf.mean(0))
        return route(c, w, xf)
    MOE._route = record
    try:
        with torch.no_grad():
            T.train_forward(params_from_numpy(params, cfg, device="cpu"),
                            cfg, torch.as_tensor(tokens),
                            PM.segment_layout(*LAYOUT))
    finally:
        MOE._route = route
    router = params["layers"]["moe"]["router"]           # (L, d, E)
    for li, m in enumerate(means):
        u = (m / m.norm()).numpy()
        router[li, :, :2] += 3 * u[:, None] * router[li].std()
    return params


def _ref_cfg(model, impl, **ccm):
    import importlib

    from repro.models.config import CCMConfig
    mod = importlib.import_module(f"repro.configs.{model}")
    return mod.smoke(**_cfg_kw(model)).replace(
        moe_impl=impl, ccm=CCMConfig(comp_len=2, max_steps=4, **ccm))


_REF = """
import importlib, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import inference as I
from repro.core import masks as M
from repro.core import streaming as STR
from repro.launch import serve as S
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.launch.train import (jit_train_step, make_train_step,
                                trainable_mask_for)
from repro.models import moe as MOE
from repro.models.config import CCMConfig, ModelConfig
from repro.optim import partition as PT
from repro.optim.adamw import AdamWConfig, init_adamw
assert jax.device_count() == 4
params_all, batches, t = pickle.load(open(sys.argv[1], "rb"))
t = {{k: jnp.asarray(v) for k, v in t.items()}}
model_here = sys.argv[3]
layout = M.segment_layout(*{layout})
flat = lambda tr: {{"/".join(str(k.key) for k in p): np.asarray(x)
                   for p, x in jax.tree_util.tree_flatten_with_path(tr)[0]}}
np_ = lambda x: None if x is None else np.asarray(x)
fresh = lambda st: jax.tree.map(lambda x: jnp.array(np.asarray(x)), st)

def cfg_of(model, impl, **ccm):
    mod = importlib.import_module("repro.configs." + model)
    return mod.smoke(compute_dtype="float32", param_dtype="float32",
                     train_mode={models}[model]).replace(
        moe_impl=impl, ccm=CCMConfig(comp_len=2, max_steps=4, **ccm))

def state_np(st):
    c, m = st.cache, st.mem
    return dict(k=np_(c.k), v=np_(c.v), length=int(c.length),
                mem_k=np_(m.k), mem_v=np_(m.v), slots=int(m.slots),
                steps=int(m.steps), pos=int(st.pos))

def train(cfg, params, batch, dist):
    trainable = trainable_mask_for(cfg, params)
    tp, fp = PT.partition(params, trainable)
    step = make_train_step(cfg, layout, AdamWConfig(**{opt}), dist)
    if dist is None:
        step = jax.jit(step)
    else:
        step = jit_train_step(step, cfg, dist, params,
                              jax.eval_shape(init_adamw, tp), batch,
                              trainable)
    tp2, opt2, m, _ = step(tp, fp, init_adamw(tp), batch, None)
    return dict(loss=float(m["loss"]), tp=flat(tp2), mu=flat(opt2.mu),
                nu=flat(opt2.nu))

out = {{}}
part = sys.argv[4]
for key, (shape, model, impl) in {cases}.items():
    if model != model_here:
        continue
    dist = make_dist(make_debug_mesh(*shape))
    params = jax.tree.map(jnp.asarray, params_all[model])
    batch = {{k: jnp.asarray(v) for k, v in batches[model].items()}}
    cfg = cfg_of(model, impl)
    if part == "train":
        out[key] = train(cfg, params, batch, dist)
        continue
    ing, pre = S.make_ingest_step(cfg, dist), S.make_prefill_step(cfg, dist)
    dec = S.make_decode_step(cfg, dist)
    st = ing(params, fresh(I.init_online_state(cfg, 2, 16)), t["ctx"])
    lp, st = pre(params, st, t["prompt"])
    ld, st = dec(params, st, t["tok"])
    out[key] = dict(prefill=np_(lp), decode=np_(ld), state=state_np(st))
    if impl != "ragged_tp":
        continue
    # the stream step's MoE takes no dist: dropless under either impl, so
    # one run serves both
    scfg = cfg_of(model, impl, **{stream})
    step = S.make_stream_step(scfg, params, dist)
    st = fresh(STR.init_stream_state(scfg, 2))
    logits = []
    for c in t["stream"]:
        lg, st = step(params, st, c)
        logits.append(np_(lg))
    out[("stream", model, shape)] = dict(
        logits=logits, win_k=np_(st.win_k), mem_k=np_(st.mem.k),
        slots=int(st.mem.slots))
if part == "train":
    params = jax.tree.map(jnp.asarray, params_all[model_here])
    batch = {{k: jnp.asarray(v) for k, v in batches[model_here].items()}}
    out[("none", model_here)] = train(cfg_of(model_here, "ragged_tp"),
                                      params, batch, None)["loss"]
if part == "train" and model_here == "phi35_moe":
    # apply_moe alone, at test_moe_tp_ep_equivalence's shape, on (2, 2)
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
                      n_experts=8, top_k=2, compute_dtype="float32",
                      ccm=CCMConfig(comp_len=2, max_steps=4))
    p = MOE.init_moe(jax.random.PRNGKey(0), cfg, 64, 128)
    dist = make_dist(make_debug_mesh(2, 2))
    alone = dict(p=jax.tree.map(np.asarray, p))
    for impl in ("ragged_tp", "ep"):
        c = cfg.replace(moe_impl=impl)
        def fwd_bwd(pp, xx):
            y, vjp = jax.vjp(lambda a, b: MOE.apply_moe(c, a, b, dist), pp,
                             xx)
            return y, vjp(jnp.cos(y))
        y, (gp, gx) = jax.jit(fwd_bwd)(p, t["x"])
        alone[impl] = dict(y=np_(y), gx=np_(gx),
                           gp=jax.tree.map(np.asarray, gp))
    out["alone"] = alone
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path, part):
    """``part`` ("train" or "online") of the reference, one subprocess per
    model (they run side by side); returns [(process, its output file)]."""
    src = textwrap.dedent(_REF.format(layout=LAYOUT, models=MODELS,
                                      cases=CASES, opt=OPT, stream=STREAM))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    procs = []
    for model in MODELS:
        out = tmp_path / f"ref_{part}_{model}.pkl"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", src, str(inp), str(out), model, part],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), out))
    return procs


def _np(x):
    return None if x is None else x.detach().numpy().copy()


def _state_np(st):
    c, m = st.cache, st.mem
    return dict(k=_np(c.k), v=_np(c.v), length=int(c.length),
                mem_k=_np(m.k), mem_v=_np(m.v), slots=int(m.slots),
                steps=int(m.steps), pos=int(st.pos))


def _world(dev, params_all, batches, t, keys, part):
    """On every rank: ``part`` ("train" or "online") of each case of
    ``keys``; rank 0 returns the gathered results and the assignments
    ``ep`` dropped in each case."""
    import torch.distributed as tdist

    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP
    from repro_torch.params import params_from_numpy

    def flat(tree):
        return {"/".join(p): x.detach().numpy().copy()
                for p, x in PP.leaves(tree)}

    tt = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    meshes, out = {}, {}
    for key in keys:
        shape, model, impl = CASES[key]
        if shape not in meshes:
            meshes[shape] = make_dist(make_debug_mesh(*shape, device=dev))
        dist = meshes[shape]
        cfg = _port_cfg(model, impl)
        params = params_from_numpy(params_all[model], cfg, device=dev)
        MOE.EP_DROPS.update(assignments=0, dropped=0)
        if part == "train":
            tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
            opt = PA.init_adamw(tp)
            batch = {k: torch.from_numpy(v.copy())
                     for k, v in batches[model].items()}
            step = TR.jit_train_step(
                TR.make_train_step(cfg, PM.segment_layout(*LAYOUT),
                                   PA.AdamWConfig(**OPT), dist),
                cfg, dist, None, None, batch, None)
            tp, fp, opt = step.place(tp, fp, opt)
            tp, opt, m, _ = step(tp, fp, opt, batch)
            res = dict(loss=float(m["loss"]), tp=flat(step.gather(tp)),
                       mu=flat(step.gather(opt.mu)),
                       nu=flat(step.gather(opt.nu)))
        else:
            res = _online(dev, cfg, params, tt, dist)
        # model-axis rank 0 counts; the data ranks' counts are summed
        drops = torch.tensor([MOE.EP_DROPS["dropped"]])
        tdist.all_reduce(drops)
        res["drops"] = int(drops)
        out[key] = res
    return out


def _online(dev, cfg, params, tt, dist):
    """An ingest, a prefill and a decode step through the ``dist=`` serve
    builders, then the stream step through an eviction, gathered."""
    from repro_torch.core import inference as I
    from repro_torch.core import streaming as STR
    from repro_torch.launch import serve as SRV
    from repro_torch.models import moe as MOE
    ing = SRV.make_ingest_step(cfg, dist)
    pre = SRV.make_prefill_step(cfg, dist)
    dec = SRV.make_decode_step(cfg, dist)
    pl, st = ing.place(params, I.init_online_state(cfg, 2, 16, device=dev))
    st = ing(pl, st, tt["ctx"])
    lp, st = pre(pl, st, tt["prompt"])
    ld, st = dec(pl, st, tt["tok"])
    res = dict(prefill=_np(pre.gather_logits(lp)),
               decode=_np(dec.gather_logits(ld)),
               state=_state_np(dec.gather_state(st)))
    scfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, **STREAM))
    sstep = SRV.make_stream_step(scfg, dist)
    pl, st = sstep.place(params, STR.init_stream_state(scfg, 2, device=dev))
    before = MOE.EP_DROPS["dropped"]
    logits = []
    for c in tt["stream"]:
        lg, st = sstep(pl, st, c)
        logits.append(_np(sstep.gather_logits(lg)))
    st = sstep.gather_state(st)
    res["stream"] = dict(logits=logits, win_k=_np(st.win_k),
                         mem_k=_np(st.mem.k), slots=int(st.mem.slots),
                         drops=MOE.EP_DROPS["dropped"] - before)
    return res


def close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


def run_cases(tmp_path_factory, part):
    """``part`` of every case, in the port's gloo worlds and in the
    reference: (port results, reference results, tokens)."""
    tmp = tmp_path_factory.mktemp(f"moe_tp_{part}")
    params, batches, t = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, batches, t)))
    refs = _reference(inp, tmp, part)
    want = {}
    try:
        got = {}
        for world in (2, 4):
            keys = [k for k, c in CASES.items()
                    if c[0][0] * c[0][1] == world]
            got.update(launch_world(world, _world, params, batches, t, keys,
                                    part, device="cpu", timeout=600))
        for ref, out in refs:
            _, stderr = ref.communicate(timeout=900)
            assert ref.returncode == 0, stderr
            want.update(pickle.loads(out.read_bytes()))
    finally:
        for ref, _ in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    return got, want, t


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory, "train")


@pytest.mark.parametrize("case", list(CASES))
def test_moe_tp_train_step_matches_reference(results, case):
    got, want, _ = results
    g, w = got[case], want[case]
    close(g["loss"], w["loss"], f"{case} loss")
    assert sorted(g["tp"]) == sorted(w["tp"]) and w["tp"]
    for part in ("tp", "mu", "nu"):
        for k, v in w[part].items():
            close(g[part][k], v, f"{case} {part} {k}")
    _, model, impl = CASES[case]
    if impl == "ep":
        # ep drops assignments, and the reference's dist=None differs
        assert g["drops"] > 0, case
        none = want[("none", model)]
        assert abs(none - w["loss"]) > 10 * REL * abs(none), (case, none)


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_moe_alone_matches_reference(results, impl):
    """``apply_moe(dist=)`` at the reference's equivalence test's shape
    (8 experts top-2, x (8, 16, 64)) on the 2 LocalGroup ranks of a
    model axis, its rows in 2 blocks (``row_blocks``, as the reference's
    data shards hold them),
    against the reference's on ``make_debug_mesh(2, 2)``: the output and
    the gradients of x and every leaf under the cotangent cos(y)."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import CCMConfig, ModelConfig
    _, want, t = results
    ref = want["alone"]
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
                      n_experts=8, top_k=2, compute_dtype="float32",
                      moe_impl=impl, ccm=CCMConfig(comp_len=2, max_steps=4))
    p = {k: torch.from_numpy(v.copy()) for k, v in ref["p"].items()}
    x = torch.from_numpy(t["x"].copy())
    group = TPX.LocalGroup(2)
    ranks = TPX.local_ranks(cfg, group)

    def one(r):
        # the rows of the reference's 2 data shards are 2 blocks here
        tp = dataclasses.replace(ranks[r], row_blocks=2)
        sh = TPX.shard_params({"moe": p}, cfg, tp)["moe"]
        leaves = {k: v.clone().requires_grad_(True) for k, v in sh.items()}
        xx = x.clone().requires_grad_(True)
        y = MOE.apply_moe(cfg, leaves, xx, tp)
        g = torch.autograd.grad(y, [xx] + list(leaves.values()),
                                torch.cos(y))
        whole = TPX.gather_params({"moe": dict(zip(leaves, g[1:]))}, cfg,
                                  tp)["moe"]
        return y.detach(), g[0], whole

    for y, gx, gp in group.run(one):
        close(y, ref[impl]["y"], f"{impl} y")
        close(gx, ref[impl]["gx"], f"{impl} grad x")
        for k, v in ref[impl]["gp"].items():
            close(gp[k], v, f"{impl} grad {k}")


# ---------------------------------------------------------------------------
# in one process: the rank loop against the unsharded model
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ep_counterpart(n, blocks=1):
    """Within: every unsharded MoE call (``dist`` None) computes what
    ``ep`` at ``n`` computes (``moe_ep_unsharded``)."""
    from repro_torch.models import moe as MOE
    apply = MOE.apply_moe

    def swapped(cfg, p, x, dist=None):
        if dist is None:
            return MOE.moe_ep_unsharded(cfg, p, x, n, blocks)
        return apply(cfg, p, x, dist)
    MOE.apply_moe = swapped
    try:
        yield
    finally:
        MOE.apply_moe = apply


def _skewed_params(cfg, seed, tokens):
    """The port's init perturbed, then `skew`-ed over ``tokens``."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP
    gen = torch.Generator().manual_seed(seed)
    params = PP.tree_map(
        lambda _, x: (x + 0.02 * torch.randn(x.shape, generator=gen)).numpy(),
        T.init_lm(cfg, 0, device="cpu"))
    model = "phi35_moe" if cfg.top_k == 2 else "llama4_maverick"
    return PP.tree_map(lambda _, x: torch.from_numpy(x),
                       skew(model, params, tokens))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("model", list(MODELS))
def test_local_group_moe_ranks_match_unsharded(model, impl, n):
    """The n ranks of a ``LocalGroup`` on their shards give the unsharded
    model's training logits, loss and every gradient (gathered; full
    training, so the experts' and the router's), ``ep`` against
    ``moe_ep_unsharded`` at n; then an ingest, a prefill and a decode
    step.  ``ep`` must drop here, and its result differ from the
    dropless model's."""
    from repro_torch.core import inference as PI
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP
    from repro_torch.optim.losses import next_token_loss

    cfg = _port_cfg(model, impl).replace(train_mode="full")
    layout = PM.segment_layout(*LAYOUT)
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab_size, (2, layout.seq_len), generator=gen)
    params = _skewed_params(cfg, 3, tok)
    mask = torch.ones(2, layout.tail_len - 1)
    ctx, prompt = (torch.randint(0, cfg.vocab_size, (2, w), generator=gen)
                   for w in (6, 5))
    st0 = PI.init_online_state(cfg, 2, 16, device="cpu")

    def run(p, st, tp):
        leaves = [x.detach().clone().requires_grad_(True)
                  for _, x in PP.leaves(p)]
        it = iter(leaves)
        p = PP.tree_map(lambda _, x: next(it), p)
        lg = T.train_forward(p, cfg, tok, layout, dist=tp)
        loss = next_token_loss(lg, tok[:, -layout.tail_len:], mask, tp=tp)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = PP.tree_map(lambda _, x: next(it), p)
        drops = MOE.EP_DROPS["dropped"]        # rank 0's, in training
        with torch.no_grad():
            st = PI.ingest_context(p, cfg, st, ctx, dist=tp)
            lp, st = PI.prefill(p, cfg, st, prompt, dist=tp)
            ld, st = PI.decode_step(p, cfg, st, prompt[:, :1], dist=tp)
        return (PI.gather_vocab(lg.detach(), cfg, tp), loss.detach(), grads,
                PI.gather_vocab(lp, cfg, tp), PI.gather_vocab(ld, cfg, tp),
                drops)

    def clone(st):
        return TPX.map_by_spec(lambda x, _: x.clone(), st, None)

    with ep_counterpart(n) if impl == "ep" else contextlib.nullcontext():
        want = run(params, clone(st0), None)
    dropless = run(params, clone(st0), None)
    group = TPX.LocalGroup(n)
    ranks = TPX.local_ranks(cfg, group)
    MOE.EP_DROPS.update(assignments=0, dropped=0)

    def one(r):
        tp = ranks[r]
        st = TPX.map_by_spec(
            lambda x, _: x.clone() if tp.attn != "kv" else x.narrow(
                3, r * x.shape[3] // n, x.shape[3] // n).clone(), st0, None)
        lg, loss, g, lp, ld, drops = run(TPX.shard_params(params, cfg, tp),
                                         st, tp)
        return lg, loss, TPX.gather_params(g, cfg, tp), lp, ld, drops

    outs = group.run(one)
    top = max(x.abs().max() for _, x in PP.leaves(want[2]))
    for lg, loss, g, lp, ld, _ in outs:
        close(lg, want[0], f"{impl} logits")
        close(loss, want[1], f"{impl} loss")
        for (path, a), (_, b) in zip(PP.leaves(g), PP.leaves(want[2])):
            if path[-1] == "router" and cfg.top_k == 1:
                # 0 in exact arithmetic under top-1 (a weight renormalised
                # to 1): both are rounding noise
                assert max(a.abs().max(), b.abs().max()) <= 1e-6 * top
                continue
            close(a, b, f"{impl} grad {'/'.join(path)}")
        close(lp, want[3], f"{impl} prefill logits")
        close(ld, want[4], f"{impl} decode logits")
    if impl == "ep":
        assert outs[0][5] > 0 and MOE.EP_DROPS["dropped"] > outs[0][5]
        assert (want[1] - dropless[1]).abs() > 10 * REL * dropless[1].abs()
    else:
        assert MOE.EP_DROPS["assignments"] == 0
        close(want[1], dropless[1], "ragged_tp is dropless")


def test_ep_capacity_rule_matches_a_direct_count():
    """``ep_slots`` against the reference's rule counted by hand: per
    block, C = int((N k / n) * 1.25) + 1, the destination the expert's
    owner, the position the count of the block's earlier assignments
    (token-major, choice-minor) to it, kept below C."""
    from repro_torch.models import moe as MOE
    gen = torch.Generator().manual_seed(0)
    for N, k, E, n, blocks in ((12, 2, 4, 2, 1), (12, 2, 4, 2, 2),
                               (30, 1, 8, 4, 3), (7, 2, 6, 3, 1)):
        topi = torch.randint(0, E, (N, k), generator=gen)
        topi[: N // 2] = 0                  # crowd owner 0
        dest, slot, keep, C = MOE.ep_slots(topi, E // n, n, blocks)
        nb = N // blocks
        assert C == int((nb * k / n) * 1.25) + 1
        for b in range(blocks):
            seen = [0] * n
            for i in range(b * nb * k, (b + 1) * nb * k):
                e = int(topi.reshape(-1)[i])
                d = e // (E // n)
                assert int(dest[i]) == d
                assert bool(keep[i]) == (seen[d] < C)
                if seen[d] < C:
                    assert int(slot[i]) == b * C + seen[d]
                seen[d] += 1
        assert not bool(keep.all())
    with pytest.raises(ValueError, match="blocks"):
        MOE.ep_slots(torch.zeros(7, 1, dtype=torch.long), 1, 2, blocks=2)


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_shards_gather_to_whole_leaves(impl):
    """What ``TrainLoop`` and ``remesh_restore`` rely on for the MoE
    family: a mesh with a model axis passes ``check_mesh``, and every
    rank's shard (``shard_params``; ``ep``'s experts along E)
    gathers back to the whole leaves, bit for bit, at n = 2 and 4."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.train import check_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 4}

    cfg = _port_cfg("phi35_moe", impl)
    check_mesh(cfg, DistContext(mesh=Mesh()))
    params = T.init_lm(cfg, 0, device="cpu")
    for n in (2, 4):
        group = TPX.LocalGroup(n)
        ranks = TPX.local_ranks(cfg, group)
        outs = group.run(lambda r: TPX.gather_params(
            TPX.shard_params(params, cfg, ranks[r]), cfg, ranks[r]))
        for whole in outs:
            for (path, a), (_, b) in zip(PP.leaves(whole),
                                         PP.leaves(params)):
                assert torch.equal(a, b), (impl, n, path)
        experts = TPX.shard_params(params, cfg, ranks[1])["layers"]["moe"]
        assert experts["router"] is params["layers"]["moe"]["router"]
        E, f = cfg.n_experts, cfg.d_ff
        assert experts["wi"].shape[-3:] == ((E // n, cfg.d_model, f)
                                            if impl == "ep" else
                                            (E, cfg.d_model, f // n))


def test_moe_split_refusals():
    """What the reference's shard_map cannot split raises: ``ragged_tp``
    with ``d_ff % n``, ``ep`` with ``E % n``; every other family of the
    registry takes the split (``tests/test_torch_tp_families.py``)."""
    import importlib

    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models.config import ModelConfig
    cfg = _port_cfg("phi35_moe", "ragged_tp")            # d_ff 96, E 4
    with pytest.raises(ValueError, match="d_ff 96 over 5"):
        TPX.require_tp_family(cfg, 5)
    with pytest.raises(ValueError, match="4 experts over 3"):
        TPX.require_tp_family(cfg.replace(moe_impl="ep"), 3)
    TPX.require_tp_family(cfg.replace(moe_impl="ep"), 4)
    TPX.require_tp_family(cfg, 4)
    for name in ("mamba2_370m", "zamba2_12b", "whisper_tiny",
                 "pixtral_12b"):
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        c = mod.smoke()
        assert isinstance(c, ModelConfig)
        tp = TPX.tp_of(c, TPX.TensorParallel(c, 2, 0, None))
        assert tp.n == 2 and tp.local.vocab_size == c.vocab_size // 2
