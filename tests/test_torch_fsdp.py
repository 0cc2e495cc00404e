"""ZeRO-3 (``sharding_strategy="fsdp"``, ``repro_torch.distributed.fsdp``)
in the port against the reference, in one ``gloo`` world of 4 ranks
(``distributed.elastic.launch_world``) beside one reference subprocess
(4 forced host devices), from the same weights and batches:

- one AdamW step of ``jit_train_step`` under ``fsdp`` on meshes (1, 2)
  and (2, 2) against the reference's GSPMD ``jit_train_step`` on
  ``make_debug_mesh``: ``smollm_360m.smoke`` (full training; its 180
  ``wq`` columns are stored cut mid-head) and ``phi35_moe.smoke``
  (``ragged_tp``, LoRA; and ``ep``, its router skewed so that the drops
  over each data block are many, which the reference reckons over the
  whole block and a rank's rows alone would not); the int8 and top-k
  codecs at (2, 2) against the
  reference's ``jax.jit(step)`` with the codec: the loss, every updated
  leaf and both moments, gathered to whole leaves.  A (1, 2) mesh is
  ranks {0, 1} and ranks {2, 3} of the world, each pair running the
  case;
- each rank's stored leaves and moments against ``shard_by_spec(leaf,
  param_spec(...))``, exactly;
- ``TrainLoop`` under ``fsdp`` on (2, 2) for 2 steps with a checkpoint,
  resumed by a loop under ``tp`` for a step, then by one under ``fsdp``
  for the last, against the loop on one device; ``remesh_restore`` of the
  checkpoints under both strategies;
- the three ``dist=`` serve builders and ``make_stream_step`` under
  ``fsdp`` at (1, 2) against the reference's builders given
  ``params_shapes``: the logits and the state; under ``fsdp`` with
  ``ep`` against the port's own builders under ``tp`` with ``ep``;
- mamba2, zamba2, whisper and pixtral (smoke): the fsdp train step and
  prefill builder at (1, 2) against the port's ``dist=None``;
- ``reduce_scatter`` over a gloo pair.

In one process: rows that do not split over every mesh axis raise, the
gather dims follow ``param_spec`` (its ties and the leaves it keeps
whole), the shape mesh's and ``LocalGroup``'s ``reduce_scatter``, and
``ep`` on ZeRO-3 training ranks (a ``LocalGroup``): the keep mask from
the gathered ids is ``ep_slots`` over the whole data block.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_tensor_parallel.py``.
"""
import importlib
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
B = 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
# model -> config module (smoke, float32, fsdp), and the overrides of
# those that have them
MODELS = {"smollm": "smollm_360m", "phi35": "phi35_moe",
          "phi35-ep": "phi35_moe"}
OVER = {"phi35-ep": {"moe_impl": "ep"}}
# case -> (mesh, model, codec)
CASES = {
    "smollm-1x2": ((1, 2), "smollm", "none"),
    "smollm-2x2": ((2, 2), "smollm", "none"),
    "phi35-1x2": ((1, 2), "phi35", "none"),
    "phi35-2x2": ((2, 2), "phi35", "none"),
    "phi35-ep-1x2": ((1, 2), "phi35-ep", "none"),
    "phi35-ep-2x2": ((2, 2), "phi35-ep", "none"),
    "smollm-int8-2x2": ((2, 2), "smollm", "int8"),
    "smollm-topk-2x2": ((2, 2), "smollm", "topk"),
}
STREAM = dict(stream_window=24, stream_chunk=8, stream_sink=2,
              stream_mem_slots=2)
FAMILIES = {"mamba2": "mamba2_370m", "zamba2": "zamba2_12b",
            "whisper": "whisper_tiny", "pixtral": "pixtral_12b"}


def _cfg(pkg, model, **kw):
    mod = importlib.import_module(f"{pkg}.configs.{MODELS.get(model, model)}")
    cfg = mod.smoke(compute_dtype="float32", param_dtype="float32")
    return cfg.replace(**{"sharding_strategy": "fsdp",
                          **OVER.get(model, {}), **kw})



def _inputs():
    """Per model the reference's init, perturbed so that every LoRA
    factor has a gradient; a batch whose row 0 loses loss positions; the
    serve tokens; as numpy."""
    import jax

    from repro.core import masks as JM
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    params, batches = {}, {}
    for i, model in enumerate(MODELS):
        cfg = _cfg("repro", model)
        p = JT.init_lm(jax.random.PRNGKey(i), cfg)
        leaves, tdef = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(7 + i), len(leaves))
        p = tdef.unflatten([x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
                            for x, k in zip(leaves, keys)])
        params[model] = jax.tree.map(np.array, p)
        b = jsample(jax.random.PRNGKey(1), JM.segment_layout(*LAYOUT), B)
        b = {k: np.array(v) for k, v in b.items()}
        b["tokens"] = b["tokens"] % cfg.vocab_size
        b["loss_mask"][0, :3] = 0
        batches[model] = b
        if model in OVER:
            # the router turned so that ep drops (the MoE split's tests')
            from test_torch_moe_tp import skew
            params[model] = skew("phi35_moe", params[model], b["tokens"])
    rng = np.random.default_rng(0)
    t = {"ctx": rng.integers(0, 256, (2, 6)),
         "ctx2": rng.integers(0, 256, (2, 5)),
         "prompt": rng.integers(0, 256, (2, 5)),
         "tok": rng.integers(0, 256, (2, 1)),
         "stream": rng.integers(0, 256, (6, 2, 8))}
    return params, batches, {k: v.astype(np.int32) for k, v in t.items()}


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
from repro.models.config import CCMConfig
from repro.optim import partition as PT
from repro.optim.adamw import AdamWConfig, init_adamw
from repro.optim.grad_compress import EFState
assert jax.device_count() == 4
params_all, batches, t = pickle.load(open(sys.argv[1], "rb"))
t = {{k: jnp.asarray(v) for k, v in t.items()}}
layout = M.segment_layout(*{layout})
flat = lambda tr: {{"/".join(str(k.key) for k in p): np.asarray(x)
                   for p, x in jax.tree_util.tree_flatten_with_path(tr)[0]}}
np_ = lambda x: None if x is None else np.asarray(x)
fresh = lambda st: jax.tree.map(lambda x: jnp.array(np.asarray(x)), st)

def cfg_of(model, **kw):
    mod = importlib.import_module("repro.configs." + {models}[model])
    return mod.smoke(compute_dtype="float32", param_dtype="float32").replace(
        sharding_strategy="fsdp", **{over}.get(model, {{}}), **kw)

out = {{}}
for key, (shape, model, codec) in {cases}.items():
    dist = make_dist(make_debug_mesh(*shape))
    cfg = cfg_of(model)
    params = jax.tree.map(jnp.asarray, params_all[model])
    batch = {{k: jnp.asarray(v) for k, v in batches[model].items()}}
    trainable = trainable_mask_for(cfg, params)
    tp, fp = PT.partition(params, trainable)
    ef = None if codec == "none" else EFState(jax.tree.map(
        lambda p: jnp.zeros((shape[0],) + p.shape, jnp.float32), tp))
    step = make_train_step(cfg, layout, AdamWConfig(**{opt}), dist,
                           grad_codec=codec)
    if codec == "none":
        step = jit_train_step(step, cfg, dist, params,
                              jax.eval_shape(init_adamw, tp), batch,
                              trainable)
    else:
        step = jax.jit(step)
    tp2, opt2, m, _ = step(tp, fp, init_adamw(tp), batch, ef)
    out[key] = dict(loss=float(m["loss"]), tp=flat(tp2), mu=flat(opt2.mu),
                    nu=flat(opt2.nu))

dist = make_dist(make_debug_mesh(1, 2))
cfg = cfg_of("smollm")
params = jax.tree.map(jnp.asarray, params_all["smollm"])
ing = S.make_ingest_step(cfg, dist, params_shapes=params)
pre = S.make_prefill_step(cfg, dist, params_shapes=params)
dec = S.make_decode_step(cfg, dist, params_shapes=params)
st = ing(params, fresh(I.init_online_state(cfg, 2, 32)), t["ctx"])
st = ing(params, st, t["ctx2"])
lp, st = pre(params, st, t["prompt"])
ld, st = dec(params, st, t["tok"])
out["serve"] = dict(prefill=np_(lp), decode=np_(ld), k=np_(st.cache.k),
                    v=np_(st.cache.v), mem_k=np_(st.mem.k),
                    mem_v=np_(st.mem.v), length=int(st.cache.length),
                    slots=int(st.mem.slots))
cfg = cfg_of("smollm", ccm=CCMConfig(comp_len=2, max_steps=4, **{stream}))
step = S.make_stream_step(cfg, params, dist)
st = fresh(STR.init_stream_state(cfg, 2))
logits = []
for c in t["stream"]:
    lg, st = step(params, st, c)
    logits.append(np_(lg))
out["stream"] = dict(logits=logits, win_k=np_(st.win_k), mem_k=np_(st.mem.k),
                     slots=int(st.mem.slots), pos=int(st.pos))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path):
    src = textwrap.dedent(_REF.format(layout=LAYOUT, models=MODELS,
                                      over=OVER, cases=CASES, opt=OPT,
                                      stream=STREAM))
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", src, str(inp), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


# ---------------------------------------------------------------------------
# the world's ranks
# ---------------------------------------------------------------------------

def _meshes(dev):
    """{(1, 2): this rank's pair's mesh, (2, 2): the world's}: every rank
    builds both pairs' meshes (building one is a collective)."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    pairs = [DeviceMesh("cpu", torch.tensor([[0, 1]]),
                        mesh_dim_names=("data", "model")),
             DeviceMesh("cpu", torch.tensor([[2, 3]]),
                        mesh_dim_names=("data", "model"))]
    return {(1, 2): make_dist(pairs[tdist.get_rank() // 2]),
            (2, 2): make_dist(make_debug_mesh(2, 2, device=dev))}


def _flat(t):
    from repro_torch.optim import partition as PP
    return {"/".join(p): x.detach().numpy().copy() for p, x in PP.leaves(t)}


def _train(dists, params_all, batches):
    """Each case's one step; and whether every rank stores exactly its
    ``param_spec`` blocks of the leaves and moments."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.launch import train as TR
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import grad_compress as PG
    from repro_torch.optim import partition as PP
    from repro_torch.params import params_from_numpy

    out, stored = {}, []
    for key, (shape, model, codec) in CASES.items():
        dist = dists[shape]
        cfg = _cfg("repro_torch", model)
        params = params_from_numpy(params_all[model], cfg, device="cpu")
        tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
        opt = PA.init_adamw(tp)
        batch = {k: torch.from_numpy(v.copy())
                 for k, v in batches[model].items()}
        step = TR.make_train_step(cfg, PM.segment_layout(*LAYOUT),
                                  PA.AdamWConfig(**OPT), dist,
                                  grad_codec=codec)
        jstep = TR.jit_train_step(step, cfg, dist, None, None, batch, None)
        ptp, pfp, popt = jstep.place(tp, fp, opt)
        specs = SH.param_pspecs(cfg, params, dist)
        for whole, mine in ((tp, ptp), (fp, pfp), (opt.mu, popt.mu)):
            for (path, w), (_, x) in zip(PP.leaves(whole), PP.leaves(mine)):
                spec = specs
                for k in path:
                    spec = spec[k]
                if not torch.equal(x, TPX.shard_by_spec(w, spec, dist)):
                    stored.append((key, "/".join(path)))
        ef = None if codec == "none" else PG.init_ef(ptp)
        MOE.EP_DROPS.update(assignments=0, dropped=0)
        ptp, popt, m, _ = jstep(ptp, pfp, popt, batch, ef)
        out[key] = dict(loss=float(m["loss"]), tp=_flat(jstep.gather(ptp)),
                        mu=_flat(jstep.gather(popt.mu)),
                        nu=_flat(jstep.gather(popt.nu)),
                        drops=dict(MOE.EP_DROPS))
    return out, stored


def _loop(dev, dists, ckpt_dir):
    """TrainLoop under fsdp (2 steps, a checkpoint), resumed under tp (a
    step, a checkpoint), then under fsdp (the last step), against the
    loop on one device; remesh_restore of each checkpoint under the other
    strategy against the strategy's blocks of its whole leaves."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed.elastic import remesh_restore
    from repro_torch.launch import train as TR
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP

    dist = dists[(2, 2)]
    fcfg = _cfg("repro_torch", "smollm")
    tcfg = fcfg.replace(sharding_strategy="tp")

    def loop(cfg, d, every):
        return TR.TrainLoop(cfg, PM.segment_layout(*LAYOUT),
                            PA.AdamWConfig(**OPT), batch_size=B,
                            ckpt_dir=None if d is None else ckpt_dir,
                            ckpt_every=every, dist=d, device="cpu")
    want = [h["loss"] for h in loop(fcfg, None, 1).run(4, log_every=0)]
    hist = loop(fcfg, dist, 2).run(2, log_every=0)
    lt = loop(tcfg, dist, 3)
    hist += lt.run(3, start_step=lt.maybe_restore(), log_every=0)
    lf = loop(fcfg, dist, 4)
    start = lf.maybe_restore()
    hist += lf.run(4, start_step=start, log_every=0)
    same = start == 3
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    for step, cfg in ((2, tcfg), (3, fcfg)):
        tmpl = {"tp": lf.tp, "opt": lf.opt}
        state, extra, d2 = remesh_restore(ckpt, step, cfg, dists[(2, 2)].mesh,
                                          tmpl, None)
        whole = {"tp": FS.gather_model(lf.tp, fcfg, dist)}
        on_disk, _ = ckpt.restore(step, whole)
        mine = FS.shard_model(on_disk["tp"], cfg, d2)
        same &= int(extra["step"]) == step and all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(PP.leaves(state["tp"]), PP.leaves(mine)))
    return dict(want=want, got=[h["loss"] for h in hist], same=same)


def _serve(dists, params_all, t):
    from repro_torch.core import inference as I
    from repro_torch.core import streaming as STR
    from repro_torch.launch import serve as SRV
    from repro_torch.models.config import CCMConfig as PCCM
    from repro_torch.params import params_from_numpy

    dist = dists[(1, 2)]
    tt = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    cfg = _cfg("repro_torch", "smollm")
    params = params_from_numpy(params_all["smollm"], cfg, device="cpu")
    ing, pre = SRV.make_ingest_step(cfg, dist), SRV.make_prefill_step(cfg,
                                                                      dist)
    dec = SRV.make_decode_step(cfg, dist)
    pl, st = ing.place(params, I.init_online_state(cfg, 2, 32, device="cpu"))
    st = ing(pl, st, tt["ctx"])
    st = ing(pl, st, tt["ctx2"])
    lp, st = pre(pl, st, tt["prompt"])
    ld, st = dec(pl, st, tt["tok"])
    st = dec.gather_state(st)
    n = lambda x: x.detach().numpy().copy()          # noqa: E731
    out = {"serve": dict(prefill=n(pre.gather_logits(lp)),
                         decode=n(dec.gather_logits(ld)), k=n(st.cache.k),
                         v=n(st.cache.v), mem_k=n(st.mem.k),
                         mem_v=n(st.mem.v), length=int(st.cache.length),
                         slots=int(st.mem.slots))}
    cfg = _cfg("repro_torch", "smollm", ccm=PCCM(comp_len=2, max_steps=4,
                                                  **STREAM))
    params = params_from_numpy(params_all["smollm"], cfg, device="cpu")
    step = SRV.make_stream_step(cfg, dist)
    pl, st = step.place(params, STR.init_stream_state(cfg, 2, device="cpu"))
    logits = []
    for c in tt["stream"]:
        lg, st = step(pl, st, c)
        logits.append(n(step.gather_logits(lg)))
    st = step.gather_state(st)
    out["stream"] = dict(logits=logits, win_k=n(st.win_k), mem_k=n(st.mem.k),
                         slots=int(st.mem.slots), pos=int(st.pos))
    out["serve-ep"] = {s: _serve_ep(dist, params_all["phi35-ep"], tt,
                                    _cfg("repro_torch", "phi35-ep",
                                         sharding_strategy=s))
                       for s in ("fsdp", "tp")}
    return out


def _serve_ep(dist, params_np, tt, cfg):
    """The three builders and the stream step under ``cfg`` (``ep``): the
    gathered logits and states."""
    from repro_torch.core import inference as I
    from repro_torch.core import streaming as STR
    from repro_torch.launch import serve as SRV
    from repro_torch.models.config import CCMConfig as PCCM
    from repro_torch.params import params_from_numpy

    n = lambda x: x.detach().numpy().copy()          # noqa: E731
    params = params_from_numpy(params_np, cfg, device="cpu")
    ing, pre = SRV.make_ingest_step(cfg, dist), SRV.make_prefill_step(cfg,
                                                                      dist)
    dec = SRV.make_decode_step(cfg, dist)
    pl, st = ing.place(params, I.init_online_state(cfg, 2, 32, device="cpu"))
    st = ing(pl, st, tt["ctx"])
    lp, st = pre(pl, st, tt["prompt"])
    ld, st = dec(pl, st, tt["tok"])
    st = dec.gather_state(st)
    out = dict(prefill=n(pre.gather_logits(lp)),
               decode=n(dec.gather_logits(ld)), k=n(st.cache.k),
               mem_k=n(st.mem.k))
    scfg = cfg.replace(ccm=PCCM(comp_len=2, max_steps=4, **STREAM))
    step = SRV.make_stream_step(scfg, dist)
    pl, st = step.place(params, STR.init_stream_state(scfg, 2, device="cpu"))
    for i, c in enumerate(tt["stream"]):
        lg, st = step(pl, st, c)
        out[f"stream{i}"] = n(step.gather_logits(lg))
    out["win_k"] = n(step.gather_state(st).win_k)
    return out


def _families(dists):
    """Per family, the fsdp train step and prefill builder at (1, 2)
    against ``dist=None``: (loss, leaves' and logits' worst error over
    their largest)."""
    from repro_torch.core import inference as I
    from repro_torch.data import synthetic as PD
    from repro_torch.launch import serve as SRV
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP

    dist = dists[(1, 2)]
    layout = PM.segment_layout(*LAYOUT)
    out = {}
    for name in FAMILIES:
        cfg = _cfg("repro_torch", FAMILIES[name])
        gen = torch.Generator().manual_seed(3)
        params = PP.tree_map(lambda _, x: x + 0.02 * torch.randn(
            x.shape, generator=gen), T.init_lm(cfg, 0, device="cpu"))
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 2)
                                   .key_for(0), layout, 2, device="cpu")
        batch["tokens"] = batch["tokens"] % cfg.vocab_size
        kw = {}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(2, 12, cfg.d_model, generator=gen)
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(2, cfg.n_frontend_tokens, 1024,
                                           generator=gen)
            kw["patches"] = batch["patches"]
        worst = 0.0
        runs = []
        for d in (dist, None):
            tp, fp = PP.partition(PP.tree_map(lambda _, x: x.clone(), params),
                                  TR.trainable_mask_for(cfg, params))
            opt = PA.init_adamw(tp)
            step = TR.make_train_step(cfg, layout, PA.AdamWConfig(**OPT), d)
            if d is not None:
                step = TR.jit_train_step(step, cfg, d, None, None, batch,
                                         None)
                tp, fp, opt = step.place(tp, fp, opt)
            tp, opt, m, _ = step(tp, fp, opt, batch)
            if d is not None:
                tp = step.gather(tp)
            toks = batch["tokens"][:, :cfg.n_frontend_tokens + 8]
            st = I.init_online_state(cfg, 2, 64, device="cpu")
            if cfg.family == "encdec":
                st = st._replace(cross=I.encode_cross(params, cfg,
                                                      batch["frames"]))
            if d is None:
                lg, _ = I.prefill(params, cfg, st, toks, **kw)
            else:
                pre = SRV.make_prefill_step(cfg, d)
                pl, pst = pre.place(params, st)
                lg, _ = pre(pl, pst, toks, **kw)
                lg = pre.gather_logits(lg)
            runs.append((float(m["loss"]), dict(PP.leaves(tp)), lg))
        (la, ta, ga), (lb, tb, gb) = runs
        for k, w in tb.items():
            worst = max(worst, float((ta[k] - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
        worst = max(worst, float((ga - gb).abs().max())
                    / float(gb.abs().max()))
        out[name] = dict(loss=(la, lb), worst=worst)
    return out


def _collectives(dists):
    """``reduce_scatter`` over a gloo pair (the (1, 2) mesh's model
    axis): rank r of the pair gets block r of the pair's sum."""
    import torch.distributed as tdist

    from repro_torch.distributed import tensor_parallel as TPX
    coll = TPX.collectives(dists[(1, 2)])
    r = tdist.get_rank()
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * (r + 1)
    got = coll.reduce_scatter(x, 2)
    pair = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * (
        (r // 2) * 4 + 3)
    want = pair[..., (r % 2) * 2:(r % 2) * 2 + 2]
    return bool(torch.equal(got, want)) and tuple(got.shape) == (2, 3, 2)


def _world(dev, params_all, batches, t, ckpt_dir):
    import torch.distributed as tdist
    dists = _meshes(dev)
    out = {}
    out["train"], stored = _train(dists, params_all, batches)
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, stored)
    out["stored"] = every
    out["loop"] = _loop(dev, dists, ckpt_dir)
    out.update(_serve(dists, params_all, t))
    out["families"] = _families(dists)
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, _collectives(dists))
    out["reduce_scatter"] = every
    return out


def close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    params, batches, t = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, batches, t)))
    ref, ref_out = _reference(inp, tmp)
    try:
        got = launch_world(4, _world, params, batches, t,
                           str(tmp / "ckpt"), device="cpu", timeout=600)
        _, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    return got, pickle.loads(ref_out.read_bytes())


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_train_step_matches_reference(results, case):
    got, want = results
    g, w = got["train"][case], want[case]
    close(g["loss"], w["loss"], f"{case} loss")
    assert sorted(g["tp"]) == sorted(w["tp"]) and w["tp"]
    for part in ("tp", "mu", "nu"):
        for k, v in w[part].items():
            close(g[part][k], v, f"{case} {part} {k}")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][1] in OVER])
def test_fsdp_ep_drops_over_the_data_block(results, case):
    """The ``ep`` cases drop (the skewed router overflows the first
    owner), counted once for the data block's B S / n_data rows by
    model rank 0, in each layer's forward and its recompute."""
    got, _ = results
    d = got["train"][case]["drops"]
    shape = CASES[case][0]
    cfg = _cfg("repro_torch", CASES[case][1])
    rows = B // shape[0] * PM.segment_layout(*LAYOUT).seq_len
    runs = cfg.n_layers * (2 if cfg.remat else 1)
    assert d["assignments"] == runs * rows * cfg.top_k, d
    assert d["dropped"] > 0, d


def test_fsdp_ep_serve_builders_match_tp_ep(results):
    """Under ``fsdp`` with ``ep`` the three builders and the stream step
    (a gathered layer cut along E) give what ``tp`` with ``ep`` gives."""
    got, _ = results
    f, t = got["serve-ep"]["fsdp"], got["serve-ep"]["tp"]
    assert sorted(f) == sorted(t) and len(t) == 5 + 6
    for k, v in t.items():
        close(f[k], v, f"serve-ep {k}")


def test_fsdp_ranks_store_their_param_spec_blocks(results):
    """Every rank of every case stores exactly ``shard_by_spec`` of each
    leaf, frozen and trainable, and of each first moment."""
    got, _ = results
    assert got["stored"] == [[], [], [], []]


def test_fsdp_train_loop_resumes_across_strategies(results):
    got, _ = results
    loop = got["loop"]
    assert loop["same"]
    assert len(loop["got"]) == len(loop["want"]) == 4
    close(loop["got"], loop["want"], "loss history")


def test_fsdp_serve_builders_match_reference(results):
    got, want = results
    g, w = got["serve"], want["serve"]
    for k in ("prefill", "decode", "k", "v", "mem_k", "mem_v"):
        close(g[k], w[k], f"serve {k}")
    assert (g["length"], g["slots"]) == (w["length"], w["slots"])


def test_fsdp_stream_step_matches_reference(results):
    got, want = results
    g, w = got["stream"], want["stream"]
    assert len(g["logits"]) == len(w["logits"]) == 6
    for i, (a, b) in enumerate(zip(g["logits"], w["logits"])):
        close(a, b, f"stream chunk {i}")
    close(g["win_k"], w["win_k"], "stream win_k")
    close(g["mem_k"], w["mem_k"], "stream mem_k")
    assert (g["slots"], g["pos"]) == (w["slots"], w["pos"]) and w["slots"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fsdp_families_match_one_device(results, family):
    got, _ = results
    r = got["families"][family]
    close(r["loss"][0], r["loss"][1], f"{family} loss")
    assert r["worst"] <= REL, (family, r["worst"])


def test_reduce_scatter_over_a_gloo_pair(results):
    got, _ = results
    assert got["reduce_scatter"] == [True] * 4


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_fsdp_rows_must_split_over_every_axis():
    """The batch's rows split over data and model (rank-major); 6 rows on
    a (2, 2) mesh raise, as ``local_rows`` does."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as TR
    from repro_torch.optim.adamw import AdamWConfig
    cfg = _cfg("repro_torch", "smollm")
    dist = MESH.make_dist(MESH.make_shape_mesh((2, 2), ("data", "model")))
    assert TR.row_axes(cfg, dist) == ("data", "model")
    assert TR.row_axes(cfg.replace(sharding_strategy="tp"), dist) == \
        ("data",)
    step = TR.make_train_step(cfg, PM.segment_layout(*LAYOUT), AdamWConfig(),
                              dist)
    batch = {"tokens": torch.zeros((6, 48), dtype=torch.int32)}
    with pytest.raises(ValueError, match="6 rows"):
        TR.jit_train_step(step, cfg, dist, None, None, batch, None)
    with pytest.raises(ValueError, match="6 rows"):
        TR.local_rows(batch, dist, TR.row_axes(cfg, dist))
    rows = TR.local_rows({"t": torch.arange(8)}, dist, ("data", "model"))
    assert rows["t"].tolist() == [0, 1]          # rank (0, 0)'s block


def test_gather_dims_follow_param_spec():
    """The stored dim is ``param_spec``'s: the LAST of equal largest dims
    (a square (L, d, d) ``wq`` on dim 2), a leaf with no dim >= 128 that
    divides whole, LoRA ``b`` on its last dim, LoRA ``a`` and norms
    whole, an expert leaf on the largest of E, d and f."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.models.config import ModelConfig
    sq = ModelConfig(name="sq", n_layers=2, d_model=256, n_heads=4,
                     n_kv_heads=4, d_ff=512, vocab_size=100,
                     sharding_strategy="fsdp")
    assert FS.gather_dim(("layers", "attn", "wq"), sq, 2) == -1
    assert FS.gather_dim(("layers", "mlp", "wo"), sq, 2) == -2
    assert FS.gather_dim(("embed",), sq, 2) == -1          # 100 rows odd
    assert FS.gather_dim(("layers", "attn", "lora", "q", "b"), sq, 2) == -1
    assert FS.gather_dim(("layers", "attn", "lora", "q", "a"), sq, 2) is None
    assert FS.gather_dim(("layers", "ln1", "scale"), sq, 2) is None
    small = sq.replace(d_model=64, d_ff=96, vocab_size=120, n_heads=2,
                       n_kv_heads=2)
    assert FS.gather_dim(("layers", "mlp", "wi"), small, 2) is None
    moe = _cfg("repro_torch", "phi35").replace(d_ff=192, n_experts=8)
    assert FS.gather_dim(("layers", "moe", "wi"), moe, 2) == -1
    assert FS.gather_dim(("layers", "moe", "router"), moe, 2) is None


def test_reduce_scatter_on_the_shape_mesh_and_local_group():
    """The shape mesh counts a reduce-scatter's result bytes under the
    reference's name; a LocalGroup's ranks in turn get their blocks of
    the sum."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.launch import mesh as MESH
    mesh = MESH.make_shape_mesh((2, 4), ("data", "model"))
    coll = TPX.collectives(MESH.make_dist(mesh))
    y = coll.reduce_scatter(torch.empty((3, 8, 5), device="meta"), 1)
    assert tuple(y.shape) == (3, 2, 5)
    assert mesh.counts == {"reduce-scatter": 3 * 2 * 5 * 4}
    grp = TPX.LocalGroup(2)
    xs = [torch.arange(8.).reshape(2, 4) * (r + 1) for r in range(2)]
    got = grp.run(lambda r: grp.member(r).reduce_scatter(xs[r], -1))
    s = xs[0] + xs[1]
    assert torch.equal(got[0], s[:, :2]) and torch.equal(got[1], s[:, 2:])


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_ep_keep_mask_is_ep_slots_over_the_data_block(n):
    """ZeRO-3 training ranks of a ``LocalGroup`` (each its share of a
    data block's rows, the whole experts): the ids gathered over the
    model axis give each rank its slice of ``ep_slots``' keep mask over
    the whole block, so the ranks' rows are ``moe_ep_unsharded``'s at
    ``blocks=1`` and their router and expert gradients sum to its; the
    drops (many: the router is skewed) are the block's, counted once."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import moe as MOE
    cfg = _cfg("repro_torch", "phi35-ep").replace(n_experts=8)
    gen = torch.Generator().manual_seed(11)
    p = MOE.init_moe(gen, cfg, cfg.d_model, cfg.d_ff, "cpu")
    x = torch.randn(8, 6, cfg.d_model, generator=gen)
    p["router"][:, :2] += 3 * (x.mean((0, 1)) / x.mean((0, 1)).norm()
                               )[:, None] * p["router"].std()
    w = torch.randn(x.shape, generator=gen)
    rows = x.shape[0] // n

    def grads(fn, lo, hi):
        """fn's rows lo:hi of x and the gradients of their weighted sum."""
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        y = fn(leaves, x[lo:hi])
        g = torch.autograd.grad((y * w[lo:hi]).sum(), list(leaves.values()))
        return y.detach(), dict(zip(leaves, g))
    want_y, want_g = grads(lambda q, xs: MOE.moe_ep_unsharded(cfg, q, xs, n),
                           0, x.shape[0])
    _, topi = MOE._route(cfg, p["router"], x.reshape(-1, cfg.d_model))
    keep = MOE.ep_slots(topi, cfg.n_experts // n, n)[2]
    grp = TPX.LocalGroup(n)
    MOE.EP_DROPS.update(assignments=0, dropped=0)
    outs = grp.run(lambda r: grads(lambda q, xs: MOE.apply_moe(
        cfg, q, xs, dist=FS.Fsdp(cfg, n, r, grp.member(r))),
        r * rows, (r + 1) * rows))
    assert MOE.EP_DROPS == {"assignments": keep.numel(),
                            "dropped": int((~keep).sum())}
    assert int((~keep).sum()) > 0
    torch.testing.assert_close(torch.cat([y for y, _ in outs]), want_y,
                               rtol=0, atol=1e-5)
    for k, g in want_g.items():
        torch.testing.assert_close(sum(o[1][k] for o in outs), g, rtol=1e-5,
                                   atol=1e-5)
