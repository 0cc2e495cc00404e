"""Tensor parallelism in the port against the reference: one AdamW step
of ``make_train_step(dist=)`` with the model split over the ``model``
axis, in ``gloo`` worlds of 2 and 4 ranks
(``distributed.elastic.launch_world``) on meshes (1, 2), (2, 2) and
(1, 4), against the reference's ``jit_train_step`` on
``make_debug_mesh(n_data, n_model)`` (a subprocess with 4 forced host
devices) from the same weights and batch: the loss, every updated
trainable leaf and both AdamW moments, gathered to whole leaves.  Cases:
concat and merge on the tests' 8/4-head model (the "kv" regime, LoRA);
codec "int8" at (2, 2); ``gemma_2b.smoke`` (2/1 heads: the "query"
regime) and ``smollm_360m.smoke`` (3/1: the "replicated" regime) at
(1, 2), both training every leaf.  Also, in the same world of 4,
``TrainLoop(dist=)`` on a (2, 2) mesh against the single-device loop,
its checkpoint's whole leaves, and ``remesh_restore`` of that
checkpoint onto (1, 4).

In one process (no world): the local layout's departures from
``param_pspecs`` (exactly the documented ones), the rank loop of a
``LocalGroup`` against the unsharded model in every regime (the training
forward and every gradient, and the online path with an int8 cache or
merge memory; the "query" regime with two KV heads included), the
vocab-parallel greedy pick's ties, and the log-sum-exp of the segmented
attention's plain version against float64.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_distributed.py``: the ranks' partial sums add the
reference's terms in another order.
"""
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
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
MODEL = dict(name="d", family="dense", n_layers=2, d_model=64, n_heads=8,
             n_kv_heads=4, d_ff=128, vocab_size=128, train_mode="lora",
             compute_dtype="float32")
LAYOUT = (4, 8, 2, 8)                # t_steps, chunk, comp_len, tail
B = 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)

# case -> (mesh, model, mode, codec); model "d" is MODEL, else a smoke
# config of the registry
CASES = {
    "d-concat-1x2": ((1, 2), "d", "concat", "none"),
    "d-merge-1x2": ((1, 2), "d", "merge", "none"),
    "gemma-1x2": ((1, 2), "gemma_2b", "concat", "none"),
    "smollm-1x2": ((1, 2), "smollm_360m", "concat", "none"),
    "d-concat-2x2": ((2, 2), "d", "concat", "none"),
    "d-merge-2x2": ((2, 2), "d", "merge", "none"),
    "d-int8-2x2": ((2, 2), "d", "concat", "int8"),
    "d-concat-1x4": ((1, 4), "d", "concat", "none"),
    "d-merge-1x4": ((1, 4), "d", "merge", "none"),
}


def _port_cfg(model: str, mode: str) -> PCfg:
    if model == "d":
        return PCfg(**MODEL, ccm=PCCM(comp_len=2, max_steps=4, mode=mode))
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{model}")
    cfg = mod.smoke(compute_dtype="float32")
    return cfg.replace(ccm=PCCM(comp_len=2, max_steps=4, mode=mode))


def _inputs():
    """Per model, the reference's init perturbed so that every LoRA
    factor has a gradient; one batch whose row 0 loses loss positions
    (the ranks then hold different mask counts); as numpy."""
    import jax

    from repro.core import masks as JM
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    params = {}
    for model in sorted({c[1] for c in CASES.values()}):
        cfg = _ref_cfg(model, "concat")
        p = JT.init_lm(jax.random.PRNGKey(0), cfg)
        leaves, tdef = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
        p = tdef.unflatten([x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
                            for x, k in zip(leaves, keys)])
        params[model] = jax.tree.map(np.asarray, p)
    batches = {}
    for model in params:
        vocab = _ref_cfg(model, "concat").vocab_size
        b = jsample(jax.random.PRNGKey(1), JM.segment_layout(*LAYOUT), B)
        b = {k: np.array(v) for k, v in b.items()}
        b["tokens"] = b["tokens"] % vocab
        b["loss_mask"][0, :3] = 0
        batches[model] = b
    return params, batches


def _ref_cfg(model: str, mode: str):
    from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
    if model == "d":
        return JCfg(**MODEL, ccm=JCCM(comp_len=2, max_steps=4, mode=mode))
    import importlib
    mod = importlib.import_module(f"repro.configs.{model}")
    return mod.smoke(compute_dtype="float32").replace(
        ccm=JCCM(comp_len=2, max_steps=4, mode=mode))


_REF = """
import importlib, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import masks as M
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.launch.train import (jit_train_step, make_train_step,
                                trainable_mask_for)
from repro.models.config import CCMConfig, ModelConfig
from repro.optim import partition as PT
from repro.optim.adamw import AdamWConfig, init_adamw
from repro.optim.grad_compress import EFState
assert jax.device_count() == 4
params_all, batches = pickle.load(open(sys.argv[1], "rb"))
layout = M.segment_layout(*{layout})
flat = lambda t: {{"/".join(str(k.key) for k in p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}}

def cfg_of(model, mode):
    if model == "d":
        return ModelConfig(**{model_kw}, ccm=CCMConfig(comp_len=2,
                                                       max_steps=4,
                                                       mode=mode))
    mod = importlib.import_module("repro.configs." + model)
    return mod.smoke(compute_dtype="float32").replace(
        ccm=CCMConfig(comp_len=2, max_steps=4, mode=mode))

out = {{}}
for key, (shape, model, mode, codec) in {cases}.items():
    dist = make_dist(make_debug_mesh(*shape))
    cfg = cfg_of(model, mode)
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
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path):
    src = textwrap.dedent(_REF.format(layout=LAYOUT, model_kw=MODEL,
                                      cases=CASES, opt=OPT))
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", src, str(inp), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _steps(dev, params_all, batches, keys, ckpt_dir=None):
    """On every rank: one step of each case in ``keys``; returns, on rank
    0, the loss and the whole trainable leaves and moments, and with
    ``ckpt_dir`` the loop's results (`_loop`) under "loop"."""
    import torch.distributed as tdist

    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import grad_compress as PG
    from repro_torch.optim import partition as PP
    from repro_torch.params import params_from_numpy

    def flat(t):
        return {"/".join(p): x.detach().numpy().copy()
                for p, x in PP.leaves(t)}

    meshes, out = {}, {}
    for key in keys:
        shape, model, mode, codec = CASES[key]
        if shape not in meshes:
            meshes[shape] = make_dist(make_debug_mesh(*shape, device=dev))
        dist = meshes[shape]
        cfg = _port_cfg(model, mode)
        params = params_from_numpy(params_all[model], cfg, device=dev)
        tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
        opt = PA.init_adamw(tp)
        batch = {k: torch.from_numpy(v.copy())
                 for k, v in batches[model].items()}
        step = TR.make_train_step(cfg, PM.segment_layout(*LAYOUT),
                                  PA.AdamWConfig(**OPT), dist,
                                  grad_codec=codec)
        jstep = TR.jit_train_step(step, cfg, dist, None, None, batch, None)
        tp, fp, opt = jstep.place(tp, fp, opt)
        ef = None if codec == "none" else PG.init_ef(tp)
        tp, opt, m, _ = jstep(tp, fp, opt, batch, ef)
        whole = dict(loss=float(m["loss"]), tp=flat(jstep.gather(tp)),
                     mu=flat(jstep.gather(opt.mu)),
                     nu=flat(jstep.gather(opt.nu)))
        every = [None] * tdist.get_world_size()
        tdist.all_gather_object(every, whole["loss"])
        assert all(v == every[0] for v in every), (key, every)
        out[key] = whole
    if ckpt_dir is not None:
        out["loop"] = _loop(dev, ckpt_dir)
    return out


def close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    params, batches = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, batches)))
    ref, ref_out = _reference(inp, tmp)
    try:
        got = {}
        for world in (2, 4):
            keys = [k for k, c in CASES.items()
                    if c[0][0] * c[0][1] == world]
            got.update(launch_world(
                world, _steps, params, batches, keys,
                str(tmp / "ckpt") if world == 4 else None, device="cpu",
                timeout=600))
        _, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    return got, pickle.loads(ref_out.read_bytes())


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_matches_reference(train_results, case):
    got, want = train_results
    g, w = got[case], want[case]
    close(g["loss"], w["loss"], f"{case} loss")
    assert sorted(g["tp"]) == sorted(w["tp"]) and w["tp"]
    for part in ("tp", "mu", "nu"):
        for k, v in w[part].items():
            close(g[part][k], v, f"{case} {part} {k}")


# ---------------------------------------------------------------------------
# TrainLoop(dist=) with a model axis, its checkpoint, remesh_restore
# ---------------------------------------------------------------------------

LOOP_MODEL = dict(MODEL, train_mode="full")


def _loop(dev, ckpt_dir):
    """On every rank: 2 steps of a TrainLoop on mesh (2, 2) with a
    checkpoint at step 2, then that checkpoint restored onto (1, 4), by
    ``remesh_restore`` and by a TrainLoop there.  Returns, on rank 0, the
    losses, the loop's whole leaves, the checkpoint's leaves and whether
    every rank's restored shards are the checkpoint's blocks."""
    import torch.distributed as tdist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.elastic import remesh_restore
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP

    cfg = PCfg(**LOOP_MODEL, ccm=PCCM(comp_len=2, max_steps=4))
    dist = make_dist(make_debug_mesh(2, 2, device=dev))
    loop = TR.TrainLoop(cfg, PM.segment_layout(*LAYOUT),
                        PA.AdamWConfig(**OPT), batch_size=B,
                        ckpt_dir=ckpt_dir, ckpt_every=2, dist=dist,
                        device=dev)
    hist = loop.run(2, log_every=0)
    whole = TPX.gather_params(loop.tp, cfg, loop.tpx)
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    state, extra, dist4 = remesh_restore(
        ckpt, 2, cfg, make_debug_mesh(1, 4, device=dev),
        {"tp": loop.tp, "opt": loop.opt}, None)
    full = {"tp": TPX.gather_params(loop.tp, cfg, loop.tpx),
            "opt": loop.opt._replace(mu=TPX.gather_params(loop.opt.mu, cfg,
                                                        loop.tpx),
                                     nu=TPX.gather_params(loop.opt.nu, cfg,
                                                        loop.tpx))}
    on_disk, _ = ckpt.restore(2, full)
    mine = TPX.shard_params(on_disk["tp"], cfg, dist4)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(PP.leaves(state["tp"]), PP.leaves(mine)))
    same &= all(torch.equal(a, b) for (_, a), (_, b) in
                zip(PP.leaves(state["opt"].mu),
                    PP.leaves(TPX.shard_params(on_disk["opt"].mu, cfg,
                                             dist4))))
    # a TrainLoop on (1, 4) resumes from the same checkpoint: its shards
    loop4 = TR.TrainLoop(cfg, PM.segment_layout(*LAYOUT),
                         PA.AdamWConfig(**OPT), batch_size=B,
                         ckpt_dir=ckpt_dir, ckpt_every=2, dist=dist4,
                         device=dev)
    same &= loop4.maybe_restore() == 2
    same &= all(torch.equal(a, b) for (_, a), (_, b) in
                zip(PP.leaves(loop4.tp), PP.leaves(mine)))
    split = [p for p, x in PP.leaves(state["tp"])
             if TPX.split_dim(p, cfg, 4) is not None]
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, same)

    def flat(t):
        return {"/".join(p): x.detach().numpy().copy()
                for p, x in PP.leaves(t)}
    return ([h["loss"] for h in hist], flat(whole), flat(on_disk["tp"]),
            all(every), extra["step"], len(split))


def test_tp_train_loop_checkpoint_and_remesh(train_results):
    """TrainLoop on (2, 2) gives the single-device loop's losses and
    leaves; its checkpoint holds whole leaves; remesh_restore and a
    TrainLoop's maybe_restore put each rank of a (1, 4) mesh on its shard
    of them (run in the world of 4 of ``train_results``)."""
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as PT_
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP

    losses, whole, on_disk, same, step, n_split = train_results[0]["loop"]
    cfg = PCfg(**LOOP_MODEL, ccm=PCCM(comp_len=2, max_steps=4))
    one = TR.TrainLoop(cfg, PM.segment_layout(*LAYOUT),
                       PA.AdamWConfig(**OPT), batch_size=B, device="cpu")
    want = [h["loss"] for h in one.run(2, log_every=0)]
    close(losses, want, "TrainLoop losses")
    shapes = {"/".join(p): tuple(x.shape) for p, x in
              PP.leaves(PT_.init_lm(cfg, device="meta"))}
    for p, x in PP.leaves(one.tp):
        k = "/".join(p)
        assert on_disk[k].shape == shapes[k], k       # whole on disk
        close(whole[k], x.detach().numpy(), f"TrainLoop {k}")
        np.testing.assert_array_equal(on_disk[k], whole[k])
    assert same and step == 2 and n_split > 0


# ---------------------------------------------------------------------------
# in one process: the layout, the rank loop, the greedy pick, the lse
# ---------------------------------------------------------------------------

# (model, n) -> the leaves whose local layout departs from param_pspecs
_DEPARTURES = {
    ("d", 2): {"lora/o/a", "lora/o/b"},
    ("gemma_2b", 2): {"lora/o/a", "lora/o/b", "attn/wk", "attn/wv",
                      "lora/k/b", "lora/v/b"},
    ("smollm_360m", 2): {"attn/wq", "attn/wk", "attn/wv", "attn/wo",
                         "lora/q/b", "lora/k/b", "lora/v/b", "lora/o/b"},
    ("qwen2_05b", 2): {"lora/o/a", "lora/o/b"},
    ("qwen2_05b", 4): {"attn/wq", "attn/bq", "attn/wk", "attn/bk",
                       "attn/wv", "attn/bv", "attn/wo", "lora/q/b",
                       "lora/k/b", "lora/v/b", "lora/o/b"},
    # the MoE family (smoke: 8/2 heads): the attention's departures alone,
    # the experts split as the spec splits them (":ep" for moe_impl="ep")
    ("phi35_moe", 2): {"lora/o/a", "lora/o/b"},
    ("phi35_moe", 4): {"lora/o/a", "lora/o/b", "attn/wk", "attn/wv",
                       "lora/k/b", "lora/v/b"},
    ("phi35_moe:ep", 4): {"lora/o/a", "lora/o/b", "attn/wk", "attn/wv",
                          "lora/k/b", "lora/v/b"},
    ("llama4_maverick:ep", 8): {"lora/o/a", "lora/o/b", "attn/wk",
                                "attn/wv", "lora/k/b", "lora/v/b"},
}


@pytest.mark.parametrize("model,n", sorted(_DEPARTURES))
def test_local_layout_departs_from_pspecs_where_documented(model, n):
    """The local layout (``split_dim``) against ``param_pspecs``: the
    same split everywhere but at the leaves the module documents.  The
    Qwen2 cases take its published widths (14/2 heads, 896 wide), on the
    meta device; the MoE cases' experts (every leaf under ``moe``) split
    as the spec splits them."""
    import importlib

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import DistContext
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": n}

    if model == "d":
        cfg = PCfg(**MODEL, ccm=PCCM(comp_len=2, max_steps=4))
    elif model == "qwen2_05b":
        cfg = importlib.import_module(
            "repro_torch.configs.qwen2_05b").config().replace(n_layers=2)
    else:
        name, _, impl = model.partition(":")
        cfg = _port_cfg(name, "concat")
        if impl:
            cfg = cfg.replace(moe_impl=impl)
    params = T.init_lm(cfg, device="meta")
    specs = SH.param_pspecs(cfg, params, DistContext(mesh=Mesh()))
    departs = set()
    for path, x in PP.leaves(params):
        spec = PP.tree_map(lambda _, s: s, specs)
        for k in path:
            spec = spec[k]
        want = [i - x.ndim for i, d in enumerate(spec) if d is not None]
        got = TPX.split_dim(path, cfg, n)
        if want != ([] if got is None else [got]):
            departs.add("/".join(path[-3:] if "lora" in path else path[-2:]))
    assert departs == _DEPARTURES[(model, n)]


_REGIMES = {
    # name -> (config overrides, n)
    "kv-2": (dict(), 2),
    "kv-4": (dict(), 4),
    "query-hkv2-4": (dict(n_kv_heads=2), 4),
    "query-gemma-2": (dict(n_heads=2, n_kv_heads=1, head_dim=32,
                           activation="geglu", tie_embeddings=True,
                           embed_scale=True), 2),
    "replicated-2": (dict(n_heads=3, n_kv_heads=1, d_model=60,
                          tie_embeddings=True, vocab_size=256), 2),
    "bias-replicated-2": (dict(n_heads=7, n_kv_heads=1, d_model=56,
                               qkv_bias=True), 2),
}


@pytest.mark.parametrize("mode", ["concat", "merge"])
@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_local_group_ranks_match_unsharded(regime, mode):
    """The n ranks of a ``LocalGroup`` (turns of one process) on their
    shards give the unsharded model's logits, loss and every gradient
    (gathered), full training."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP
    from repro_torch.optim.losses import next_token_loss

    kw, n = _REGIMES[regime]
    cfg = PCfg(**dict(MODEL, train_mode="full", **kw),
               ccm=PCCM(comp_len=2, max_steps=4, mode=mode))
    gen = torch.Generator().manual_seed(3)
    params = PP.tree_map(
        lambda _, x: x + 0.02 * torch.randn(x.shape, generator=gen),
        T.init_lm(cfg, 0, device="cpu"))
    layout = PM.segment_layout(*LAYOUT)
    tok = torch.randint(0, cfg.vocab_size, (2, layout.seq_len), generator=gen)
    mask = torch.ones(2, layout.tail_len - 1)

    def run(p, tp):
        leaves = [x.detach().clone().requires_grad_(True)
                  for _, x in PP.leaves(p)]
        it = iter(leaves)
        p = PP.tree_map(lambda _, x: next(it), p)
        lg = T.train_forward(p, cfg, tok, layout, dist=tp)
        loss = next_token_loss(lg, tok[:, -layout.tail_len:], mask, tp=tp)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return lg.detach(), loss.detach(), PP.tree_map(lambda _, x: next(it),
                                                       p)

    lg, loss, grads = run(params, None)
    group = TPX.LocalGroup(n)
    ranks = TPX.local_ranks(cfg, group)

    def one(r):
        tp = ranks[r]
        lg_r, loss_r, g_r = run(TPX.shard_params(params, cfg, tp), tp)
        whole = lg_r if not tp.vocab_split else TPX.gather_from_tp(lg_r, tp)
        return whole, loss_r, TPX.gather_params(g_r, cfg, tp)

    outs = group.run(one)
    for whole, loss_r, g_r in outs:
        close(whole, lg, f"{regime} logits")
        close(loss_r, loss, f"{regime} loss")
        for (path, g), (_, w) in zip(PP.leaves(g_r), PP.leaves(grads)):
            close(g, w, f"{regime} grad {'/'.join(path)}")


def test_greedy_pick_across_vocab_blocks_breaks_ties_low():
    """Ties across ranks' blocks go to the lower id, as jnp.argmax."""
    from repro_torch.core import inference as I
    from repro_torch.distributed import tensor_parallel as TPX

    cfg = PCfg(**MODEL)
    full = torch.zeros(3, cfg.vocab_size)
    full[0, [5, 70, 127]] = 2.0            # tie across ranks 0, 2, 3
    full[1, [40, 33]] = 1.0                # tie inside rank 1's block
    full[2, 100] = -1.0                    # every other id ties at 0
    group = TPX.LocalGroup(4)
    ranks = TPX.local_ranks(cfg, group)
    picks = group.run(lambda r: I.greedy(
        full[:, r * 32:(r + 1) * 32], cfg, ranks[r]))
    for p in picks:
        assert p.tolist() == torch.argmax(full, -1).tolist() == [5, 33, 0]


def test_segmented_lse_of_plain_version_matches_float64():
    """The plain segmented attention's log-sum-exp (mem | cache(:len) |
    self segments, int8 cache, per-lane lengths, a lane that sees no
    key) against float64 logsumexp of the same logits."""
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(0)
    B, Sq, Hq, Hkv, D = 3, 2, 4, 2, 16
    q = torch.randn(B, Sq, Hq, D, generator=gen)
    mk, mv = (torch.randn(B, 4, Hkv, D, generator=gen) for _ in range(2))
    ck = torch.randint(-100, 100, (B, 8, Hkv, D), generator=gen,
                       dtype=torch.int8)
    cv = torch.randint(-100, 100, (B, 8, Hkv, D), generator=gen,
                       dtype=torch.int8)
    cks, cvs = (torch.rand(B, 8, Hkv, generator=gen) * 0.02
                for _ in range(2))
    sk, sv = (torch.randn(B, Sq, Hkv, D, generator=gen) for _ in range(2))
    qi = torch.tensor([2 ** 30, 2 ** 30 + 1], dtype=torch.int32)
    one = torch.ones(Sq, dtype=torch.int32)
    segs = [dict(k=mk, v=mv, length=torch.tensor([4, 2, 0])),
            dict(k=ck, v=cv, k_scale=cks, v_scale=cvs,
                 length=torch.tensor([8, 5, 0])),
            dict(k=sk, v=sv, idx=qi, seg=one, comp=torch.zeros(Sq),
                 valid=torch.tensor([[1, 1], [1, 1], [0, 0]]))]
    scale = D ** -0.5
    out, lse = ref.segmented_attention_ref(q, segs, qi, one, scale, lse=True)
    assert torch.equal(out, ref.segmented_attention_ref(q, segs, qi, one,
                                                        scale))
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    k = torch.cat([mk.double(), (ck.double() * cks.double()[..., None]),
                   sk.double()], 1)
    lens = [(4, 8, (1, 2)), (2, 5, (1, 2)), (0, 0, (0, 0))]
    for b, (lm, lc, (s0, s1)) in enumerate(lens):
        for h in range(Hq):
            kh = k[b, :, h // (Hq // Hkv)]
            for t in range(Sq):
                vis = list(range(lm)) + [4 + j for j in range(lc)]
                vis += [12 + j for j in range(Sq) if j <= t
                        and (s0 if j == 0 else s1)]
                if not vis:
                    assert lse[b, h, t] == -torch.inf
                    continue
                lg = (kh[vis] @ q[b, t, h].double()) * scale
                want = torch.logsumexp(lg, 0).item()
                assert abs(lse[b, h, t].item() - want) <= 1e-5 * max(
                    abs(want), 1.0), (b, h, t)


def _rank_state(st, tp):
    """A rank's copy of an online state: its block of the KV heads (dim 3
    of every cache, scale and memory leaf) in the "kv" regime, else the
    whole state (each rank writes its own copy in place)."""
    from repro_torch.distributed import tensor_parallel as TPX

    def cut(x, _):
        if tp.attn != "kv":
            return x.clone()
        h = x.shape[3] // tp.n
        return x.narrow(3, tp.rank * h, h).clone()
    return TPX.map_by_spec(cut, st, None)


@pytest.mark.parametrize("cache", ["int8", "merge"])
@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_local_group_online_matches_unsharded(regime, cache):
    """The online path on the ranks of a ``LocalGroup``: two ingests, a
    prefill, a decode step and ``generate`` on each rank's shard of the
    params and the state give the unsharded model's logits (gathered over
    the vocabulary blocks) and tokens; an int8 cache (its scales narrowed
    to the rank's KV head in the "query" regime) or merge memory."""
    from repro_torch.core import inference as PI
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP

    kw, n = _REGIMES[regime]
    mode = "merge" if cache == "merge" else "concat"
    cfg = PCfg(**dict(MODEL, **kw),
               kv_cache_dtype="int8" if cache == "int8" else "bfloat16",
               ccm=PCCM(comp_len=2, max_steps=4, mode=mode))
    gen = torch.Generator().manual_seed(5)
    params = PP.tree_map(
        lambda _, x: x + 0.02 * torch.randn(x.shape, generator=gen),
        T.init_lm(cfg, 0, device="cpu"))
    toks = [torch.randint(0, cfg.vocab_size, (2, w), generator=gen)
            for w in (6, 5, 4, 3)]
    st0 = PI.init_online_state(cfg, 2, 24, device="cpu")

    def run(p, st, tp):
        for c in toks[:2]:
            st = PI.ingest_context(p, cfg, st, c, dist=tp)
        lp, st = PI.prefill(p, cfg, st, toks[2], full_logits=True, dist=tp)
        ld, st = PI.decode_step(p, cfg, st, toks[2][:, :1], dist=tp)
        g = PI.generate(p, cfg, st, toks[3], 3, dist=tp)
        return (PI.gather_vocab(lp, cfg, tp), PI.gather_vocab(ld, cfg, tp),
                g)

    want = run(params, TPX.map_by_spec(lambda x, _: x.clone(), st0, None),
               None)
    group = TPX.LocalGroup(n)
    ranks = TPX.local_ranks(cfg, group)
    outs = group.run(lambda r: run(TPX.shard_params(params, cfg, ranks[r]),
                                   _rank_state(st0, ranks[r]), ranks[r]))
    for lp, ld, g in outs:
        close(lp, want[0], f"{regime} {cache} prefill logits")
        close(ld, want[1], f"{regime} {cache} decode logits")
        assert torch.equal(g, want[2]), (regime, cache)
