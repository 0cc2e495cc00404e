"""The recurrent, encoder-decoder and VLM families split over the
``model`` axis, in the port against the reference: ``mamba2_370m``,
``zamba2_12b``, ``whisper_tiny`` and ``pixtral_12b`` at their smoke
sizes, float32 params, one AdamW step of ``jit_train_step`` on meshes
(1, 2), (2, 2) and (1, 4), in ``gloo`` worlds of 2 and 4 ranks
(``distributed.elastic.launch_world``), against the reference's
``jit_train_step`` on ``make_debug_mesh`` (one subprocess for every
case, 4 forced host devices), from the same weights and batch (Whisper's
with ``frames``, Pixtral's with ``patches``): the loss, every updated
trainable leaf and both AdamW moments, gathered to whole leaves.

The regimes each family meets at its published widths: Whisper's 4/4
smoke heads in "kv" at n = 2 and 4, and a 6/6-head variant with an odd
vocabulary (as whisper-tiny's 6 heads and 51865 ids) in "replicated" at
n = 4; Pixtral's 8/2 in "kv" at n = 2 and "query" at n = 4; Zamba2's
shared site in "kv"; Mamba2 with its vocabulary split, and a variant with
an odd vocabulary (whole).  Every case runs the reference on its mesh
(GSPMD's run of each family works under jax 0.9.0 here).

In one process (no world): the local layout's departures from
``param_pspecs`` for these families (the ``xattn`` and ``pos_embed``
rules included, Whisper-tiny at its published widths too), and every
rank's shards gathering back to the whole leaves (what ``TrainLoop``'s
checkpoints and ``remesh_restore`` rely on).
``tests/test_torch_tp_families_online.py`` holds the online path.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_tensor_parallel.py``, for the loss, both moments (the
first is 0.1 x the gradient after one step) and the updated leaves; an
updated element whose gradient lies within 1e-4 x the leaf's largest of
0 may differ by up to 2 x lr besides, the allowance
``tests/test_torch_recurrent_train.py`` and ``tests/test_torch_zoo.py``
make for Adam's first step, which takes ~lr x sign(g) there (the Mamba2
layers' float32 scans round differently in the two frameworks).
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
LAYOUT = (4, 8, 2, 8)                # t_steps, chunk, comp_len, tail
B = 8
SE = 12                              # Whisper's frames a row
# eps 1e-6, as tests/test_torch_moe_tp.py: a near-zero gradient's
# float32 rounding stays small in the first step's update
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6, eps=1e-6)
# model -> (config module, overrides of its smoke config)
MODELS = {
    "mamba2": ("mamba2_370m", {}),
    "mamba2_odd": ("mamba2_370m", {"vocab_size": 255}),
    "zamba2": ("zamba2_12b", {}),
    "whisper": ("whisper_tiny", {}),
    "whisper6": ("whisper_tiny", {"n_heads": 6, "n_kv_heads": 6,
                                  "d_model": 96, "vocab_size": 255}),
    "pixtral": ("pixtral_12b", {}),
}
MESHES = ((1, 2), (2, 2), (1, 4))
CASES = {f"{m}-{a}x{b}": ((a, b), m)
         for m in ("mamba2", "zamba2", "whisper", "pixtral")
         for a, b in MESHES}
CASES["whisper6-1x4"] = ((1, 4), "whisper6")
CASES["mamba2_odd-1x2"] = ((1, 2), "mamba2_odd")


def _cfg_kw():
    return dict(compute_dtype="float32", param_dtype="float32")


def port_cfg(model):
    import importlib
    mod, over = MODELS[model]
    return importlib.import_module(f"repro_torch.configs.{mod}").smoke(
        **_cfg_kw()).replace(**over)


def _ref_cfg(model):
    import importlib
    mod, over = MODELS[model]
    return importlib.import_module(f"repro.configs.{mod}").smoke(
        **_cfg_kw()).replace(**over)


def _inputs():
    """Per model the reference's init, perturbed (every LoRA factor gets
    a gradient); a training batch whose row 0 loses loss positions, with
    frames (encdec) or patches (vlm); as numpy."""
    import jax

    from repro.core import masks as JM
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    params, batches = {}, {}
    rng = np.random.default_rng(0)
    for i, model in enumerate(MODELS):
        cfg = _ref_cfg(model)
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
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (B, SE, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, 1024)).astype(np.float32)
        batches[model] = b
    return params, batches


_REF = """
import importlib, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import masks as M
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.launch.train import (jit_train_step, make_train_step,
                                trainable_mask_for)
from repro.optim import partition as PT
from repro.optim.adamw import AdamWConfig, init_adamw
assert jax.device_count() == 4
params_all, batches = pickle.load(open(sys.argv[1], "rb"))
layout = M.segment_layout(*{layout})
flat = lambda tr: {{"/".join(str(k.key) for k in p): np.asarray(x)
                   for p, x in jax.tree_util.tree_flatten_with_path(tr)[0]}}

def cfg_of(model):
    mod, over = {models}[model]
    return importlib.import_module("repro.configs." + mod).smoke(
        compute_dtype="float32", param_dtype="float32").replace(**over)

out = {{}}
for key, (shape, model) in {cases}.items():
    dist = make_dist(make_debug_mesh(*shape))
    cfg = cfg_of(model)
    # fresh buffers: the step donates its arguments
    params = jax.tree.map(jnp.array, params_all[model])
    batch = {{k: jnp.asarray(v) for k, v in batches[model].items()}}
    trainable = trainable_mask_for(cfg, params)
    tp, fp = PT.partition(params, trainable)
    step = jit_train_step(
        make_train_step(cfg, layout, AdamWConfig(**{opt}), dist), cfg, dist,
        params, jax.eval_shape(init_adamw, tp), batch, trainable)
    tp2, opt2, m, _ = step(tp, fp, init_adamw(tp), batch, None)
    out[key] = dict(loss=float(m["loss"]), tp=flat(tp2), mu=flat(opt2.mu),
                    nu=flat(opt2.nu))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(inp, tmp_path):
    src = textwrap.dedent(_REF.format(layout=LAYOUT, models=MODELS,
                                      cases=CASES, opt=OPT))
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", src, str(inp), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _steps(dev, params_all, batches, keys):
    """On every rank: one step of each case in ``keys``; rank 0 returns
    the loss and the whole trainable leaves and moments."""
    import torch.distributed as tdist

    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP
    from repro_torch.params import params_from_numpy

    def flat(t):
        return {"/".join(p): x.detach().numpy().copy()
                for p, x in PP.leaves(t)}

    meshes, out = {}, {}
    for key in keys:
        shape, model = CASES[key]
        if shape not in meshes:
            meshes[shape] = make_dist(make_debug_mesh(*shape, device=dev))
        dist = meshes[shape]
        cfg = port_cfg(model)
        params = params_from_numpy(params_all[model], cfg, device=dev)
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
        every = [None] * tdist.get_world_size()
        tdist.all_gather_object(every, float(m["loss"]))
        assert all(v == every[0] for v in every), (key, every)
        out[key] = dict(loss=float(m["loss"]), tp=flat(step.gather(tp)),
                        mu=flat(step.gather(opt.mu)),
                        nu=flat(step.gather(opt.nu)))
    return out


def close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families_train")
    params, batches = _inputs()
    inp = tmp / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, batches)))
    ref, ref_out = _reference(inp, tmp)
    try:
        got = {}
        for world in (2, 4):
            keys = [k for k, c in CASES.items()
                    if c[0][0] * c[0][1] == world]
            got.update(launch_world(world, _steps, params, batches, keys,
                                    device="cpu", timeout=600))
        _, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    return got, pickle.loads(ref_out.read_bytes())


@pytest.mark.parametrize("case", list(CASES))
def test_tp_family_train_step_matches_reference(train_results, case):
    got, want = train_results
    g, w = got[case], want[case]
    close(g["loss"], w["loss"], f"{case} loss")
    assert sorted(g["tp"]) == sorted(w["tp"]) and w["tp"]
    for part in ("mu", "nu"):
        for k, v in w[part].items():
            close(g[part][k], v, f"{case} {part} {k}")
    for k, v in w["tp"].items():
        mu = np.abs(w["mu"][k])
        loose = (mu > 0) & (mu <= REL * mu.max())
        tol = REL * np.abs(v).max() + 2 * OPT["lr"] * loose
        err = np.abs(np.asarray(g["tp"][k], np.float64) - v)
        assert (err <= tol).all(), (case, k, float(err.max()))


def test_tp_family_regimes_are_the_ones_named():
    """Each case meets the regime the module docstring names, and the
    vocabulary and position tables split where they divide."""
    from repro_torch.distributed import tensor_parallel as TPX
    want = {("whisper", 2): "kv", ("whisper", 4): "kv",
            ("whisper6", 4): "replicated", ("pixtral", 2): "kv",
            ("pixtral", 4): "query", ("zamba2", 2): "kv",
            ("zamba2", 4): "kv"}
    for (model, n), reg in want.items():
        assert TPX.attn_regime(port_cfg(model), n) == reg, (model, n)
    for model, n, vocab in (("mamba2", 4, 64), ("mamba2_odd", 2, 255),
                            ("whisper6", 4, 255)):
        cfg = port_cfg(model)
        tp = TPX.TensorParallel(cfg, n, 0, None)
        assert tp.local.vocab_size == vocab, model
        assert tp.local.d_ff == cfg.d_ff // n if cfg.d_ff else \
            tp.local.d_ff == 0
    assert TPX.TensorParallel(port_cfg("whisper6"), 4, 0, None).pos_split
    assert not TPX.TensorParallel(port_cfg("pixtral"), 4, 0,
                                  None).pos_split     # rope: no table


# ---------------------------------------------------------------------------
# in one process: the layout's departures, shards back to whole leaves
# ---------------------------------------------------------------------------

_ATTN_REPLICATED = {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}
_LORA_REPLICATED = {"lora/q/b", "lora/k/b", "lora/v/b", "lora/o/b"}
# (model, n) -> the leaves whose local layout departs from param_pspecs;
# "whisper_full" is whisper-tiny at its published widths (meta device)
_DEPARTURES = {
    ("mamba2", 2): set(),
    ("mamba2", 4): set(),
    ("mamba2_odd", 2): set(),
    ("zamba2", 2): {"lora/o/a", "lora/o/b"},
    ("zamba2", 4): {"lora/o/a", "lora/o/b"},
    ("whisper", 2): {"lora/o/a", "lora/o/b"},
    ("whisper", 4): {"lora/o/a", "lora/o/b"},
    ("whisper6", 4): _ATTN_REPLICATED | _LORA_REPLICATED
    | {"xattn/wq", "xattn/wk", "xattn/wv", "xattn/wo"},
    ("whisper_full", 2): {"lora/o/a", "lora/o/b"},
    ("whisper_full", 4): _ATTN_REPLICATED | _LORA_REPLICATED
    | {"xattn/wq", "xattn/wk", "xattn/wv", "xattn/wo"},
    ("whisper_full", 8): _ATTN_REPLICATED | _LORA_REPLICATED
    | {"xattn/wq", "xattn/wk", "xattn/wv", "xattn/wo"},
    ("pixtral", 2): {"lora/o/a", "lora/o/b"},
    ("pixtral", 4): {"lora/o/a", "lora/o/b", "attn/wk", "attn/wv",
                     "lora/k/b", "lora/v/b"},
}


def _cfg_for_layout(model):
    if model == "whisper_full":
        from repro_torch.configs import whisper_tiny
        return whisper_tiny.config()
    return port_cfg(model)


@pytest.mark.parametrize("model,n", sorted(_DEPARTURES))
def test_family_layout_departs_from_pspecs_where_documented(model, n):
    """``split_dim`` against ``param_pspecs``: the same split everywhere
    but at the leaves the module documents.  ``xattn`` splits as the spec
    splits it (heads) but in the "replicated" regime; ``pos_embed`` and
    ``encoder/pos_embed`` split by rows as the spec does (whisper-tiny's
    65536 rows at n = 2, 4 and 8); Mamba2 leaves and ``frontend/proj``
    stay whole as the spec keeps them."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import DistContext
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": n}

    cfg = _cfg_for_layout(model)
    params = T.init_lm(cfg, device="meta")
    specs = SH.param_pspecs(cfg, params, DistContext(mesh=Mesh()))
    departs, split = set(), set()
    for path, x in PP.leaves(params):
        spec = specs
        for k in path:
            spec = spec[k]
        want = [i - x.ndim for i, d in enumerate(spec) if d is not None]
        got = TPX.split_dim(path, cfg, n)
        if want != ([] if got is None else [got]):
            departs.add("/".join(path[-3:] if "lora" in path else path[-2:]))
        if got is not None:
            split.add("/".join(path))
    assert departs == _DEPARTURES[(model, n)]
    fam = cfg.family
    if fam == "encdec":
        assert {"pos_embed", "encoder/pos_embed"} <= split
        assert ("layers/xattn/wq" in split) == (TPX.attn_regime(cfg, n)
                                                 != "replicated")
        assert "encoder/layers/mlp/wi" in split
    if fam in ("ssm", "hybrid"):
        assert not any("mamba" in p for p in split)
    if fam == "vlm":
        assert "frontend/proj" not in split


@pytest.mark.parametrize("model", ["mamba2", "zamba2", "whisper",
                                   "whisper6", "pixtral"])
def test_family_shards_gather_to_whole_leaves(model):
    """What ``TrainLoop`` and ``remesh_restore`` rely on for these
    families: a mesh with a model axis passes ``check_mesh``, and every
    rank's shard (``shard_params``: ``xattn`` and the position tables
    included) gathers back to the whole leaves, bit for bit, at n = 2 and
    4; the leaves the rules keep whole are the same tensors."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.train import check_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import partition as PP

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 4}

    cfg = port_cfg(model)
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
                assert torch.equal(a, b), (model, n, path)
        mine = TPX.shard_params(params, cfg, ranks[1])
        for (path, a), (_, b) in zip(PP.leaves(mine), PP.leaves(params)):
            if TPX.split_dim(path, cfg, n) is None:
                assert a is b, (model, n, path)
