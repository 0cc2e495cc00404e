"""Data-parallel training in the port against the reference: one AdamW
step with ``grad_codec`` "none", "int8" and "topk" in ``gloo`` worlds of
2 and 4 ranks (``distributed.elastic.launch_world``: spawned processes
on the CPU), each rank on its block of the batch, against the
reference's ``make_debug_mesh(n, 1)`` step (a subprocess with 4 forced
host devices) on the same weights and batch: the loss, every updated
trainable leaf and the AdamW moments, and each rank's error-feedback
residual against the reference's ``residual[r]``.  Also: a recurrent
family on a mesh that splits the model (in a world of 4 on (2, 2):
mamba2-370m trains a step, zamba2-1.2b restores a checkpoint), and the
refusal of a CUDA tensor on a ``gloo`` group.  Tensor parallelism
itself is ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tp_families.py``.  ``TrainLoop(dist=)`` and the
elastic resume are in ``tests/test_torch_distributed_loop.py``.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_train.py``; the ranks' sums and the reference's psum
add the same per-rank terms in another order.  An error-feedback
residual is a difference, gradient minus its compressed value, so it
carries the gradient's error: 1e-4 x max|the rank's local gradient|
(the reference's, on that rank's rows).
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
CCM = dict(comp_len=2, max_steps=4)
LAYOUT = (4, 8, 2, 8)                # t_steps, chunk, comp_len, tail
B = 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
CODECS = ("none", "int8", "topk")
TOPK = 0.05


def _inputs():
    """The reference's init, perturbed so that every LoRA factor has a
    gradient (b = 0 at init zeroes a's), and one batch, as numpy.  Row 0
    loses loss positions, so that the ranks hold different mask counts
    (the global masked mean then differs from the mean of the ranks')."""
    import jax

    from repro.core import masks as JM
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
    cfg = JCfg(**MODEL, ccm=JCCM(**CCM))
    params = JT.init_lm(jax.random.PRNGKey(0), cfg)
    leaves, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params = tdef.unflatten([p + 0.02 * jax.random.normal(k, p.shape, p.dtype)
                             for p, k in zip(leaves, keys)])
    batch = jsample(jax.random.PRNGKey(1), JM.segment_layout(*LAYOUT), B)
    batch = {k: np.array(v) for k, v in batch.items()}
    batch["loss_mask"][0, :3] = 0
    return jax.tree.map(np.asarray, params), batch


_REF = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import masks as M
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.launch.train import make_train_step, trainable_mask_for
from repro.models.config import CCMConfig, ModelConfig
from repro.optim import partition as PT
from repro.optim.adamw import AdamWConfig, init_adamw
from repro.optim.grad_compress import EFState
assert jax.device_count() == 4
params, batch = pickle.load(open(sys.argv[1], "rb"))
cfg = ModelConfig(**{model}, ccm=CCMConfig(**{ccm}))
layout = M.segment_layout(*{layout})
flat = lambda t: {{"/".join(str(k.key) for k in p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}}
params = jax.tree.map(jnp.asarray, params)
batch = {{k: jnp.asarray(v) for k, v in batch.items()}}
tp, fp = PT.partition(params, trainable_mask_for(cfg, params))
out = {{}}
for n in (2, 4):
    dist = make_dist(make_debug_mesh(n, 1))
    for codec in {codecs}:
        ef = None if codec == "none" else EFState(jax.tree.map(
            lambda p: jnp.zeros((n,) + p.shape, jnp.float32), tp))
        step = jax.jit(make_train_step(cfg, layout, AdamWConfig(**{opt}),
                                       dist, grad_codec=codec,
                                       topk_frac={topk}))
        tp2, opt2, m, ef2 = step(tp, fp, init_adamw(tp), batch, ef)
        out[(n, codec)] = dict(
            loss=float(m["loss"]), tp=flat(tp2), mu=flat(opt2.mu),
            nu=flat(opt2.nu),
            ef=None if ef2 is None else flat(ef2.residual))
pickle.dump(out, open(sys.argv[2], "wb"))
print("SAVED", len(out))
"""


def _reference(inp, tmp_path):
    """Start the reference in a subprocess (4 forced host devices)."""
    src = textwrap.dedent(_REF.format(model=MODEL, ccm=CCM, layout=LAYOUT,
                                      codecs=CODECS, opt=OPT, topk=TOPK))
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", src, str(inp), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _one_step(dev, params_np, batch_np):
    """On every rank: one step per codec from the same weights; returns,
    on rank 0, the loss, the trainable leaves and moments (checked equal
    on every rank) and every rank's error-feedback residual."""
    import torch.distributed as tdist

    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import grad_compress as PG
    from repro_torch.optim import partition as PP
    from repro_torch.params import params_from_numpy

    n = tdist.get_world_size()
    dist = make_dist(make_debug_mesh(n, 1, device=dev))
    cfg = PCfg(**MODEL, ccm=PCCM(**CCM))
    layout = PM.segment_layout(*LAYOUT)

    def flat(t):
        return {"/".join(p): x.detach().numpy().copy()
                for p, x in PP.leaves(t)}

    out = {}
    for codec in CODECS:
        params = params_from_numpy(params_np, cfg, device=dev)
        tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
        ef = None if codec == "none" else PG.init_ef(tp)
        step = TR.make_train_step(cfg, layout, PA.AdamWConfig(**OPT), dist,
                                  grad_codec=codec, topk_frac=TOPK)
        batch = {k: torch.from_numpy(v.copy()) for k, v in batch_np.items()}
        tp, opt, m, ef = step(tp, fp, PA.init_adamw(tp), batch, ef)
        mine = dict(loss=float(m["loss"]), tp=flat(tp), mu=flat(opt.mu),
                    nu=flat(opt.nu),
                    ef=None if ef is None else flat(ef.residual))
        every = [None] * n
        tdist.all_gather_object(every, mine)
        for other in every[1:]:            # replicas stay equal
            assert other["loss"] == mine["loss"]
            for k in ("tp", "mu", "nu"):
                for name, x in mine[k].items():
                    assert np.array_equal(other[k][name], x), (k, name)
        mine["ef"] = None if ef is None else [e["ef"] for e in every]
        out[codec] = mine
    return out


def _close(got, want, what, scale=None):
    """Within 1e-4 x ``scale`` (default max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= REL * max(scale, 1e-30), (what, err, scale)


def _local_grads(params, batch, n):
    """The reference's gradient of each rank's loss on its rows: rank r
    of n holds rows [r B/n, (r+1) B/n)."""
    import jax

    from repro.core import masks as JM
    from repro.launch import train as JTR
    from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
    from repro.optim import partition as JP
    cfg = JCfg(**MODEL, ccm=JCCM(**CCM))
    layout = JM.segment_layout(*LAYOUT)
    jp = jax.tree.map(jax.numpy.asarray, params)
    tp, fp = JP.partition(jp, JTR.trainable_mask_for(cfg, jp))
    grad = jax.jit(jax.grad(
        lambda t, b: JTR._loss_fn(t, fp, cfg, layout, b, None)))
    b = B // n
    out = []
    for r in range(n):
        g = grad(tp, {k: v[r * b:(r + 1) * b] for k, v in batch.items()})
        out.append({"/".join(str(k.key) for k in path): np.asarray(x)
                    for path, x in jax.tree_util.tree_flatten_with_path(
                        g)[0]})
    return out


def test_data_parallel_step_matches_reference(tmp_path):
    params, batch = _inputs()
    inp = tmp_path / "inputs.pkl"
    inp.write_bytes(pickle.dumps((params, batch)))
    ref, ref_out = _reference(inp, tmp_path)
    try:
        got = {n: launch_world(n, _one_step, params, batch, device="cpu",
                               timeout=600) for n in (2, 4)}
        local = {n: _local_grads(params, batch, n) for n in (2, 4)}
        stdout, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr
    want = pickle.loads(ref_out.read_bytes())
    for n in (2, 4):
        for codec in CODECS:
            g, w = got[n][codec], want[(n, codec)]
            what = f"world {n} {codec}"
            _close(g["loss"], w["loss"], f"{what} loss")
            assert sorted(g["tp"]) == sorted(w["tp"]) and w["tp"]
            for part in ("tp", "mu", "nu"):
                for k, v in w[part].items():
                    _close(g[part][k], v, f"{what} {part} {k}")
            if codec == "none":
                assert g["ef"] is None and w["ef"] is None
                continue
            assert len(g["ef"]) == n
            for r in range(n):               # rank r holds residual[r]
                for k, v in w["ef"].items():
                    assert np.abs(v[r]).max() > 0, (what, k)
                    _close(g["ef"][r][k], v[r], f"{what} ef[{r}] {k}",
                           scale=float(np.abs(local[n][r][k]).max()))


def _model_axis_world(dev, ckpt_dir):
    """On every rank of a world of 4, mesh (2, 2): one AdamW step of
    mamba2-370m's smoke config through ``make_train_step`` /
    ``jit_train_step(dist=)`` (its vocabulary split over the model axis,
    its Mamba2 layers whole), the loss and the whole leaves; then
    zamba2-1.2b's checkpoint in ``ckpt_dir`` restored by
    ``remesh_restore`` onto the mesh, and whether every rank holds its
    shard of the checkpoint's leaves (its shared site split, its Mamba2
    layers whole)."""
    import torch.distributed as tdist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import mamba2_370m, zamba2_12b
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.elastic import remesh_restore
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP

    mesh = make_debug_mesh(2, 2, device=dev)
    dist = make_dist(mesh)
    cfg = mamba2_370m.smoke(compute_dtype="float32")
    params = T.init_lm(cfg, 0, device=dev)
    tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
    batch = _mamba_batch(cfg)
    step = TR.jit_train_step(
        TR.make_train_step(cfg, PM.segment_layout(*LAYOUT),
                           PA.AdamWConfig(**OPT), dist),
        cfg, dist, None, None, batch, None)
    tp, fp, opt = step.place(tp, fp, PA.init_adamw(tp))
    assert tp["embed"].shape[0] == cfg.vocab_size // 2       # split
    tp, opt, m, _ = step(tp, fp, opt, batch)
    whole = {"/".join(p): x.detach().numpy().copy()
             for p, x in PP.leaves(step.gather(tp))}

    zcfg = zamba2_12b.smoke(compute_dtype="float32")
    template = {"tp": T.init_lm(zcfg, 1, device=dev)}
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    state, extra, dist2 = remesh_restore(ckpt, 3, zcfg, mesh, template, None)
    on_disk, _ = ckpt.restore(3, template)
    mine = TPX.shard_params(on_disk["tp"], zcfg, dist2)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(PP.leaves(state["tp"]), PP.leaves(mine)))
    split = {"/".join(p) for p, _ in PP.leaves(state["tp"])
             if TPX.split_dim(p, zcfg, 2) is not None}
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, same)
    return float(m["loss"]), whole, all(every), extra["step"], split


def _mamba_batch(cfg):
    from repro_torch.data.synthetic import ShardableIndexIterator, \
        sample_kv_batch
    b = sample_kv_batch(ShardableIndexIterator(0, B).key_for(0),
                        PM.segment_layout(*LAYOUT), B, device="cpu")
    b["tokens"] = b["tokens"] % cfg.vocab_size
    b["loss_mask"][0, :3] = 0
    return b


@pytest.fixture(scope="module")
def model_axis_world(tmp_path_factory):
    """`_model_axis_world`'s results, with zamba2-1.2b's whole smoke
    params checkpointed at step 3 before the world starts."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import zamba2_12b
    from repro_torch.models import transformer as T
    tmp = tmp_path_factory.mktemp("model_axis")
    zcfg = zamba2_12b.smoke(compute_dtype="float32")
    ckpt = CheckpointManager(str(tmp / "ckpt"), async_save=False)
    ckpt.save(3, {"tp": T.init_lm(zcfg, 1, device="cpu")},
              extra={"step": 3})
    return launch_world(4, _model_axis_world, str(tmp / "ckpt"),
                        device="cpu", timeout=600)


def test_tensor_parallel_mesh_raises_and_cuda_needs_nccl(model_axis_world):
    """A mesh with a model axis takes a recurrent family: the steps build
    on a shape-only (2, 2) mesh (the model axis's process group is taken
    at the first step), and mamba2-370m's step on (2, 2) in a world of 4
    gives the one-device step's loss and leaves; a CUDA tensor never goes
    through a gloo group (no hidden copy to the host)."""
    import types

    import torch.distributed as tdist

    from repro_torch.configs import mamba2_370m
    from repro_torch.distributed.context import (DistContext, check_backend,
                                                 free_port)
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

    cfg = mamba2_370m.smoke(compute_dtype="float32")
    step = TR.make_train_step(cfg, PM.segment_layout(*LAYOUT),
                              PA.AdamWConfig(**OPT),
                              dist=DistContext(mesh=Mesh()))
    placed = TR.jit_train_step(step, cfg, DistContext(mesh=Mesh()), None,
                               None, {}, None)
    assert callable(step) and placed.step_fn is step
    loss, whole, _, _, _ = model_axis_world
    params = T.init_lm(cfg, 0, device="cpu")
    tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
    tp, _, m, _ = TR.make_train_step(cfg, PM.segment_layout(*LAYOUT),
                                     PA.AdamWConfig(**OPT))(
        tp, fp, PA.init_adamw(tp), _mamba_batch(cfg))
    _close(loss, m["loss"].item(), "mamba2 (2, 2) loss")
    for p, x in PP.leaves(tp):
        _close(whole["/".join(p)], x.detach().numpy(),
               f"mamba2 (2, 2) {'/'.join(p)}")
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        cuda_like = types.SimpleNamespace(is_cuda=True, device="cuda:0")
        with pytest.raises(RuntimeError, match="NCCL"):
            check_backend(cuda_like, tdist.group.WORLD)
        check_backend(torch.zeros(1), tdist.group.WORLD)     # CPU: gloo
    finally:
        tdist.destroy_process_group()


def test_meshes_need_their_world_and_remesh_restore(tmp_path,
                                                    model_axis_world):
    """A (data, model) mesh needs a process group of exactly its ranks;
    ``remesh_restore`` reads a checkpoint onto a data-parallel mesh, and
    onto a mesh with a model axis for a recurrent family: zamba2-1.2b's
    checkpoint on (2, 2) in a world of 4, every rank on its shard (the
    dense family's restore is ``tests/test_torch_tensor_parallel.py``)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.elastic import remesh_restore
    from repro_torch.launch import mesh as LM

    for make in (lambda: LM.make_production_mesh(device="cpu"),
                 lambda: LM.make_debug_mesh(2, 1, device="cpu"),
                 lambda: LM.available_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            make()

    class Mesh:
        axis_names = ("data", "model")

        def __init__(self, n_model):
            self.shape = {"data": 2, "model": n_model}

    cfg = PCfg(**MODEL, ccm=PCCM(**CCM))
    state = {"tp": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"mu": torch.ones(3)}}
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(8, state, extra={"step": 8})
    template = {"tp": {"w": torch.zeros(2, 3)}, "opt": {"mu": torch.zeros(3)}}
    got, extra, dist = remesh_restore(ckpt, 8, cfg, Mesh(1), template, None)
    assert extra["step"] == 8 and dist.n_data == 2 and dist.n_model == 1
    assert torch.equal(got["tp"]["w"], state["tp"]["w"])
    assert torch.equal(got["opt"]["mu"], state["opt"]["mu"])
    _, _, same, step, split = model_axis_world
    assert same and step == 3
    assert "shared_attn/attn/wq" in split and "embed" in split
    assert not any("mamba" in p for p in split)
