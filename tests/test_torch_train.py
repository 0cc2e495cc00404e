"""Port parity for the CCM parallel training path: ``train_forward``, the
loss and its gradients, ``make_train_step`` over three AdamW steps and
``TrainLoop`` restarts, against ``repro`` on the same weights and tokens
(drawn by the reference and handed to both packages as numpy).  The
paper's baselines (``ccm.method`` "gisting" and "compressive") run in both
modes: the method takes precedence over the mode, in both packages.

The reference runs its default ``attn_impl="dense"`` (jnp attend) and,
for the forward, ``"pallas"`` (its CCM flash-attention kernel in
interpret mode; that kernel has no VJP, so the gradients come from
``jax.grad`` of the dense path).  The port runs its kernel op, whose CPU
version is the plain ``ccm_attention_ref``.

Tolerance (float32 on the CPU): 1e-4 x max|reference| per tensor.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.data.synthetic import sample_kv_batch as jsample
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro.optim import adamw as JA
from repro.optim import partition as JP
from repro_torch.core import inference as PI
from repro_torch.core import masks as PM
from repro_torch.launch import train as PTR
from repro_torch.models import transformer as PT
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.optim import adamw as PA
from repro_torch.optim import partition as PP
from repro_torch.params import params_from_numpy, params_to_numpy

REL = 1e-4
T_STEPS, LC, M, TAIL, B = 4, 8, 2, 8, 2
MODEL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, compute_dtype="float32")


def _cfgs(mode="concat", alpha=None, method="ccm", **kw):
    ccm = dict(comp_len=M, max_steps=T_STEPS, mode=mode, merge_alpha=alpha,
               method=method)
    return (JCfg(**MODEL, ccm=JCCM(**ccm), **kw),
            PCfg(**MODEL, ccm=PCCM(**ccm), **kw))


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _params(jcfg, pcfg):
    """Reference init, perturbed so the LoRA deltas are not zero (b = 0 at
    init gives every ``a`` a zero gradient), and the port's copy."""
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    leaves, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params = tdef.unflatten([p + 0.02 * jax.random.normal(k, p.shape, p.dtype)
                             for p, k in zip(leaves, keys)])
    return params, params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                     device="cpu")


def _layouts():
    return (JM.segment_layout(T_STEPS, LC, M, TAIL),
            PM.segment_layout(T_STEPS, LC, M, TAIL))


def _batch(seed):
    jl, _ = _layouts()
    jb = jsample(jax.random.PRNGKey(seed), jl, B)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _flat(tree):
    """{path: numpy leaf} of a port tree (None leaves dropped)."""
    return {"/".join(p): x.detach().numpy() for p, x in PP.leaves(tree)}


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in flat}


@pytest.mark.parametrize("method,mode,alpha,impl", [
    ("ccm", "concat", None, "dense"), ("ccm", "concat", None, "pallas"),
    ("ccm", "merge", None, "dense"), ("ccm", "merge", 0.3, "dense"),
    ("gisting", "concat", None, "dense"), ("gisting", "merge", None, "dense"),
    ("compressive", "concat", None, "dense"),
    ("compressive", "merge", None, "dense")])
def test_train_forward_matches_reference(method, mode, alpha, impl):
    """The reference's kernel ('pallas') runs in concat mode only."""
    jcfg, pcfg = _cfgs(mode, alpha, method, attn_impl=impl)
    jparams, pparams = _params(jcfg, pcfg)
    jl, pl = _layouts()
    jb, pb = _batch(1)
    want = np.asarray(JT.train_forward(jparams, jcfg, jb["tokens"], jl))
    got = PT.train_forward(pparams, pcfg, pb["tokens"], pl)
    assert got.shape == (B, TAIL, MODEL["vocab_size"])
    _close(got.detach(), want)


def test_train_forward_concat_oracle_equals_kernel_op():
    """'concat' (dense masked oracle) and the kernel op agree."""
    _, pcfg = _cfgs("concat")
    _, pparams = _params(*_cfgs("concat"))
    _, pl = _layouts()
    _, pb = _batch(2)
    a = PT.train_forward(pparams, pcfg, pb["tokens"], pl)
    b = PT.train_forward(pparams, pcfg.replace(attn_impl="concat"),
                         pb["tokens"], pl)
    _close(a.detach(), b.detach().numpy())


def _jax_loss_grads(jcfg, jl, jparams, jb):
    trainable = JTR.trainable_mask_for(jcfg, jparams)
    tp, fp = JP.partition(jparams, trainable)
    fn = jax.jit(lambda tp, fp, b: jax.value_and_grad(JTR._loss_fn)(
        tp, fp, jcfg, jl, b, None))
    loss, grads = fn(tp, fp, jb)
    return float(loss), _jflat(grads)


@pytest.mark.parametrize("method,mode,alpha,train_mode", [
    ("ccm", "concat", None, "lora"), ("ccm", "merge", None, "lora"),
    ("ccm", "merge", 0.3, "lora"), ("gisting", "concat", None, "lora"),
    ("gisting", "merge", None, "lora"),
    ("compressive", "concat", None, "lora"),
    ("compressive", "merge", None, "full")])
def test_loss_and_gradients_match_reference(method, mode, alpha, train_mode):
    """Compressive pools raw tokens only: the <COMP> rows, where the LoRA
    fires, reach no loss position, so the LoRA and comp_embed gradients
    are exactly 0 in both packages; full training holds the pooling's
    gradient through the base weights."""
    jcfg, pcfg = _cfgs(mode, alpha, method, train_mode=train_mode)
    jparams, pparams = _params(jcfg, pcfg)
    jl, pl = _layouts()
    jb, pb = _batch(3)
    want_loss, want_grads = _jax_loss_grads(jcfg, jl, jparams, jb)
    tp, fp = PP.partition(pparams, PTR.trainable_mask_for(pcfg, pparams))
    leaves = PP.leaves(tp)
    for _, x in leaves:
        x.requires_grad_(True)
    loss = PTR._loss_fn(tp, fp, pcfg, pl, pb)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    _close(loss.item(), want_loss, "loss")
    got = {"/".join(p): g.numpy() for (p, _), g in zip(leaves, grads)}
    assert set(got) == set(want_grads)
    if train_mode == "lora":
        assert len(got) == 9      # 4 projections x (a, b) + comp_embed
    for k in got:
        if method == "compressive" and ("lora" in k or "comp_embed" in k):
            assert not want_grads[k].any() and not got[k].any(), k
            continue
        assert np.abs(want_grads[k]).max() > 0, k
        _close(got[k], want_grads[k], k)


@pytest.mark.parametrize("method,mode,train_mode", [
    ("ccm", "concat", "lora"), ("ccm", "merge", "lora"),
    ("gisting", "concat", "lora"), ("compressive", "merge", "full")])
def test_three_train_steps_match_reference(method, mode, train_mode):
    """Compressive trains in full: its LoRA gradients are exactly 0."""
    jcfg, pcfg = _cfgs(mode, method=method, train_mode=train_mode)
    jparams, pparams = _params(jcfg, pcfg)
    jl, pl = _layouts()
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=6, weight_decay=0.01)
    jstep = jax.jit(JTR.make_train_step(jcfg, jl, JA.AdamWConfig(**ocfg)))
    pstep = PTR.make_train_step(pcfg, pl, PA.AdamWConfig(**ocfg))
    jtp, jfp = JP.partition(jparams, JTR.trainable_mask_for(jcfg, jparams))
    ptp, pfp = PP.partition(pparams, PTR.trainable_mask_for(pcfg, pparams))
    jopt, popt = JA.init_adamw(jtp), PA.init_adamw(ptp)
    frozen0 = _flat(pfp)
    for s in range(3):
        jb, pb = _batch(10 + s)
        jtp, jopt, jm, _ = jstep(jtp, jfp, jopt, jb, None)
        ptp, popt, pm, _ = pstep(ptp, pfp, popt, pb, None)
        _close(pm["loss"].item(), float(jm["loss"]), f"loss {s}")
        _close(pm["grad_norm"].item(), float(jm["grad_norm"]), f"gnorm {s}")
        assert popt.step == int(jopt.step) == s + 1
        want = _jflat(jtp)
        for k, v in _flat(ptp).items():
            _close(v, want[k], f"step {s} {k}")
        for k, v in _jflat(jopt.mu).items():
            _close(_flat(popt.mu)[k], v, f"mu {s} {k}")
    for k, v in _flat(pfp).items():
        assert np.array_equal(v, frozen0[k]), k


def test_train_loop_restart_equals_uninterrupted(tmp_path):
    """The port's analogue of tests/test_checkpoint.py's restart test:
    6 steps in one go == 3 steps, a checkpoint, a fresh loop restored
    from it and 3 more steps (leaves, moments, losses and data order)."""
    cfg = PCfg(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
               n_kv_heads=2, d_ff=64, vocab_size=128, train_mode="lora",
               compute_dtype="float32",
               ccm=PCCM(comp_len=2, max_steps=2))
    layout = PM.segment_layout(2, 6, 2, 8)
    ocfg = PA.AdamWConfig(lr=1e-3, total_steps=20)

    ticks = iter(range(1000))      # an injected fake clock: 1 s per read

    def mk(d, every):
        return PTR.TrainLoop(cfg, layout, ocfg, batch_size=4, ckpt_dir=d,
                             ckpt_every=every, device="cpu",
                             clock=lambda: float(next(ticks)))

    full = mk(None, 50)
    h_full = full.run(6, log_every=0)
    first = mk(str(tmp_path), 3)
    first.run(3, log_every=0)
    second = mk(str(tmp_path), 3)
    start = second.maybe_restore()
    assert start == 3 and second.it.step == 3 and second.opt.step == 3
    h = second.run(6, start_step=start, log_every=0)
    assert [r["loss"] for r in h_full[3:]] == [r["loss"] for r in h]
    for k, v in _flat(full.tp).items():
        assert np.array_equal(v, _flat(second.tp)[k]), k
    for k, v in _flat(full.opt.nu).items():
        assert np.array_equal(v, _flat(second.opt.nu)[k]), k
    assert all(np.isfinite(r["loss"]) for r in h_full)
    assert [r["dt"] for r in h_full] == [1.0] * 6
    assert not any(r["straggler"] for r in h_full + h)


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_parallel_equals_online_in_port(mode):
    """The paper's property inside the port (tests/test_equivalence.py):
    the tail logits of the parallel forward equal T ingests + prefill."""
    _, pcfg = _cfgs(mode)
    _, params = _params(*_cfgs(mode))
    _, pl = _layouts()
    _, pb = _batch(1)
    toks = pb["tokens"]
    lg_train = PT.train_forward(params, pcfg, toks, pl)
    st = PI.init_online_state(pcfg, B, 32, device="cpu")
    step = LC + M
    for j in range(T_STEPS):
        st = PI.ingest_context(params, pcfg, st,
                               toks[:, j * step:(j + 1) * step - M])
    logits, _ = PI.prefill(params, pcfg, st, toks[:, T_STEPS * step:])
    np.testing.assert_allclose(lg_train[:, -1].detach().numpy(),
                               logits[:, -1].numpy(), atol=2e-4, rtol=0)


def test_multi_device_training_raises():
    """Data-parallel meshes train (tests/test_torch_distributed.py), and
    a mesh with a model axis trains every family
    (tests/test_torch_tensor_parallel.py, tests/test_torch_tp_families.py):
    zamba2's step builds on such a mesh (shape-only: the check reads no
    more), and the 2 ranks of a ``LocalGroup`` give the unsharded loss
    and gradients.  What still raises is a split the reference cannot
    make: an MoE ``ragged_tp`` whose d_ff does not divide."""
    from repro_torch.configs import phi35_moe, zamba2_12b
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import DistContext
    from repro_torch.models import transformer as PT_
    from repro_torch.optim.losses import next_token_loss

    class Mesh:                   # shape-only: the check reads no more
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}

    _, pl = _layouts()
    cfg = zamba2_12b.smoke(compute_dtype="float32")
    assert callable(PTR.make_train_step(cfg, pl, PA.AdamWConfig(),
                                        dist=DistContext(mesh=Mesh())))
    params = PT_.init_lm(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, pl.seq_len), generator=gen)
    mask = torch.ones(2, pl.tail_len - 1)

    def loss_grads(p, tp):
        leaves = [x.detach().clone().requires_grad_(True)
                  for _, x in PP.leaves(p)]
        it = iter(leaves)
        p = PP.tree_map(lambda _, x: next(it), p)
        lg = PT_.train_forward(p, cfg, tok, pl, dist=tp)
        loss = next_token_loss(lg, tok[:, -pl.tail_len:], mask, tp=tp)
        it = iter(torch.autograd.grad(loss, leaves))
        return loss.detach(), PP.tree_map(lambda _, x: next(it), p)

    want, wgrads = loss_grads(params, None)
    group = TPX.LocalGroup(2)
    ranks = TPX.local_ranks(cfg, group)
    for loss, grads in group.run(lambda r: (lambda lg: (
            lg[0], TPX.gather_params(lg[1], cfg, ranks[r])))(
            loss_grads(TPX.shard_params(params, cfg, ranks[r]), ranks[r]))):
        assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
        for (path, a), (_, b) in zip(PP.leaves(grads), PP.leaves(wgrads)):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), path
    Mesh.shape = {"data": 1, "model": 5}
    with pytest.raises(ValueError, match="d_ff 96 over 5"):
        PTR.make_train_step(phi35_moe.smoke(), pl, PA.AdamWConfig(),
                            dist=DistContext(mesh=Mesh()))


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg, pcfg = _cfgs("concat", param_dtype="bfloat16")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(host, pcfg, device="cpu"))
    flat = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, x in flat:
        y = back
        for k in path:
            y = y[k.key]
        assert np.array_equal(np.asarray(x, np.float32), y), path


def _example():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" \
        / "train_online_torch.py"
    spec = importlib.util.spec_from_file_location("_train_online_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_online_example_resumes_on_the_cpu(tmp_path, capsys,
                                                 monkeypatch):
    """``examples/train_online_torch.py --device cpu``: 4 steps with a
    checkpoint every 2, then a second run resumes at step 4 and trains
    to 6; an int8 codec on one device logs the losses of "none";
    ``--ablate-lora`` trains both arms and prints their accuracy."""
    ex = _example()
    monkeypatch.setattr(ex, "CKPT_EVERY", 2)
    args = ["--arch", "llama-7b", "--smoke", "--device", "cpu", "--batch",
            "2", "--lr", "1e-2"]
    ck = str(tmp_path / "ck")
    assert ex.main(args + ["--steps", "4", "--ckpt", ck]) == 0
    first = capsys.readouterr().out
    assert "resumed" not in first and "final loss" in first
    def steps():
        return sorted(int(p.name.split("_")[1])
                      for p in (tmp_path / "ck").iterdir()
                      if p.name.startswith("step_"))
    assert steps() == [2, 4]
    assert ex.main(args + ["--steps", "6", "--ckpt", ck]) == 0
    second = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in second
    assert steps() == [2, 4, 6]
    finals = []
    for codec in ("none", "int8"):
        assert ex.main(args + ["--steps", "3", "--ckpt",
                               str(tmp_path / codec), "--grad-codec",
                               codec]) == 0
        finals.append([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("final loss")])
    assert finals[0] == finals[1] and finals[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # small ops stall on shared, contended cores
    try:
        assert ex.main(["--ablate-lora", "--device", "cpu", "--steps",
                        "2"]) == 0
    finally:
        torch.set_num_threads(threads)
    accs = [ln for ln in capsys.readouterr().out.splitlines()
            if "LoRA acc@t4 = " in ln]
    assert [ln.split()[0] for ln in accs] == ["conditional", "default"]
    assert all(0.0 <= float(ln.rsplit("=", 1)[1]) <= 1.0 for ln in accs)
