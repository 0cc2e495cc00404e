"""Port parity for the CCM parallel training path: ``train_forward``, the
loss and its gradients, ``make_train_step`` over three AdamW steps and
``TrainLoop`` restarts, against ``repro`` on the same weights and tokens
(drawn by the reference and handed to both packages as numpy).

The reference runs its default ``attn_impl="dense"`` (jnp attend) and,
for the forward, ``"pallas"`` (its CCM flash-attention kernel in
interpret mode; that kernel has no VJP, so the gradients come from
``jax.grad`` of the dense path).  The port runs its kernel op, whose CPU
version is the plain ``ccm_attention_ref``.

Tolerance (float32 on the CPU): 1e-4 x max|reference| per tensor.
"""
import dataclasses

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


def _cfgs(mode="concat", alpha=None, **kw):
    ccm = dict(comp_len=M, max_steps=T_STEPS, mode=mode, merge_alpha=alpha)
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


@pytest.mark.parametrize("mode,alpha,impl", [
    ("concat", None, "dense"), ("concat", None, "pallas"),
    ("merge", None, "dense"), ("merge", 0.3, "dense")])
def test_train_forward_matches_reference(mode, alpha, impl):
    """The reference's kernel ('pallas') runs in concat mode only."""
    jcfg, pcfg = _cfgs(mode, alpha, attn_impl=impl)
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


@pytest.mark.parametrize("mode,alpha", [("concat", None), ("merge", None),
                                        ("merge", 0.3)])
def test_loss_and_gradients_match_reference(mode, alpha):
    jcfg, pcfg = _cfgs(mode, alpha)
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
    assert len(got) == 9          # 4 projections x (a, b) + comp_embed
    for k in got:
        assert np.abs(want_grads[k]).max() > 0, k
        _close(got[k], want_grads[k], k)


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_three_train_steps_match_reference(mode):
    jcfg, pcfg = _cfgs(mode)
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


def test_unported_training_options_raise():
    _, pcfg = _cfgs("concat")
    _, params = _params(*_cfgs("concat"))
    _, pl = _layouts()
    _, pb = _batch(1)
    for method in ("gisting", "compressive"):
        c = pcfg.replace(ccm=dataclasses.replace(pcfg.ccm, method=method))
        with pytest.raises(NotImplementedError):
            PT.train_forward(params, c, pb["tokens"], pl)
    with pytest.raises(NotImplementedError):
        PTR.make_train_step(pcfg, pl, PA.AdamWConfig(), grad_codec="int8")
    with pytest.raises(NotImplementedError):
        PTR.make_train_step(pcfg, pl, PA.AdamWConfig(), dist=object())


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
