"""Full training of the recurrent families against ``repro``: one AdamW
step of ``make_train_step`` (``train_mode="full"``, both configs) for
mamba2-370m without CCM and for zamba2-1.2b with CCM concat and merge at
its shared-attention sites, at the registry's smoke sizes in float32.

Clipping is off (``clip_norm=0``), so the first moment after one step is
``0.1 x`` the gradient: the loss, the gradient norm, the gradient of every
leaf (through the moments) and every updated leaf are held to 1e-4 x
max|reference| per tensor, with ``tests/test_torch_zoo.py``'s allowance
for Adam's sign on elements whose gradient lies within that tolerance
of 0.  Helpers and weights are ``tests/test_torch_recurrent.py``'s.
"""
import jax
import numpy as np
import pytest

from repro.launch import train as JTR
from repro.optim import adamw as JA
from repro.optim import partition as JP
from repro_torch.launch import train as PTR
from repro_torch.optim import adamw as PA
from repro_torch.optim import partition as PP
from test_torch_recurrent import (CASES, IDS, REL, _batch, _cfgs, _flat,
                                  _jflat, _layouts, _params, _rel)


@pytest.mark.parametrize("arch,mode", CASES, ids=IDS)
def test_train_step_matches_reference(arch, mode):
    jc, pc = _cfgs(arch, mode)
    jp, pp = _params(arch, pc)
    jl, pl = _layouts()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01,
                clip_norm=0.0)
    jstep = jax.jit(JTR.make_train_step(jc, jl, JA.AdamWConfig(**ocfg)))
    pstep = PTR.make_train_step(pc, pl, PA.AdamWConfig(**ocfg))
    jtp, jfp = JP.partition(jp, JTR.trainable_mask_for(jc, jp))
    ptp, pfp = PP.partition(pp, PTR.trainable_mask_for(pc, pp))
    jopt, popt = JA.init_adamw(jtp), PA.init_adamw(ptp)
    before = _flat(ptp)
    assert not _flat(pfp) and len(before) == len(_flat(pp))   # full
    jb, pb = _batch(10, pc.vocab_size)
    jtp, jopt, jm, _ = jstep(jtp, jfp, jopt, jb, None)
    ptp, popt, pm, _ = pstep(ptp, pfp, popt, pb, None)
    _rel(pm["loss"].item(), float(jm["loss"]), "loss")
    _rel(pm["grad_norm"].item(), float(jm["grad_norm"]), "grad norm")
    assert popt.step == int(jopt.step) == 1
    grads = {k: v / 0.1 for k, v in _jflat(jopt.mu).items()}
    assert "layers/mamba/a_log" in grads and \
        ("shared_attn/attn/lora/q/b" in grads) == (arch == "zamba2-1.2b")
    for moment in ("mu", "nu"):
        w, g = _jflat(getattr(jopt, moment)), _flat(getattr(popt, moment))
        assert set(g) == set(w) == set(grads)
        for k, v in g.items():
            assert np.abs(w[k]).max() > 0, f"{moment} {k}"
            _rel(v, w[k], f"{moment} {k}")
    want, got = _jflat(jtp), _flat(ptp)
    for k, v in got.items():
        g = np.abs(grads[k])
        loose = (g > 0) & (g <= REL * g.max())
        tol = REL * np.abs(want[k]).max() + 2 * ocfg["lr"] * loose
        assert (np.abs(v - want[k]) <= tol).all(), k
        assert not np.array_equal(v, before[k]), k        # it moved


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_train_loop_runs_full_training(arch):
    """``TrainLoop`` (the port's own init and data) trains both configs in
    full on the CPU: 3 steps, finite losses, every leaf trainable and
    moved."""
    _, pc = _cfgs(arch)
    _, pl = _layouts()
    loop = PTR.TrainLoop(pc, pl, PA.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=4),
                         batch_size=2, seed=3, device="cpu")
    before = _flat(loop.tp)
    assert not _flat(loop.fp) and "layers/mamba/a_log" in before
    hist = loop.run(3, log_every=0)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    for k, v in _flat(loop.tp).items():
        assert not np.array_equal(v, before[k]), k
