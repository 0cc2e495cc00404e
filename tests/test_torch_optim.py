"""Port parity for the optimizer pieces (``repro_torch.optim`` against
``repro.optim``): ``schedule_lr``, ``global_norm``, ``adamw_update`` over
several steps (clipping, weight decay, a bf16 leaf, a frozen leaf),
``partition``/``merge`` and ``next_token_loss``, on the same numpy inputs.

Tolerance: float32, 1e-6 relative for the schedule and 1e-4 x max|ref|
for updated leaves and moments (the reference's float32 arithmetic; the
global norm is summed in another order); a bf16 leaf within one bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import losses as JL
from repro.optim import partition as JP
from repro_torch.optim import adamw as PA
from repro_torch.optim import losses as PL
from repro_torch.optim import partition as PP


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_lr(schedule):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=30, schedule=schedule)
    jc, pc = JA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    for s in (0, 1, 4, 5, 6, 17, 30, 45):
        want = float(JA.schedule_lr(jc, jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(PA.schedule_lr(pc, s), want, rtol=1e-6,
                                   atol=0)


def _trees(rs):
    p = {"a": rs.normal(size=(3, 4)).astype(np.float32),
         "blk": {"w": rs.normal(size=(5,)).astype(np.float32),
                 "e": rs.normal(size=(2, 3)).astype(np.float32)}}
    return p


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (0.0, 0.01), (0.05, 0.1)])
def test_adamw_update_matches_reference(clip, wd):
    rs = np.random.default_rng(0)
    p = _trees(rs)
    kw = dict(lr=1e-2, clip_norm=clip, weight_decay=wd, warmup_steps=2,
              total_steps=8)
    jc, pc = JA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    mask = {"a": True, "blk": {"w": False, "e": True}}
    jp = jax.tree.map(jnp.asarray, p)
    jp["blk"]["e"] = jp["blk"]["e"].astype(jnp.bfloat16)   # a bf16 leaf
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p)
    tp["blk"]["e"] = tp["blk"]["e"].bfloat16()
    jst, pst = JA.init_adamw(jp, mask), PA.init_adamw(tp, mask)
    assert pst.nu["blk"]["w"] is None and pst.step == 0
    w0 = tp["blk"]["w"].clone()
    for s in range(4):
        g = jax.tree.map(lambda x: rs.normal(size=x.shape).astype(np.float32)
                         * (s + 1), p)
        jp, jst, jm = JA.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g),
                                      jst, mask)
        tp, pst, pm = PA.adamw_update(
            pc, tp, jax.tree.map(lambda x: torch.from_numpy(x), g), pst, mask)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(pm["lr"], float(jm["lr"]), rtol=1e-6)
        a, want = tp["a"].numpy(), np.asarray(jp["a"])
        np.testing.assert_allclose(a, want, atol=1e-4 * np.abs(want).max(),
                                   rtol=0)
        e = tp["blk"]["e"].float().numpy()
        we = np.asarray(jp["blk"]["e"].astype(jnp.float32))
        np.testing.assert_allclose(e, we, atol=2 ** -8 * np.abs(we).max(),
                                   rtol=0)
        for k in ("a",):
            m = np.asarray(jst.mu[k])
            np.testing.assert_allclose(pst.mu[k].numpy(), m,
                                       atol=1e-4 * np.abs(m).max(), rtol=0)
    assert pst.step == int(jst.step) == 4
    assert torch.equal(tp["blk"]["w"], w0)             # untrainable leaf
    assert tp["blk"]["e"].dtype == torch.bfloat16


def test_global_norm():
    rs = np.random.default_rng(1)
    g = _trees(rs)
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, g)))
    got = PA.global_norm(jax.tree.map(torch.from_numpy, g)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_partition_merge_and_lora_predicate():
    rs = np.random.default_rng(2)
    tree = {"embed": rs.normal(size=(2,)), "comp_embed": rs.normal(size=(2,)),
            "layers": {"attn": {"wq": rs.normal(size=(2,)),
                                "lora": {"q": {"a": rs.normal(size=(2,)),
                                               "b": rs.normal(size=(2,))}}}}}
    jm = JP.trainable_mask(tree, JP.lora_predicate)
    pm = PP.trainable_mask(tree, PP.lora_predicate)
    assert pm == jm
    ttree = jax.tree.map(torch.from_numpy, tree)
    tr, fr = PP.partition(ttree, pm)
    assert tr["embed"] is None and fr["embed"] is ttree["embed"]
    assert tr["layers"]["attn"]["lora"]["q"]["a"] is \
        ttree["layers"]["attn"]["lora"]["q"]["a"]
    assert [p for p, _ in PP.leaves(tr)] == [
        ("comp_embed",), ("layers", "attn", "lora", "q", "a"),
        ("layers", "attn", "lora", "q", "b")]
    back = PP.merge(tr, fr)
    jtr, jfr = JP.partition(tree, jm)
    jback = JP.merge(jtr, jfr)
    assert jax.tree.map(lambda x: x.shape, jback) == \
        PP.tree_map(lambda _, x: tuple(x.shape), back)
    for p, x in PP.leaves(back):
        y = tree
        for k in p:
            y = y[k]
        assert np.array_equal(x.numpy(), y)


def test_next_token_loss():
    rs = np.random.default_rng(3)
    logits = rs.normal(size=(3, 6, 11)).astype(np.float32) * 3
    toks = rs.integers(0, 11, size=(3, 7)).astype(np.int32)
    mask = (rs.random((3, 6)) > 0.4).astype(np.float32)
    want = float(JL.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                                    jnp.asarray(mask)))
    got = PL.next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                             torch.from_numpy(mask)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    zero = PL.next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                              torch.zeros(3, 6)).item()
    assert zero == 0.0
