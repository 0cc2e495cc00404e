"""Port parity for the optimizer pieces (``repro_torch.optim`` against
``repro.optim``): ``schedule_lr``, ``global_norm``, ``adamw_update`` over
several steps (clipping, weight decay, a bf16 leaf, a frozen leaf),
``partition``/``merge``, ``next_token_loss`` and the gradient codecs of
``grad_compress`` (int8, top-k, error feedback), on the same numpy
inputs; and ``TrainLoop`` with a codec on one device.

Tolerance: float32, 1e-6 relative for the schedule and 1e-4 x max|ref|
for updated leaves and moments (the reference's float32 arithmetic; the
global norm is summed in another order); a bf16 leaf within one bf16 ulp.
The codecs are elementwise float32 arithmetic and must be equal: int8
``q``, ``scale``, the top-k masks and the error-feedback residuals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.launch import train as JTR
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro.optim import adamw as JA
from repro.optim import grad_compress as JG
from repro.optim import losses as JL
from repro.optim import partition as JP
from repro_torch.core import masks as PM
from repro_torch.launch import train as PTR
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.optim import adamw as PA
from repro_torch.optim import grad_compress as PG
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


# ---------------------------------------------------------------------------
# gradient codecs (grad_compress)
# ---------------------------------------------------------------------------

def _codec_input(case, rs):
    x = rs.normal(size=(37, 29)).astype(np.float32)
    if case == "ties":
        # exact halves of the int8 quantum (round half to even) and
        # repeated magnitudes (top-k keeps every tie of the threshold)
        x = (rs.integers(-40, 41, size=(16, 16)) / 2.0).astype(np.float32)
        x[0, 0] = 63.5
    elif case == "zeros":
        x = np.zeros((8, 8), np.float32)
    elif case == "tiny":
        x = x * 1e-30
    return x


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny", "bf16"])
def test_int8_codec_matches_reference(case):
    x = _codec_input(case, np.random.default_rng(4))
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, px = jx.astype(jnp.bfloat16), px.bfloat16()
    jq, js = JG.quantize_int8(jx)
    pq, ps = PG.quantize_int8(px)
    assert pq.dtype == torch.int8 and ps.ndim == 0
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert ps.float().item() == float(js.astype(jnp.float32))
    np.testing.assert_array_equal(
        PG.dequantize_int8(pq, ps).float().numpy(),
        np.asarray(JG.dequantize_int8(jq, js).astype(jnp.float32)))


@pytest.mark.parametrize("case,frac", [("normal", 0.01), ("normal", 0.25),
                                       ("normal", 1e-9), ("ties", 0.1),
                                       ("zeros", 0.5)])
def test_topk_sparsify_matches_reference(case, frac):
    x = _codec_input(case, np.random.default_rng(5))
    want = np.asarray(JG.topk_sparsify(jnp.asarray(x), frac))
    got = PG.topk_sparsify(torch.from_numpy(x), frac).numpy()
    np.testing.assert_array_equal(got, want)
    k = max(int(x.size * frac), 1)
    if case == "ties":
        assert np.count_nonzero(got) > k       # ties at the threshold kept


def _grad_tree(rs, scale):
    return {"a": (rs.normal(size=(6, 5)) * scale).astype(np.float32),
            "blk": {"w": (rs.normal(size=(40,)) * scale).astype(np.float32),
                    "e": (rs.normal(size=(3, 7)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("codec", ["int8", "topk", "none"])
def test_compress_with_ef_matches_reference(codec):
    """Three error-feedback rounds; a bf16 gradient leaf and a None leaf
    (the frozen side of a partition) in the port's tree."""
    rs = np.random.default_rng(6)
    g0 = _grad_tree(rs, 1.0)
    jef = JG.init_ef(jax.tree.map(jnp.asarray, g0))
    pt = jax.tree.map(torch.from_numpy, g0)
    pt["frozen"] = None
    pef = PG.init_ef(pt)
    assert pef.residual["frozen"] is None
    for _, r in PP.leaves(pef.residual):
        assert r.dtype == torch.float32 and not r.any()
    for rnd in range(3):
        g = _grad_tree(rs, rnd + 1.0)
        jg = jax.tree.map(jnp.asarray, g)
        jg["blk"]["e"] = jg["blk"]["e"].astype(jnp.bfloat16)
        pg = jax.tree.map(torch.from_numpy, g)
        pg["blk"]["e"] = pg["blk"]["e"].bfloat16()
        pg["frozen"] = None
        old = {"/".join(p): r.clone() for p, r in PP.leaves(pef.residual)}
        jc, jef = JG.compress_with_ef(jg, jef, codec, topk_frac=0.1)
        pc, pef = PG.compress_with_ef(pg, pef, codec, topk_frac=0.1)
        assert pc["frozen"] is None and pef.residual["frozen"] is None
        for path, c in PP.leaves(pc):
            key = "/".join(path)
            want_c, want_r = jc, jef.residual
            for k in path:
                want_c, want_r = want_c[k], want_r[k]
            r = dict(PP.leaves(pef.residual))[path]
            assert c.dtype == r.dtype == torch.float32
            np.testing.assert_array_equal(c.numpy(), np.asarray(want_c), key)
            np.testing.assert_array_equal(r.numpy(), np.asarray(want_r), key)
            gin = dict(PP.leaves(pg))[path].float() + old[key]
            np.testing.assert_allclose((c + r).numpy(), gin.numpy(),
                                       atol=1e-6 * gin.abs().max().item())


def test_compressed_psum_needs_the_multi_device_slice():
    """The data-parallel reduce needs a process group: without one it
    raises; in a gloo world of one rank it is `compress_with_ef` followed
    by a sum over that one rank (codec "none": the gradients as they
    are).  Worlds of 2 and 4 ranks: tests/test_torch_distributed.py."""
    import torch.distributed as tdist

    from repro_torch.distributed.context import free_port
    g = {"a": torch.linspace(-1, 1, 7), "frozen": None}
    with pytest.raises((RuntimeError, ValueError)):
        PG.compressed_psum(dict(g), None, PG.init_ef(g), "int8")
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        group = tdist.group.WORLD
        for codec in ("int8", "topk"):
            want, want_ef = PG.compress_with_ef(g, PG.init_ef(g), codec, 0.3)
            got, ef = PG.compressed_psum({"a": g["a"].clone(),
                                          "frozen": None}, group,
                                         PG.init_ef(g), codec, 0.3)
            assert got["frozen"] is None
            assert torch.equal(got["a"], want["a"])
            assert torch.equal(ef.residual["a"], want_ef.residual["a"])
        got, ef = PG.compressed_psum({"a": g["a"].clone()}, group)
        assert ef is None and torch.equal(got["a"], g["a"])
    finally:
        tdist.destroy_process_group()


def _loop_cfgs():
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=128, train_mode="lora",
                compute_dtype="float32")
    return (JCfg(**base, ccm=JCCM(comp_len=2, max_steps=2)),
            PCfg(**base, ccm=PCCM(comp_len=2, max_steps=2)))


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_train_loop_codec_on_one_device_trains_as_none(codec):
    """With ``dist=None`` the reference's step compresses nothing
    (``launch/train.py``: the codec acts on the data-parallel reduce
    only), so 3 steps give the parameters of ``grad_codec="none"`` bit
    for bit; the residual it allocates stays 0.  The port trains the
    same and allocates no residual."""
    jcfg, pcfg = _loop_cfgs()
    ocfg = dict(lr=1e-2, total_steps=20)
    shape = (2, 6, 2, 8)

    def port(c):
        loop = PTR.TrainLoop(pcfg, PM.segment_layout(*shape),
                             PA.AdamWConfig(**ocfg), batch_size=2,
                             device="cpu", grad_codec=c, clock=None)
        loop.run(3, log_every=0)
        return loop

    def ref(c):
        loop = JTR.TrainLoop(jcfg, JM.segment_layout(*shape),
                             JA.AdamWConfig(**ocfg), batch_size=2,
                             grad_codec=c)
        loop.run(3, log_every=0)
        return loop

    p_none, p_codec = port("none"), port(codec)
    assert p_none.ef is None and p_codec.ef is None
    for (path, a), (_, b) in zip(PP.leaves(p_none.tp),
                                 PP.leaves(p_codec.tp)):
        assert torch.equal(a, b), path
    assert [h["loss"] for h in p_none.history] == \
        [h["loss"] for h in p_codec.history]
    j_none, j_codec = ref("none"), ref(codec)
    assert j_none.ef is None and isinstance(j_codec.ef, JG.EFState)
    for a, b in zip(jax.tree.leaves(j_none.tp), jax.tree.leaves(j_codec.tp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not any(np.asarray(r).any()
                   for r in jax.tree.leaves(j_codec.ef.residual))
