"""The port's synthetic data (``repro_torch.data.synthetic``).  Its draws
come from a ``torch.Generator`` and differ from the reference's
``jax.random`` numbers, so the checks are of properties: the same layout
and loss mask as ``repro``, <COMP> tokens exactly at the layout's comp
positions, every tail answer equal to the identity's value for its key,
``query_pool="ctx"`` keys shown in context, ``"all"`` keys distinct, and
a restartable, seed-determined iterator."""
import jax
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.data.synthetic import sample_kv_batch as jsample
from repro_torch.core import masks as PM
from repro_torch.data import synthetic as PD

LAYOUTS = [(4, 8, 2, 8), (16, 64, 8, 64), (3, 7, 1, 6)]


@pytest.mark.parametrize("t,lc,m,tail", LAYOUTS)
@pytest.mark.parametrize("pool", ["ctx", "all"])
def test_batch_structure(t, lc, m, tail, pool):
    task = PD.KVTaskConfig()
    pl = PM.segment_layout(t, lc, m, tail)
    jb = jsample(jax.random.PRNGKey(0), JM.segment_layout(t, lc, m, tail), 3,
                 query_pool=pool)
    b = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 3).key_for(0), pl, 3,
                           task, query_pool=pool, device="cpu")
    toks, lm = b["tokens"].numpy(), b["loss_mask"].numpy()
    assert toks.shape == np.asarray(jb["tokens"]).shape
    assert toks.dtype == np.int32
    assert np.array_equal(lm, np.asarray(jb["loss_mask"]))
    comp = pl.comp_mask.numpy()
    assert (toks[:, comp] == PD.COMP).all()
    assert (toks[:, ~comp] != PD.COMP).all()
    body = toks[:, :t * (lc + m)].reshape(3, t, lc + m)[:, :, :lc]
    n_pairs = lc // 2
    keys = body[:, :, 0:2 * n_pairs:2] - 4
    vals = body[:, :, 1:2 * n_pairs:2] - 4 - task.n_keys
    assert ((keys >= 0) & (keys < task.n_keys)).all()
    assert ((vals >= 0) & (vals < task.n_vals)).all()
    if lc > 2 * n_pairs:
        assert (body[:, :, 2 * n_pairs:] == PD.SEP).all()
    tail_t = toks[:, t * (lc + m):]
    n_q = tail // 2
    qk = tail_t[:, 0:2 * n_q:2] - 4
    qv = tail_t[:, 1:2 * n_q:2] - 4 - task.n_keys
    for i in range(3):
        mapping = {}
        for k, v in zip(keys[i].ravel(), vals[i].ravel()):
            assert mapping.setdefault(k, v) == v       # one identity
        assert len(set(keys[i, 0])) == n_pairs        # distinct per chunk
        for k, v in zip(qk[i], qv[i]):
            if pool == "ctx":
                assert mapping[k] == v                # answer in context
            elif k in mapping:
                assert mapping[k] == v
        if pool == "all":
            assert len(set(qk[i])) == n_q
    # loss positions predict the values that follow query keys
    pos = np.nonzero(lm[0])[0]
    assert np.array_equal(pos, np.arange(0, 2 * n_q - 1, 2))


def test_iterator_is_seed_determined_and_restartable():
    pl = PM.segment_layout(4, 8, 2, 8)
    it = PD.ShardableIndexIterator(5, 2)
    a = [PD.sample_kv_batch(it.next_key(), pl, 2, device="cpu")["tokens"]
         for _ in range(4)]
    st = it.state_dict()
    assert st == {"step": 4, "seed": 5}
    it2 = PD.ShardableIndexIterator(0, 2)
    it2.load_state_dict({"step": 2, "seed": 5})
    b = PD.sample_kv_batch(it2.next_key(), pl, 2, device="cpu")["tokens"]
    assert torch.equal(a[2], b)
    assert not torch.equal(a[0], a[1])
    other_host = PD.ShardableIndexIterator(5, 2, n_hosts=2, host_id=1)
    c = PD.sample_kv_batch(other_host.key_for(0), pl, 2,
                           device="cpu")["tokens"]
    assert not torch.equal(a[0], c)


def test_unknown_query_pool_raises():
    pl = PM.segment_layout(2, 4, 1, 4)
    with pytest.raises(ValueError):
        PD.sample_kv_batch(torch.Generator(), pl, 1, query_pool="x",
                           device="cpu")
