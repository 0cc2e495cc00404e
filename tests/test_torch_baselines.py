"""Port parity for the paper's §4.1 baselines (``repro_torch.core.baselines``
against ``repro.core.baselines``) and the dense path's leftovers: the
plain ``attend_chunked``, ``mem_key_info``, ``masks.causal_mask`` /
``apply_mask`` and the lane-loop oracle ``segmented_attention_lanes_ref``,
on the same numpy inputs.  The baselines' training forward, loss,
gradients and AdamW steps are held in ``test_torch_train.py``.

Tolerances: masks equal; pooled slots within 1e-6 in float32 and within
one bf16 ulp of max|slot| in bf16 (both means accumulate in float32 and
round once); ``attend_chunked`` atol 1e-5 (float32, the same blocked
online softmax); the lanes oracle atol 2e-5 (the reference's dense
softmax against the port's, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import masks as JM
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro_torch.core import baselines as PB
from repro_torch.core import masks as PM
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as PA

# (t_steps, chunk_len, comp_len, tail_len): tiny_layout's shape, a chunk
# that does not divide by comp_len (the reference drops the trailing raw
# tokens), a single step and a pool of one
LAYOUTS = [(4, 8, 2, 8), (3, 7, 2, 5), (1, 6, 3, 4), (2, 2, 2, 3)]


def _layouts(shape):
    return JM.segment_layout(*shape), PM.segment_layout(*shape)


@pytest.mark.parametrize("shape", LAYOUTS)
def test_baseline_masks_match_reference(shape):
    jl, pl = _layouts(shape)
    t, _, m, _ = shape
    gist = PB.gisting_online_mask(pl.seg_ids, pl.comp_mask, t)
    assert gist.dtype == torch.bool and gist.shape == (pl.seq_len,) * 2
    np.testing.assert_array_equal(
        gist.numpy(), np.asarray(JB.gisting_online_mask(jl.seg_ids,
                                                        jl.comp_mask, t)))
    slots = PB.compressive_slot_mask(pl.seg_ids, t, m)
    assert slots.shape == (pl.seq_len, t * m)
    np.testing.assert_array_equal(
        slots.numpy(), np.asarray(JB.compressive_slot_mask(jl.seg_ids, t, m)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LAYOUTS)
def test_compressive_virtual_kv_matches_reference(shape, dtype):
    jl, pl = _layouts(shape)
    t, _, m, _ = shape
    rs = np.random.default_rng(sum(shape))
    B, H, D = 2, 3, 8
    k, v = (rs.normal(size=(B, pl.seq_len, H, D)).astype(np.float32)
            for _ in range(2))
    jk, jv = JB.compressive_virtual_kv(
        jnp.asarray(k, dtype), jnp.asarray(v, dtype), jl.seg_ids,
        jl.comp_mask, t, m)
    tdt = getattr(torch, dtype)
    index = PB.compressive_pool_index(pl.seg_ids, pl.comp_mask, t, m)
    pool = (shape[1] // m)
    assert index.shape == (t, m, pool)
    assert not pl.comp_mask[index.reshape(-1)].any()
    pk, pv = PB.compressive_virtual_kv(
        torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), index)
    for got, want in ((pk, jk), (pv, jv)):
        assert got.dtype == tdt and got.shape == (B, t * m, H, D)
        want = np.asarray(want.astype(jnp.float32))
        tol = 1e-6 if dtype == "float32" \
            else float(np.abs(want).max()) * 2.0 ** -8
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=0)


def test_compressive_pool_index_refuses_a_ragged_layout():
    seg = torch.tensor([1, 1, 1, 1, 2, 2, 2, 3], dtype=torch.int32)
    comp = torch.tensor([0, 0, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    with pytest.raises(ValueError, match="uniform"):
        PB.compressive_pool_index(seg, comp, 2, 2)


def _infos(rs, Sq, Sk, n_seg):
    q_idx = np.arange(Sk - Sq, Sk).astype(np.int32)
    q_seg = rs.integers(0, n_seg, Sq).astype(np.int32)
    k_idx = np.arange(Sk).astype(np.int32)
    k_idx[:3] = -1                                      # memory-like keys
    k_seg = rs.integers(0, n_seg, Sk).astype(np.int32)
    k_comp = rs.random(Sk) < 0.3
    valid = rs.random(Sk) < 0.85
    return q_idx, q_seg, k_idx, k_seg, k_comp, valid


@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,qc,kc", [
    (4, 2, 13, 29, 4, 8),      # both axes padded, GQA
    (2, 2, 16, 16, 8, 8),      # no padding, MHA
    (3, 1, 5, 40, 16, 16),     # MQA, one q block
    (2, 1, 9, 21, 16, 4)])     # one padded q block, six k blocks
def test_attend_chunked_matches_reference(Hq, Hkv, Sq, Sk, qc, kc):
    rs = np.random.default_rng(Sq * Sk)
    B, D = 2, 8
    q = rs.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rs.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rs.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    qi, qs, ki, ks, kc_, valid = _infos(rs, Sq, Sk, 3)
    t = torch.from_numpy
    qinfo = PA.KeyInfo(t(qi), t(qs), t(np.zeros(Sq, bool)))
    kinfo = PA.KeyInfo(t(ki), t(ks), t(kc_), t(valid))
    got = PA.attend_chunked(t(q), t(k), t(v), qinfo, kinfo, 0.3,
                            q_chunk=qc, k_chunk=kc)
    assert got.shape == (B, Sq, Hq, D)
    want = JA.attend_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        JA.KeyInfo(jnp.asarray(qi), jnp.asarray(qs), jnp.zeros(Sq, bool)),
        JA.KeyInfo(jnp.asarray(ki), jnp.asarray(ks), jnp.asarray(kc_),
                   jnp.asarray(valid)), 0.3, q_chunk=qc, k_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # and the dense masked attend on the same metadata, where no row is
    # fully masked
    mask = PA.mask_from_info(qinfo, kinfo)
    rows = mask.any(-1)
    dense = PA.attend_dense(t(q), t(k), t(v), mask, 0.3)
    np.testing.assert_allclose(got[:, rows].numpy(), dense[:, rows].numpy(),
                               atol=1e-5, rtol=0)


def test_mask_helpers_match_reference():
    for q_len, k_len, off in ((4, 4, 0), (3, 9, 6), (5, 2, -1)):
        np.testing.assert_array_equal(
            PM.causal_mask(q_len, k_len, off).numpy(),
            np.asarray(JM.causal_mask(q_len, k_len, off)))
    rs = np.random.default_rng(0)
    logits = rs.normal(size=(2, 3, 4)).astype(np.float32)
    mask = rs.random((3, 4)) < 0.5
    got = PM.apply_mask(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JM.apply_mask(jnp.asarray(logits), jnp.asarray(mask))))
    valid = np.array([True, False, True])
    for vv in (None, valid):
        got = PA.mem_key_info(3, None if vv is None else torch.from_numpy(vv))
        want = JA.mem_key_info(3, None if vv is None else jnp.asarray(vv))
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                assert a.dtype == {"int32": torch.int32,
                                   "bool": torch.bool}[str(b.dtype)]


def _lane_segs(rs, N, L, Hkv, D):
    """Three segments in the lane schema: a lane-major layered memory with
    per-lane layers and lengths, a layer-major layered cache with a shared
    layer and per-lane lengths and per-lane metadata, and a plain self
    block with shared metadata."""
    S0, S1, S2 = 6, 10, 4
    f = lambda *s: rs.normal(size=s).astype(np.float32)   # noqa: E731
    mem = dict(k=f(N, L, S0, Hkv, D), v=f(N, L, S0, Hkv, D),
               layer=rs.integers(0, L, N).astype(np.int32), lane_major=True,
               length=rs.integers(0, S0 + 1, N).astype(np.int32))
    cache = dict(k=f(L, N, S1, Hkv, D), v=f(L, N, S1, Hkv, D), layer=1,
                 length=rs.integers(1, S1 + 1, N).astype(np.int32),
                 idx=np.tile(np.arange(S1, dtype=np.int32), (N, 1)),
                 seg=rs.integers(0, 2, (N, S1)).astype(np.int32),
                 comp=rs.random((N, S1)) < 0.4,
                 valid=rs.random((N, S1)) < 0.9)
    self_ = dict(k=f(N, S2, Hkv, D), v=f(N, S2, Hkv, D),
                 idx=np.arange(S1, S1 + S2, dtype=np.int32),
                 seg=np.ones(S2, np.int32), comp=np.zeros(S2, bool))
    return [mem, cache, self_]


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (2, 2)])
def test_segmented_attention_lanes_ref_matches_reference(Hq, Hkv):
    rs = np.random.default_rng(Hq)
    N, L, D, Sq = 3, 2, 8, 4
    segs = _lane_segs(rs, N, L, Hkv, D)
    q = rs.normal(size=(N, Sq, Hq, D)).astype(np.float32)
    q_idx = np.tile(np.arange(10, 10 + Sq, dtype=np.int32), (N, 1))
    q_seg = np.ones(Sq, np.int32)

    def conv(s, fn):
        return {k: (fn(v) if isinstance(v, np.ndarray) else v)
                for k, v in s.items()}
    want = jref.segmented_attention_lanes_ref(
        jnp.asarray(q), [conv(s, jnp.asarray) for s in segs],
        jnp.asarray(q_idx), jnp.asarray(q_seg), 0.25)
    got = pref.segmented_attention_lanes_ref(
        torch.from_numpy(q), [conv(s, torch.from_numpy) for s in segs],
        torch.from_numpy(q_idx), torch.from_numpy(q_seg), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    # the port's batched oracle reads the same per-lane schema natively
    batched = pref.segmented_attention_ref(
        torch.from_numpy(q), [conv(s, torch.from_numpy) for s in segs],
        torch.from_numpy(q_idx), torch.from_numpy(q_seg), 0.25)
    np.testing.assert_allclose(got.numpy(), batched.numpy(), atol=2e-5,
                               rtol=0)
