"""Port parity for the three kernel ops of the online slice: the plain
PyTorch versions (what the ops run for CPU tensors) against the JAX
Pallas wrappers in interpret mode and against ``repro.kernels.ref``, on
the same numpy inputs.  The CUDA/Triton kernels themselves run only on
the card (``chip_smoke.py`` holds them against these plain versions).

Tolerances (float32 on the CPU): segmented attention atol 2e-5 (the
Pallas kernel's online softmax against the port's dense softmax over the
concatenation); cond_lora atol 1e-4 at K = 256 (float32 sums in another
order); kv_merge atol 1e-6 (the same float32 arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as JI
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cond_lora as pcl
from repro_torch.kernels import decode_attention as pda
from repro_torch.kernels import kv_merge as pkm
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

D = 16
SCALE = 1.0 / D ** 0.5


def _t(x):
    """numpy/jax -> torch (CPU), keeping ints and bools."""
    return None if x is None else torch.from_numpy(np.array(x))


def _seg(k, v, length=None, layer=None, k_scale=None, v_scale=None,
         lane_major=False, idx=None, seg=None, comp=None, valid=None):
    return dict(k=k, v=v, length=length, layer=layer, k_scale=k_scale,
                v_scale=v_scale, lane_major=lane_major, idx=idx, seg=seg,
                comp=comp, valid=valid)


def _to_jax(s):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in s.items()}


def _to_torch(s):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in s.items()}


def _run_both(q, segs, q_idx, q_seg, lanes_oracle=False):
    """(port plain, JAX Pallas interpret, JAX ref oracle) outputs."""
    out_t = pops.segmented_attention(_t(q), [_to_torch(s) for s in segs],
                                     _t(q_idx), _t(q_seg), SCALE).numpy()
    jsegs = [_to_jax(s) for s in segs]
    out_k = np.asarray(jops.segmented_attention(
        jnp.asarray(q), jsegs, jnp.asarray(q_idx), jnp.asarray(q_seg), SCALE,
        interpret=True))
    oracle = jref.segmented_attention_lanes_ref if lanes_oracle \
        else jref.segmented_attention_ref
    out_r = np.asarray(oracle(jnp.asarray(q), jsegs, jnp.asarray(q_idx),
                              jnp.asarray(q_seg), SCALE))
    return out_t, out_k, out_r


def _check(out_t, out_k, out_r, atol=2e-5):
    np.testing.assert_allclose(out_t, out_k, atol=atol, rtol=0)
    np.testing.assert_allclose(out_t, out_r, atol=atol, rtol=0)


def _self(rs, B, Sq, Hkv):
    k, v = rs.normal(size=(2, B, Sq, Hkv, D)).astype(np.float32)
    ar = np.arange(Sq, dtype=np.int32)
    return ar, _seg(k, v, idx=ar, seg=np.ones(Sq, np.int32),
                    comp=np.zeros(Sq, bool))


# (Hq, Hkv, mem_S, mem_len, cache_S, cache_len, Sq): the layouts of
# tests/test_decode_attention.py
LAYOUTS = [
    (4, 2, 0, 0, 0, 0, 9),
    (4, 2, 16, 10, 0, 0, 9),
    (4, 2, 16, 16, 96, 40, 9),
    (8, 1, 16, 2, 100, 77, 5),
    (4, 4, 16, 0, 64, 0, 7),
    (4, 2, 16, 16, 64, 64, 1),
]


@pytest.mark.parametrize("case", LAYOUTS)
def test_segmented_layouts(case):
    Hq, Hkv, mS, mL, cS, cL, Sq = case
    rs = np.random.default_rng(sum(case))
    B = 2
    q = rs.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    segs = []
    if mS:
        mk, mv = rs.normal(size=(2, B, mS, Hkv, D)).astype(np.float32)
        segs.append(_seg(mk, mv, length=mL))
    if cS:
        ck, cv = rs.normal(size=(2, B, cS, Hkv, D)).astype(np.float32)
        segs.append(_seg(ck, cv, length=cL))
    ar, s = _self(rs, B, Sq, Hkv)
    segs.append(s)
    _check(*_run_both(q, segs, ar, np.ones(Sq, np.int32)))


def _int8(x):
    q8, sc = JI.quantize_kv(jnp.asarray(x))
    return np.asarray(q8), np.asarray(sc)


@pytest.mark.parametrize("layer", [0, 2])
def test_segmented_int8_layer_major(layer):
    """int8 stacked cache (L, B, S, Hkv, D) read at one layer, unaligned
    valid length, plus a memory segment and a ragged self segment."""
    rs = np.random.default_rng(7 + layer)
    B, Hq, Hkv, Sq, Lyr, cS = 2, 4, 2, 6, 3, 40
    q = rs.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    mk, mv = rs.normal(size=(2, B, 8, Hkv, D)).astype(np.float32)
    ck8, cks = _int8(rs.normal(size=(Lyr, B, cS, Hkv, D)))
    cv8, cvs = _int8(rs.normal(size=(Lyr, B, cS, Hkv, D)))
    ar, s = _self(rs, B, Sq, Hkv)
    s["valid"] = ar < Sq - 2
    segs = [_seg(mk, mv, length=5),
            _seg(ck8, cv8, length=29, layer=layer, k_scale=cks, v_scale=cvs),
            s]
    _check(*_run_both(q, segs, ar, np.ones(Sq, np.int32)))


def test_segmented_lane_major_per_lane_lengths():
    """Lane-major int8 stack (B, L, S, Hkv, D) with per-lane lengths,
    per-lane layer ids and per-lane metadata (the serve-lane schema)."""
    rs = np.random.default_rng(11)
    B, Hq, Hkv, Lyr, cS = 3, 4, 2, 2, 50
    q = rs.normal(size=(B, 1, Hq, D)).astype(np.float32)
    ck8, cks = _int8(rs.normal(size=(B, Lyr, cS, Hkv, D)))
    cv8, cvs = _int8(rs.normal(size=(B, Lyr, cS, Hkv, D)))
    mk, mv = rs.normal(size=(2, B, 4, Hkv, D)).astype(np.float32)
    sk, sv = rs.normal(size=(2, B, 1, Hkv, D)).astype(np.float32)
    lens = np.array([0, 17, 50], np.int32)
    layers = np.array([1, 0, 1], np.int32)
    qi = np.full((B, 1), 2 ** 30, np.int32)
    segs = [_seg(mk, mv, length=np.array([4, 0, 2], np.int32)),
            _seg(ck8, cv8, length=lens, layer=layers, k_scale=cks,
                 v_scale=cvs, lane_major=True),
            _seg(sk, sv, idx=qi.copy(), seg=np.ones((B, 1), np.int32),
                 comp=np.zeros((B, 1), bool))]
    _check(*_run_both(q, segs, qi, np.ones((B, 1), np.int32),
                      lanes_oracle=True))


def test_segmented_fully_masked_row_is_zero():
    """A q row that sees no key (index below every key, no memory keys)
    gives exactly 0, never NaN."""
    rs = np.random.default_rng(3)
    B, Hq, Hkv, Sq = 2, 4, 2, 4
    q = rs.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    mk, mv = rs.normal(size=(2, B, 8, Hkv, D)).astype(np.float32)
    ar, s = _self(rs, B, Sq, Hkv)
    qi = ar.copy()
    qi[1] = -5                      # row 1 precedes every self key
    segs = [_seg(mk, mv, length=0), s]
    out_t, out_k, out_r = _run_both(q, segs, qi, np.ones(Sq, np.int32))
    _check(out_t, out_k, out_r)
    assert np.all(out_t[:, 1] == 0) and np.isfinite(out_t).all()


@pytest.mark.parametrize("M,K,N,r", [(40, 256, 96, 8), (128, 128, 128, 4)])
def test_cond_lora(M, K, N, r):
    rs = np.random.default_rng(M + r)
    x = rs.normal(size=(M, K)).astype(np.float32)
    w = (rs.normal(size=(K, N)) / 16).astype(np.float32)
    a = (rs.normal(size=(r, K)) / 16).astype(np.float32)
    b = (rs.normal(size=(r, N)) / 4).astype(np.float32)
    g = (rs.random(M) < 0.3).astype(np.float32)
    out_t = pops.cond_lora(_t(x), _t(w), _t(a), _t(b), _t(g), 2.0).numpy()
    out_k = np.asarray(jops.cond_lora(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(g), 2.0, 32, 32, 64, interpret=True))
    out_r = np.asarray(jref.cond_lora_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(g), 2.0))
    _check(out_t, out_k, out_r, atol=1e-4)


def test_cond_lora_gate_zero_is_base_matmul():
    rs = np.random.default_rng(1)
    x = rs.normal(size=(32, 64)).astype(np.float32)
    w = rs.normal(size=(64, 48)).astype(np.float32)
    a = rs.normal(size=(4, 64)).astype(np.float32)
    b = rs.normal(size=(4, 48)).astype(np.float32)
    bias = rs.normal(size=(48,)).astype(np.float32)
    out = pops.cond_lora(_t(x), _t(w), _t(a), _t(b), torch.zeros(32), 2.0,
                         bias=_t(bias)).numpy()
    np.testing.assert_allclose(out, x @ w + bias, atol=1e-4, rtol=0)


@pytest.mark.parametrize("alpha", [None, 0.3])
def test_kv_merge_update(alpha):
    """t = 1..5 in place, against the Pallas kernel and the running mean."""
    rs = np.random.default_rng(5)
    hs = rs.normal(size=(5, 2, 3, 4, 16)).astype(np.float32)
    mem_t = torch.zeros(2, 3, 4, 16)
    mem_j = jnp.zeros((2, 3, 4, 16))
    for t in range(1, 6):
        a = (1.0 / t) if alpha is None else (1.0 if t == 1 else alpha)
        out = pops.kv_merge_update(mem_t, _t(hs[t - 1]), a)
        assert out is mem_t                      # written in place
        mem_j = jops.kv_merge_update(mem_j, jnp.asarray(hs[t - 1]), a,
                                     interpret=True)
        np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j),
                                   atol=1e-6, rtol=0)
        if alpha is None:
            np.testing.assert_allclose(mem_t.numpy(), hs[:t].mean(0),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(
                np.asarray(jref.kv_merge_ref(jnp.asarray(hs[t - 2] if t > 1
                                                         else hs[0] * 0),
                                             jnp.asarray(hs[t - 1]),
                                             jnp.asarray(t))),
                pref.kv_merge_ref(_t(hs[t - 2] if t > 1 else hs[0] * 0),
                                  _t(hs[t - 1]), 1.0 / t).numpy(),
                atol=1e-6, rtol=0)


def test_cpu_ops_launch_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    pops.reset_launch_counts()
    pops.kv_merge_update(torch.zeros(4), torch.ones(4), 0.5)
    pops.cond_lora(torch.ones(2, 8), torch.ones(8, 8), torch.ones(1, 8),
                   torch.ones(1, 8), torch.ones(2), 2.0)
    assert pops.launch_counts() == {"segmented_attention": 0, "cond_lora": 0,
                                    "kv_merge_update": 0}


def test_kernel_launchers_refuse_cpu_tensors():
    """The kernel entry points never compute on the CPU."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        pcl.cond_lora_matmul(x, torch.zeros(8, 8), torch.zeros(1, 8),
                             torch.zeros(1, 8), torch.zeros(2), 2.0)
    with pytest.raises(ValueError):
        pkm.kv_merge_update_(x, x, 0.5)
    with pytest.raises(ValueError):
        pda.segmented_flash_attention(torch.zeros(1, 1, 2, 8), [], [0], [0],
                                      1.0)
