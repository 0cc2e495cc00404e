"""Port parity for the kernel ops of the online and training slices: the plain
PyTorch versions (what the ops run for CPU tensors) against the JAX
Pallas wrappers in interpret mode and against ``repro.kernels.ref``, on
the same numpy inputs.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions); here their
launchers' host-side checks and planning are tested.

The training slice's kernel ops (CCM flash attention, kv_cummean) are
at the end of the file.

Tolerances (float32 on the CPU): segmented attention atol 2e-5 (the
Pallas kernel's online softmax against the port's dense softmax over the
concatenation); cond_lora atol 1e-4 at K = 256 (float32 sums in another
order); kv_merge atol 1e-6 (the same float32 arithmetic), also for the
batched merge op (k and v, per-lane weights, a strided ``h``) held lane
by lane against the Pallas kernel; kv_cummean atol 1e-6 forward and
1e-5 for its reverse (float32 sums in another order than jax.vjp's).
"""
import ctypes

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


@pytest.mark.parametrize("weights", ["per_lane", "shared"])
@pytest.mark.parametrize("h_layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("lane_major", [False, True])
def test_kv_merge_update_lanes(lane_major, h_layout, weights):
    """The batched op's plain version (k and v in one call, a weight per
    lane, the lane on axis 0 or 1, h contiguous or a transposed view)
    against the Pallas kernel run on each lane alone (interpret mode)."""
    rs = np.random.default_rng(8)
    L, B, m, H, hd = 3, 4, 2, 2, 8
    lanes = [1.0, 0.5, 1.0 / 3, 0.3]
    a = lanes if weights == "per_lane" else 1.0 / 3
    shape = (B, L, m, H, hd) if lane_major else (L, B, m, H, hd)
    mk, mv = rs.normal(size=(2,) + shape).astype(np.float32)
    # h in the layout of the memory, or the other one seen transposed
    other = (L, B) if lane_major else (B, L)
    hk, hv = rs.normal(size=(2,) + (other if h_layout == "transposed"
                                    else shape[:2]) + shape[2:]
                       ).astype(np.float32)
    th = [_t(x) for x in (hk, hv)]
    if h_layout == "transposed":
        th = [x.transpose(0, 1) for x in th]
        assert not th[0].is_contiguous()
    hk_m, hv_m = (x.numpy() for x in th)         # in the memory's layout
    mems = [_t(mk), _t(mv)]
    out = pops.kv_merge_update_lanes(mems, th, a,
                                     lane_axis=0 if lane_major else 1)
    assert out[0] is mems[0] and out[1] is mems[1]     # in place
    for b in range(B):
        ab = lanes[b] if weights == "per_lane" else a
        for got, mem0, h in ((mems[0], mk, hk_m), (mems[1], mv, hv_m)):
            lane = (lambda x: x[b]) if lane_major else (lambda x: x[:, b])
            want = jops.kv_merge_update(jnp.asarray(lane(mem0)),
                                        jnp.asarray(lane(h)), ab,
                                        interpret=True)
            np.testing.assert_allclose(lane(got).numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


def test_cpu_ops_launch_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    pops.reset_launch_counts()
    pops.kv_merge_update(torch.zeros(4), torch.ones(4), 0.5)
    pops.kv_merge_update_lanes([torch.zeros(2, 3)] * 2, [torch.ones(2, 3)] * 2,
                               [0.5, 0.25], lane_axis=0)
    pops.cond_lora(torch.ones(2, 8), torch.ones(8, 8), torch.ones(1, 8),
                   torch.ones(1, 8), torch.ones(2), 2.0)
    pops.kv_cummean(torch.ones(3, 4))
    q = torch.ones(1, 4, 2, 8)
    pops.ccm_attention(q, q, q, *(pops_info(4),) * 2, 1.0)
    slab = torch.zeros(3, 4)
    pops.session_scatter(slab, [1], pops.session_gather(slab, [0]))
    assert pops.launch_counts() == {
        "segmented_attention": 0, "segmented_attention_splitk": 0,
        "segmented_attention_mma": 0, "cond_lora": 0, "cond_lora_wgmma": 0,
        "kv_merge_update": 0,
        "ccm_attention": 0, "ccm_attention_backward": 0,
        "ccm_attention_mma": 0, "ccm_attention_backward_mma": 0,
        "kv_cummean": 0,
        "kv_cummean_backward": 0, "session_gather": 0, "session_scatter": 0}


@pytest.mark.parametrize("case", ["cpu", "shapes", "lanes_over_max",
                                  "lane_count", "three_pairs", "dtype"])
def test_kv_merge_lanes_launcher_refuses(case):
    """The merge kernel's launcher refuses CPU tensors, tensors of
    different shapes, a lane count other than the lane axis's or above
    MAX_LANES, more than two (mem, h) pairs and dtypes it does not take,
    with a ValueError before any launch."""
    x = torch.zeros(4, 3, 8)
    mems, hs, a, axis, match = [x, x.clone()], [x, x], [0.5] * 4, 0, "CUDA"
    if case == "shapes":
        hs, match = [x, torch.zeros(4, 3, 9)], "one shape"
    elif case == "lanes_over_max":
        big = torch.zeros(pkm.MAX_LANES + 1, 1, 8)
        mems, hs, a = [big], [big], [0.5] * (pkm.MAX_LANES + 1)
        match = "lane weights"
    elif case == "lane_count":
        a, axis, match = [0.5] * 4, 1, "lane weights"
    elif case == "three_pairs":
        mems, hs, match = [x] * 3, [x] * 3, "pairs"
    elif case == "dtype":
        mems, match = [x.half(), x.half()], "float32/bf16"
    with pytest.raises(ValueError, match=match):
        pkm.kv_merge_update_lanes_(mems, hs, a, lane_axis=axis)


def pops_info(S):
    from repro_torch.models.attention import plain_causal_info
    return plain_causal_info(S)


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
    # the tensor-core routes: bf16 cond_lora (wgmma), bf16 segmented
    # attention at Sq 1 (split-K decode) and Sq 3 (mma.sync)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="CUDA"):
        pcl.cond_lora_matmul(torch.zeros(2, 8, dtype=bf),
                             torch.zeros(8, 8, dtype=bf),
                             torch.zeros(1, 8, dtype=bf),
                             torch.zeros(1, 8, dtype=bf), torch.zeros(2), 2.0)
    kv = torch.zeros(1, 4, 2, 8, dtype=bf)
    for sq in (1, 3):
        with pytest.raises(ValueError, match="CUDA"):
            pda.segmented_flash_attention(
                torch.zeros(1, sq, 2, 8, dtype=bf), [dict(k=kv, v=kv)],
                list(range(sq)), [0] * sq, 1.0)


# ---------------------------------------------------------------------------
# the training slice's kernels: CCM flash attention and kv_cummean
# (tolerances: float32 on the CPU, 1e-5 x max|reference| for the forward
# and 1e-4 x max|reference| for gradients, sums taken in another order)
# ---------------------------------------------------------------------------

def _ccm_inputs(rs, B, Hq, Hkv, S, Dh, valid_tail=0):
    from repro.core import masks as JM
    lay = JM.segment_layout(3, 5, 2, S - 3 * 7)
    q = rs.normal(size=(B, Hq, S, Dh)).astype(np.float32)
    k, v = rs.normal(size=(2, B, Hkv, S, Dh)).astype(np.float32)
    idx = np.arange(S, dtype=np.int32)
    seg = np.asarray(lay.seg_ids)
    comp = np.asarray(lay.comp_mask)
    valid = np.ones(S, bool)
    if valid_tail:
        valid[-valid_tail:] = False
    q_idx = idx.copy()
    q_idx[1] = -5                      # row 1 sees no key at all
    return q, k, v, (q_idx, seg, idx, seg, comp, valid)


@pytest.mark.parametrize("Hq,Hkv,S,Dh,pad", [(4, 2, 29, 16, 0),
                                             (2, 2, 33, 8, 3),
                                             (6, 3, 27, 24, 2)])
def test_ccm_attention_matches_pallas_and_reference(Hq, Hkv, S, Dh, pad):
    """The port's plain version against the Pallas kernel (interpret) and
    the reference's oracle; a fully masked row gives exactly 0."""
    from repro.kernels import ccm_attention as jca
    rs = np.random.default_rng(11)
    q, k, v, meta = _ccm_inputs(rs, 2, Hq, Hkv, S, Dh, pad)
    scale = Dh ** -0.5
    got = pref.ccm_attention_ref(_t(q), _t(k), _t(v), *map(_t, meta),
                                 scale).numpy()
    want = np.asarray(jref.ccm_attention_ref(
        *map(jnp.asarray, (q, k, v) + meta), scale))
    # the Pallas kernel needs block multiples: pad as repro's ops.py does
    P = -(-S // 16) * 16
    pad_s = lambda x, fill: np.concatenate(
        [x, np.full((P - S,) + x.shape[1:], fill, x.dtype)])
    qp, kp, vp = (np.pad(x, ((0, 0), (0, 0), (0, P - S), (0, 0)))
                  for x in (q, k, v))
    q_idx, q_seg, k_idx, k_seg, k_comp, k_val = meta
    kern = np.asarray(jca.ccm_flash_attention(
        *map(jnp.asarray, (qp, kp, vp)),
        jnp.asarray(pad_s(q_idx, -2 ** 30)), jnp.asarray(pad_s(q_seg, -3)),
        jnp.asarray(pad_s(k_idx, 2 ** 30)), jnp.asarray(pad_s(k_seg, -2)),
        jnp.asarray(pad_s(k_comp.astype(np.int32), 0)),
        jnp.asarray(pad_s(k_val.astype(np.int32), 0)), scale,
        block_q=16, block_k=16, interpret=True))[:, :, :S]
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, kern, atol=tol, rtol=0)
    assert (got[:, :, 1] == 0).all()


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (2, 2)])
def test_ccm_attention_gradients_match_jax_grad(Hq, Hkv):
    """Autograd through the port's plain version (the plain backward the
    CUDA backward kernel is held to) against jax.grad of the oracle."""
    import jax
    rs = np.random.default_rng(12)
    q, k, v, meta = _ccm_inputs(rs, 2, Hq, Hkv, 25, 16, 2)
    g = rs.normal(size=q.shape).astype(np.float32)
    scale = 0.25

    def jloss(q, k, v):
        o = jref.ccm_attention_ref(q, k, v, *map(jnp.asarray, meta), scale)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = pref.ccm_attention_ref(tq, tk, tv, *map(_t, meta), scale)
    got = torch.autograd.grad((out * _t(g)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-4 * np.abs(b).max(), rtol=0)


def test_ccm_attention_op_layout_and_grads():
    """ops.ccm_attention takes (B, S, H, D) like repro's wrapper and is
    differentiable; its CPU path is the plain version."""
    from repro.kernels import ops as jo
    from repro.models.attention import KeyInfo as JK
    from repro_torch.models.attention import KeyInfo as PK
    rs = np.random.default_rng(13)
    q, k, v, meta = _ccm_inputs(rs, 2, 4, 2, 30, 16)
    qs, ks, vs = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    qi = (meta[0], meta[1], np.zeros(30, bool))
    ki = (meta[2], meta[3], meta[4], meta[5])
    want = np.asarray(jo.ccm_attention(
        *map(jnp.asarray, (qs, ks, vs)), JK(*map(jnp.asarray, qi)),
        JK(*map(jnp.asarray, ki)), 0.25, block_q=16, block_k=16,
        interpret=True))
    tq = _t(qs).requires_grad_(True)
    got = pops.ccm_attention(tq, _t(ks), _t(vs), PK(*map(_t, qi)),
                             PK(*map(_t, ki)), 0.25)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    (gq,) = torch.autograd.grad(got.sum(), (tq,))
    assert gq.shape == tq.shape and torch.isfinite(gq).all()


@pytest.mark.parametrize("shape", [(7, 33), (16, 2, 3, 8), (1, 5)])
def test_kv_cummean_matches_pallas(shape):
    rs = np.random.default_rng(14)
    h = rs.normal(size=shape).astype(np.float32)
    got = pops.kv_cummean(_t(h)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.kv_cummean(jnp.asarray(h), interpret=True)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jref.kv_cummean_ref(
        jnp.asarray(h))), atol=1e-6, rtol=0)


def test_kv_cummean_dim_and_reverse_gradient():
    """Along another axis; the plain backward is the reverse pass
    dh[t] = sum_{j>=t} g[j] / (j+1)."""
    rs = np.random.default_rng(15)
    h = rs.normal(size=(3, 6, 10)).astype(np.float32)
    g = rs.normal(size=h.shape).astype(np.float32)
    th = _t(h).requires_grad_(True)
    out = pops.kv_cummean(th, dim=1)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.cumsum(h, 1) / np.arange(1, 7)[:, None],
                               atol=1e-6, rtol=0)
    (dh,) = torch.autograd.grad((out * _t(g)).sum(), (th,))
    w = g / np.arange(1, 7)[:, None]
    want = np.flip(np.cumsum(np.flip(w, 1), 1), 1)
    np.testing.assert_allclose(dh.numpy(), want, atol=1e-5, rtol=0)


def test_ccm_and_cummean_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import ccm_attention as pca
    x = torch.zeros(1, 2, 8, 8)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        pca.ccm_attention_fwd(x, x, x, z, z, z, z, z, None, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        pkm.kv_cummean_launch([torch.zeros(2, 3, 4)])


# kv_cummean's k + v pair (one kernel launch on the card): the plain pair
# and the plain reverse on the (N, T, R) views the kernel is given, held
# against the Pallas kernel (interpret mode), the JAX reference and its
# jax.vjp, on the same numpy inputs.  Cases: contiguous; the strided
# <COMP> groups of two (B, S, H, D) activations (the training call); a
# gradient sliced out of a larger one (its row stride is not T * R, as
# when it comes from torch.cat's backward); T = 1; T = 37.
CUMMEAN_CASES = ["contiguous", "comp_groups", "grad_slice", "t1", "t37"]


def _cummean_case(case):
    """(hk, hv, gk, gv): torch (N, T, R) views of numpy inputs."""
    from repro_torch.core import masks as PM
    rs = np.random.default_rng(CUMMEAN_CASES.index(case) + 40)
    shapes = {"contiguous": (3, 6, 20), "grad_slice": (2, 5, 12),
              "t1": (2, 1, 12), "t37": (2, 37, 10), "comp_groups": None}
    if case == "comp_groups":
        lay = PM.segment_layout(4, 8, 2, 8)
        x = _t(rs.normal(size=(2, 2, lay.seq_len, 3, 8)).astype(np.float32))
        hk, hv = (PM._comp_groups(x[i], lay.comp_mask, 4, 2) for i in (0, 1))
        assert hk._base is not None and not hk.is_contiguous()
    else:
        hk, hv = _t(rs.normal(size=(2,) + shapes[case]).astype(np.float32))
    N, T, R = hk.shape
    if case == "grad_slice":
        big = _t(rs.normal(size=(2, N, T + 3, R)).astype(np.float32))
        gk, gv = big[0, :, :T], big[1, :, :T]
        assert gk.stride(0) != T * R
    else:
        gk, gv = _t(rs.normal(size=(2, N, T, R)).astype(np.float32))
    return hk, hv, gk, gv


def _time_first(x):
    """(N, T, R) -> the (T, N, R) layout the JAX functions take."""
    return jnp.asarray(np.moveaxis(np.asarray(x), 1, 0))


@pytest.mark.parametrize("case", CUMMEAN_CASES)
def test_kv_cummean_pair_plain_matches_pallas(case):
    """The plain pair (the k + v op on CPU tensors) against the Pallas
    kernel in interpret mode and the JAX reference: atol 1e-6."""
    hk, hv, _, _ = _cummean_case(case)
    pops.reset_launch_counts()
    got = pops.kv_cummean_pair(hk, hv, dim=1)
    assert pops.launch_counts()["kv_cummean"] == 0
    for out, h in zip(got, (hk, hv)):
        assert out.shape == h.shape
        jh = _time_first(h)
        for want in (jops.kv_cummean(jh, interpret=True),
                     jref.kv_cummean_ref(jh)):
            np.testing.assert_allclose(
                out.numpy(), np.moveaxis(np.asarray(want), 0, 1), atol=1e-6,
                rtol=0)


@pytest.mark.parametrize("case", CUMMEAN_CASES)
def test_kv_cummean_reverse_plain_matches_jax_vjp(case):
    """The plain reverse dh[t] = sum_{j>=t} g[j] / (j+1) against jax.vjp
    of the JAX reference, and the CPU pair op's autograd against the
    plain reverse: atol 1e-5."""
    import jax
    hk, hv, gk, gv = _cummean_case(case)
    hs = [h.clone().requires_grad_(True) for h in (hk, hv)]
    outs = pops.kv_cummean_pair(*hs, dim=1)
    dhs = torch.autograd.grad(outs, hs, (gk, gv))
    for h, g, dh in zip((hk, hv), (gk, gv), dhs):
        got = pref.kv_cummean_reverse_ref(g, dim=1)
        assert got.shape == g.shape
        _, vjp = jax.vjp(jref.kv_cummean_ref, _time_first(h))
        (want,) = vjp(_time_first(g))
        want = np.moveaxis(np.asarray(want), 0, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(dh.numpy(), got.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("case", ["cpu", "shapes", "three", "dtype"])
def test_kv_cummean_launcher_refuses(case):
    """The running-mean kernel's launcher refuses CPU tensors, tensors of
    different shapes, more than two tensors and dtypes it does not take,
    with a ValueError before any launch."""
    x = torch.zeros(2, 4, 8)
    hs, match = [x, x.clone()], "CUDA"
    if case == "shapes":
        hs, match = [x, torch.zeros(2, 4, 9)], "one shape"
    elif case == "three":
        hs, match = [x] * 3, "1 or 2"
    elif case == "dtype":
        hs, match = [x.half(), x.half()], "float32/bf16"
    with pytest.raises(ValueError, match=match):
        pkm.kv_cummean_launch(hs, reverse=case == "three")


def _aligned(shape, dtype):
    """A tensor of ``shape`` whose data starts on a 64-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 64, dtype=dtype)
    off = (-buf.data_ptr() % 64) // buf.element_size()
    return buf[off:off + n].view(shape)


@pytest.mark.parametrize("case,want", [
    ("bf16", 8), ("float32", 4), ("pair_own_strides", 8), ("r185", 1),
    ("base_2_bytes_off", 1), ("step_stride_off", 1)])
def test_kv_cummean_vector_width(case, want):
    """The wrapper's route: 16-byte accesses when R is a multiple of 16
    bytes' worth and every base and stride is 16-byte aligned; else the
    one-element path."""
    bf = torch.bfloat16
    hs = [_aligned((2, 5, 64), bf)] * 2
    if case == "float32":
        hs = [_aligned((2, 5, 64), torch.float32)]
    elif case == "pair_own_strides":      # a strided slice and a plain one
        hs = [_aligned((2, 7, 64), bf)[:, 1:6], _aligned((2, 5, 64), bf)]
    elif case == "r185":
        hs = [_aligned((2, 5, 185), bf)] * 2
    elif case == "base_2_bytes_off":
        hs = [_aligned((2, 5, 64), bf), _aligned((2 * 5 * 64 + 8,), bf)[1:641]
              .view(2, 5, 64)]
    elif case == "step_stride_off":       # T stride of 68 bf16 = 136 bytes
        hs = [_aligned((2, 5, 68), bf)[:, :, :64]] * 2
    assert pkm.cummean_vector_width(hs) == want


def test_kv_cummean_params_pack():
    """The parameter struct of a k + v launch carries each tensor's own
    pointers and (row, step) strides, the shape, the direction, the
    dtype and the route, in the C layout's order."""
    bf = torch.bfloat16
    hk = _aligned((3, 9, 64), bf)[:, 2:7]           # strides (576, 64, 1)
    hv = _aligned((3, 5, 64), bf)                   # strides (320, 64, 1)
    outs = [torch.empty(3, 5, 64, dtype=bf) for _ in range(2)]
    p = pkm._cummean_params([hk, hv], outs, reverse=True)
    assert list(p.h) == [hk.data_ptr(), hv.data_ptr()]
    assert list(p.out) == [o.data_ptr() for o in outs]
    assert list(p.s_n) == [576, 320] and list(p.s_t) == [64, 64]
    assert (p.R, p.N, p.T, p.n_tensors, p.reverse, p.bf16, p.vec) == \
        (64, 3, 5, 2, 1, 1, 8)
    one = pkm._cummean_params([hv[:1, :1]], outs[:1], reverse=False)
    assert list(one.s_n) == [0, 0] and list(one.s_t) == [0, 0]
    assert (one.N, one.T, one.n_tensors, one.reverse) == (1, 1, 1, 0)
    assert ctypes.sizeof(pkm._CumMeanParams) == pkm._CUM.size


@pytest.mark.parametrize("bias", [False, True])
def test_cond_lora_backward_formula_matches_autograd(bias):
    """The matmul backward of the kernel's autograd.Function (called
    directly: its forward needs the card) against autograd through the
    plain version: dx, dA, dB and dbias (float32, atol 1e-5 x max)."""
    import types
    rs = np.random.default_rng(16)
    x, dy = (_t(rs.normal(size=s).astype(np.float32)) for s in ((24, 40),
                                                             (24, 32)))
    w = _t(rs.normal(size=(40, 32)).astype(np.float32))
    a = _t(rs.normal(size=(4, 40)).astype(np.float32))
    b = _t(rs.normal(size=(4, 32)).astype(np.float32))
    bb = _t(rs.normal(size=(32,)).astype(np.float32)) if bias else None
    gate = (torch.arange(24) % 3 == 0).float()
    ctx = types.SimpleNamespace(saved_tensors=(x, w, a, b, gate), scale=2.0,
                                has_bias=bias,
                                needs_input_grad=(True, False, True, True,
                                                  False, False, bias))
    got = pcl._CondLoRA.backward(ctx, dy)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    if bias:
        leaves.append(bb.clone().requires_grad_(True))
    y = pref.cond_lora_ref(leaves[0], w, leaves[1], leaves[2], gate, 2.0,
                           leaves[3] if bias else None)
    want = torch.autograd.grad(y, leaves, dy)
    for g, wv in zip([got[0], got[2], got[3]] + ([got[6]] if bias else []),
                     want):
        np.testing.assert_allclose(g.numpy(), wv.numpy(),
                                   atol=1e-5 * wv.abs().max().item(), rtol=0)
    assert got[1] is None and got[4] is None and got[5] is None


def test_cond_lora_refuses_trainable_w():
    """W was frozen (a trainable W raised) until full training came to the
    card; a W that requires a gradient now gets dW = x^T dy from the
    Function's backward (called directly: its forward needs the card),
    against autograd through the plain version (float32, atol 1e-5 x
    max), and a frozen W still gets none."""
    import types
    rs = np.random.default_rng(17)
    x, dy = (_t(rs.normal(size=s).astype(np.float32)) for s in ((24, 40),
                                                             (24, 32)))
    w = _t(rs.normal(size=(40, 32)).astype(np.float32))
    a = _t(rs.normal(size=(4, 40)).astype(np.float32))
    b = _t(rs.normal(size=(4, 32)).astype(np.float32))
    gate = (torch.arange(24) % 3 == 0).float()
    need = (True, True, True, True, False, False, False)
    ctx = types.SimpleNamespace(saved_tensors=(x, w, a, b, gate), scale=2.0,
                                has_bias=False, needs_input_grad=need)
    got = pcl._CondLoRA.backward(ctx, dy)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, a, b)]
    y = pref.cond_lora_ref(leaves[0], leaves[1], leaves[2], leaves[3], gate,
                           2.0)
    want = torch.autograd.grad(y, leaves, dy)
    for g, wv in zip(got[:4], want):
        np.testing.assert_allclose(g.numpy(), wv.numpy(),
                                   atol=1e-5 * wv.abs().max().item(), rtol=0)
    ctx.needs_input_grad = (True, False) + need[2:]
    assert pcl._CondLoRA.backward(ctx, dy)[1] is None
