"""Port parity for the kernel ops of the online and training slices: the plain
PyTorch versions (what the ops run for CPU tensors) against the JAX
Pallas wrappers in interpret mode and against ``repro.kernels.ref``, on
the same numpy inputs.  The CUDA/Triton kernels themselves run only on
the card (``chip_smoke.py`` holds them against these plain versions).

The training slice's kernel ops (CCM flash attention, kv_cummean) are
at the end of the file.

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
    pops.kv_cummean(torch.ones(3, 4))
    q = torch.ones(1, 4, 2, 8)
    pops.ccm_attention(q, q, q, *(pops_info(4),) * 2, 1.0)
    slab = torch.zeros(3, 4)
    pops.session_scatter(slab, [1], pops.session_gather(slab, [0]))
    assert pops.launch_counts() == {
        "segmented_attention": 0, "cond_lora": 0, "kv_merge_update": 0,
        "ccm_attention": 0, "ccm_attention_backward": 0, "kv_cummean": 0,
        "kv_cummean_backward": 0, "session_gather": 0, "session_scatter": 0}


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
    with pytest.raises(ValueError):
        pkm.kv_cummean_launch(torch.zeros(2, 3, 4))


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
    w = torch.zeros(8, 8, requires_grad=True)
    with pytest.raises(ValueError, match="frozen"):
        pcl.cond_lora(torch.zeros(2, 8), w, torch.zeros(1, 8),
                      torch.zeros(1, 8), torch.zeros(2), 2.0)
