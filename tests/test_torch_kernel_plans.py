"""What the CPU can hold of the tensor-core kernel routes: the split-K
decode's plan and combine, cond_lora's rank padding, and the shapes the
new routes refuse before any launch.  The kernels themselves run only on
the card (``chip_smoke.py`` phase 2 holds them against their plain
versions).

Tolerances (float32 on the CPU): the split-K combine against the dense
reference 1e-5 (float32 sums over a few hundred keys, in another order);
the padded-rank plain cond_lora 1e-5 x max|y| (the zero rows add exact
zeros, the matmuls may block their sums differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import cond_lora as pcl
from repro_torch.kernels import decode_attention as pda
from repro_torch.kernels import ref as pref

D = 16


def _seg(k, v, length=None, idx=None, seg=None, comp=None, valid=None):
    return dict(k=k, v=v, k_scale=None, v_scale=None, length=length,
                layer=None, lane_major=False, idx=idx, seg=seg, comp=comp,
                valid=valid)


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 7, 16, 32])
def test_split_bounds_cover_every_valid_key_once(n_split):
    """For lanes holding 0, 1, a few and every key of each segment, the
    splits' pieces cover each valid key exactly once, in order."""
    caps = (16, 96, 5)
    for counts in ((0, 0, 0), (1, 0, 0), (0, 1, 1), (16, 96, 5),
                   (3, 40, 0), (16, 0, 5)):
        seen = [np.zeros(c, int) for c in caps]
        flat = []
        for pieces in pda.split_bounds(counts, n_split):
            for si, lo, hi in pieces:
                assert 0 <= lo < hi <= counts[si] <= caps[si]
                seen[si][lo:hi] += 1
                flat += [(si, j) for j in range(lo, hi)]
        for si, c in enumerate(counts):
            assert (seen[si][:c] == 1).all() and (seen[si][c:] == 0).all()
        assert flat == sorted(flat)


def test_plan_splits_fills_the_card_with_64_key_splits():
    # LLaMA-7B decode: B=4 x 32 kv heads, 32 + 480 + 1 keys a lane
    n = pda.plan_splits(32 + 480 + 1, 4 * 32)
    assert n * 4 * 32 <= 4 * pda.SM_COUNT < (n + 1) * 4 * 32
    assert 513 // n >= 64
    assert pda.plan_splits(40, 8) == 1               # too few keys to cut
    assert pda.plan_splits(10 ** 6, 1) == pda.MAX_SPLITS
    assert pda.plan_splits(4096, 10 ** 4) == 1       # the grid is full


def _decode_case(rs):
    """3 lanes (B, 2 q rows, 4/2 heads): memory, cache and self segments;
    lane 0 holds no memory or cache key and its row 1 sees no key."""
    B, Sq, Hq, Hkv = 3, 2, 4, 2
    mem = rs.normal(size=(2, B, 16, Hkv, D)).astype(np.float32)
    cache = rs.normal(size=(2, B, 96, Hkv, D)).astype(np.float32)
    slf = rs.normal(size=(2, B, 5, Hkv, D)).astype(np.float32)
    q = rs.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    cidx = np.arange(96, dtype=np.int32)
    sidx = np.arange(100, 105, dtype=np.int32)
    segs = [
        _seg(mem[0], mem[1], length=np.array([0, 1, 16], np.int32)),
        _seg(cache[0], cache[1], length=np.array([0, 1, 96], np.int32),
             idx=cidx, seg=np.ones(96, np.int32),
             comp=(cidx % 9 == 0)),
        _seg(slf[0], slf[1], idx=sidx, seg=np.full(5, 2, np.int32),
             comp=np.zeros(5, bool),
             valid=np.array([[1, 1, 0, 1, 1]] * B, bool)),
    ]
    q_idx = np.array([200, -1], np.int32)          # row 1: memory keys only
    q_seg = np.array([2, 2], np.int32)
    return q, segs, q_idx, q_seg


def _split_partials(q, segs, q_idx, q_seg, scale, n_split):
    """Per split, the running-softmax state (m, l, acc) of each lane and q
    row over the split's pieces, in plain torch: what a split-K block
    writes.  m is -inf and l, acc are 0 where the split saw no key."""
    B, Sq, Hq, _ = q.shape
    G = Hq // segs[0]["k"].shape[2]
    m = torch.full((n_split, B, Sq, Hq), -torch.inf)
    l = torch.zeros((n_split, B, Sq, Hq))
    acc = torch.zeros((n_split, B, Sq, Hq, D))
    for b in range(B):
        counts = [min(int(s["length"][b]) if s["length"] is not None
                      else s["k"].shape[1], s["k"].shape[1]) for s in segs]
        for sp, pieces in enumerate(pda.split_bounds(counts, n_split)):
            ks, vs, ok = [], [], []
            for si, lo, hi in pieces:
                s = segs[si]
                ks.append(s["k"][b, lo:hi])
                vs.append(s["v"][b, lo:hi])
                pos = torch.arange(lo, hi)
                if s["idx"] is None:         # memory keys: idx -1, <COMP>
                    vis = (q_idx[:, None] >= -1).expand(Sq, hi - lo)
                else:
                    ki, kg = s["idx"][pos], s["seg"][pos]
                    vis = (ki[None] <= q_idx[:, None]) & \
                        ((kg[None] == q_seg[:, None]) | s["comp"][pos][None])
                    if s["valid"] is not None:
                        vis &= s["valid"][b, pos][None]
                ok.append(vis)
            if not ks:
                continue
            k = torch.cat(ks).repeat_interleave(G, dim=1)     # (n, Hq, D)
            v = torch.cat(vs).repeat_interleave(G, dim=1)
            vis = torch.cat(ok, 1)                            # (Sq, n)
            logit = torch.einsum("qhd,khd->qhk", q[b], k) * scale
            logit = logit.masked_fill(~vis[:, None, :], -torch.inf)
            mm = logit.amax(-1)                               # (Sq, Hq)
            p = torch.exp(logit - mm[..., None]).nan_to_num(0.0)
            m[sp, b] = mm
            l[sp, b] = p.sum(-1)
            acc[sp, b] = torch.einsum("qhk,khd->qhd", p, v)
    return m, l, acc


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 40])
def test_split_partials_merge_to_the_reference(n_split):
    """Per-split (m, l, acc) over the planner's pieces, combined by
    ``merge_partials`` (the formula the kernel's last block applies),
    equal the dense reference and the JAX oracle; splits past a lane's
    keys are empty, and a row that sees no key gives exactly 0."""
    rs = np.random.default_rng(n_split)
    q, segs, q_idx, q_seg = _decode_case(rs)
    scale = D ** -0.5
    tsegs = [{k: (torch.from_numpy(np.asarray(v))
                  if isinstance(v, np.ndarray) else v) for k, v in s.items()}
             for s in segs]
    tq, tqi, tqs = (torch.from_numpy(x) for x in (q, q_idx, q_seg))
    m, l, acc = _split_partials(tq, tsegs, tqi, tqs, scale, n_split)
    got = pref.merge_partials(m, l, acc)
    want = pref.segmented_attention_ref(tq, tsegs, tqi, tqs, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    jwant = np.asarray(jref.segmented_attention_lanes_ref(
        jnp.asarray(q), [{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                              else v) for k, v in s.items()} for s in segs],
        jnp.asarray(q_idx), jnp.asarray(q_seg), scale))
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-5, rtol=0)
    assert bool((got[0, 1] == 0).all()) and bool(torch.isfinite(got).all())
    if n_split == 40:                          # more splits than lane 1's keys
        assert bool((l[:, 1] == 0).any())


def test_merge_partials_of_empty_splits_is_exactly_zero():
    m = torch.full((3, 2, 4), -torch.inf)
    l = torch.zeros((3, 2, 4))
    acc = torch.zeros((3, 2, 4, D))
    out = pref.merge_partials(m, l, acc)
    assert bool((out == 0).all())


@pytest.mark.parametrize("r", [1, 4, 8, 13, 64])
def test_cond_lora_rank_padding_keeps_the_plain_result(r):
    """A and B zero-padded to a multiple of 8 rows (8, 16, 32 or 64)
    leave y = x@W + gate * (x@A^T@B) * s unchanged."""
    rs = np.random.default_rng(r)
    M, K, N = 24, 64, 40
    x, w = (torch.from_numpy(rs.normal(size=s).astype(np.float32))
            for s in ((M, K), (K, N)))
    a = torch.from_numpy(rs.normal(size=(r, K)).astype(np.float32))
    b = torch.from_numpy(rs.normal(size=(r, N)).astype(np.float32))
    gate = torch.from_numpy((rs.random(M) < 0.5).astype(np.float32))
    ap, bp = pcl.pad_rank(a, b)
    assert ap.shape[0] in pcl.PADDED_RANKS and ap.shape[0] < 2 * r + 8
    assert torch.equal(ap[:r], a) and bool((ap[r:] == 0).all())
    assert torch.equal(bp[:r], b) and bool((bp[r:] == 0).all())
    want = pref.cond_lora_ref(x, w, a, b, gate, 2.0)
    got = pref.cond_lora_ref(x, w, ap, bp, gate, 2.0)
    tol = 1e-5 * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("K,N", [(60, 64), (64, 36), (1, 8)])
def test_cond_lora_bf16_refuses_unaligned_rows_before_launch(K, N):
    """The tensor-core route needs 16-byte rows (K, N multiples of 8):
    the wrapper refuses other bf16 shapes before it builds anything."""
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 8"):
        pcl.cond_lora_matmul(torch.zeros(4, K, dtype=bf),
                             torch.zeros(K, N, dtype=bf),
                             torch.zeros(2, K, dtype=bf),
                             torch.zeros(2, N, dtype=bf), torch.zeros(4), 2.0)
    assert pcl.launches == 0


def test_segmented_bf16_q_refuses_float32_kv_before_launch():
    q = torch.zeros(1, 1, 2, 8, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="bf16 q"):
        pda.segmented_flash_attention(q, [_seg(kv, kv)], [0], [0], 1.0)
    assert pda.launches == 0


def test_build_name_follows_the_shared_headers(tmp_path):
    """A library's file name hashes its source and every csrc/*.cuh, so
    an edited shared header rebuilds each source that may include it."""
    from repro_torch.kernels import _build
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = _build._target(src)
    assert _build._target(src) == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._target(src)
    assert second != first and second.name.startswith("k-")
    src.write_text('#include "h.cuh"\n// edited\n')
    assert _build._target(src) not in (first, second)
