"""What the CPU can hold of the CCM attention's bf16 tensor-core route:
the two-stream planner (the natural key tiles under D = causal & same
segment & !comp & valid, the <COMP> keys compacted into tiles of their
own under C = causal & comp & valid), the plain version of the
two-stream algorithm (the training layout, per-lane layouts, padded
and blind rows, and Whisper's encoder: every key a <COMP> key at index 0
of segment 0), and the shapes the route refuses before any launch.  The kernels themselves run only on the card (``chip_smoke.py``
phase 2 holds them against the plain versions).

Tolerances (float32 on the CPU): the two-stream plain version against
the JAX oracle and the Pallas kernel (interpret mode) 1e-5 x max|out|
(float32 sums over at most a few hundred keys, in another order); its
autograd gradients against ``jax.grad`` of the oracle 1e-4 x max|grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ccm_attention as jca
from repro.kernels import ref as jref
from repro_torch.core.masks import segment_layout
from repro_torch.kernels import ccm_attention as pca
from repro_torch.kernels import ref as pref


def _layout(t, c, m, tail):
    lay = segment_layout(t, c, m, tail)
    return (np.asarray(lay.seg_ids, np.int32),
            np.asarray(lay.comp_mask, bool))


def _case(name):
    """(B, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid, tile) as numpy;
    per-lane cases are (B, S), the rest (S,)."""
    if name == "training":                   # the training layout, S 1216
        seg, comp = _layout(16, 64, 8, 64)
        idx = np.arange(seg.size, dtype=np.int32)
        return 4, idx, seg, idx, seg, comp, None, 64
    if name == "per_lane":                   # three layouts of S = 45
        lays = [_layout(3, 10, 2, 9), _layout(5, 5, 2, 10),
                _layout(2, 17, 3, 5)]
        seg = np.stack([s for s, _ in lays])
        comp = np.stack([c for _, c in lays])
        idx = np.tile(np.arange(45, dtype=np.int32), (3, 1))
        valid = np.ones((3, 45), bool)
        valid[1, -4:] = False
        return 3, idx, seg, idx, seg, comp, valid, 8
    if name == "encoder":                    # Whisper's encoder: S = 100
        # every key a <COMP> key at index 0 of segment 0 (bidirectional),
        # at 64-row tiles that 100 does not fill
        z = np.zeros(100, np.int32)
        return 2, z, z, z, z, np.ones(100, bool), None, 64
    seg, comp = _layout(3, 11, 3, 8)         # S = 50
    S = seg.size
    idx = np.arange(S, dtype=np.int32)
    q_idx, valid = idx.copy(), None
    if name == "no_comp":
        comp = np.zeros(S, bool)
    elif name == "all_comp":
        comp = np.ones(S, bool)
    elif name == "padded":
        valid = np.ones(S, bool)
        valid[-7:] = False
        valid[20:23] = False                 # invalid <COMP> keys too
    elif name == "blind_row":
        q_idx[4] = -9                        # row 4 sees no key
    tile = 16 if name == "ragged" else 8     # 50 = 3 x 16 + 2
    return 2, q_idx, seg, idx, seg, comp, valid, tile


CASES = ["training", "per_lane", "no_comp", "all_comp", "padded",
         "blind_row", "ragged", "encoder"]


def _dense(B, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid):
    """(B, Sq, Sk) CCM mask in numpy."""
    lane = lambda x: np.broadcast_to(x, (B,) + x.shape[-1:])
    qi, qs, ki, ks, kc = map(lane, (q_idx, q_seg, k_idx, k_seg, k_comp))
    kv = np.ones_like(kc) if k_valid is None else lane(k_valid)
    return (ki[:, None] <= qi[:, :, None]) \
        & ((ks[:, None] == qs[:, :, None]) | kc[:, None]) & kv[:, None]


def _plan(case):
    B, *meta, tile = case
    Sq, Sk = meta[0].shape[-1], meta[2].shape[-1]
    return pca.plan(*(None if x is None else torch.from_numpy(x)
                      for x in meta), B, Sq, Sk, tile=tile)


@pytest.mark.parametrize("name", CASES)
def test_plan_covers_every_visible_pair_once(name):
    """Each visible (q, k) pair of the dense mask lies in exactly one
    planned tile of exactly one stream; no planned tile is empty; the
    key-side lists are the transpose of the q-side ones; every key
    position is owned by exactly one slot."""
    case = _case(name)
    B, meta, T = case[0], case[1:7], case[7]
    pl = _plan(case)
    want = _dense(B, *meta)
    Sq, Sk = want.shape[1:]
    P = pl.ktab.shape[0]
    assert P == (B if meta[0].ndim == 2 else 1)
    ktab = pl.ktab.numpy()
    qi = np.broadcast_to(meta[0], (P, Sq))
    qs = np.broadcast_to(meta[1], (P, Sq))
    seen = np.zeros((P, Sq, Sk), int)
    for b in range(P):
        for t in range(pl.nq):
            r0, r1 = t * T, min(Sq, (t + 1) * T)
            slots = pl.q_tiles[b, t, :pl.q_count[b, t]].tolist()
            assert slots == sorted(slots) and len(set(slots)) == len(slots)
            assert (pl.q_tiles[b, t, pl.q_count[b, t]:] == -1).all()
            for slot in slots:
                e = ktab[b, slot * T:(slot + 1) * T]
                vis = (e[None, :, 1] <= qi[b, r0:r1, None]) \
                    & (((e[None, :, 3] & pca.F_ANY) != 0)
                       | (e[None, :, 2] == qs[b, r0:r1, None]))
                assert vis.any(), f"planned tile {slot} of q tile {t} empty"
                rr, jj = np.nonzero(vis)
                np.add.at(seen[b], (r0 + rr, e[jj, 0]), 1)
        # the key-side lists hold exactly the q tiles whose lists hold the slot
        for slot in range(pl.nk + pl.nc):
            qts = [t for t in range(pl.nq)
                   if slot in pl.q_tiles[b, t, :pl.q_count[b, t]].tolist()]
            assert pl.k_tiles[b, slot, :pl.k_count[b, slot]].tolist() == qts
        own = ktab[b, :, 0][(ktab[b, :, 3] & pca.F_OWN) != 0]
        assert sorted(own.tolist()) == list(range(Sk))
    np.testing.assert_array_equal(seen, want[:P] if P == B else
                                  np.broadcast_to(want[:1], seen.shape))


def test_plan_training_layout_keeps_62_of_361_tiles():
    """The training layout (16 steps of 64 + 8 <COMP> tokens, a 64-token
    tail) at 64 x 64 tiles: 35 natural tiles and 27 <COMP> tiles."""
    pl = _plan(_case("training"))
    assert (pl.nq, pl.nk) == (19, 19)
    assert int(pl.k_count[:, :pl.nk].sum()) == 35
    assert int(pl.k_count[:, pl.nk:].sum()) == 27
    assert int(pl.q_count.sum()) == 62


def test_plan_encoder_regime_is_the_comp_stream_alone():
    """Whisper's encoder metadata (every key <COMP>, index 0, segment 0)
    at S = 100: the natural stream shows no key (idx 0 and segment 0 mean
    nothing of their own there) and owns none; both 64-key <COMP> tiles,
    the second partly filled, are visited by both q tiles, and each key
    is owned by its <COMP> slot."""
    pl = _plan(_case("encoder"))
    assert (pl.nq, pl.nk, pl.nc) == (2, 2, 2)
    assert pl.q_tiles[0].tolist() == [[2, 3, -1, -1]] * 2
    nat = pl.ktab[0, :pl.nk * 64].numpy()
    assert (nat[:, 1] == pca.KBIG).all() and not (nat[:, 3] & pca.F_OWN).any()
    comp = pl.ktab[0, pl.nk * 64:].numpy()
    assert comp[:100, 0].tolist() == list(range(100))
    assert (comp[:100, 1] == 0).all() and (comp[100:, 0] == -1).all()
    assert ((comp[:100, 3] & pca.F_OWN) != 0).all()


@pytest.mark.parametrize("per_lane", [False, True])
def test_comp_list_compacts_comp_and_valid_keys_in_order(per_lane):
    rs = np.random.default_rng(3)
    comp = rs.random((3, 40)) < 0.3
    valid = rs.random((3, 40)) < 0.8
    if not per_lane:
        comp, valid = comp[:1], valid[:1]
    pos, n = pca.comp_list(torch.from_numpy(comp), torch.from_numpy(valid))
    for b in range(comp.shape[0]):
        want = np.nonzero(comp[b] & valid[b])[0]
        assert int(n[b]) == want.size
        np.testing.assert_array_equal(pos[b, :want.size].numpy(), want)
        assert (pos[b, want.size:] == -1).all()


def _inputs(rs, name, Hq, Hkv, Dh):
    case = _case(name)
    B, meta = case[0], case[1:7]
    S = meta[0].shape[-1]
    q = rs.normal(size=(B, Hq, S, Dh)).astype(np.float32)
    k, v = rs.normal(size=(2, B, Hkv, S, Dh)).astype(np.float32)
    return case, q, k, v, meta


def _oracle(q, k, v, meta, scale):
    """repro's oracle, lane by lane where the metadata are per lane."""
    if meta[0].ndim == 1:
        return np.asarray(jref.ccm_attention_ref(
            *map(jnp.asarray, (q, k, v)),
            *(jnp.asarray(np.ones(meta[2].shape, bool) if x is None else x)
              for x in meta), scale))
    return np.concatenate([_oracle(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   tuple(None if x is None else x[b]
                                         for x in meta), scale)
                           for b in range(q.shape[0])])


@pytest.mark.parametrize("name,Hq,Hkv,Dh", [("per_lane", 4, 2, 16),
                                            ("padded", 2, 2, 8),
                                            ("blind_row", 6, 3, 24),
                                            ("no_comp", 2, 1, 16),
                                            ("all_comp", 2, 2, 16),
                                            ("ragged", 4, 2, 16),
                                            ("encoder", 6, 6, 16)])
def test_two_stream_plain_version_matches_oracle_and_pallas(name, Hq, Hkv,
                                                            Dh):
    """The two-stream algorithm (one running softmax over the natural
    stream, then the <COMP> stream) against repro's dense oracle and,
    for shared metadata, the Pallas kernel in interpret mode."""
    rs = np.random.default_rng(21)
    case, q, k, v, meta = _inputs(rs, name, Hq, Hkv, Dh)
    scale = Dh ** -0.5
    pl = _plan(case)
    got = pref.ccm_attention_streams_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(meta[0]), torch.from_numpy(meta[1]), pl,
        scale).numpy()
    want = _oracle(q, k, v, meta, scale)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    blind = ~_dense(q.shape[0], *meta).any(-1)               # (B, Sq)
    assert (got.transpose(0, 2, 1, 3)[blind] == 0).all()
    if meta[0].ndim == 2:
        return
    S, P = q.shape[2], -(-q.shape[2] // 16) * 16
    pad = lambda x, fill: np.concatenate(
        [x, np.full((P - S,), fill, x.dtype)])
    pad4 = lambda x: np.pad(x, ((0, 0), (0, 0), (0, P - S), (0, 0)))
    q_idx, q_seg, k_idx, k_seg, k_comp, k_val = meta
    k_val = np.ones(S, bool) if k_val is None else k_val
    kern = np.asarray(jca.ccm_flash_attention(
        *map(jnp.asarray, (pad4(q), pad4(k), pad4(v))),
        jnp.asarray(pad(q_idx, -2 ** 30)), jnp.asarray(pad(q_seg, -3)),
        jnp.asarray(pad(k_idx, 2 ** 30)), jnp.asarray(pad(k_seg, -2)),
        jnp.asarray(pad(k_comp.astype(np.int32), 0)),
        jnp.asarray(pad(k_val.astype(np.int32), 0)), scale,
        block_q=16, block_k=16, interpret=True))[:, :, :S]
    np.testing.assert_allclose(got, kern, atol=tol, rtol=0)


@pytest.mark.parametrize("name,Hq,Hkv", [("padded", 4, 2),
                                         ("per_lane", 2, 2),
                                         ("blind_row", 2, 1),
                                         ("encoder", 6, 6)])
def test_two_stream_plain_version_gradients_match_jax_grad(name, Hq, Hkv):
    """Autograd through the two-stream plain version against jax.grad of
    repro's oracle (lane by lane for per-lane metadata)."""
    rs = np.random.default_rng(22)
    case, q, k, v, meta = _inputs(rs, name, Hq, Hkv, 16)
    g = rs.normal(size=q.shape).astype(np.float32)
    scale = 0.25
    B = q.shape[0]

    def jloss(q, k, v):
        if meta[0].ndim == 1:
            o = jref.ccm_attention_ref(
                q, k, v, *(jnp.asarray(np.ones(meta[2].shape, bool)
                                       if x is None else x) for x in meta),
                scale)
        else:
            o = jnp.concatenate([jref.ccm_attention_ref(
                q[b:b + 1], k[b:b + 1], v[b:b + 1],
                *(jnp.asarray(x[b]) for x in meta), scale)
                for b in range(B)])
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    pl = _plan(case)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = pref.ccm_attention_streams_ref(
        tq, tk, tv, torch.from_numpy(meta[0]), torch.from_numpy(meta[1]), pl,
        scale)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(),
                                   rtol=0)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what", ["unaligned_stride", "mixed_dtype",
                                  "head_dim", "too_long"])
def test_bf16_route_refuses_before_launch(what):
    """What the tensor-core route cannot take raises ValueError before
    anything is built or launched (on any device)."""
    S, D = 16, 16
    q = k = v = _bf(1, 2, S, D)
    if what == "unaligned_stride":           # token stride 20 elements
        q = _bf(1, 2, S, D + 4)[..., :D]
        match = "16-byte"
    elif what == "mixed_dtype":
        k = torch.zeros(1, 2, S, D)
        match = "k: want"
    elif what == "head_dim":
        q = k = v = _bf(1, 2, S, 12)
        match = "head dim"
    else:
        S = pca.MAX_S_BF16 + 8
        q = k = v = torch.zeros(1, 1, S, 8, dtype=torch.bfloat16)
        match = "bf16 route"
    z = torch.zeros(S, dtype=torch.int32)
    before = (pca.launches, pca.mma_launches, pca.bwd_launches,
              pca.bwd_mma_launches)
    with pytest.raises(ValueError, match=match):
        pca.ccm_attention_fwd(q, k, v, z, z, z, z, z.bool(), None, 1.0)
    with pytest.raises(ValueError, match=match):
        pca.ccm_attention_bwd(q, k, v, q, torch.zeros(q.shape[:3]), q, z, z,
                              z, z, z.bool(), None, 1.0)
    assert (pca.launches, pca.mma_launches, pca.bwd_launches,
            pca.bwd_mma_launches) == before
