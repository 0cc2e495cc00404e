"""Port parity for the CCM layout and masks (``repro_torch.core.masks``
against ``repro.core.masks``): the segment layout, <COMP> offsets, the
concat, merge-slot and intra-segment masks, the merge weights and the
merge-mode virtual slots (running mean through the ``kv_cummean_pair``
op, one call for k and v, and the EMA), on the same numpy inputs; the
merge slots of ``train_forward`` read the layout's host <COMP> mask.

Tolerance: masks, layouts and offsets are exact; float32 merge slots
atol 1e-6 (the kernel op's float32 running mean against the
reference's float32 einsum with the (T, T) weights).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro_torch.core import masks as PM

LAYOUTS = [(4, 8, 2, 8), (1, 5, 3, 4), (3, 6, 1, 0), (16, 64, 8, 64)]


@pytest.mark.parametrize("t,lc,m,tail", LAYOUTS)
def test_segment_layout_and_masks(t, lc, m, tail):
    jl, pl = JM.segment_layout(t, lc, m, tail), PM.segment_layout(t, lc, m, tail)
    assert pl.seq_len == jl.seq_len
    for name in ("seg_ids", "comp_mask", "positions"):
        assert np.array_equal(getattr(pl, name).numpy(),
                              np.asarray(getattr(jl, name))), name
    assert (pl.t_steps, pl.comp_len, pl.chunk_len, pl.tail_len) == \
        (jl.t_steps, jl.comp_len, jl.chunk_len, jl.tail_len)
    assert np.array_equal(PM.comp_offset_array(pl.comp_mask).numpy(),
                          np.asarray(JM.comp_offset_array(jl.comp_mask)))
    pairs = [
        (PM.ccm_mask_concat(pl.seg_ids, pl.comp_mask),
         JM.ccm_mask_concat(jl.seg_ids, jl.comp_mask)),
        (PM.ccm_mask_concat(pl.seg_ids[3:], pl.comp_mask[3:], pl.seg_ids,
                            pl.comp_mask, q_offset=3),
         JM.ccm_mask_concat(jl.seg_ids[3:], jl.comp_mask[3:], jl.seg_ids,
                            jl.comp_mask, q_offset=3)),
        (PM.merge_slot_mask(pl.seg_ids, t), JM.merge_slot_mask(jl.seg_ids, t)),
        (PM.intra_segment_causal(pl.seg_ids, pl.comp_mask),
         JM.intra_segment_causal(jl.seg_ids, jl.comp_mask)),
        (PM.expand_slot_mask(PM.merge_slot_mask(pl.seg_ids, t), m),
         JM.expand_slot_mask(JM.merge_slot_mask(jl.seg_ids, t), m)),
    ]
    for i, (a, b) in enumerate(pairs):
        assert np.array_equal(a.numpy(), np.asarray(b)), i


@pytest.mark.parametrize("alpha", [None, 0.3, 0.9])
def test_merge_coefficients(alpha):
    np.testing.assert_allclose(PM.merge_coefficients(6, alpha).numpy(),
                               np.asarray(JM.merge_coefficients(6, alpha)),
                               atol=0, rtol=0)


@pytest.mark.parametrize("alpha", [None, 0.3])
@pytest.mark.parametrize("t,lc,m,tail", LAYOUTS[:3])
def test_merge_virtual_kv(alpha, t, lc, m, tail):
    jl = JM.segment_layout(t, lc, m, tail)
    pl = PM.segment_layout(t, lc, m, tail)
    rs = np.random.default_rng(3)
    k, v = rs.normal(size=(2, 2, jl.seq_len, 3, 8)).astype(np.float32)
    want = JM.merge_virtual_kv(jnp.asarray(k), jnp.asarray(v), jl.comp_mask,
                               t, m, alpha)
    got = PM.merge_virtual_kv(torch.from_numpy(k), torch.from_numpy(v),
                              pl.comp_mask, t, m, alpha)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


def test_comp_groups_view_equals_gather():
    """The strided in-place view of the <COMP> groups equals the gather
    the reference makes (nonzero + take), and is a view when it can be."""
    pl = PM.segment_layout(4, 8, 2, 8)
    x = torch.randn(2, pl.seq_len, 3, 8)
    view = PM._comp_groups(x, pl.comp_mask, 4, 2)
    assert view.data_ptr() != 0 and view._base is not None
    idx = torch.nonzero(pl.comp_mask).reshape(-1)
    assert torch.equal(view, x[:, idx].reshape(2, 4, 2 * 3 * 8))
    # a non-uniform <COMP> placement falls back to the gather
    cm = pl.comp_mask.clone()
    cm[9], cm[7] = False, True
    got = PM._comp_groups(x, cm, 4, 2)
    idx = torch.nonzero(cm).reshape(-1)
    assert torch.equal(got, x[:, idx].reshape(2, 4, 2 * 3 * 8))


def _count_ops(monkeypatch):
    """Count the kv_cummean pair op's calls and torch.einsum's; the
    one-tensor op must not be called."""
    from repro_torch.kernels import ops
    calls = {"pair": 0, "einsum": 0}
    pair, einsum = ops.kv_cummean_pair, torch.einsum

    def count_pair(*a, **kw):
        calls["pair"] += 1
        return pair(*a, **kw)

    def count_einsum(*a, **kw):
        calls["einsum"] += 1
        return einsum(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the one-tensor kv_cummean op was called")
    monkeypatch.setattr(ops, "kv_cummean_pair", count_pair)
    monkeypatch.setattr(ops, "kv_cummean", refuse)
    monkeypatch.setattr(torch, "einsum", count_einsum)
    return calls


@pytest.mark.parametrize("alpha,want", [(None, {"pair": 1, "einsum": 0}),
                                        (0.3, {"pair": 0, "einsum": 2})])
def test_merge_virtual_kv_op_calls(monkeypatch, alpha, want):
    """The running mean makes one op call for k and v together (one
    kernel launch on the card); the EMA keeps its two einsums."""
    pl = PM.segment_layout(4, 8, 2, 8)
    k, v = torch.randn(2, 2, pl.seq_len, 3, 8)
    calls = _count_ops(monkeypatch)
    PM.merge_virtual_kv(k, v, pl.comp_mask, 4, 2, alpha)
    assert calls == want


@pytest.mark.parametrize("alpha", [None, 0.3])
def test_train_forward_merge_reads_the_host_mask(monkeypatch, alpha):
    """``train_forward`` hands the merge slots the layout's host <COMP>
    mask, not a device copy, so reading the groups' placement never
    syncs the card: on the meta device, whose tensors hold no data, a
    device->host copy of the mask would raise.  One kv_cummean pair op
    call per layer in mean mode."""
    from repro_torch.models import transformer as PT
    from repro_torch.models.config import CCMConfig, ModelConfig
    cfg = ModelConfig(name="t", family="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                      compute_dtype="float32",
                      ccm=CCMConfig(comp_len=2, max_steps=4, mode="merge",
                                    merge_alpha=alpha))

    def to_meta(t):
        if isinstance(t, dict):
            return {k: to_meta(v) for k, v in t.items()}
        return t.to("meta") if isinstance(t, torch.Tensor) else t
    params = to_meta(PT.init_lm(cfg, seed=0, device="cpu"))
    pl = PM.segment_layout(4, 8, 2, 8)
    masks = []
    slots = PM.merge_virtual_kv

    def record(k, v, comp_mask, *a, **kw):
        masks.append(comp_mask)
        return slots(k, v, comp_mask, *a, **kw)
    monkeypatch.setattr(PM, "merge_virtual_kv", record)
    calls = _count_ops(monkeypatch)
    tokens = torch.zeros(2, pl.seq_len, dtype=torch.long, device="meta")
    out = PT.train_forward(params, cfg, tokens, pl)
    assert out.shape == (2, 8, 128) and out.device.type == "meta"
    assert len(masks) == 3
    assert all(m is pl.comp_mask and m.device.type == "cpu" for m in masks)
    assert calls["pair"] == (3 if alpha is None else 0)
