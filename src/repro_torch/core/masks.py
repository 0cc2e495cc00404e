"""CCM segment layout, attention masks and cache writes (port of
``repro/core/masks.py``).

Parallel-training layout (paper Fig. 3) for ``t`` online steps, ``m``
<COMP> tokens per step and an input/output tail::

    [ c(1) <COMP>^m | c(2) <COMP>^m | ... | c(t) <COMP>^m | I(t) O(t) ]
      seg=1           seg=2                 seg=t           seg=t+1

Mask rule (CCM-concat): ``allow(q, k) = (k <= q) and (seg_k == seg_q or
comp_k)``.  CCM-merge replaces the per-segment <COMP> keys by virtual
memory slots holding the running (weighted) average of the compressed
states; queries of segment ``j`` attend only slot ``j-1``.

Layouts are static: their tensors live on the CPU and the callers move
them to the device of the activations.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


class SegmentLayout(NamedTuple):
    """Static description of one CCM training sequence."""

    seg_ids: torch.Tensor    # (S,) int32, 1..t+1
    comp_mask: torch.Tensor  # (S,) bool, True at <COMP> positions
    positions: torch.Tensor  # (S,) int32, RoPE position ids
    t_steps: int
    comp_len: int
    chunk_len: int
    tail_len: int

    @property
    def seq_len(self) -> int:
        return int(self.seg_ids.shape[0])


def segment_layout(t_steps: int, chunk_len: int, comp_len: int,
                   tail_len: int, mode: str = "concat") -> SegmentLayout:
    """The uniform parallel-training layout; ``chunk_len`` counts the raw
    tokens of each c(j).  Positions are the packed indices 0..S-1, so the
    parallel pass is an exact unroll of the online recursion (identical
    RoPE phases in training and online).  ``mode`` does not change it."""
    del mode
    m = comp_len
    segs, comps = [], []
    for j in range(1, t_steps + 1):
        segs.append(np.full(chunk_len + m, j, np.int32))
        comps.append(np.concatenate([np.zeros(chunk_len, bool),
                                     np.ones(m, bool)]))
    segs.append(np.full(tail_len, t_steps + 1, np.int32))
    comps.append(np.zeros(tail_len, bool))
    total = t_steps * (chunk_len + m) + tail_len
    return SegmentLayout(
        seg_ids=torch.from_numpy(np.concatenate(segs)),
        comp_mask=torch.from_numpy(np.concatenate(comps)),
        positions=torch.arange(total, dtype=torch.int32),
        t_steps=t_steps, comp_len=comp_len, chunk_len=chunk_len,
        tail_len=tail_len)


def comp_offset_array(comp_mask: torch.Tensor) -> torch.Tensor:
    """(S,) offset of each <COMP> token within its group (0 elsewhere):
    selects the per-offset <COMP> embedding."""
    cm = comp_mask.cpu().numpy()
    out = np.zeros(cm.shape, np.int32)
    run = 0
    for i, c in enumerate(cm):
        run = run + 1 if c else 0
        out[i] = max(run - 1, 0)
    return torch.from_numpy(out).to(comp_mask.device)


def ccm_mask_concat(seg_ids: torch.Tensor, comp_mask: torch.Tensor,
                    k_seg_ids: Optional[torch.Tensor] = None,
                    k_comp_mask: Optional[torch.Tensor] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Boolean (Q, K) mask: causal AND (same segment OR key-is-<COMP>);
    ``q_offset`` shifts query indices relative to keys."""
    k_seg_ids = seg_ids if k_seg_ids is None else k_seg_ids
    k_comp_mask = comp_mask if k_comp_mask is None else k_comp_mask
    dev = seg_ids.device
    q_idx = torch.arange(seg_ids.shape[0], device=dev)[:, None] + q_offset
    k_idx = torch.arange(k_seg_ids.shape[0], device=dev)[None, :]
    same = seg_ids[:, None] == k_seg_ids[None, :]
    return (k_idx <= q_idx) & (same | k_comp_mask[None, :])


def merge_slot_mask(seg_ids: torch.Tensor, t_steps: int) -> torch.Tensor:
    """(Q, T) mask over virtual memory slots: segment j attends the slot
    holding Mem(j-1) only (slot s holds Mem(s+1))."""
    slot = torch.arange(1, t_steps + 1, device=seg_ids.device)[None, :]
    return slot == (seg_ids.long() - 1)[:, None]


def intra_segment_causal(seg_ids: torch.Tensor,
                         comp_mask: torch.Tensor) -> torch.Tensor:
    """(Q, K) raw-key mask used in merge mode: causal AND same segment."""
    del comp_mask
    ar = torch.arange(seg_ids.shape[0], device=seg_ids.device)
    return (ar[None, :] <= ar[:, None]) & (seg_ids[:, None] == seg_ids[None, :])


def merge_coefficients(t_steps: int, alpha: Optional[float]) -> torch.Tensor:
    """(T, T) lower-triangular float32 weights W[j, i] such that
    Mem(j+1) = sum_i W[j, i] h(i+1): the arithmetic mean for
    ``alpha=None``, else the EMA Mem(t) = (1-a) Mem(t-1) + a h(t), a_1 = 1."""
    t = t_steps
    if alpha is None:
        w = np.tril(np.ones((t, t))) / np.arange(1, t + 1)[:, None]
    else:
        w = np.zeros((t, t))
        for j in range(t):
            for i in range(j + 1):
                coef = 1.0 if i == 0 else alpha
                w[j, i] = coef * (1.0 - alpha) ** (j - i)
    return torch.from_numpy(w.astype(np.float32))


def _comp_groups(x: torch.Tensor, comp_mask: torch.Tensor, t_steps: int,
                 comp_len: int) -> torch.Tensor:
    """(B, T, m*H*D) <COMP>-group rows of x (B, S, H, D): a strided VIEW
    when the groups sit at the uniform stride of ``segment_layout`` and x
    is contiguous per token, else a gathered copy."""
    B, S, H, D = x.shape
    m = comp_len
    idx = torch.nonzero(comp_mask.cpu()).reshape(-1)[:t_steps * m]
    if idx.numel() != t_steps * m:
        raise ValueError(f"{idx.numel()} <COMP> tokens, want {t_steps * m}")
    first = int(idx[0])
    step = (int(idx[m]) - first) if t_steps > 1 else m
    want = (first + torch.arange(t_steps)[:, None] * step
            + torch.arange(m)[None, :]).reshape(-1)
    start = first - (step - m)          # row 0 of the first segment
    if torch.equal(idx, want) and start >= 0 and step >= m \
            and x.stride(3) == 1 and x.stride(2) == D and x.stride(1) == H * D:
        v = x[:, start:start + t_steps * step]
        return v.reshape(B, t_steps, step, H * D)[:, :, step - m:].flatten(2)
    return x[:, idx.to(x.device)].reshape(B, t_steps, m * H * D)


def merge_virtual_kv(k: torch.Tensor, v: torch.Tensor,
                     comp_mask: torch.Tensor, t_steps: int, comp_len: int,
                     alpha: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Virtual memory-slot KV for merge-mode parallel training.

    k, v: (B, S, H, D).  Returns (B, T*comp_len, H, D) slot keys/values;
    slot j holds Mem(j+1), the weighted average of the <COMP>-group KVs
    of segments 1..j+1.  ``alpha=None`` (the running mean) goes to the
    ``kv_cummean`` kernel op over the groups read in place, in float32
    with one rounding; the reference computes the same mean as an einsum
    with the (T, T) weights cast to k.dtype, so in bf16 the two differ
    at bf16 level (1/3 rounds to 0.33398).  The EMA keeps the einsum.
    """
    from repro_torch.kernels import ops
    B, S, H, D = k.shape
    T, m = t_steps, comp_len
    out = []
    for x in (k, v):
        g = _comp_groups(x, comp_mask, T, m)                 # (B, T, m*H*D)
        if alpha is None:
            mem = ops.kv_cummean(g, dim=1)
        else:
            w = merge_coefficients(T, alpha).to(device=x.device,
                                                dtype=x.dtype)
            mem = torch.einsum("ji,bir->bjr", w, g)
        out.append(mem.reshape(B, T * m, H, D))
    return out[0], out[1]


def expand_slot_mask(slot_mask: torch.Tensor, comp_len: int) -> torch.Tensor:
    """(Q, T) -> (Q, T*comp_len) by repeating each slot column."""
    return torch.repeat_interleave(slot_mask, comp_len, dim=1)


def layer_window_write(buf: torch.Tensor, blk: torch.Tensor, layer: int,
                       at: int) -> torch.Tensor:
    """Write ``blk`` (B, s, ...) into layer ``layer`` of the stacked state
    ``buf`` (L, B, S, ...) at row ``at``, IN PLACE, and return ``buf``.

    Like the reference's ``dynamic_update_slice`` the start is clamped so
    the block fits: once ``at + s`` passes ``S`` the block lands on the
    last ``s`` rows, while the caller's length counter keeps advancing.
    """
    s, S = blk.shape[1], buf.shape[2]
    a = min(max(int(at), 0), max(S - s, 0))
    buf[layer, :, a:a + s] = blk.to(buf.dtype)
    return buf
