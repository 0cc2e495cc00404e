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
    ``kv_cummean_pair`` kernel op over the k and v groups read in place,
    one launch for both, in float32 with one rounding; the reference
    computes the same mean as an einsum with the (T, T) weights cast to
    k.dtype, so in bf16 the two differ at bf16 level (1/3 rounds to
    0.33398).  The EMA keeps the einsum.  ``comp_mask`` is best given on
    the host: the groups' placement is read from it on every call.
    """
    from repro_torch.kernels import ops
    B, S, H, D = k.shape
    T, m = t_steps, comp_len
    # the (B, T, m*H*D) <COMP> groups, strided views where they can be
    gk, gv = (_comp_groups(x, comp_mask, T, m) for x in (k, v))
    if alpha is None:
        mk, mv = ops.kv_cummean_pair(gk, gv, dim=1)
    else:
        w = merge_coefficients(T, alpha).to(device=k.device, dtype=k.dtype)
        mk, mv = (torch.einsum("ji,bir->bjr", w, g) for g in (gk, gv))
    return mk.reshape(B, T * m, H, D), mv.reshape(B, T * m, H, D)


def expand_slot_mask(slot_mask: torch.Tensor, comp_len: int) -> torch.Tensor:
    """(Q, T) -> (Q, T*comp_len) by repeating each slot column."""
    return torch.repeat_interleave(slot_mask, comp_len, dim=1)


# ---------------------------------------------------------------------------
# ragged token lanes (serve-engine token-bucket padding) and block writes
# ---------------------------------------------------------------------------

def lane_valid(length: int, valid_len, tail_start: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Key-validity mask of ragged lanes: (length,) for an int
    ``valid_len``, (B, length) for B per-lane lengths.

    True at positions ``< valid_len`` (the real tokens of a request padded
    up to a token bucket) and, when ``tail_start`` is given, at positions
    ``>= tail_start`` (a block that is always real, e.g. the <COMP> group
    appended after a padded context chunk).
    """
    ar = torch.arange(length, device=device)
    vl = torch.as_tensor(np.asarray(valid_len), device=device)
    v = ar < (vl[..., None] if vl.ndim else vl)
    if tail_start is not None:
        v = v | (ar >= tail_start)
    return v


class BlockWrite(NamedTuple):
    """Where a block of ``s`` new rows lands in a (B, n, ...) buffer view:
    one slice ``[start, start + count)`` shared by every lane, or (when
    ``start`` is None) explicit (lane, buffer row, block row) index lists
    for one ``index_put``."""
    start: Optional[int]
    count: int
    lanes: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    src: Optional[torch.Tensor] = None


def block_rows(at: int, s: int, n: int, valid_len=None):
    """Host plan of one lane's block write: (buffer rows, block rows).

    ``valid_len`` None: the block is written whole and its start clamps so
    it fits, like ``dynamic_update_slice`` (a write past the end lands on
    the last ``s`` rows).  Else (ragged lane): only the first
    ``valid_len`` rows are written and rows past the buffer's end are
    dropped, with no clamp-shift; every other row stays bit-exact."""
    if valid_len is None:
        a = min(max(int(at), 0), max(n - s, 0))
        k = min(s, n)
        return list(range(a, a + k)), list(range(k))
    src = [j for j in range(min(int(valid_len), s)) if 0 <= at + j < n]
    return [int(at) + j for j in src], src


def plan_block_write(at, s: int, n: int, valid_len=None,
                     device=None) -> BlockWrite:
    """The write of a (B, s, ...) block into a (B, n, ...) view at
    per-lane starts ``at`` (an int or B ints) with per-lane valid lengths
    ``valid_len`` (None, an int or B ints; see `block_rows`).  Planned on
    the host once per step and reused by every layer."""
    ats = np.atleast_1d(np.asarray(at, dtype=np.int64))
    vls = [None] * len(ats) if valid_len is None \
        else np.broadcast_to(np.asarray(valid_len, np.int64), ats.shape)
    plans = [block_rows(int(a), s, n, None if v is None else int(v))
             for a, v in zip(ats, vls)]
    dst, src = plans[0]
    if all(p == plans[0] for p in plans) and src == list(range(len(src))) \
            and dst == list(range(dst[0] if dst else 0,
                                  (dst[0] if dst else 0) + len(dst))):
        return BlockWrite(start=dst[0] if dst else 0, count=len(dst))
    lanes, rows, src = [], [], []
    for b, (r, j) in enumerate(plans):
        lanes += [b] * len(r)
        rows += r
        src += j
    t = lambda x: torch.tensor(x, dtype=torch.long, device=device)  # noqa: E731
    return BlockWrite(start=None, count=len(rows), lanes=t(lanes),
                      rows=t(rows), src=t(src))


def apply_block_write(view: torch.Tensor, blk: torch.Tensor,
                      plan: BlockWrite) -> torch.Tensor:
    """Write ``blk`` (B, s, ...) into ``view`` (B, n, ...) IN PLACE as
    ``plan`` says; returns ``view``.  A view of a larger buffer (one layer
    of a stacked cache) writes through to it."""
    if plan.start is not None:
        if plan.count:
            view[:, plan.start:plan.start + plan.count] = \
                blk[:, :plan.count].to(view.dtype)
    elif plan.count:
        view[plan.lanes, plan.rows] = \
            blk[plan.lanes, plan.src].to(view.dtype)
    return view


def layer_window_write(buf: torch.Tensor, blk: torch.Tensor, layer: int,
                       at, valid_len=None,
                       lane_major: bool = False) -> torch.Tensor:
    """Write ``blk`` (B, s, ...) into layer ``layer`` of the stacked state
    ``buf`` (L, B, S, ...) (or lane-major (B, L, S, ...)) at row ``at``
    (an int, or B per-lane ints), IN PLACE, and return ``buf``.

    Without ``valid_len`` the start clamps like the reference's
    ``dynamic_update_slice``: once ``at + s`` passes ``S`` the block lands
    on the last ``s`` rows, while the caller's length counter keeps
    advancing.  With ``valid_len`` (ragged lanes) only the first
    ``valid_len`` rows are written and rows past ``S`` are dropped.
    """
    view = buf[:, layer] if lane_major else buf[layer]
    apply_block_write(view, blk, plan_block_write(
        at, blk.shape[1], view.shape[1], valid_len, device=buf.device))
    return buf


def ragged_window_write(buf: torch.Tensor, blk: torch.Tensor, starts,
                        valid_len: int, axis: int) -> torch.Tensor:
    """Write ``blk``'s first ``valid_len`` rows (along ``axis``) into
    ``buf`` at the index tuple ``starts`` (every dim of ``buf``), IN PLACE;
    rows past ``valid_len`` or past the buffer's end are not written (no
    clamp-shift).  Returns ``buf``."""
    n, s = buf.shape[axis], blk.shape[axis]
    at = int(starts[axis])
    dst, src = block_rows(at, s, n, valid_len)
    if not dst:
        return buf
    win = tuple(slice(int(st), int(st) + blk.shape[d])
                if d != axis else slice(dst[0], dst[-1] + 1)
                for d, st in enumerate(starts))
    part = blk.narrow(axis, src[0], len(src))
    buf[win] = part.to(buf.dtype)
    return buf


def ragged_block_write(buf: torch.Tensor, blk: torch.Tensor, start: int,
                       valid_len: int, axis: int) -> torch.Tensor:
    """Write ``blk``'s first ``valid_len`` rows into ``buf`` at ``start``
    along ``axis``, IN PLACE; every other position of ``buf`` stays
    bit-exact (no ``dynamic_update_slice`` clamp-shift when the block
    overhangs the buffer's end).  Returns ``buf``."""
    starts = [0] * buf.ndim
    starts[axis] = start
    return ragged_window_write(buf, blk, starts, valid_len, axis)
