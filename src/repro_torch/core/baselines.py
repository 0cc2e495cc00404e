"""Established context-compression baselines (paper §4 comparisons),
expressed in the same parallelized-training framework as CCM (port of
``repro/core/baselines.py``).

  Gisting-online (Mu et al. 2023, adapted to online use as in the paper):
      each chunk c(j) is compressed INDEPENDENTLY: its <COMP> tokens see
      only c(j) (not Mem(j-1)); inference concatenates the per-chunk gists.
      Mask: causal AND (same_seg OR (comp_k AND q in tail)).

  Compressive Transformer (Rae et al. 2020): old raw KV are pooled by a
      fixed function (mean-pool groups) into a shorter memory; implemented
      as per-segment virtual slots = mean-pooled raw KV of that segment,
      visible to later segments and the tail.

Both train with the same conditional-LoRA budget and compression factor as
CCM (the paper's fair-comparison protocol).  Both exist only in the
training forward (``models/transformer.train_forward``), as in the
reference: neither has an online inference path.

The reference gathers each segment's raw tokens once per segment and
layer; here the (T, m, pool) gather table is planned on the host once per
layout (``compressive_pool_index``; ``train_forward`` keeps it on the
device) and each of k and v is pooled by one ``index_select``, a reshape
and a mean.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gisting_online_mask(seg_ids: torch.Tensor, comp_mask: torch.Tensor,
                        t_steps: int) -> torch.Tensor:
    """(S, S) bool: chunks are independent; gists are visible only to the
    tail; gist tokens see their own chunk only."""
    ar = torch.arange(seg_ids.shape[0], device=seg_ids.device)
    causal = ar[None, :] <= ar[:, None]
    same = seg_ids[:, None] == seg_ids[None, :]
    tail_q = (seg_ids == t_steps + 1)[:, None]
    return causal & (same | (comp_mask.to(seg_ids.device)[None, :] & tail_q))


def compressive_pool_index(seg_ids: torch.Tensor, comp_mask: torch.Tensor,
                           t_steps: int, comp_len: int) -> torch.Tensor:
    """(T, m, pool) int64 token positions: slot i of segment j pools the
    raw tokens ``[j, i, :]`` of that segment.  Each segment's trailing
    ``len % m`` raw tokens are dropped, as in the reference.  Planned on
    the host from the static layout."""
    raw = ~comp_mask.cpu().numpy().astype(bool)
    segs = seg_ids.cpu().numpy()
    m = comp_len
    rows = []
    for j in range(1, t_steps + 1):
        idx = np.nonzero(raw & (segs == j))[0]
        rows.append(idx[:(len(idx) // m) * m].reshape(m, -1))
    if len({r.shape for r in rows}) != 1:
        raise ValueError("compressive pooling needs the same number of raw "
                         "tokens in every segment (a uniform layout)")
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def compressive_virtual_kv(k: torch.Tensor, v: torch.Tensor,
                           index: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment mean-pooled raw KV -> (B, T*m, H, D) memory slots.

    Segment j's chunk (raw tokens only) is pooled into ``comp_len`` slots
    (pool factor = chunk_len / comp_len, the paper-matched compression
    rate).  ``index``: the layout's ``compressive_pool_index``, on the
    device of ``k``.  The mean accumulates in float32 and rounds once to
    ``k.dtype`` (the reference's ``jnp.mean`` of bf16 does the same)."""
    B, _, H, D = k.shape
    T, m, pool = index.shape
    flat = index.reshape(-1)

    def pooled(x):
        g = x.index_select(1, flat).reshape(B, T * m, pool, H, D)
        return torch.mean(g, dim=2, dtype=torch.float32).to(x.dtype)
    return pooled(k), pooled(v)


def compressive_slot_mask(seg_ids: torch.Tensor, t_steps: int,
                          comp_len: int) -> torch.Tensor:
    """(Q, T*m): segment q attends every pooled slot of segments < seg_q."""
    slot_seg = torch.arange(1, t_steps + 1, device=seg_ids.device
                            ).repeat_interleave(comp_len)[None, :]
    return slot_seg < seg_ids[:, None]
