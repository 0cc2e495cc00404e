"""Streaming helpers (port of ``repro/core/streaming.py``: the serve
engine's per-lane memory recompression only).

The rest of the reference module (bounded-window stream sessions,
``stream_step`` and its lane-batched form) belongs to the streaming slice
and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.memory import MemState, per_lane, recompress_memory
from repro_torch.models.config import ModelConfig


def recompress_memory_lanes(cfg: ModelConfig, mem: MemState, group: int,
                            do) -> MemState:
    """Masked per-lane memory recompression over N lanes (the arena-gather
    layout: lane-major tensors, per-lane counters).

    ``do`` (N,) bool selects the lanes to recompress
    (`core.memory.recompress_memory` at ratio ``group``); the selected
    lanes are packed, recompressed and written back IN PLACE, so every
    other lane's tensors and counters stay bit-exact.  A batch with no
    selected lane returns ``mem`` untouched."""
    if not mem.lane_major:
        raise ValueError("recompress_memory_lanes takes lane-major memory")
    N = mem.k.shape[0]
    do = np.asarray(do, dtype=bool).reshape(N)
    if not do.any():
        return mem
    sel = torch.as_tensor(np.flatnonzero(do), device=mem.k.device)
    sub = MemState(k=mem.k[sel], v=mem.v[sel],
                   slots=per_lane(mem.slots, N)[do],
                   steps=per_lane(mem.steps, N)[do],
                   stream_pos=per_lane(mem.stream_pos, N)[do],
                   lane_major=True)
    sub = recompress_memory(cfg, sub, group)
    mem.k[sel] = sub.k
    mem.v[sel] = sub.v
    slots = per_lane(mem.slots, N)
    slots[do] = sub.slots
    return mem._replace(slots=slots)
