"""Compressed context memory state + update (paper Eq. 1-2; port of
``repro/core/memory.py``).

  concat: k/v (L, B, T*m, Hkv, hd); ``slots`` counts filled <COMP> groups.
  merge : k/v (L, B,   m, Hkv, hd); running (weighted) average; ``steps``
          tracks t for the a_t = 1/t arithmetic-mean coefficient.

The counters (``slots``, ``steps``, ``stream_pos``) are host ints: the
port runs eagerly and every update is known on the host, so no layer
loop waits on the device for them.  ``update_memory`` writes ``k``/``v``
IN PLACE and returns a new ``MemState`` over the same tensors; a caller
that needs the old memory keeps a clone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


class MemState(NamedTuple):
    k: torch.Tensor           # (L, B, M, Hkv, hd)
    v: torch.Tensor
    slots: int                # filled <COMP> groups (concat)
    steps: int                # online time step t
    stream_pos: int           # virtual stream position

    def max_slots(self, comp_len: int) -> int:
        return self.k.shape[2] // comp_len

    def valid_len(self, comp_len: int) -> int:
        return self.slots * comp_len


def mem_layers(cfg: ModelConfig) -> int:
    """Number of attention layers that carry CCM memory."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def init_memory(cfg: ModelConfig, batch: int,
                max_slots: Optional[int] = None, dtype=None,
                device: DeviceLike = None) -> MemState:
    dev = resolve_device(device)
    L = max(mem_layers(cfg), 1)
    m = cfg.ccm.comp_len
    if max_slots is None:
        max_slots = cfg.ccm.mem_slots
    if cfg.ccm.mode == "merge":
        max_slots = 1
    shape = (L, batch, max_slots * m, cfg.n_kv_heads, cfg.hd)
    dt = dtype or cfg.cdtype
    return MemState(k=torch.zeros(shape, dtype=dt, device=dev),
                    v=torch.zeros(shape, dtype=dt, device=dev),
                    slots=0, steps=0, stream_pos=0)


def merge_weight(cfg: ModelConfig, t: int) -> float:
    """a_t of the merge update: 1/t, or the EMA alpha (1 at t = 1)."""
    if cfg.ccm.merge_alpha is None:
        return 1.0 / t
    return 1.0 if t == 1 else float(cfg.ccm.merge_alpha)


def update_memory(cfg: ModelConfig, mem: MemState, h_k: torch.Tensor,
                  h_v: torch.Tensor, n_new_tokens: int) -> MemState:
    """Apply g_update with the new compressed state h(t), in place.

    h_k/h_v: (L, B, m, Hkv, hd) — the <COMP> keys/values from g_comp.
    n_new_tokens: tokens consumed this step (context + m).

    Merge mode goes through the ``kv_merge_update`` kernel op, which
    computes in float32 (the reference computes in the memory dtype, with
    ``a`` rounded to it).  Concat mode writes group ``slots``; once the
    memory is full the write start clamps, like the reference's
    ``dynamic_update_slice``: the newest group overwrites the last slot
    and ``slots`` stays at its maximum.
    """
    m = cfg.ccm.comp_len
    t_new = mem.steps + 1
    if cfg.ccm.mode == "merge":
        a = merge_weight(cfg, t_new)
        ops.kv_merge_update(mem.k, h_k.to(mem.k.dtype).contiguous(), a)
        ops.kv_merge_update(mem.v, h_v.to(mem.v.dtype).contiguous(), a)
        slots = 1
    else:
        M = mem.k.shape[2]
        start = min(mem.slots * m, M - m)
        mem.k[:, :, start:start + m] = h_k.to(mem.k.dtype)
        mem.v[:, :, start:start + m] = h_v.to(mem.v.dtype)
        slots = min(mem.slots + 1, mem.max_slots(m))
    return MemState(k=mem.k, v=mem.v, slots=slots, steps=t_new,
                    stream_pos=mem.stream_pos + int(n_new_tokens))
