"""Compressed context memory state + update (paper Eq. 1-2; port of
``repro/core/memory.py``).

  concat: k/v (L, B, T*m, Hkv, hd); ``slots`` counts filled <COMP> groups.
  merge : k/v (L, B,   m, Hkv, hd); running (weighted) average; ``steps``
          tracks t for the a_t = 1/t arithmetic-mean coefficient.

The counters (``slots``, ``steps``, ``stream_pos``) are host ints: the
port runs eagerly and every update is known on the host, so no layer
loop waits on the device for them.  ``update_memory`` and
``recompress_memory`` write ``k``/``v`` IN PLACE and return a new
``MemState`` over the same tensors; a caller that needs the old memory
keeps a clone.

Lanes: a batch packed from independent sessions (the serve engine's
arena step) carries one counter per lane, as int64 numpy arrays (B,),
and its tensors lane-major, (B, L, M, Hkv, hd) (``lane_major``): each
lane's memory is then one contiguous block.  Every function here takes
either form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


class MemState(NamedTuple):
    k: torch.Tensor           # (L, B, M, Hkv, hd); (B, L, M, ...) lane-major
    v: torch.Tensor
    slots: Counter            # filled <COMP> groups (concat)
    steps: Counter            # online time step t
    stream_pos: Counter       # virtual stream position
    lane_major: bool = False

    def max_slots(self, comp_len: int) -> int:
        return self.k.shape[2] // comp_len

    def valid_len(self, comp_len: int) -> Counter:
        return self.slots * comp_len

    def layer(self, x: torch.Tensor, li: int) -> torch.Tensor:
        """Layer ``li`` of ``x`` (k or v): (B, M, Hkv, hd)."""
        return x[:, li] if self.lane_major else x[li]

    def lane(self, b: int, x: torch.Tensor) -> torch.Tensor:
        """Lane ``b`` of ``x`` (k or v): (L, M, Hkv, hd)."""
        return x[b] if self.lane_major else x[:, b]


# A counter: one host int shared by the batch, or int64 numpy (B,) per lane.
Counter = Union[int, np.ndarray]


def per_lane(c: Counter, B: int) -> np.ndarray:
    """Counter -> int64 numpy (B,)."""
    return np.broadcast_to(np.asarray(c, dtype=np.int64), (B,)).copy()


def uniform(c: Counter) -> Optional[int]:
    """The counter's one value when every lane shares it, else None."""
    if isinstance(c, np.ndarray):
        return int(c[0]) if c.size and (c == c[0]).all() else None
    return int(c)


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
                  h_v: torch.Tensor, n_new_tokens: Counter) -> MemState:
    """Apply g_update with the new compressed state h(t), in place.

    h_k/h_v: (L, B, m, Hkv, hd) — the <COMP> keys/values from g_comp.
    n_new_tokens: tokens consumed this step (context + m), per lane or
    shared.

    Merge mode goes through the ``kv_merge_update`` kernel op, which
    computes in float32 (the reference computes in the memory dtype, with
    ``a`` rounded to it): one launch over the whole batch when every lane
    has the same ``a_t``, else one launch per lane on the lane's
    contiguous block (lane-major memory).  Concat mode writes group
    ``slots`` of each lane; once the memory is full the write start
    clamps, like the reference's ``dynamic_update_slice``: the newest
    group overwrites the last slot and ``slots`` stays at its maximum.
    """
    m = cfg.ccm.comp_len
    B = h_k.shape[1]
    t_new = mem.steps + 1
    if mem.lane_major:
        h_k, h_v = h_k.transpose(0, 1), h_v.transpose(0, 1)
    h_k, h_v = h_k.to(mem.k.dtype), h_v.to(mem.v.dtype)
    if cfg.ccm.mode == "merge":
        t = uniform(t_new)
        if t is not None:
            a = merge_weight(cfg, t)
            ops.kv_merge_update(mem.k, h_k.contiguous(), a)
            ops.kv_merge_update(mem.v, h_v.contiguous(), a)
        elif not mem.lane_major:
            raise ValueError("per-lane merge weights need lane-major memory")
        else:
            for b, tb in enumerate(per_lane(t_new, B)):
                a = merge_weight(cfg, int(tb))
                ops.kv_merge_update(mem.k[b], h_k[b].contiguous(), a)
                ops.kv_merge_update(mem.v[b], h_v[b].contiguous(), a)
        slots = mem.slots * 0 + 1
    else:
        M = mem.k.shape[2]
        start = np.minimum(mem.slots * m, M - m)
        s0 = uniform(start)
        if s0 is not None:
            mem.k[:, :, s0:s0 + m] = h_k
            mem.v[:, :, s0:s0 + m] = h_v
        else:
            for b, sb in enumerate(per_lane(start, B)):
                lk, lv = mem.lane(b, mem.k), mem.lane(b, mem.v)
                hk = h_k[b] if mem.lane_major else h_k[:, b]
                hv = h_v[b] if mem.lane_major else h_v[:, b]
                lk[:, sb:sb + m] = hk
                lv[:, sb:sb + m] = hv
        slots = np.minimum(mem.slots + 1, mem.max_slots(m))
        if not isinstance(mem.slots, np.ndarray):
            slots = int(slots)
    return mem._replace(slots=slots, steps=t_new,
                        stream_pos=mem.stream_pos + n_new_tokens)


def recompress_memory(cfg: ModelConfig, mem: MemState,
                      group: int) -> MemState:
    """Re-run the merge over EXISTING memory slots at a higher ratio:
    every ``group`` consecutive filled <COMP> groups collapse into one
    (position-aligned arithmetic mean in float32, one rounding), shrinking
    a g-group memory to ceil(g / group) groups, IN PLACE.  Groups at or
    past the new count are zeroed.  Per-lane ``slots`` give per-lane
    weights.  Merge mode (1 slot), G <= 1 and ``group == 1`` return the
    state unchanged.  ``steps`` / ``stream_pos`` are unchanged.

    The pressure controller's cheapest lever (``serve.pressure``); lanes
    that must stay bit-exact go through `streaming.recompress_memory_lanes`.
    """
    if group < 1:
        raise ValueError(f"recompress group must be >= 1, got {group}")
    m = cfg.ccm.comp_len
    G = mem.k.shape[2] // m
    if cfg.ccm.mode == "merge" or G <= 1 or group == 1:
        return mem
    B = mem.k.shape[0 if mem.lane_major else 1]
    g = torch.as_tensor(per_lane(mem.slots, B), device=mem.k.device)
    new_g = -(-mem.slots // group)                       # ceil(g / group)
    gi = torch.arange(G, device=mem.k.device)
    owner = gi // group
    w = (owner[None, None, :] == gi[None, :, None]) \
        & (gi[None, None, :] < g[:, None, None])         # (B, G_new, G_old)
    wn = w.float() / w.sum(-1, keepdim=True).clamp(min=1)
    spec = "bji,blimhd->bljmhd" if mem.lane_major else "bji,lbimhd->lbjmhd"
    for x in (mem.k, mem.v):
        shp = x.shape
        xg = x.reshape(shp[0], shp[1], G, m, shp[3], shp[4]).float()
        x.copy_(torch.einsum(spec, wn, xg).reshape(shp).to(x.dtype))
    return mem._replace(slots=new_g if isinstance(new_g, np.ndarray)
                        else int(new_g))
