"""Fixed-shape device memory arena for per-session serving state (port of
``repro/serve/arena.py``).

Every session's ``OnlineState`` (``StreamState`` in a stream arena) is
one *row* of a set of preallocated slabs: each tensor leaf of the
single-session template (inner batch 1) becomes a slab of shape
``(n_rows,) + leaf.shape`` on the arena's device, and each counter leaf
(``pos``, ``cache.length`` or ``win_len``, ``mem.slots`` / ``steps`` /
``stream_pos``, host ints in the port) a host int64 numpy array of shape
``(n_rows,)``.  Slot ids are handed out from a free-list;
nothing is reallocated per session.

REFCOUNTED ROWS: a live row is held by one or more logical references —
a resident session, a forked child sharing its parent's state
copy-on-write, a prefix-cache entry pinning a compressed shared prefix.
``alloc`` hands a row out at refcount 1, ``incref`` adds a holder, and
``free`` DROPS ONE REFERENCE — the row only returns to its shard's
free-list when the count hits zero.  Shared rows are read-only by
contract: every scatter entry point (``unpack`` / ``mark_dirty`` /
``reset_slots``) refuses target rows with refcount > 1; writers break
sharing first (`launch.serve.cow_clone_slots`).  The consistency probe
asserts the refcount bookkeeping and reports any recorded write-guard
violation.

SHARD GEOMETRY: the rows split into ``n_shards`` equal contiguous blocks,
each with its own free-list and one reserved *scratch* row at the
block's end (``pad_slot_of(s)``); ``n_shards=1`` gives ``n_slots + 1``
rows with the scratch row at ``n_slots``.  The geometry is pure Python;
placing the blocks on several devices belongs to the multi-device slice
(the engine refuses ``n_shards > 1`` for now).

``pack`` gathers any set of slot ids into a batch (``(B,) + leaf.shape``
tensors, ``(B,)`` counters) and ``unpack`` scatters an updated batch back
IN PLACE — through the ``session_gather`` / ``session_scatter`` kernel
ops (``kernels/ops.py``) on the card.  The engine's hot path
(`launch.serve.make_arena_step`) gathers, runs the lane-batched op and
scatters the rows the op wrote; pack/unpack here serve offload/restore.

Pad lanes of a short batch point at the scratch row: they gather scratch,
compute garbage and scatter it back to scratch, with no semantic effect.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import inference as I
from repro_torch.core import streaming as STR
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.session_gather import MAX_IDS
from repro_torch.models.config import ModelConfig


class ArenaFull(RuntimeError):
    """No free session slots (caller should offload or shed load).

    Internal to the serve package: `ServeEngine` admission control
    guarantees this never escapes `submit`/`run`; it can still surface
    from direct `SessionArena`/`SessionManager` misuse."""


# ---------------------------------------------------------------------------
# state trees: NamedTuples of tensors (device leaves), counters (host
# ints / int64 arrays) and static flags (bools, None)
# ---------------------------------------------------------------------------

def _static(x) -> bool:
    return x is None or isinstance(x, bool)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every tensor and counter leaf of ``tree`` (and the
    matching leaves of ``rest``); static leaves pass through."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if _static(tree):
        return tree
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def leaf_bytes(x) -> int:
    """Bytes of one tensor leaf; host counters never move (0)."""
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _chunks(ids: List[int]):
    for i in range(0, len(ids), MAX_IDS):
        yield i, ids[i:i + MAX_IDS]


def gather_rows(slabs, ids: Sequence[int]):
    """Rows ``ids`` of every slab: tensor leaves through the gather kernel
    op into fresh ``(B,) + row`` tensors, counters as int64 arrays (B,)."""
    ids = [int(i) for i in ids]

    def one(slab):
        if isinstance(slab, np.ndarray):
            return slab[ids].copy()
        out = torch.empty((len(ids),) + tuple(slab.shape[1:]),
                          dtype=slab.dtype, device=slab.device)
        for i, part in _chunks(ids):
            ops.session_gather(slab, part, out=out[i:i + len(part)])
        return out
    return tree_map(one, slabs)


def scatter_rows(slabs, ids: Sequence[int], rows):
    """``slab[ids] = rows`` for every leaf of ``rows`` IN PLACE (tensor
    leaves through the scatter kernel op); returns ``slabs``."""
    ids = [int(i) for i in ids]

    def one(slab, r):
        if isinstance(slab, np.ndarray):
            slab[ids] = np.asarray(r)
        else:
            for i, part in _chunks(ids):
                ops.session_scatter(slab, part, r[i:i + len(part)])
        return slab
    tree_map(one, slabs, rows)
    return slabs


def online_template(cfg: ModelConfig, cache_len: int,
                    mem_slots: Optional[int] = None):
    """Single-session (inner batch 1) OnlineState of shapes only (tensors
    on the ``meta`` device, counters 0)."""
    return I.init_online_state(cfg, 1, cache_len, mem_slots, device="meta")


def stream_template(cfg: ModelConfig):
    """Single-session (inner batch 1) StreamState of shapes only (tensors
    on the ``meta`` device, counters 0)."""
    return STR.init_stream_state(cfg, 1, device="meta")


class SessionArena:
    """Slab allocator + pack/unpack for one state template."""

    def __init__(self, template: Any, n_slots: int, n_shards: int = 1,
                 device: DeviceLike = None):
        if n_slots < 1:
            raise ValueError("arena needs at least one slot")
        if n_shards < 1:
            raise ValueError("arena needs at least one shard")
        if n_slots % n_shards:
            raise ValueError(
                f"n_slots ({n_slots}) must divide evenly into n_shards "
                f"({n_shards}) so every device owns an equal block")
        self.template = template
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.n_shards = n_shards
        self.slots_per_shard = n_slots // n_shards
        self._stride = self.slots_per_shard + 1   # rows per shard block
        self.n_rows = n_shards * self._stride
        self.slabs = tree_map(self._slab, template)
        self.state_bytes = sum(leaf_bytes(x) for x in tree_leaves(template))
        self._free = [deque(self.shard_slots(s)) for s in range(n_shards)]
        self._live = set()
        self._refs = {}               # slot -> reference count (live only)
        self._dirty = set()           # slots that have ever been written
        self._violations = []         # recorded shared-row write attempts

    def _slab(self, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.zeros((self.n_rows,) + tuple(leaf.shape),
                               dtype=leaf.dtype, device=self.device)
        return np.zeros(self.n_rows, dtype=np.int64)

    # -- allocation ----------------------------------------------------
    @classmethod
    def for_online(cls, cfg: ModelConfig, n_slots: int, cache_len: int,
                   mem_slots: Optional[int] = None, n_shards: int = 1,
                   device: DeviceLike = None) -> "SessionArena":
        return cls(online_template(cfg, cache_len, mem_slots), n_slots,
                   n_shards, device)

    @classmethod
    def for_stream(cls, cfg: ModelConfig, n_slots: int, n_shards: int = 1,
                   device: DeviceLike = None) -> "SessionArena":
        return cls(stream_template(cfg), n_slots, n_shards, device)

    # -- shard geometry ------------------------------------------------
    def shard_slots(self, shard: int) -> range:
        """The data rows shard ``shard`` owns (its scratch row excluded)."""
        base = shard * self._stride
        return range(base, base + self.slots_per_shard)

    def pad_slot_of(self, shard: int) -> int:
        """The shard's reserved scratch row (batch padding lanes)."""
        return shard * self._stride + self.slots_per_shard

    @property
    def pad_slot(self) -> int:
        """Shard 0's scratch row — with ``n_shards == 1`` this is row
        ``n_slots``."""
        return self.pad_slot_of(0)

    def shard_of(self, slot: int) -> int:
        """Owning shard of a global slot/row id."""
        return slot // self._stride

    def local_row(self, slot: int) -> int:
        """Row index within the owning shard's block."""
        return slot % self._stride

    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self._free)

    def shard_free(self, shard: int) -> int:
        return len(self._free[shard])

    @property
    def occupancy(self) -> float:
        return 1.0 - self.n_free / self.n_slots

    def alloc(self, shard: int = 0) -> int:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")
        if not self._free[shard]:
            raise ArenaFull(
                f"all {self.slots_per_shard} slots of shard {shard} in use")
        slot = self._free[shard].popleft()
        self._live.add(slot)
        self._refs[slot] = 1
        return slot

    def incref(self, slot: int) -> int:
        """Add one logical reference to a live row (fork / prefix-cache
        attach); returns the new count."""
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not allocated")
        self._refs[slot] += 1
        return self._refs[slot]

    def refcount(self, slot: int) -> int:
        """Current reference count (0 for rows not allocated)."""
        return self._refs.get(slot, 0)

    def shared(self, slot: int) -> bool:
        """Whether the row has more than one holder (writes forbidden
        until sharing is broken)."""
        return self._refs.get(slot, 0) > 1

    def shared_slots(self) -> List[int]:
        """Live rows currently held by more than one reference."""
        return sorted(s for s, n in self._refs.items() if n > 1)

    def free(self, slot: int) -> int:
        """Drop ONE reference; the row returns to its shard's free-list
        only when no holder remains.  Returns the remaining count."""
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not allocated")
        self._refs[slot] -= 1
        left = self._refs[slot]
        if left == 0:
            del self._refs[slot]
            self._live.remove(slot)
            self._free[self.shard_of(slot)].append(slot)
        return left

    def _guard_writes(self, slot_ids) -> None:
        """Reject any scatter targeting a shared row (refcount > 1).
        Violations are recorded (surfaced by `consistency_errors`) and
        raised — callers must COW-break first."""
        bad = sorted({int(s) for s in slot_ids
                      if self._refs.get(int(s), 0) > 1})
        if bad:
            msg = (f"write targets shared rows {bad} (refcount > 1): "
                   "break sharing (cow_clone_slots) before any scatter")
            self._violations.append(msg)
            raise RuntimeError(msg)

    def metrics_sample(self) -> dict:
        """Point-in-time occupancy sample for gauge export."""
        return {"n_slots": self.n_slots, "live": self.n_slots - self.n_free,
                "free": self.n_free, "occupancy": self.occupancy,
                "shared": len(self.shared_slots()),
                "shards": [
                    {"n_slots": self.slots_per_shard,
                     "live": self.slots_per_shard - len(self._free[s]),
                     "free": len(self._free[s]),
                     "occupancy": 1.0 - (len(self._free[s])
                                         / self.slots_per_shard)}
                    for s in range(self.n_shards)]}

    def consistency_errors(self) -> list:
        """Free-list / live-set invariant violations (empty = healthy):
        no slot both free and live, no duplicates in any shard's free
        list, every data row of every shard accounted exactly once, no
        slot parked on the wrong shard's free-list, refcounts only for
        live rows and positive, and no recorded shared-row write."""
        errs = []
        all_free = []
        for shard in range(self.n_shards):
            free = list(self._free[shard])
            owned = set(self.shard_slots(shard))
            stray = [s for s in free if s not in owned]
            if stray:
                errs.append(f"shard {shard} free list holds foreign "
                            f"slots: {sorted(stray)}")
            all_free.extend(free)
        if len(all_free) != len(set(all_free)):
            errs.append(f"duplicate slots in free lists: "
                        f"{sorted(all_free)}")
        overlap = set(all_free) & self._live
        if overlap:
            errs.append(f"slots both free and live: {sorted(overlap)}")
        data_rows = set()
        for shard in range(self.n_shards):
            data_rows.update(self.shard_slots(shard))
        missing = data_rows - set(all_free) - self._live
        if missing:
            errs.append(f"slots leaked (neither free nor live): "
                        f"{sorted(missing)}")
        bogus = (set(all_free) | self._live) - data_rows
        if bogus:
            errs.append(f"out-of-range slots tracked: {sorted(bogus)}")
        unref = self._live - set(self._refs)
        if unref:
            errs.append(f"live slots with no refcount: {sorted(unref)}")
        ghost = set(self._refs) - self._live
        if ghost:
            errs.append(f"refcounts tracked for dead slots: "
                        f"{sorted(ghost)}")
        nonpos = sorted(s for s, n in self._refs.items() if n < 1)
        if nonpos:
            errs.append(f"non-positive refcounts: {nonpos}")
        errs.extend(f"shared-row write attempted: {v}"
                    for v in self._violations)
        return errs

    # -- batched pack/unpack -------------------------------------------
    def pack(self, slot_ids: Sequence[int]):
        """Gather slots into a batch: tensors (B,) + row shape on the
        arena's device (fresh copies), counters int64 (B,)."""
        return gather_rows(self.slabs, slot_ids)

    def unpack(self, slot_ids: Sequence[int], state) -> None:
        """Scatter an updated batch back into the slabs, in place."""
        self._guard_writes(slot_ids)
        self._dirty.update(int(i) for i in slot_ids)
        scatter_rows(self.slabs, slot_ids, state)

    def mark_dirty(self, slot_ids: Sequence[int]) -> None:
        """Record external writes (the engine's fused step scatters into
        ``slabs`` directly without going through ``unpack``)."""
        self._guard_writes(slot_ids)
        self._dirty.update(int(i) for i in slot_ids)

    # -- single-slot access --------------------------------------------
    def read_slot(self, slot: int):
        """A copy of one session's state (template shape, no batch axis)."""
        return tree_map(lambda x: x[0] if isinstance(x, torch.Tensor)
                        else int(x[0]), self.pack([slot]))

    def write_slot(self, slot: int, state) -> None:
        """Write one session's state (template shape) into a slot."""
        self.unpack([slot], tree_map(
            lambda x: x[None] if isinstance(x, torch.Tensor)
            else np.asarray([x], np.int64), state))

    def reset_slots(self, slot_ids: Sequence[int]) -> None:
        """Zero slots (fresh sessions): never-written slots are already
        zero from construction and are skipped; the rest are cleared row
        by row in place."""
        stale = [s for s in slot_ids if s in self._dirty]
        if not stale:
            return
        self._guard_writes(stale)

        def zero(slab):
            if isinstance(slab, np.ndarray):
                slab[stale] = 0
            else:
                for s in stale:
                    slab[s].zero_()
            return slab
        tree_map(zero, self.slabs)
        self._dirty.difference_update(stale)

    def reset_slot(self, slot: int) -> None:
        """Zero a slot (fresh session without a host-side init tree)."""
        self.reset_slots([slot])
