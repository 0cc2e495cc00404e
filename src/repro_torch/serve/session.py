"""Session lifecycle + batched host offload with tenant-aware eviction
(port of ``repro/serve/session.py``).

A session is a named user stream whose state lives in one arena slot
while *resident*.  When the arena (or the ``max_resident`` budget, or
its tenant's resident-slot quota — see `serve.admission`) is exhausted,
least-recently-used victims are offloaded to host memory (pinned host
tensors) and their slots freed; the next request on an offloaded session
transparently restores it.

Offload and restore are BATCHED: activation picks every victim the
batch needs up front, packs their arena rows with ONE gather into a
staging batch on the device (the ``session_gather`` kernel), and copies
it into pinned host tensors; a restore stacks the host rows and moves
them with ONE host-to-device copy per leaf, then scatters them into
their slots (the ``session_scatter`` kernel).  Per-victim transfers
survive as ``batched_offload=False``.  Unlike the reference, batches are
not padded up to a bucket: the port compiles nothing per shape, so a pad
row would only add wire bytes.

``async_offload=True`` overlaps the device->host copy with the engine's
next scheduler pop.  The arena's slabs are overwritten in place and a
freed slot is handed to the next session at once, so the copy never
reads the slab: the main stream first packs the victims' rows into the
staging batch, then a side stream (ordered after the gather by
``wait_stream``) copies the staging batch to the host; the staging
tensors are ``record_stream``-ed on the side stream and an event marks
the copy's end.  A restore of a session still in flight, and `sync()`,
wait on that event.

On a SHARDED arena the manager stays global: one LRU clock, one session
table, one ``max_resident`` budget; sessions are pinned to one shard
for life, slot scarcity is resolved PER SHARD during activation
planning, and batched offload/restore stage host transfers per shard,
to and from the shard's own device on a placed arena (transfer counters
and the bandwidth gauges carry a ``shard`` label).  A row that batch
sessions leave — a victim's, or a shared row one breaks away from —
may stay alive on a prefix-cache pin alone; the planner drops such pins
rather than starve (the reference raises ``ArenaFull``; ROADMAP §3).

Offload -> restore is a pure copy of the state tree, so a restored
session's next logits are bit-identical to never having been offloaded.
An optional `OffloadCostModel` compares that transfer latency against
REPLAYING the session's recorded request history from a zero slot and
drops the state entirely when recompute is cheaper; replayed state is
numerically equivalent but not bit-exact (a replay runs at batch 1), so
the cost model is opt-in.

Fresh sessions carry no host tree: their slot is zero-initialised on
first activation (all state inits are zeros + zero counters).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Collection, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.serve import cow_clone_slots
from repro_torch.obs import Observability
from repro_torch.serve.arena import (ArenaFull, SessionArena, tree_leaves,
                                     tree_map)


@dataclasses.dataclass
class Session:
    sid: str
    tenant: str = "default"        # admission-quota group
    shard: int = 0                 # owning arena shard (fixed for life)
    slot: Optional[int] = None     # arena slot while resident
    host_state: Any = None         # host tree while offloaded (None = zero)
    fresh: bool = True             # never activated yet
    needs_replay: bool = False     # state dropped; rebuild from history
    history: Optional[list] = None  # [(op, tokens)] when recording enabled
    history_tokens: int = 0        # running total (cost-model decision)
    last_used: int = 0             # logical LRU clock
    n_ops: int = 0
    n_offloads: int = 0
    mem_groups: int = 0            # filled <COMP> groups (host mirror of
    #                                the slot's MemState.slots; the
    #                                pressure controller's footprint and
    #                                recompress-candidate accounting)

    @property
    def resident(self) -> bool:
        return self.slot is not None


@dataclasses.dataclass(frozen=True)
class OffloadResult:
    """Structured outcome of an offload attempt.  Offloading an unknown
    or already-offloaded session is a NO-OP with a telling status — it
    used to trust callers and crash (unknown sid) or silently pass."""
    sid: str
    status: str   # offloaded | recompute | already-offloaded | fresh | unknown
    n_bytes: int = 0

    @property
    def moved(self) -> bool:
        return self.status in ("offloaded", "recompute")


@dataclasses.dataclass(frozen=True)
class CloseResult:
    """Structured outcome of closing a session.  Closing an unknown sid
    is a NO-OP with a telling status — it used to KeyError out of the
    manager (and out of `ServeEngine.close_session`) after the caller
    had already cancelled queue entries, leaving the engine's side
    tables half-torn-down."""
    sid: str
    status: str                 # closed | unknown
    was_resident: bool = False

    @property
    def closed(self) -> bool:
        return self.status == "closed"


@dataclasses.dataclass(frozen=True)
class OffloadCostModel:
    """Restore-from-host vs recompute-from-history, per session.

    The transfer path pays the state tree down AND back up
    (``2 * state_bytes / host_bandwidth``); the recompute path pays
    nothing at offload time and replays the session's recorded requests
    at restore time (``history_tokens / replay_tokens_per_s``).  Both
    rates are workload constants the operator calibrates (defaults are
    a PCIe-ish bandwidth and a small-model CPU replay rate).

    ``calibrated=True`` folds MEASURED rates back in at decision time:
    `SessionManager.effective_cost_model` overrides ``host_bandwidth``
    with the bandwidth gauge and ``replay_tokens_per_s`` with the replay
    token/seconds counters once those sensors have data, so the
    transfer-vs-recompute tradeoff tracks the hardware actually
    underneath instead of the operator's guess.

    ``latch_history``: whether a transfer-wins decision permanently
    drops the session's replay history.  Sound for static rates (history
    only grows, state bytes are constant — transfer keeps winning) but
    WRONG under calibration or any bandwidth change at runtime: a
    degraded link can flip the decision back to recompute, which needs
    the history that the latch threw away.  Set False to keep recording
    (costs host memory proportional to history)."""
    host_bandwidth: float = 8e9          # bytes/s, device<->host
    replay_tokens_per_s: float = 2e4
    calibrated: bool = False
    latch_history: bool = True

    def transfer_seconds(self, state_bytes: int) -> float:
        return 2.0 * state_bytes / self.host_bandwidth

    def replay_seconds(self, history_tokens: int) -> float:
        return history_tokens / self.replay_tokens_per_s

    def prefers_recompute(self, state_bytes: int,
                          history_tokens: int) -> bool:
        return (self.replay_seconds(history_tokens)
                < self.transfer_seconds(state_bytes))


class SessionManager:
    def __init__(self, arena: SessionArena,
                 max_resident: Optional[int] = None, *,
                 batched_offload: bool = True,
                 async_offload: bool = False,
                 cost_model: Optional[OffloadCostModel] = None,
                 replay_fn: Optional[Callable] = None,
                 resident_quota_of: Optional[Callable[[str],
                                                      Optional[int]]] = None,
                 obs: Optional[Observability] = None):
        """``batched_offload``: move k victims with one gather + one
        host copy per leaf each way (False = per-victim transfers).
        ``async_offload``: don't block on the device->host copy; the
        engine overlaps it with the next scheduler pop and `sync()`s at
        drain end.  ``cost_model`` + ``replay_fn(sid, slot, history)``:
        drop state instead of transferring when replaying the session's
        history is cheaper (enables per-session request recording).
        ``resident_quota_of(tenant)``: per-tenant resident-slot cap —
        activation evicts the tenant's own LRU session once at quota."""
        self.arena = arena
        self.max_resident = min(max_resident or arena.n_slots,
                                arena.n_slots)
        self.batched_offload = batched_offload
        self.async_offload = async_offload
        self.cost_model = cost_model
        self.replay_fn = replay_fn
        self.resident_quota_of = resident_quota_of or (lambda tenant: None)
        self.sessions: Dict[str, Session] = {}
        self._clock = 0
        # async transfers not yet synced: [host buffer, n transfer rows,
        # shard, {sids whose state rides the buffer}, end event].  The sid
        # set is how close() severs a closed session from a copy still
        # on the wire — entries with no surviving sids are dropped (the
        # pinned buffer's allocator waits for the copy before reuse).
        self._inflight: List[Any] = []
        # optional hook the engine wires to the prefix cache: called
        # with a shard id when activation planning needs a free slot,
        # returns the number of cache-only rows released (0 or 1) —
        # dropping a cached prefix nobody references is cheaper than
        # evicting a live session
        self.cache_release: Optional[Callable[[int], int]] = None
        # slot-targeted variant: drop the cache pin on ONE specific row
        # (returns True if an entry held it).  Needed when an eviction
        # victim's row would otherwise stay alive on a cache pin alone —
        # evicting the session then frees nothing and activation starves
        self.cache_unpin: Optional[Callable[[int], bool]] = None
        self._cuda = arena.device.type == "cuda"
        self._side: Dict[torch.device, torch.cuda.Stream] = {}  # per device
        self._state_bytes = arena.state_bytes
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        # engines with several arenas (online + stream) share one
        # registry; declaration is idempotent so these families
        # aggregate across managers
        self._m_bytes = reg.counter(
            "offload_bytes_total",
            "state bytes transferred device<->host, pack padding "
            "included (actual wire bytes)", labels=("dir", "shard"))
        self._m_seconds = reg.counter(
            "offload_transfer_seconds_total",
            "host seconds around the transfer: true (blocked) time on "
            "synchronous offloads, dispatch time on async offloads and "
            "restores", labels=("dir", "shard"))
        self._m_sessions = reg.counter(
            "offload_sessions_total",
            "sessions moved device<->host", labels=("dir", "shard"))
        self._m_decisions = reg.counter(
            "offload_decisions_total",
            "cost-model offload decisions (transfer vs recompute); "
            "absent when no cost model is wired", labels=("decision",))
        self._m_replays = reg.counter(
            "offload_replay_sessions_total",
            "recompute-dropped sessions rebuilt from request history")
        self._m_replay_tokens = reg.counter(
            "offload_replay_tokens_total",
            "tokens re-executed by restore replays")
        self._m_replay_s = reg.counter(
            "offload_replay_seconds_total",
            "seconds blocked re-executing restore replays (with "
            "offload_replay_tokens_total this measures the achieved "
            "replay rate, calibrating OffloadCostModel "
            "replay_tokens_per_s)")
        self._m_sync_s = reg.counter(
            "offload_sync_seconds_total",
            "seconds blocked in sync() barriers on async transfers")
        self._g_bw = reg.gauge(
            "offload_measured_bandwidth_bytes_per_s",
            "device->host bandwidth measured on the last synchronous "
            "offload transfer (calibrates OffloadCostModel "
            "host_bandwidth; 0 until the first blocking transfer)")
        self._g_shard_bw = reg.gauge(
            "offload_shard_bandwidth_bytes_per_s",
            "device->host bandwidth of the last measured transfer PER "
            "ARENA SHARD (each shard stages its own host copies; the "
            "unlabeled calibration gauge above stays global)",
            labels=("shard",))
        self._m_cow = reg.counter(
            "serve_cow_breaks_total",
            "copy-on-write breaks: shared arena rows cloned into fresh "
            "slots (one gather + scatter per shard per activation) before "
            "a batch could write them", labels=("shard",))
        for d in ("offload", "restore"):
            for s in range(arena.n_shards):
                self._m_bytes.labels(dir=d, shard=str(s))
                self._m_seconds.labels(dir=d, shard=str(s))
                self._m_sessions.labels(dir=d, shard=str(s))
        for s in range(arena.n_shards):
            self._g_shard_bw.labels(shard=str(s))
            self._m_cow.labels(shard=str(s))

    def _count_transfer(self, direction: str, n_rows: int, n_sessions: int,
                        seconds: float, measured: bool,
                        shard: int = 0) -> None:
        """Book one device<->host transfer; ``measured`` marks a blocked
        (true wall time) transfer, which also updates the bandwidth
        gauges the cost model can be calibrated against.  ``shard`` is
        the arena shard whose rows moved (batched transfers stage per
        shard, so one call is always one shard)."""
        n_bytes = n_rows * self._state_bytes
        lab = dict(dir=direction, shard=str(shard))
        self._m_bytes.labels(**lab).inc(n_bytes)
        self._m_seconds.labels(**lab).inc(seconds)
        self._m_sessions.labels(**lab).inc(n_sessions)
        if measured and seconds > 0:
            self._g_bw.set(n_bytes / seconds)
            self._g_shard_bw.labels(shard=str(shard)).set(n_bytes / seconds)
        self.obs.recorder.note(
            direction, f"sessions={n_sessions} rows={n_rows} "
                       f"shard={shard} bytes={n_bytes} "
                       f"seconds={seconds:.6f}"
                       + (" (dispatch)" if not measured else ""))

    # -- lifecycle -----------------------------------------------------
    def create(self, sid: str, tenant: str = "default",
               shard: int = 0) -> Session:
        """``shard``: the arena shard this session is pinned to for its
        whole life (the engine places sessions least-loaded-first at
        creation; state never migrates between shards)."""
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already exists")
        if not 0 <= shard < self.arena.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.arena.n_shards})")
        sess = Session(sid=sid, tenant=tenant, shard=shard,
                       history=[] if self.cost_model is not None else None)
        self.sessions[sid] = sess
        return sess

    def shard_load(self) -> List[int]:
        """Open sessions per shard (resident or not) — the engine's
        least-loaded placement signal."""
        load = [0] * self.arena.n_shards
        for s in self.sessions.values():
            load[s.shard] += 1
        return load

    def close(self, sid: str) -> CloseResult:
        """Tear a session down; unknown sids are a structured no-op
        (`CloseResult(status="unknown")`), not a KeyError.  Host-side
        references — an async-offloaded state buffer still in flight, a
        retained replay history — are dropped NOW rather than riding
        along until the dict entry is garbage-collected, so closing an
        offloaded session actually releases its host memory at the next
        `sync()` instead of stranding it."""
        sess = self.sessions.pop(sid, None)
        if sess is None:
            return CloseResult(sid, "unknown")
        was_resident = sess.resident
        if was_resident:
            self.arena.free(sess.slot)
            sess.slot = None
        sess.host_state = None
        sess.history = None
        sess.needs_replay = False
        # sever the sid from async transfers still on the wire: a
        # buffer carrying ONLY closed sessions is dropped outright (the
        # pinned allocator keeps its block until the copy is done) so
        # sync() never books bandwidth for — or retains — state nobody
        # can restore
        if self._inflight:
            for ent in self._inflight:
                ent[3].discard(sid)
            self._inflight = [e for e in self._inflight if e[3]]
        return CloseResult(sid, "closed", was_resident=was_resident)

    # -- forks / shared rows -------------------------------------------
    def fork(self, parent_sid: str, child_sid: str,
             tenant: Optional[str] = None) -> Session:
        """Copy-on-write fork: the child starts as a byte-identical
        branch of the parent at zero device cost.  A RESIDENT parent's
        arena row is shared (incref — the row is read-only until one of
        them writes, at which point `activate_batch` clones it); an
        OFFLOADED parent's host tree is shared by reference (immutable
        on host — each restore scatters into its own fresh slot); a
        recompute-dropped parent propagates ``needs_replay`` with the
        copied history.  The child pins to the parent's shard — forks
        never cross a device boundary."""
        parent = self.sessions.get(parent_sid)
        if parent is None:
            raise ValueError(f"unknown parent session {parent_sid!r}")
        child = self.create(child_sid, tenant or parent.tenant,
                            parent.shard)
        self._clock += 1
        child.last_used = self._clock
        if parent.history is not None:
            child.history = list(parent.history)
        child.history_tokens = parent.history_tokens
        child.mem_groups = parent.mem_groups
        child.n_ops = parent.n_ops
        if parent.resident:
            self.arena.incref(parent.slot)
            child.slot = parent.slot
            child.fresh = False
        elif parent.host_state is not None:
            child.host_state = parent.host_state   # shared immutable tree
            child.fresh = False
            # the parent's state may still be an async transfer on the
            # wire — the child's restore must order behind it too
            for ent in self._inflight:
                if parent_sid in ent[3]:
                    ent[3].add(child_sid)
        elif parent.needs_replay:
            child.needs_replay = True
            child.fresh = False
        # else: parent never activated — the child is fresh too (both
        # zero-init on first activation)
        self.obs.recorder.note(
            "fork", f"parent={parent_sid} child={child_sid} "
                    f"shard={parent.shard} "
                    f"shared_slot={parent.slot if parent.resident else None}")
        return child

    def adopt_row(self, sid: str, tenant: str, shard: int, slot: int,
                  mem_groups: int = 0) -> Session:
        """Create a session attached to an EXISTING live arena row
        (prefix-cache dedup hit): increfs the row and starts the session
        resident on it, read-only until its first write COW-breaks."""
        sess = self.create(sid, tenant, shard)
        self.arena.incref(slot)
        sess.slot = slot
        sess.fresh = False
        sess.mem_groups = mem_groups
        self._clock += 1
        sess.last_used = self._clock
        return sess

    def slot_sharers(self, slot: int) -> List[str]:
        """Resident sids currently holding ``slot`` (refcount holders
        that are sessions; a prefix-cache entry can hold one more)."""
        return sorted(s.sid for s in self.sessions.values()
                      if s.slot == slot)

    @property
    def n_resident(self) -> int:
        return sum(1 for s in self.sessions.values() if s.resident)

    def n_resident_of(self, tenant: str) -> int:
        return sum(1 for s in self.sessions.values()
                   if s.resident and s.tenant == tenant)

    def record(self, sid: str, op: str, tokens: np.ndarray) -> None:
        """Append a delivered request to the session's replay history
        (no-op unless the cost model enabled recording).  ``tokens`` is
        retained as-is — callers hand over an array nothing mutates
        (the engine passes the queue's private request copy)."""
        sess = self.sessions.get(sid)
        if sess is not None and sess.history is not None:
            sess.history.append((op, tokens))
            sess.history_tokens += int(np.asarray(tokens).size)

    # -- residency -----------------------------------------------------
    def activate(self, sid: str, pinned: Collection[str] = ()) -> int:
        """Ensure ``sid`` is resident (restoring / evicting as needed)
        and return its slot.  Sessions in ``pinned`` are never evicted —
        pass the current batch's sids so co-scheduled sessions survive."""
        return self.activate_batch([sid], pinned)[0]

    def activate_batch(self, sids, pinned: Collection[str] = ()) -> list:
        """Make every session in ``sids`` resident and return their slots.

        Four phases, each one device dispatch for the whole batch:
        (1) plan — walk the batch in order, picking every eviction
        victim up front (tenant-quota LRU first, then global LRU for
        the ``max_resident`` budget, then the owning SHARD's LRU when
        that shard is out of free slots — a full shard evicts its own
        victim even while other shards have room, since sessions never
        migrate).  Slot scarcity is REFCOUNT-AWARE: evicting a session
        that shares its row only frees the slot when no other holder
        remains, and cache-only prefix rows are released (engine-wired
        ``cache_release`` hook) before any live session is evicted.
        Batch sessions sitting on a SHARED row additionally reserve a
        fresh slot for their copy-on-write break — a write must never
        scatter into a row with refcount > 1; (2) evict — ONE batched
        offload of all victims (staged per shard, one transfer per
        unique row inside `offload_batch`); (3) COW-break — clone every
        still-shared batch row into its reserved slot with one
        `cow_clone_slots` per shard and drop the reference on the
        shared original; (4) admit — allocate slots on each session's
        own shard, zero fresh sessions, restore offloaded sessions with
        one stacked host-to-device copy + scatter per shard, and replay
        recompute-dropped sessions from their history."""
        untouchable = set(pinned) | set(sids)
        res = {s.sid: s for s in self.sessions.values() if s.resident}
        victims: List[Session] = []
        avail = [self.arena.shard_free(s)
                 for s in range(self.arena.n_shards)]
        # planned refcounts: eviction decrefs are staged here so the
        # planner knows which evictions actually free a slot (a shared
        # row survives until its last holder goes)
        plan_ref: Dict[int, int] = {}

        def ref_left(slot: int) -> int:
            return plan_ref.get(slot, self.arena.refcount(slot))

        def evict_one(pool, why="batch size exceeds arena capacity"):
            cands = [s for s in pool if s.sid not in untouchable]
            if not cands:
                raise ArenaFull(f"no evictable session: {why}")
            v = min(cands, key=lambda s: s.last_used)
            victims.append(v)
            del res[v.sid]
            plan_ref[v.slot] = ref_left(v.slot) - 1
            if plan_ref[v.slot] == 0:
                avail[v.shard] += 1
            return v

        def unpin_victim_row(shard: int) -> bool:
            # a planned victim's row may stay alive on a prefix-cache pin
            # alone — drop that pin, else the eviction frees no slot and
            # the loop starves out of candidates.  Victims planned by the
            # quota and max_resident loops count too: the reference
            # checks only the victim make_room itself just evicted, and
            # raises ArenaFull out of ServeEngine.run when a full batch
            # needs the row of a session the max_resident loop evicted
            if self.cache_unpin is None:
                return False
            for v in victims:
                if v.shard == shard and plan_ref.get(v.slot, 0) > 0 \
                        and self.cache_unpin(v.slot):
                    plan_ref[v.slot] -= 1
                    if plan_ref[v.slot] == 0:
                        avail[shard] += 1
                    return True
            return False

        def unpin_broken_row(shard: int, breaking: Optional[Session]) -> bool:
            # the last resort before ArenaFull: a shared row that batch
            # sessions break away from may be left to a prefix-cache pin
            # alone.  Drop that pin and the row's last session keeps it
            # with no copy, so the slot reserved for its copy-on-write
            # break stays free — for a session broken away earlier in the
            # batch, and for ``breaking``, the one now asking for its
            # reservation.  The reference raises ArenaFull here (a full
            # shard whose batch holds a cache-pinned row)
            if self.cache_unpin is None:
                return False
            for c in cow:
                if c.shard == shard and c is not breaking \
                        and plan_ref.get(c.slot, 0) == 1 \
                        and self.cache_unpin(c.slot):
                    plan_ref[c.slot] = 0
                    avail[shard] += 1
                    return True
            if breaking is not None and ref_left(breaking.slot) == 2 \
                    and self.cache_unpin(breaking.slot):
                if breaking.slot in plan_ref:
                    plan_ref[breaking.slot] -= 1
                avail[shard] += 1
                return True
            return False

        def make_room(shard: int, why: str,
                      breaking: Optional[Session] = None) -> None:
            while avail[shard] == 0:
                if self.cache_release is not None \
                        and self.cache_release(shard):
                    avail[shard] += 1
                    continue
                if unpin_victim_row(shard):
                    continue
                pool = [s for s in res.values() if s.shard == shard]
                if all(s.sid in untouchable for s in pool) \
                        and unpin_broken_row(shard, breaking):
                    continue
                evict_one(pool, why=why)

        need: List[str] = []
        cow: List[Session] = []
        cow_sids = set()
        for sid in sids:
            sess = self.sessions[sid]
            self._clock += 1
            sess.last_used = self._clock
            if sess.resident:
                # a batch session on a shared row needs a private copy
                # before the step's scatter — reserve a slot for the
                # COW break on its own shard
                if sid not in cow_sids and ref_left(sess.slot) > 1:
                    cow_sids.add(sid)
                    cow.append(sess)
                    make_room(sess.shard,
                              why=f"shard {sess.shard} has no free slot "
                                  "for a copy-on-write break",
                              breaking=sess)
                    avail[sess.shard] -= 1
                    # once broken away this session no longer holds the
                    # shared row, so a sibling later in the batch may
                    # keep it (as `_cow_break` finds at execution).  The
                    # reference reserves a slot for every sharer and
                    # raises ArenaFull on a full batch holding siblings
                    plan_ref[sess.slot] = ref_left(sess.slot) - 1
                continue
            if sid in need:
                continue
            quota = self.resident_quota_of(sess.tenant)
            if quota is not None:
                while sum(1 for s in res.values()
                          if s.tenant == sess.tenant) >= quota:
                    evict_one([s for s in res.values()
                               if s.tenant == sess.tenant])
            while len(res) >= self.max_resident:
                evict_one(res.values())
            make_room(sess.shard,
                      why=f"shard {sess.shard} has no free slot and "
                          "no evictable resident")
            res[sid] = sess          # planned resident
            need.append(sid)
            avail[sess.shard] -= 1

        if victims:
            self.offload_batch([v.sid for v in victims])
        if cow:
            self._cow_break(cow)

        fresh_slots, replay, restore = [], [], []
        for sid in need:
            sess = self.sessions[sid]
            sess.slot = self.arena.alloc(sess.shard)
            if sess.host_state is not None:
                restore.append(sess)
            elif sess.needs_replay:
                fresh_slots.append(sess.slot)
                replay.append(sess)
            else:
                # fresh (never activated) — offload always leaves either
                # host_state or needs_replay, so nothing else reaches here
                fresh_slots.append(sess.slot)
            sess.fresh = False
        if fresh_slots:
            self.arena.reset_slots(fresh_slots)
        if restore:
            self._restore_batch(restore)
        for sess in replay:
            if self.replay_fn is None:
                raise RuntimeError(
                    f"session {sess.sid!r} needs replay but no replay_fn "
                    "is wired (cost model dropped its state)")
            t0 = self.obs.clock.now()
            self.replay_fn(sess.sid, sess.slot, sess.history or [])
            # the seconds counter must see true time or the calibrated
            # replay rate inflates
            self._wait_device()
            self._m_replay_s.inc(self.obs.clock.now() - t0)
            sess.needs_replay = False
            self._m_replays.inc()
            self._m_replay_tokens.inc(sess.history_tokens)
            self.obs.recorder.note(
                "replay", f"sid={sess.sid} tokens={sess.history_tokens}")
        return [self.sessions[sid].slot for sid in sids]

    def _cow_break(self, sess_list: List[Session]) -> None:
        """Clone each session's shared row into a freshly allocated slot
        on its own shard (one `cow_clone_slots` per shard) and drop the
        reference on the shared original — the siblings' row is never
        written.  Sessions whose row stopped being shared since
        planning (a sibling was evicted or closed meanwhile) keep their
        slot; the conservative reservation is simply unused."""
        todo = [s for s in sess_list if self.arena.shared(s.slot)]
        by_shard: Dict[int, List[Session]] = {}
        for sess in todo:
            by_shard.setdefault(sess.shard, []).append(sess)
        for shard in sorted(by_shard):
            group = by_shard[shard]
            src = [s.slot for s in group]
            dst = [self.arena.alloc(shard) for _ in group]
            self.arena.slabs = cow_clone_slots(self.arena.slabs, src, dst)
            for sess, new in zip(group, dst):
                old = sess.slot
                sess.slot = new
                self.arena.free(old)          # drop ref; siblings keep it
            self.arena.mark_dirty(dst)
            self._m_cow.labels(shard=str(shard)).inc(len(group))
            self.obs.recorder.note(
                "cow_break", f"shard={shard} rows={len(group)} "
                             f"src={src} dst={dst}")

    # -- offload -------------------------------------------------------
    def _classify(self, sid: str) -> Optional[OffloadResult]:
        """Structured no-op verdicts; None = resident, proceed."""
        sess = self.sessions.get(sid)
        if sess is None:
            return OffloadResult(sid, "unknown")
        if sess.resident:
            return None
        if sess.host_state is not None or sess.needs_replay:
            return OffloadResult(sid, "already-offloaded")
        return OffloadResult(sid, "fresh")

    def effective_cost_model(self) -> Optional[OffloadCostModel]:
        """The cost model with measured rates folded in.  With
        ``calibrated=False`` (or no model) this is ``cost_model``
        verbatim; with ``calibrated=True`` the operator constants are
        only the cold-start fallback — ``host_bandwidth`` comes from the
        bandwidth gauge and ``replay_tokens_per_s`` from the replay
        token/seconds counters once each sensor has data."""
        cm = self.cost_model
        if cm is None or not cm.calibrated:
            return cm
        kw = {}
        bw = float(self._g_bw.value)
        if bw > 0:
            kw["host_bandwidth"] = bw
        tokens = float(self._m_replay_tokens.value)
        seconds = float(self._m_replay_s.value)
        if tokens > 0 and seconds > 0:
            kw["replay_tokens_per_s"] = tokens / seconds
        return dataclasses.replace(cm, **kw) if kw else cm

    def _drop_for_recompute(self, sess: Session) -> bool:
        """True when the cost model chose recompute: state dropped, slot
        freed, nothing transferred."""
        if (self.cost_model is None or self.replay_fn is None
                or sess.history is None):
            return False
        cm = self.effective_cost_model()
        if not cm.prefers_recompute(self._state_bytes,
                                    sess.history_tokens):
            if cm.latch_history:
                # history only grows and state bytes are constant, so
                # under STATIC rates once the transfer wins it wins
                # forever — drop the retained token arrays and stop
                # recording (bounds host memory; the session is
                # transfer-only from here on).  Calibrated rates move at
                # runtime — a degraded link can flip the decision back —
                # so latching is policy-controlled via ``latch_history``.
                sess.history = None
            self._m_decisions.labels(decision="transfer").inc()
            return False
        self._m_decisions.labels(decision="recompute").inc()
        self.arena.free(sess.slot)
        sess.slot = None
        sess.host_state = None
        sess.needs_replay = True
        sess.n_offloads += 1
        return True

    # -- host transfers ------------------------------------------------
    def _wait_device(self) -> None:
        if self._cuda:
            for dev in set(self.arena.devices):
                torch.cuda.synchronize(dev)

    def _to_host(self, packed, shard: int):
        """Copy a packed batch of one shard's rows (fresh tensors on the
        shard's device from ``arena.pack``, host counters) into host
        memory.  Returns (host tree, event): the event marks the end of
        an async copy on the device's side stream (None when the copy is
        complete on return)."""
        if not self._cuda:
            return packed, None           # the gather made fresh copies
        dev = self.arena.devices[shard]

        def pinned(x):
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)

        if not self.async_offload:
            return tree_map(lambda x: pinned(x).copy_(x)
                            if isinstance(x, torch.Tensor) else x,
                            packed), None
        main = torch.cuda.current_stream(dev)
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(dev)
        # the side stream copies only after the gather kernels that
        # filled the staging batch; the staging tensors stay allocated
        # until the side stream is done with them
        side.wait_stream(main)
        with torch.cuda.stream(side):
            host = tree_map(lambda x: pinned(x).copy_(x, non_blocking=True)
                            if isinstance(x, torch.Tensor) else x, packed)
        for x in tree_leaves(packed):
            if isinstance(x, torch.Tensor):
                x.record_stream(side)
        done = torch.cuda.Event()
        done.record(side)
        return host, done

    def _wait_inflight(self, sids) -> None:
        """Block until async copies carrying any of ``sids`` are done
        (their host rows are about to be read)."""
        for ent in self._inflight:
            if ent[4] is not None and ent[3] & sids:
                ent[4].synchronize()

    def offload(self, sid: str) -> OffloadResult:
        """Per-victim offload: one gather + one host copy for ONE session
        (the ``batched_offload=False`` path)."""
        verdict = self._classify(sid)
        if verdict is not None:
            return verdict
        sess = self.sessions[sid]
        if self._drop_for_recompute(sess):
            return OffloadResult(sid, "recompute")
        packed = self.arena.pack([sess.slot])
        t0 = self.obs.clock.now()
        host, done = self._to_host(packed, sess.shard)
        if self.async_offload:
            self._inflight.append([host, 1, sess.shard, {sid}, done])
        self._count_transfer("offload", 1, 1, self.obs.clock.now() - t0,
                             measured=not self.async_offload,
                             shard=sess.shard)
        sess.host_state = tree_map(lambda x: x[0], host)
        self.arena.free(sess.slot)
        sess.slot = None
        sess.n_offloads += 1
        return OffloadResult(sid, "offloaded", n_bytes=self._state_bytes)

    def offload_batch(self, sids: Sequence[str]) -> List[OffloadResult]:
        """Move k resident sessions to host with ONE arena gather and ONE
        host copy per leaf per SHARD (vs k of each on the per-victim
        path).  Victims are grouped by owning shard so every gather reads
        one row block."""
        if not self.batched_offload:
            return [self.offload(sid) for sid in sids]
        results: Dict[str, OffloadResult] = {}
        todo: List[Session] = []
        seen = set()
        for sid in sids:
            if sid in seen:      # dup sid: one verdict, one transfer
                continue
            seen.add(sid)
            verdict = self._classify(sid)
            if verdict is not None:
                results[sid] = verdict
                continue
            sess = self.sessions[sid]
            if self._drop_for_recompute(sess):
                results[sid] = OffloadResult(sid, "recompute")
            else:
                todo.append(sess)
        by_shard: Dict[int, List[Session]] = {}
        for sess in todo:
            by_shard.setdefault(sess.shard, []).append(sess)
        for shard in sorted(by_shard):
            group = by_shard[shard]
            # sessions sharing one row (COW siblings never diverged)
            # stage ONE transfer lane for that row; every sibling's
            # host_state references the same lane
            lane_of: Dict[int, int] = {}
            uniq: List[int] = []
            for sess in group:
                if sess.slot not in lane_of:
                    lane_of[sess.slot] = len(uniq)
                    uniq.append(sess.slot)
            packed = self.arena.pack(uniq)
            t0 = self.obs.clock.now()
            host, done = self._to_host(packed, shard)
            if self.async_offload:
                self._inflight.append(
                    [host, len(uniq), shard, {s.sid for s in group}, done])
            self._count_transfer("offload", len(uniq), len(group),
                                 self.obs.clock.now() - t0,
                                 measured=not self.async_offload,
                                 shard=shard)
            row_host: Dict[int, Any] = {}
            for sess in group:
                if sess.slot not in row_host:
                    i = lane_of[sess.slot]
                    row_host[sess.slot] = tree_map(
                        lambda x, i=i: x[i], host)
                sess.host_state = row_host[sess.slot]
                self.arena.free(sess.slot)
                sess.slot = None
                sess.n_offloads += 1
                results[sess.sid] = OffloadResult(
                    sess.sid, "offloaded", n_bytes=self._state_bytes)
        out, emitted = [], set()
        for sid in sids:
            if sid not in emitted:
                emitted.add(sid)
                out.append(results[sid])
            elif results[sid].moved:
                # a later duplicate observes the first occurrence's
                # effect — exactly what sequential per-victim calls
                # would report
                out.append(OffloadResult(sid, "already-offloaded"))
            else:
                out.append(results[sid])
        return out

    def _restore_batch(self, sess_list: List[Session]) -> None:
        """Stack k host states, move them up with ONE host-to-device copy
        per leaf, and scatter them into their slots with one arena unpack
        — per SHARD.  Rows of an async offload still in flight are waited
        for first."""
        by_shard: Dict[int, List[Session]] = {}
        for sess in sess_list:
            by_shard.setdefault(sess.shard, []).append(sess)
        self._wait_inflight({s.sid for s in sess_list})
        cuda = self._cuda

        def stack(dev, *rows):
            if not isinstance(rows[0], torch.Tensor):
                return np.asarray(rows, np.int64)
            out = torch.empty((len(rows),) + tuple(rows[0].shape),
                              dtype=rows[0].dtype, pin_memory=cuda)
            torch.stack(rows, out=out)
            return out.to(dev, non_blocking=True) if cuda else out

        for shard in sorted(by_shard):
            group = by_shard[shard]
            slots = [s.slot for s in group]
            t0 = self.obs.clock.now()
            dev = self.arena.devices[shard]     # the rows' own device
            rows = tree_map(lambda *r, dev=dev: stack(dev, *r),
                            *[s.host_state for s in group])
            self.arena.unpack(slots, rows)
            # dispatch time only: blocking here to measure the true copy
            # would serialize restore against the batch that triggered it
            self._count_transfer("restore", len(slots), len(group),
                                 self.obs.clock.now() - t0, measured=False,
                                 shard=shard)
            for sess in group:
                sess.host_state = None

    def sync(self) -> None:
        """Barrier for ``async_offload`` transfers still in flight.

        Also the async path's bandwidth sensor: dispatch timestamps say
        nothing about the wire, so async transfers used to never touch
        the bandwidth gauge and a ``calibrated`` cost model ran blind on
        exactly the configuration built for throughput.  The barrier is
        the one place async transfer time is actually observed — we
        attribute the in-flight bytes over the blocked interval.  Since
        copies overlap engine compute before the barrier, blocked time
        can be shorter than wire time, making this an EFFECTIVE
        (overlap-discounted) bandwidth rather than raw link speed —
        which is the cost the async engine actually pays per transfer,
        i.e. the right quantity for the transfer-vs-recompute call."""
        if not self._inflight:
            return
        t0 = self.obs.clock.now()
        rows = 0
        shard_rows: Dict[int, int] = {}
        for _host, n, shard, _sids, done in self._inflight:
            if done is not None:
                done.synchronize()
            rows += n
            shard_rows[shard] = shard_rows.get(shard, 0) + n
        self._inflight.clear()
        dt = self.obs.clock.now() - t0
        self._m_sync_s.inc(dt)
        if dt > 0 and rows:
            self._g_bw.set(rows * self._state_bytes / dt)
            # attribute the blocked interval to each shard by its share
            # of the in-flight rows (one barrier covers all shards)
            for shard, r in shard_rows.items():
                self._g_shard_bw.labels(shard=str(shard)).set(
                    r * self._state_bytes / dt)
