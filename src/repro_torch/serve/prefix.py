"""Content-addressed prefix cache: shared-prefix memory dedup.

Thousands of sessions behind one engine typically open with an
identical system-prompt / few-shot prefix.  CCM compresses that prefix
into a tiny per-session memory — byte-identical across sessions — so
compressing it once and REFERENCE-COUNTING the resulting arena row
multiplies effective arena capacity for prefix-heavy traffic.

The cache maps ``(tenant, token_count, sha1(tokens))`` to a live arena
row holding the prefix's compressed state.  `ServeEngine.create_session`
consults it when the caller passes ``prefix_tokens=``:

  * HIT  — the new session ATTACHES to the cached row
    (`SessionManager.adopt_row`: incref + resident on the shared slot,
    read-only until its first write triggers the copy-on-write break in
    `activate_batch`).  No recompression runs; admission never sees the
    prefix tokens.
  * MISS — the session is created normally and the prefix is submitted
    as a regular ingest; when that request executes, the engine inserts
    the session's row here (incref — the cache is one more holder, so
    the row survives the owner's close/offload, and the owner's next
    write COW-breaks AWAY from it, leaving the cached content frozen).

Keys are TENANT-SCOPED: one tenant's cached prefix is never attached to
another tenant's session (isolation beats the marginal extra dedup).

Eviction: LRU past ``max_entries``, plus `release_one` — the
allocation-scarcity hook `SessionManager.activate_batch` calls before
evicting a live session, which drops the least-recently-used CACHE-ONLY
row (refcount 1: no session shares it) on the starved shard.  Releasing
an entry is just a decref; a row still shared with sessions survives.

Port of ``repro/serve/prefix.py``, copied: pure Python.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.obs import Observability
from repro_torch.serve.arena import SessionArena

PrefixKey = Tuple[str, int, str]


@dataclasses.dataclass(frozen=True)
class PrefixEntry:
    """One cached compressed prefix: the arena row and the host-side
    bookkeeping a session needs to attach to it."""
    key: PrefixKey
    slot: int            # live arena row (the cache holds one refcount)
    shard: int           # owning arena shard (attachers pin here)
    mem_groups: int      # filled <COMP> groups the prefix compressed to


class PrefixCache:
    def __init__(self, arena: SessionArena, max_entries: int = 64,
                 obs: Optional[Observability] = None):
        if max_entries < 1:
            raise ValueError("prefix cache needs max_entries >= 1")
        self.arena = arena
        self.max_entries = max_entries
        self._entries: "OrderedDict[PrefixKey, PrefixEntry]" = OrderedDict()
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        self._m_hits = reg.counter(
            "serve_prefix_dedup_hits_total",
            "sessions attached to an already-compressed prefix row "
            "instead of recompressing it")
        self._m_misses = reg.counter(
            "serve_prefix_misses_total",
            "prefix lookups that found no cached row (the prefix is "
            "compressed once and inserted on execution)")
        self._m_inserts = reg.counter(
            "serve_prefix_inserts_total",
            "compressed prefix rows pinned into the cache")
        self._m_released = reg.counter(
            "serve_prefix_released_total",
            "cache references dropped, by reason: 'capacity' = LRU past "
            "max_entries, 'scarcity' = a starved shard reclaimed a "
            "cache-only row instead of evicting a live session",
            labels=("why",))
        self._g_entries = reg.gauge(
            "serve_prefix_entries", "prefix rows currently cached")
        for why in ("capacity", "scarcity"):
            self._m_released.labels(why=why)

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key_of(tenant: str, tokens) -> PrefixKey:
        """Content address: (tenant, length, sha1 of the int32 bytes).
        The length rides along so a (vanishingly unlikely) digest
        collision additionally needs a length collision."""
        flat = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        return (tenant, int(flat.size),
                hashlib.sha1(flat.tobytes()).hexdigest())

    def lookup(self, tenant: str, tokens) -> Optional[PrefixEntry]:
        """The cached row for this tenant's prefix, refreshing its LRU
        position; None (counted as a miss) when absent.  The caller
        attaches via `SessionManager.adopt_row` and then `note_hit`."""
        ent = self._entries.get(self.key_of(tenant, tokens))
        if ent is None:
            self._m_misses.inc()
            return None
        self._entries.move_to_end(ent.key)
        return ent

    def note_hit(self) -> None:
        """Count one successful dedup attach (separate from `lookup` so
        a hit the caller cannot use — e.g. an explicit-shard request
        pinned elsewhere — is not overcounted)."""
        self._m_hits.inc()

    def insert(self, tenant: str, tokens, slot: int, shard: int,
               mem_groups: int) -> PrefixEntry:
        """Pin a freshly-compressed prefix row (increfs it — the cache
        becomes one more holder).  Re-inserting an existing key is an
        LRU refresh, not a second reference.  May evict the LRU entry
        past ``max_entries``."""
        key = self.key_of(tenant, tokens)
        ent = self._entries.get(key)
        if ent is not None:
            self._entries.move_to_end(key)
            return ent
        self.arena.incref(slot)
        ent = PrefixEntry(key=key, slot=slot, shard=shard,
                          mem_groups=mem_groups)
        self._entries[key] = ent
        self._m_inserts.inc()
        while len(self._entries) > self.max_entries:
            self._release(next(iter(self._entries)), "capacity")
        self._g_entries.set(len(self._entries))
        return ent

    def release_one(self, shard: int) -> int:
        """Allocation-scarcity hook (`SessionManager.cache_release`):
        drop the least-recently-used CACHE-ONLY entry on ``shard`` —
        refcount 1 means no session shares the row, so the decref frees
        a slot immediately.  Returns rows freed (1 or 0).  Entries still
        shared with sessions are kept: releasing them would free
        nothing, and they are exactly the entries earning their keep."""
        for key, ent in self._entries.items():
            if ent.shard == shard and self.arena.refcount(ent.slot) == 1:
                self._release(key, "scarcity")
                self._g_entries.set(len(self._entries))
                return 1
        return 0

    def unpin_slot(self, slot: int) -> bool:
        """Drop the cache pin on ONE specific row
        (`SessionManager.cache_unpin`): when an eviction victim's row
        would survive on the cache reference alone, releasing the entry
        lets the eviction actually free the slot.  Unlike `release_one`
        this drops the entry regardless of refcount — the caller has
        already decided the row must go."""
        for key, ent in self._entries.items():
            if ent.slot == slot:
                self._release(key, "scarcity")
                self._g_entries.set(len(self._entries))
                return True
        return False

    def clear(self) -> None:
        """Drop every cache reference (rows shared with sessions
        survive as session-only rows)."""
        for key in list(self._entries):
            self._release(key, "capacity")
        self._g_entries.set(0)

    def _release(self, key: PrefixKey, why: str) -> None:
        ent = self._entries.pop(key)
        self.arena.free(ent.slot)          # decref; sharers keep the row
        self._m_released.labels(why=why).inc()
        self.obs.recorder.note(
            "prefix", f"released slot={ent.slot} shard={ent.shard} "
                      f"why={why}")
