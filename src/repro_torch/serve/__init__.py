"""Multi-tenant session serving over compressed context memory (port of
``repro/serve``: online and stream sessions, on one device or sharded
over the session axis).

The paper's premise — per-user context compressed into a tiny bounded
memory — is what makes packing thousands of user sessions onto one
device feasible.  This package is that serving layer:

  arena.py     — fixed-shape device slabs of per-session state with a
                 free-list and pack/unpack through the hand-written
                 session gather/scatter kernels
  admission.py — bounded ingress: per-tenant quotas (resident slots,
                 queued tokens), overflow policies (block /
                 shed-lowest-priority / reject-new), structured
                 Admitted | Queued | Shed verdicts
  scheduler.py — continuous batching: queue per-session requests, group
                 by op kind + token bucket (ragged lanes carry a
                 valid_len; priorities age to prevent starvation;
                 deadlines drain earliest-first within a priority
                 class), pad to bucketed batch sizes
  session.py   — session lifecycle + batched/async LRU host offload
                 (restore-vs-recompute cost model, optionally calibrated
                 from measured transfer/replay rates); copy-on-write
                 forks share the parent's refcounted arena row
  prefix.py    — content-addressed prefix cache: sessions opening with
                 an identical (tenant-scoped) prefix attach to one
                 shared compressed row instead of recompressing it
  pressure.py  — unified memory-pressure controller: a logical token
                 budget walked down the recompress -> offload -> shed
                 degradation ladder (cheapest lever first)
  engine.py    — the main loop wiring admission -> scheduler ->
                 arena steps, online and stream sessions in arenas of
                 their own, sharded over the session axis (a loop over
                 shards, or one shard per device of a session mesh)
"""
from repro_torch.serve.admission import (Admitted, AdmissionController,
                                         Queued, Shed, TenantQuota, Verdict)
from repro_torch.serve.arena import ArenaFull, SessionArena
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.prefix import PrefixCache, PrefixEntry
from repro_torch.serve.pressure import MemoryPressureController, PressurePolicy
from repro_torch.serve.scheduler import (Request, ScheduledBatch,
                                         Scheduler, ShardedBatch)
from repro_torch.serve.session import (CloseResult, OffloadCostModel,
                                       OffloadResult, SessionManager)

__all__ = ["Admitted", "AdmissionController", "ArenaFull", "CloseResult",
           "MemoryPressureController", "OffloadCostModel",
           "OffloadResult", "PrefixCache", "PrefixEntry",
           "PressurePolicy", "Queued", "Request", "ScheduledBatch",
           "Scheduler", "ServeEngine", "SessionArena", "SessionManager",
           "ShardedBatch", "Shed", "TenantQuota", "Verdict"]
