"""Multi-tenant serve engine: admission -> scheduler -> arena -> steps
(port of ``repro/serve/engine.py``, single device).

Drives the whole subsystem: submits pass ADMISSION CONTROL
(`serve.admission`: bounded ingress, per-tenant quotas, overflow
policy) and return a structured ``Admitted | Queued | Shed`` verdict —
`ArenaFull` never reaches callers; batches are capped at evictable
capacity by construction.  `run` drains the queue batch by batch —
activate the batch's sessions (batched LRU restore/offload via
`SessionManager`, tenant-quota-aware), then one arena step per batch
(`launch.serve.make_arena_step`) gathers their arena rows with the
``session_gather`` kernel, runs the lane-batched op and scatters the
updated rows back with ``session_scatter``, fulfilling the requests.
After every popped batch the backpressure backlog is pumped.

The engine runs on the CUDA card unless built with ``device="cpu"``
(the arena's slabs live there; ``params`` must be on the same device).

OBSERVABILITY (`repro_torch.obs`): every counter the engine keeps —
per-op requests/tokens/padding waste, dispatch seconds, step-shape
churn, admission verdicts, offload transfer bytes/seconds — lives in one
`MetricsRegistry`, exported as JSON (`metrics_snapshot`) or Prometheus
text (`metrics_prometheus`); the ``stats`` dicts are read-only views.
Pass ``obs=Observability.tracing()`` for per-request lifecycle spans,
latency histograms and a bounded flight recorder the engine dumps to
stderr when an exception escapes a drain.  All timing is host-side, on
the injected clock, around dispatch; a drain ends in one device
synchronize.

Online sessions (ingest/query over ``OnlineState``) and streaming
sessions (``stream`` over ``StreamState``) live in separate arenas since
their state templates differ; ``stream_slots=0`` skips the second arena.

Not in this slice (it raises ``NotImplementedError``): sharded serving
(``n_shards > 1``, ``mesh=``; the multi-device slice).
"""
from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.launch import serve as SRV
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.specs import (SERVE_BATCH_BUCKETS, SERVE_TOKEN_BUCKETS,
                                      derive_token_buckets, token_bucket)
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.serve.admission import (AdmissionController, TenantQuota,
                                         Verdict)
from repro_torch.serve.arena import SessionArena
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.pressure import MemoryPressureController, PressurePolicy
from repro_torch.serve.scheduler import Request, ScheduledBatch, Scheduler
from repro_torch.serve.session import (CloseResult, OffloadCostModel,
                                       OffloadResult, SessionManager)

_OP_STATE = {"ingest": "online", "query": "online", "stream": "stream"}
_STAT_KEYS = ("requests", "tokens", "pad_lanes", "pad_tokens", "lanes",
              "batches")


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 64,
                 cache_len: int = 256, mem_slots: Optional[int] = None,
                 max_resident: Optional[int] = None, stream_slots: int = 0,
                 stream_max_resident: Optional[int] = None,
                 batch_buckets: Sequence[int] = SERVE_BATCH_BUCKETS,
                 token_buckets="auto", aging: Optional[int] = 32,
                 admission_policy: str = "block",
                 max_queued_tokens: Optional[int] = None,
                 max_backlog: Optional[int] = None,
                 tenant_quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 batched_offload: bool = True,
                 async_offload: bool = False,
                 offload_cost_model: Optional[OffloadCostModel] = None,
                 pressure_policy: Optional[PressurePolicy] = None,
                 prefix_cache: bool = True,
                 prefix_cache_entries: int = 64,
                 step_factory: Optional[Callable] = None,
                 n_shards: int = 1, mesh=None,
                 edf: bool = True,
                 bucket_policy: str = "static",
                 bucket_refit_interval: int = 256,
                 bucket_max: int = 8,
                 bucket_compile_cost_tokens: float = 128.0,
                 length_history: int = 4096,
                 obs: Optional[Observability] = None,
                 device: DeviceLike = None):
        """``token_buckets``: ragged-batching token buckets ("auto" picks
        `launch.specs.SERVE_TOKEN_BUCKETS` for attention archs and exact-
        length grouping for SSM/hybrid; None forces exact lengths).
        ``aging``: scheduler starvation knob — a waiting request's
        effective priority improves by one per ``aging`` popped batches.

        Admission (`serve.admission`): ``admission_policy`` is one of
        ``block`` / ``shed-lowest-priority`` / ``reject-new``;
        ``max_queued_tokens`` bounds the global queue
        (``max_backlog`` bounds the block-policy backlog entries);
        ``tenant_quotas`` / ``default_quota`` bound resident slots and
        queued tokens per tenant.  Defaults are unbounded — every
        submit returns ``Admitted``.

        Offload (`serve.session`): ``batched_offload`` moves k victims
        per transfer, ``async_offload`` overlaps the device->host copy
        with scheduling, ``offload_cost_model`` drops state and replays
        request history when that is cheaper than the round trip.

        Prefix dedup (`serve.prefix`): with ``prefix_cache=True`` (the
        default), `create_session`'s ``prefix_tokens=`` consults a
        content-addressed cache of compressed prefixes — a hit attaches
        the new session to the cached row (refcount share, no
        recompression); a miss compresses once and pins the result for
        the next session.  ``prefix_cache_entries`` bounds the LRU.

        Forks: `fork_session(parent, child)` queues a zero-token
        ``fork`` request on the PARENT session (program order picks the
        snapshot point); when it executes, the child shares the
        parent's arena row copy-on-write — the first write through
        either of them clones the row (`serve.session` COW break).

        Pressure (`serve.pressure`): a ``pressure_policy`` turns on the
        unified memory-pressure controller over the ONLINE arena — a
        logical token budget (``capacity_tokens``) enforced at
        admission, with deficits walked down the recompress -> offload
        -> shed degradation ladder instead of shedding outright; the
        drain loop additionally relieves past the high watermark.  See
        docs/SERVING.md "Memory pressure".

        ``step_factory(cfg, op, masked)``: override the fused arena step
        builder (default `launch.serve.make_arena_step`); the serve
        simulation harness injects a control-plane-only null step.

        Stream sessions: ``stream_slots > 0`` builds a second arena of
        ``StreamState`` rows (``stream_max_resident`` resident at most)
        with its own LRU offload and restore; ``create_session(sid,
        kind="stream")`` opens one and ``stream(sid, tokens)`` feeds it
        chunks of at most ``cfg.ccm.stream_chunk`` tokens.

        Not in this slice: ``n_shards > 1`` and ``mesh=`` (sharded
        serving, the multi-device slice) raise ``NotImplementedError``;
        the arguments stay so that callers keep the reference's
        signature.

        ``device``: where the arena's slabs live and the steps run; None
        means the CUDA card (raising without one), ``"cpu"`` the plain
        PyTorch path.

        Deadlines (docs/SERVING.md "Deadlines and SLOs"): every submit
        accepts ``deadline=`` (absolute seconds on the engine clock —
        ``now()``); a tenant quota's ``slo_seconds`` derives one when
        the caller passes none.  ``edf`` orders deadline-carrying
        requests earliest-deadline-first WITHIN their effective-priority
        class (`Scheduler.effective_key`); with no deadlines submitted
        the schedule is bit-identical either way.  Shed and pressure
        levers prefer already-late work (`Scheduler.shed_preference_key`,
        `PressurePolicy.offload_late_sessions`); outcomes land in the
        ``serve_deadline_*`` metric families.

        Bucket derivation: ``bucket_policy="derived"`` refits the token-
        bucket ladder to the observed request-length distribution every
        ``bucket_refit_interval`` submissions
        (`launch.specs.derive_token_buckets`: pad-waste vs shape-churn
        DP at ``bucket_compile_cost_tokens`` per NEW shape, fed by the
        shape-churn counter's seen shapes, never pad-regressing vs the
        static ladder on the fitted window of the last
        ``length_history`` lengths).  The default ``"static"`` keeps the
        configured ladder untouched; `derived_token_buckets()` previews
        a fit either way.

        ``obs``: `repro_torch.obs.Observability` bundle.  Default = live
        metrics registry + monotonic clock + `NullRecorder` (no traces,
        no flight buffer, bit-exact with pre-obs behavior).  Pass
        ``Observability.tracing()`` for request spans and latency
        histograms, or inject a `ManualClock` for deterministic
        timestamps (the simulation harness does both)."""
        if n_shards != 1 or mesh is not None:
            raise NotImplementedError(
                "sharded serving (n_shards > 1, mesh=) comes with the "
                "multi-device slice of the port")
        self.params = params
        self.cfg = cfg
        self.cache_len = cache_len
        self.device = resolve_device(device)
        if token_buckets == "auto":
            token_buckets = SERVE_TOKEN_BUCKETS if SRV.ragged_family(cfg) \
                else None
        elif token_buckets is not None and not SRV.ragged_family(cfg):
            raise ValueError(
                f"token buckets need masked lanes, unsupported for "
                f"family {cfg.family!r}")
        self.ragged = token_buckets is not None
        self._token_buckets = token_buckets
        if bucket_policy not in ("static", "derived"):
            raise ValueError(f"unknown bucket_policy {bucket_policy!r}; "
                             "pick 'static' or 'derived'")
        if bucket_policy == "derived" and not self.ragged:
            raise ValueError("bucket_policy='derived' needs ragged "
                             "batching (token_buckets is None)")
        self.bucket_policy = bucket_policy
        self._bucket_refit_interval = int(bucket_refit_interval)
        self._bucket_max = int(bucket_max)
        self._bucket_compile_cost = float(bucket_compile_cost_tokens)
        # the fit baseline: the configured static ladder (the derived
        # ladder is clamped to never pad WORSE than this on its window)
        self._static_token_buckets = tuple(sorted(token_buckets)) \
            if token_buckets is not None else None
        self._len_history: collections.deque = collections.deque(
            maxlen=int(length_history))
        self._len_seen = 0             # lengths ever recorded
        self._len_at_refit = 0         # _len_seen at the last refit
        self._step_factory = step_factory or SRV.make_arena_step
        self.n_shards = 1
        self.mesh = None
        self.obs = obs if obs is not None else Observability()
        self._build_metrics()
        mgr_kw = dict(batched_offload=batched_offload,
                      async_offload=async_offload,
                      cost_model=offload_cost_model,
                      resident_quota_of=self._resident_quota_of,
                      obs=self.obs)
        self._mgr: Dict[str, SessionManager] = {
            "online": SessionManager(
                SessionArena.for_online(cfg, n_slots, cache_len, mem_slots,
                                        device=self.device),
                max_resident, replay_fn=self._make_replay("online"),
                **mgr_kw),
        }
        if stream_slots:
            c = cfg.ccm
            if c.stream_sink + c.stream_chunk > c.stream_window:
                # stream_step raises this at its first call, mid-drain,
                # after batches were popped; fail at construction instead
                raise ValueError(
                    f"stream_sink ({c.stream_sink}) + stream_chunk "
                    f"({c.stream_chunk}) exceeds stream_window "
                    f"({c.stream_window})")
            self._mgr["stream"] = SessionManager(
                SessionArena.for_stream(cfg, stream_slots,
                                        device=self.device),
                stream_max_resident, replay_fn=self._make_replay("stream"),
                **mgr_kw)
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                self._mgr["online"].arena,
                max_entries=prefix_cache_entries, obs=self.obs)
            # activation-scarcity hook: a starved shard reclaims a
            # cache-only prefix row before evicting any live session
            self._mgr["online"].cache_release = \
                self.prefix_cache.release_one
            self._mgr["online"].cache_unpin = \
                self.prefix_cache.unpin_slot
        # prefix-miss bookkeeping: sid -> the in-flight ingest request
        # whose execution should pin the session's row into the cache
        # (and the prefix tokens that key it)
        self._prefix_req: Dict[str, Request] = {}
        self._prefix_toks: Dict[str, np.ndarray] = {}
        self._pending_forks: set = set()   # child sids reserved by
        #                                    queued fork requests
        # derived-bucket refit gating: a refit requested while a pop is
        # in progress is deferred to the next pop boundary
        self._popping = False
        self._refit_pending = False
        caps = {op: self._mgr[kind].max_resident
                for op, kind in _OP_STATE.items() if kind in self._mgr}
        # a stream op must never pad past the eviction quantum — one
        # eviction per step keeps the window bounded (stream_step guard)
        self.scheduler = Scheduler(
            batch_buckets, max_batch=caps, token_buckets=token_buckets,
            max_token_len={"stream": cfg.ccm.stream_chunk}, aging=aging,
            metrics=self.obs.registry, edf=edf, clock=self.obs.clock)
        # the budget is scoped to the ONLINE arena (memory + KV cache —
        # the states the ladder's levers act on); merge mode pins every
        # session at one group, so only concat memories can recompress
        self._max_mem_groups = 1 if cfg.ccm.mode == "merge" else \
            (mem_slots if mem_slots is not None else cfg.ccm.mem_slots)
        self.pressure: Optional[MemoryPressureController] = None
        if pressure_policy is not None:
            self.pressure = MemoryPressureController(
                pressure_policy,
                sessions_fn=lambda: list(
                    self._mgr["online"].sessions.values()),
                footprint_fn=self._session_footprint,
                queued_tokens_fn=lambda: self.admission.queued_tokens(),
                has_queued_fn=self._has_pending_work,
                recompress_fn=self._recompress_session,
                offload_fn=lambda sid:
                    self._mgr["online"].offload_batch([sid])[0],
                unsalvageable_fn=self._all_pending_late,
                obs=self.obs)
        self.admission = AdmissionController(
            self.scheduler, policy=admission_policy,
            max_queued_tokens=max_queued_tokens, quotas=tenant_quotas,
            default_quota=default_quota, on_shed=self._on_shed,
            max_backlog=max_backlog, metrics=self.obs.registry,
            pressure=self.pressure)
        self._steps = {}               # (op, masked) -> step fn
        self._seen_shapes = set()      # (kind, lanes, token_len, masked)
        self._kind: Dict[str, str] = {}   # sid -> 'online' | 'stream'
        self._shard: Dict[str, int] = {}  # sid -> owning arena shard
        self._tenant: Dict[str, str] = {}  # sid -> tenant
        self._cached: Dict[str, int] = {}  # sid -> KV-cache tokens used
        self._undelivered = []         # [(requests, device out)] per batch

    def _build_metrics(self) -> None:
        reg = self.obs.registry
        self._m = {
            "requests": reg.counter(
                "serve_requests_total",
                "real requests served, per op kind", labels=("kind",)),
            "tokens": reg.counter(
                "serve_tokens_total",
                "real (valid) tokens served, per op kind",
                labels=("kind",)),
            "pad_lanes": reg.counter(
                "serve_pad_lanes_total",
                "scratch lanes added to reach a batch bucket",
                labels=("kind",)),
            "pad_tokens": reg.counter(
                "serve_pad_tokens_total",
                "token-bucket padding waste on real lanes",
                labels=("kind",)),
            "lanes": reg.counter(
                "serve_lanes_total", "total batch lanes dispatched",
                labels=("kind",)),
            "batches": reg.counter(
                "serve_batches_total", "batches dispatched",
                labels=("kind",)),
            "dispatch_s": reg.counter(
                "serve_dispatch_seconds_total",
                "host time spent dispatching fused steps (async — the "
                "synced drain wall clock is serve_wall_seconds_total)",
                labels=("kind",)),
            "wall_s": reg.counter(
                "serve_wall_seconds_total",
                "synchronized wall seconds across all drains"),
            "compiled": reg.counter(
                "serve_compiled_programs_total",
                "first-seen fused-step shapes (compile churn), per "
                "(kind, LANESxTOKENS[/masked]) bucket",
                labels=("kind", "shape")),
        }
        # pre-create per-kind children so exports carry explicit zeros
        for fam in ("requests", "tokens", "pad_lanes", "pad_tokens",
                    "lanes", "batches", "dispatch_s"):
            for k in _OP_STATE:
                self._m[fam].labels(kind=k)
        self._m_deadline = {
            "requests": reg.counter(
                "serve_deadline_requests_total",
                "submitted requests carrying a deadline (explicit or "
                "SLO-derived), per op kind", labels=("kind",)),
            "met": reg.counter(
                "serve_deadline_met_total",
                "deadline-carrying requests delivered on time, per op "
                "kind", labels=("kind",)),
            "missed": reg.counter(
                "serve_deadline_missed_total",
                "deadline-carrying requests delivered PAST their "
                "deadline, per op kind", labels=("kind",)),
            "shed": reg.counter(
                "serve_deadline_shed_total",
                "deadline-carrying requests shed by admission, labeled "
                "by whether the deadline had ALREADY passed at shed "
                "time (late='yes' sheds lose nothing — the SLO was "
                "gone; late='no' sheds are real SLO casualties)",
                labels=("late",)),
            "cancelled": reg.counter(
                "serve_deadline_cancelled_total",
                "deadline-carrying requests cancelled (close_session) "
                "before running — the fourth terminal disposition, so "
                "met + missed + shed + cancelled == requests",
                labels=("kind",)),
        }
        for fam in ("requests", "met", "missed", "cancelled"):
            for k in _OP_STATE:
                self._m_deadline[fam].labels(kind=k)
        for late in ("yes", "no"):
            self._m_deadline["shed"].labels(late=late)
        self._m_fork = reg.counter(
            "serve_fork_total",
            "session forks executed (child attached to the parent's "
            "arena row copy-on-write)")
        self._m_fork_failed = reg.counter(
            "serve_fork_failed_total",
            "fork requests that could not execute (parent closed "
            "before the fork ran, or the child sid was taken)")
        self._h_lateness = reg.histogram(
            "serve_deadline_lateness_seconds",
            "how far past its deadline a MISSED delivery landed "
            "(delivery time - deadline; met deliveries not observed)")
        self._m_refits = reg.counter(
            "serve_bucket_refits_total",
            "token-bucket ladder refits applied from the observed "
            "length distribution (bucket_policy='derived')")
        self._m_refits_deferred = reg.counter(
            "serve_bucket_refits_deferred_total",
            "ladder refits requested mid-pop and deferred to the next "
            "pop boundary (a swap between a sharded pop's per-shard "
            "sub-batches would mix bucket ladders)")
        self._g_ladder = reg.gauge(
            "serve_token_bucket_count",
            "buckets in the active token-bucket ladder (0 = exact-"
            "length grouping)")
        self._g_ladder.set(
            len(self._token_buckets) if self._token_buckets else 0)
        self._g = {
            "occupancy": reg.gauge(
                "serve_arena_occupancy",
                "fraction of arena slots allocated", labels=("arena",)),
            "slots": reg.gauge(
                "serve_arena_slots", "arena slot counts",
                labels=("arena", "state")),
            "resident": reg.gauge(
                "serve_resident_sessions",
                "device-resident sessions", labels=("arena",)),
            "shared_rows": reg.gauge(
                "serve_shared_rows",
                "live arena rows held by more than one reference "
                "(fork siblings / prefix-cache pins) — the dedup "
                "savings currently in effect", labels=("arena",)),
            "queue_depth": reg.gauge(
                "serve_queue_depth",
                "requests in the scheduler queue"),
            "backlog_depth": reg.gauge(
                "serve_backlog_depth",
                "requests held in the admission backlog"),
            "quota_pressure": reg.gauge(
                "serve_tenant_quota_pressure",
                "per-tenant queued-token usage / quota (explicitly "
                "quota'd tenants only)", labels=("tenant",)),
        }
        self._probe = {
            "probes": reg.counter(
                "serve_arena_consistency_probes_total",
                "free-list integrity probes run", labels=("arena",)),
            "errors": reg.counter(
                "serve_arena_consistency_errors_total",
                "free-list integrity violations found (must stay 0)",
                labels=("arena",)),
        }
        # per-shard visibility (one shard per device under a mesh) —
        # populated for n_shards == 1 too, so dashboards are uniform
        self._g_shard = {
            "occupancy": reg.gauge(
                "serve_shard_occupancy",
                "fraction of one arena shard's slots allocated",
                labels=("arena", "shard")),
            "resident": reg.gauge(
                "serve_shard_resident_sessions",
                "device-resident sessions per arena shard",
                labels=("arena", "shard")),
            "queue_depth": reg.gauge(
                "serve_shard_queue_depth",
                "scheduler-queued requests routed to each shard",
                labels=("shard",)),
        }
        self._m_shard_shed = reg.counter(
            "serve_shard_shed_total",
            "requests shed by admission, by the shard that owned their "
            "session (placement-fairness signal: one shard shedding "
            "while another idles means placement is skewed)",
            labels=("shard",))
        self._m_cross_shard = reg.counter(
            "serve_cross_shard_moves_total",
            "session states moved between shards — there is NO "
            "mechanism for this on the steady path (sessions are "
            "pinned to their shard at creation), so this counter "
            "exists to PROVE it stays 0; the sharded benchmark and CI "
            "gate assert exactly that")
        for s in range(self.n_shards):
            for kind in ("online", "stream"):
                self._g_shard["occupancy"].labels(arena=kind, shard=str(s))
                self._g_shard["resident"].labels(arena=kind, shard=str(s))
            self._g_shard["queue_depth"].labels(shard=str(s))
            self._m_shard_shed.labels(shard=str(s))

    def _resident_quota_of(self, tenant: str) -> Optional[int]:
        return self.admission.quota(tenant).max_resident

    # -- session lifecycle --------------------------------------------
    def _place(self, kind: str) -> int:
        """Deterministic least-loaded shard placement: fewest open
        sessions on that kind's arena, lowest shard index on ties —
        reproducible given the same creation order, which the
        bit-exactness tests rely on."""
        load = self._mgr[kind].shard_load()
        return min(range(len(load)), key=lambda s: (load[s], s))

    def create_session(self, sid: str, kind: str = "online",
                       tenant: str = "default",
                       shard: Optional[int] = None,
                       prefix_tokens=None) -> int:
        """Open a session and return its owning shard.  ``shard=None``
        (default) places it on the least-loaded shard of its kind's
        arena; an explicit shard pins it there (operators co-locating a
        tenant, tests pinning layouts).  The placement is for life —
        session state never migrates between shards.

        ``prefix_tokens`` (online sessions): the session's opening
        context.  With the prefix cache enabled, a session whose tenant
        already compressed this exact prefix ATTACHES to the cached row
        (copy-on-write share — no ingest, no recompression; the session
        is born resident and pins to the cached row's shard); otherwise
        the prefix is submitted as a normal ingest and its compressed
        row is pinned into the cache when it executes, so the NEXT
        session with this prefix dedups."""
        if kind not in self._mgr:
            raise ValueError(
                f"no arena for session kind {kind!r} "
                "(construct the engine with stream_slots > 0?)")
        if prefix_tokens is not None and kind != "online":
            raise ValueError("prefix_tokens applies to online sessions "
                             "(compressed-memory prefixes)")
        if prefix_tokens is not None and self.prefix_cache is not None:
            ent = self.prefix_cache.lookup(tenant, prefix_tokens)
            if ent is not None and (shard is None or shard == ent.shard):
                # dedup hit: born resident on the shared row, read-only
                # until the first write COW-breaks
                self._mgr[kind].adopt_row(sid, tenant, ent.shard,
                                          ent.slot, ent.mem_groups)
                self._kind[sid] = kind
                self._shard[sid] = ent.shard
                self._tenant[sid] = tenant
                self.prefix_cache.note_hit()
                self.obs.recorder.note(
                    "prefix", f"dedup hit sid={sid} slot={ent.slot} "
                              f"shard={ent.shard}")
                return ent.shard
        if shard is None:
            shard = self._place(kind)
        self._mgr[kind].create(sid, tenant, shard=shard)
        self._kind[sid] = kind
        self._shard[sid] = shard
        self._tenant[sid] = tenant
        if prefix_tokens is not None:
            verdict = self.ingest(sid, prefix_tokens)
            req = verdict.request
            if not req.shed and self.prefix_cache is not None:
                # pin the compressed row into the cache when this very
                # request executes (cancel/shed clean these up)
                self._prefix_req[sid] = req
                self._prefix_toks[sid] = np.array(
                    np.asarray(prefix_tokens, np.int32).reshape(-1),
                    copy=True)
        return shard

    def fork_session(self, parent_sid: str, child_sid: str,
                     priority: int = 0) -> Verdict:
        """Fork ``parent_sid`` into a copy-on-write child.  The fork is
        SCHEDULED, not immediate: a zero-token ``fork`` request queues
        on the PARENT session, so the snapshot point respects the
        parent's program order (ops submitted before the fork are in
        the child's branch; ops submitted after are not).  When it
        executes, the child shares the parent's arena row (resident
        parent), host tree (offloaded parent) or replay history — zero
        device copies either way — and pins to the parent's shard.

        The child is addressable IMMEDIATELY: requests may queue on it
        right away, but the scheduler HOLDS them (no priority or
        deadline can reorder a child op before the fork that creates
        the session) until the fork request executes and releases the
        hold."""
        kind = self._kind.get(parent_sid)
        if kind is None:
            raise ValueError(f"unknown parent session {parent_sid!r}")
        if child_sid in self._kind or child_sid in self._pending_forks:
            raise ValueError(f"session {child_sid!r} already exists")
        tenant = self._tenant[parent_sid]
        req = self.scheduler.make_request(
            parent_sid, "fork", np.zeros(0, np.int32), priority,
            tenant=tenant)
        req.shard = self._shard[parent_sid]
        req.fork_child = child_sid
        self._pending_forks.add(child_sid)
        rec = self.obs.recorder
        rec.submit(req)
        verdict = self.admission.submit_request(req)
        self._record_verdict(verdict)
        if not req.shed:
            # reserve the child's address now: submits on it validate
            # and queue (held), a competing create/fork on the sid
            # raises.  _abort_fork unwinds all of this if the fork dies
            # before executing.
            self._kind[child_sid] = kind
            self._shard[child_sid] = self._shard[parent_sid]
            self._tenant[child_sid] = tenant
            self.scheduler.hold(child_sid)
        return dataclasses.replace(verdict, shard=req.shard)

    def _exec_fork(self, r: Request) -> None:
        """Execute one popped fork request — pure control plane (no
        arena activation, no device compute): wire the child into the
        manager and release the scheduler hold on its queued requests.
        A fork whose parent or child vanished between submit and
        execution (close/shed races) fails with a counted, structured
        outcome rather than an exception mid-drain."""
        child = r.fork_child
        kind = self._kind.get(r.sid)
        if kind is not None and child is not None \
                and child in self._pending_forks:
            self._pending_forks.discard(child)
            self._mgr[kind].fork(r.sid, child, tenant=r.tenant)
            if r.sid in self._cached:
                # the child's row shares the parent's KV cache rows —
                # ADD the parent's accounting to any reservations the
                # child's own held queries already made
                self._cached[child] = (self._cached[r.sid]
                                       + self._cached.get(child, 0))
            self.scheduler.release(child)
            self._m_fork.inc()
            self.obs.recorder.executed(r, "fork")
        else:
            self._abort_fork(child)
            self._m_fork_failed.inc()
            self.obs.recorder.note(
                "fork", f"failed parent={r.sid} child={child}")
        r.result = None
        r.done = True
        self.obs.recorder.finished(r)

    def _abort_fork(self, child: Optional[str]) -> None:
        """Unwind a fork that died before executing (parent closed, fork
        request shed as an overflow victim): drop the child-sid
        reservation, cancel its held queued requests (recursively
        aborting any grandchild forks queued on it), and release the
        scheduler hold."""
        if child is None or child not in self._pending_forks:
            return
        self._pending_forks.discard(child)
        self.scheduler.release(child)
        if self._kind.pop(child, None) is None:
            return                    # shed before registration
        rec = self.obs.recorder
        for r in self.admission.cancel(child):
            rec.cancelled(r)
            if r.deadline is not None:
                self._m_deadline["cancelled"].labels(kind=r.kind).inc()
            self._abort_fork(r.fork_child)
        self._cached.pop(child, None)
        self._shard.pop(child, None)
        self._tenant.pop(child, None)

    def shard_of(self, sid: str) -> Optional[int]:
        """The shard owning ``sid``'s session (None = unknown sid)."""
        return self._shard.get(sid)

    def close_session(self, sid: str,
                      shard: Optional[int] = None) -> CloseResult:
        """Tear a session down everywhere (queue, backlog, side tables,
        manager).  Closing an unknown (or already-closed) sid is a
        structured no-op — it used to KeyError out of ``self._kind``
        AFTER cancelling queue entries, leaving a double-close half
        applied.  ``shard``: optional routing assertion — a close
        routed to a shard that does not own the sid is a structured
        no-op (``status="wrong-shard"``) with NOTHING torn down, so a
        misrouted control call can never cancel another shard's
        work."""
        if shard is not None and self._shard.get(sid) != shard:
            return CloseResult(sid, "wrong-shard")
        kind = self._kind.pop(sid, None)
        if kind is None:
            return CloseResult(sid, "unknown")
        dropped = self.admission.cancel(sid)  # backlog + queue
        rec = self.obs.recorder
        for r in dropped:                     # terminal span: cancelled
            rec.cancelled(r)
            if r.deadline is not None:
                # terminal disposition: a cancelled deadline-carrying
                # request never reaches met/missed, so without this the
                # deadline conservation met+missed+shed+cancelled ==
                # requests would leak on every close
                self._m_deadline["cancelled"].labels(kind=r.kind).inc()
            if r.fork_child is not None:
                # a queued fork dies with its parent: unwind the child
                # reservation and its held queued work
                self._abort_fork(r.fork_child)
        # closing a not-yet-created fork child: drop the reservation so
        # the queued fork fails structurally instead of resurrecting it
        self._pending_forks.discard(sid)
        self.scheduler.release(sid)
        self._prefix_req.pop(sid, None)
        self._prefix_toks.pop(sid, None)
        self._cached.pop(sid, None)
        self._shard.pop(sid, None)
        self._tenant.pop(sid, None)
        return self._mgr[kind].close(sid)

    def offload_session(self, sid: str,
                        shard: Optional[int] = None) -> OffloadResult:
        """Explicitly push a session's state to host.  A no-op with a
        telling status for unknown / already-offloaded / never-activated
        sessions — never raises.  ``shard``: optional routing assertion,
        as in `close_session` — a mismatch returns
        ``OffloadResult(status="wrong-shard")`` without touching the
        session."""
        kind = self._kind.get(sid)
        if kind is None:
            return OffloadResult(sid, "unknown")
        if shard is not None and self._shard.get(sid) != shard:
            return OffloadResult(sid, "wrong-shard")
        return self._mgr[kind].offload_batch([sid])[0]

    # -- memory-pressure plumbing (serve.pressure callbacks) -----------
    def _session_footprint(self, sid: str) -> int:
        """Logical device-memory tokens a resident ONLINE session holds:
        its filled compressed-memory groups times comp_len, plus its
        live KV-cache tokens.  A SHARED row (fork siblings, prefix-cache
        attachment) is charged ONCE — to its first resident holder by
        sid order — because the device genuinely holds one copy; this is
        the accounting that lets the pressure budget admit more sessions
        under prefix-heavy dedup at equal capacity."""
        mgr = self._mgr["online"]
        sess = mgr.sessions.get(sid)
        if sess is None or not sess.resident:
            return 0
        mem = sess.mem_groups * self.cfg.ccm.comp_len
        if mgr.arena.shared(sess.slot):
            sharers = mgr.slot_sharers(sess.slot)
            if sharers and sid != sharers[0]:
                mem = 0
        return mem + self._cached.get(sid, 0)

    def _has_pending_work(self, sid: str) -> bool:
        """Whether the session has work anywhere (scheduler queue or
        admission backlog) — the pressure controller never offloads
        such sessions: they would restore on the very next batch."""
        if self.scheduler.queued(sid=sid):
            return True
        return any(r.sid == sid for r in self.admission.backlog)

    def _all_pending_late(self, sid: str) -> bool:
        """Whether EVERY pending request of the session (queue +
        backlog) is already past its deadline — the pressure
        controller's 'unsalvageable' predicate: offloading such a
        session delays only work whose SLO is lost anyway
        (`PressurePolicy.offload_late_sessions`)."""
        reqs = self.scheduler.queued(sid=sid) + [
            r for r in self.admission.backlog if r.sid == sid]
        if not reqs:
            return False
        now = self.obs.clock.now()
        return all(self.scheduler.is_late(r, now) for r in reqs)

    def _recompress_session(self, sid: str) -> int:
        """Pressure lever 1: collapse the session's resident compressed
        memory at ``recompress_group`` (one gather -> masked recompress
        -> scatter over the mem slabs); returns logical
        tokens freed (0 when nothing would shrink)."""
        mgr = self._mgr["online"]
        sess = mgr.sessions.get(sid)
        if sess is None or not sess.resident:
            return 0
        if mgr.arena.shared(sess.slot):
            # a shared row is read-only: recompressing in place would
            # silently corrupt every sibling (the arena's write guard
            # would refuse the scatter anyway) — refuse the lever; the
            # controller moves on to the next candidate
            return 0
        group = self.pressure.policy.recompress_group
        new_groups = -(-sess.mem_groups // group)
        freed = (sess.mem_groups - new_groups) * self.cfg.ccm.comp_len
        if freed <= 0:
            return 0
        arena = mgr.arena
        arena.slabs = arena.slabs._replace(mem=SRV.recompress_arena_slots(
            arena.slabs.mem, [sess.slot], cfg=self.cfg, group=group))
        arena.mark_dirty([sess.slot])
        sess.mem_groups = new_groups
        return freed

    # -- request submission -------------------------------------------
    def _on_shed(self, req: Request) -> None:
        """Admission dropped a request: release any resources its
        submit-time validation reserved (KV-cache token accounting),
        and attribute the shed to the owning shard (fairness signal)."""
        if req.kind == "query" and req.sid in self._cached:
            # plain decrement: every shed query (newcomer or queued
            # victim) carries a reservation made at its own submit
            self._cached[req.sid] -= req.token_len
        if req.fork_child is not None:
            self._abort_fork(req.fork_child)
        if self._prefix_req.get(req.sid) is req:
            # the shed request was the prefix ingest that would have
            # pinned the cache entry — it never runs
            self._prefix_req.pop(req.sid, None)
            self._prefix_toks.pop(req.sid, None)
        self._m_shard_shed.labels(shard=str(req.shard)).inc()
        if req.deadline is not None:
            late = self.scheduler.is_late(req)
            self._m_deadline["shed"].labels(
                late="yes" if late else "no").inc()

    def _submit(self, sid: str, op: str, tokens, priority: int,
                deadline: Optional[float] = None) -> Verdict:
        kind = self._kind[sid]
        if _OP_STATE[op] != kind:
            raise ValueError(f"op {op!r} invalid for {kind!r} session {sid!r}")
        tenant = self._tenant[sid]
        if deadline is None:
            # SLO-derived deadline: the tenant's per-kind budget from now
            slo = self.admission.quota(tenant).slo_for(op)
            if slo is not None:
                deadline = self.obs.clock.now() + slo
        # make (and shape-validate) the request BEFORE any reservation —
        # a validation error must raise with zero side effects
        req = self.scheduler.make_request(sid, op, tokens, priority,
                                          tenant=tenant, deadline=deadline)
        req.shard = self._shard[sid]   # route to the session's placement
        if deadline is not None:
            self._m_deadline["requests"].labels(kind=op).inc()
        # offered-traffic length sample for the bucket-derivation fit
        # (recorded regardless of verdict: the ladder should serve what
        # ARRIVES, not just what survived admission)
        self._len_history.append(req.token_len)
        self._len_seen += 1
        n = req.token_len
        if op == "stream" and n > self.cfg.ccm.stream_chunk:
            # mirror the stream_step trace-time guard HERE, before the
            # request enters the queue — a trace error mid-drain would
            # abort run() after the batch was already popped
            raise ValueError(
                f"stream chunk ({n} tokens) exceeds "
                f"cfg.ccm.stream_chunk ({self.cfg.ccm.stream_chunk}); "
                "split the input")
        if op == "query":
            # queries append their tokens to the session's KV cache; the
            # cache write clamps silently past cache_len, corrupting
            # earlier rows — admit only what fits (counts queued work).
            # The reservation happens BEFORE admission so _on_shed can
            # reverse it symmetrically whether the shed request is this
            # one (shed at submit) or a queued victim it displaces.
            used = self._cached.get(sid, 0)
            if used + n > self.cache_len:
                raise ValueError(
                    f"session {sid!r} KV cache exhausted: {used} tokens "
                    f"cached + {n} requested > cache_len "
                    f"{self.cache_len}; close the session or build the "
                    "engine with a larger cache_len")
            self._cached[sid] = used + n
        rec = self.obs.recorder
        rec.submit(req)
        verdict = self.admission.submit_request(req)
        self._record_verdict(verdict)
        # surface the owning shard on the verdict so callers can route
        # follow-up control calls (close/offload) without a lookup
        return dataclasses.replace(verdict, shard=req.shard)

    def _record_verdict(self, verdict: Verdict) -> None:
        """Span events for the verdict — the engine observes everything
        from the structured return value, so admission stays recorder-
        free (pure control plane)."""
        rec = self.obs.recorder
        req = verdict.request
        cls = type(verdict).__name__
        if cls == "Admitted":
            rec.admitted(req)
            for v in verdict.shed_victims:     # terminal: displaced
                rec.shed(v, "displaced by higher-priority submit")
        elif cls == "Queued":
            rec.backlogged(req, verdict.reason)
        else:                                  # Shed
            rec.shed(req, verdict.reason)

    def now(self) -> float:
        """Current time on the engine's clock — the base for absolute
        ``deadline=`` arguments (``eng.ingest(sid, toks,
        deadline=eng.now() + 0.5)``)."""
        return self.obs.clock.now()

    def ingest(self, sid, tokens, priority: int = 0,
               deadline: Optional[float] = None) -> Verdict:
        return self._submit(sid, "ingest", tokens, priority, deadline)

    def query(self, sid, tokens, priority: int = 0,
              deadline: Optional[float] = None) -> Verdict:
        return self._submit(sid, "query", tokens, priority, deadline)

    def stream(self, sid, tokens, priority: int = 0,
               deadline: Optional[float] = None) -> Verdict:
        return self._submit(sid, "stream", tokens, priority, deadline)

    # -- execution -----------------------------------------------------
    def _step(self, op: str, masked: bool):
        """Arena step per (op, masked).  Full-length batches take the
        unmasked step (no valid-mask metadata, slice writes); only
        genuinely ragged batches run the masked variant."""
        key = (op, masked)
        if key not in self._steps:
            self._steps[key] = self._step_factory(self.cfg, op, masked)
        return self._steps[key]

    def _note_shape(self, op: str, lanes: int, token_len: int,
                    masked: bool) -> None:
        """Count first-seen step shapes (op, lanes, token_len, masked):
        the shape-churn signal the bucket-ladder cost model feeds on (in
        the reference each new key is one fresh XLA compile; the port
        compiles nothing per shape, but keeps the count so the two
        engines report the same metric)."""
        key = (op, lanes, token_len, masked)
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            shape = f"{lanes}x{token_len}" + ("/masked" if masked else "")
            self._m["compiled"].labels(kind=op, shape=shape).inc()

    def _make_replay(self, state_kind: str):
        """Replay a recompute-dropped session's request history into its
        (zeroed) slot: one B=1 fused step per recorded request, padded
        into the same token buckets as live traffic so replay shares the
        serve programs instead of compiling exact-length ones."""
        def replay(sid: str, slot: int, history) -> None:
            mgr = self._mgr[state_kind]
            arena = mgr.arena
            ids = [slot]
            for op, toks in history:
                flat = np.asarray(toks, np.int32).reshape(-1)
                L = flat.size
                tl = token_bucket(L, self._token_buckets) if self.ragged \
                    else L
                if op == "stream":
                    tl = min(tl, self.cfg.ccm.stream_chunk)
                tl = max(tl, L)
                buf = np.zeros((1, 1, tl), np.int32)
                buf[0, 0, :L] = flat
                masked = self.ragged and tl != L
                step = self._step(op, masked)
                self._note_shape(op, 1, tl, masked)
                _, arena.slabs = step(self.params, arena.slabs, ids, buf,
                                      np.asarray([L], np.int32))
            arena.mark_dirty([slot])
            if state_kind == "online":
                # a replay rebuilds memory at the BASE ratio: the group
                # count is the replayed ingests (capped), regardless of
                # any recompression the dropped state had absorbed
                mgr.sessions[sid].mem_groups = min(
                    sum(1 for op, _ in history if op == "ingest"),
                    self._max_mem_groups)
        return replay

    def _maybe_cache_prefix(self, r: Request, sess) -> None:
        """Pin a just-executed prefix ingest into the prefix cache.
        Identity-checked against the request recorded at
        `create_session` (NOT just the sid) so a later ordinary ingest
        on the same session never caches non-prefix content.  Runs
        AFTER the batch's scatter + `mark_dirty`, so the incref lands on
        a row the write guard has already cleared at refcount 1."""
        if self._prefix_req.get(r.sid) is not r:
            return
        self._prefix_req.pop(r.sid, None)
        ptoks = self._prefix_toks.pop(r.sid, None)
        if self.prefix_cache is None or ptoks is None:
            return
        ent = self.prefix_cache.insert(
            sess.tenant, ptoks, sess.slot, sess.shard, sess.mem_groups)
        self.obs.recorder.note(
            "prefix", f"cached sid={r.sid} slot={ent.slot} "
                      f"shard={ent.shard} groups={ent.mem_groups}")

    def _run_batch(self, batch: ScheduledBatch) -> None:
        mgr = self._mgr[_OP_STATE[batch.kind]]
        arena = mgr.arena
        rec = self.obs.recorder
        pinned = {r.sid for r in batch.requests}
        t0 = self.obs.clock.now()
        slots = mgr.activate_batch([r.sid for r in batch.requests], pinned)
        ids = slots + [arena.pad_slot] * batch.pad
        # lanes padded up to the batch's token bucket; per-lane valid
        # lengths drive the masked ops (pad lanes claim the full bucket —
        # they gather/scatter the scratch row, semantics don't matter)
        toks = np.zeros((batch.bucket, 1, batch.token_len), np.int32)
        for i, r in enumerate(batch.requests):
            toks[i, 0, :r.token_len] = r.tokens[0]
        lengths = np.asarray(batch.valid_lens
                             + [batch.token_len] * batch.pad, np.int32)
        # one arena step: gather rows -> lane-batched op -> scatter rows
        # back into the slabs.  No sync here: batches queue on the device
        # stream while Python schedules the next; run() syncs once at the
        # end of the drain.
        masked = self.ragged and any(vl != batch.token_len
                                     for vl in batch.valid_lens)
        step = self._step(batch.kind, masked)
        self._note_shape(batch.kind, batch.bucket, batch.token_len, masked)
        out, arena.slabs = step(self.params, arena.slabs, ids, toks,
                                lengths)
        arena.mark_dirty(ids)
        dt = self.obs.clock.now() - t0
        # results are NOT materialized here — copying out to the host
        # would block on this batch's compute and serialize the drain;
        # run() converts all outs after the last dispatch (one transfer
        # per batch, per-request results become zero-copy numpy views)
        self._undelivered.append((batch.requests, out))
        shape = f"{batch.bucket}x{batch.token_len}" \
            + ("/masked" if masked else "")
        for r in batch.requests:
            sess = mgr.sessions[r.sid]
            sess.n_ops += 1
            if batch.kind == "ingest":
                # host mirror of the slot's MemState.slots (concat mode
                # caps at max_slots; merge pins at 1) — the pressure
                # controller's footprint accounting
                sess.mem_groups = min(sess.mem_groups + 1,
                                      self._max_mem_groups)
                self._maybe_cache_prefix(r, sess)
            mgr.record(r.sid, r.kind, r.tokens[0])
            rec.executed(r, shape)
        rec.note("batch", f"kind={batch.kind} shape={shape} "
                          f"real={len(batch.requests)} pad={batch.pad} "
                          f"dispatch_s={dt:.6f}")
        m = self._m
        m["requests"].labels(kind=batch.kind).inc(len(batch.requests))
        m["tokens"].labels(kind=batch.kind).inc(sum(batch.valid_lens))
        m["pad_lanes"].labels(kind=batch.kind).inc(batch.pad)
        m["pad_tokens"].labels(kind=batch.kind).inc(
            len(batch.requests) * batch.token_len - sum(batch.valid_lens))
        m["lanes"].labels(kind=batch.kind).inc(batch.bucket)
        m["batches"].labels(kind=batch.kind).inc()
        m["dispatch_s"].labels(kind=batch.kind).inc(dt)

    def run(self, max_batches: Optional[int] = None) -> int:
        """Drain the queue (or up to ``max_batches``); returns batches
        run.  After every popped batch the admission backlog is pumped —
        backpressured submits enter the queue as soon as their tokens
        fit — and the drain only ends once both the queue AND the
        pumpable backlog are empty.  Synchronizes once at the end, so
        per-kind dispatch seconds are dispatch times and the drain's
        wall clock is the true cost.  If anything escapes mid-drain the
        flight recorder's last events are dumped to stderr before the
        exception propagates."""
        try:
            return self._run(max_batches)
        except Exception as exc:                 # noqa: BLE001 — re-raised
            self._dump_flight_on_error(exc)
            raise

    def _run(self, max_batches: Optional[int]) -> int:
        rec = self.obs.recorder
        n = 0
        t0 = self.obs.clock.now()
        while max_batches is None or n < max_batches:
            # pop boundary: the ONLY place a derived-bucket refit may
            # land.  A pop and its execution run under `_popping`; a
            # refit requested meanwhile is deferred and applied here,
            # before the next pop starts
            if (self.bucket_policy == "derived"
                    and self._len_seen - self._len_at_refit
                    >= self._bucket_refit_interval):
                self.refit_token_buckets()
            self._popping = True
            try:
                # recomputed per pop: pumped backlog entries can
                # introduce tenants that were not queued when the drain
                # started
                caps, default_cap = self.admission.lane_caps()
                batch = self.scheduler.next_batch(caps, default_cap)
                if batch is None:
                    pumped = self.admission.pump()
                    if pumped:
                        for r in pumped:
                            rec.pumped(r)
                        continue
                    break
                self.admission.note_popped(batch.requests)
                for r in batch.requests:
                    rec.popped(r)
                if batch.kind == "fork":
                    # control-plane only: snapshot the parent at its
                    # program-order point — no device step runs
                    for r in batch.requests:
                        self._exec_fork(r)
                else:
                    self._run_batch(batch)
                if self.pressure is not None:
                    # drain hook: footprints grew by the batch's ingest
                    # groups / query cache writes AFTER their admission
                    # check — re-absorb past the high watermark so the
                    # next submit doesn't start from a deep deficit
                    self.pressure.maybe_relieve()
                for r in self.admission.pump():
                    rec.pumped(r)
                n += 1
            finally:
                self._popping = False
            if self._refit_pending:
                self._refit_pending = False
                self.refit_token_buckets()
        if n:
            now = self.obs.clock.now()
            for reqs, out in self._undelivered:
                out_np = None if out is None else (
                    out.float().cpu().numpy() if isinstance(out, torch.Tensor)
                    else np.asarray(out))
                for i, r in enumerate(reqs):
                    # slice off bucket padding: a request padded into a
                    # larger token lane only owns its first valid_len
                    # logit rows (the rest are masked-lane garbage)
                    r.result = out_np[i, 0, :r.token_len] \
                        if out_np is not None else None
                    r.done = True
                    if r.deadline is not None:
                        if now > r.deadline:
                            self._m_deadline["missed"].labels(
                                kind=r.kind).inc()
                            self._h_lateness.observe(now - r.deadline)
                        else:
                            self._m_deadline["met"].labels(
                                kind=r.kind).inc()
                    rec.finished(r)
            self._undelivered.clear()
        for m in self._mgr.values():
            # unconditional: async offload_session() transfers may be in
            # flight even when this drain popped zero batches — leaving
            # them unbarriered would pin the stacked host buffers forever
            m.sync()
        if n:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._m["wall_s"].inc(self.obs.clock.now() - t0)
        if self._refit_pending:
            # a refit deferred by the final pop (the loop broke before
            # reaching the next pop boundary) — apply it now, the drain
            # is over
            self._refit_pending = False
            self.refit_token_buckets()
        elif (self.bucket_policy == "derived"
                and self._len_seen - self._len_at_refit
                >= self._bucket_refit_interval):
            # off the hot path: refit between drains so the next drain's
            # pops (and replay padding) use the updated ladder
            self.refit_token_buckets()
        return n

    def _dump_flight_on_error(self, exc: BaseException) -> None:
        """Crash forensics: print the flight recorder's bounded ring of
        recent events to stderr (no-op under `NullRecorder`)."""
        rec = self.obs.recorder
        rec.note("error", repr(exc))
        lines = rec.flight_lines()
        if lines:
            print(f"--- serve flight recorder ({len(lines)} events, "
                  f"most recent last) ---", file=sys.stderr)
            for line in lines:
                print(line, file=sys.stderr)
            print("--- end flight recorder ---", file=sys.stderr)

    # -- introspection -------------------------------------------------
    @property
    def stats(self) -> Dict[str, Dict[str, float]]:
        """Legacy per-kind stats view, now read from the registry
        (``serve_*_total{kind}``).  ``seconds`` are dispatch times only;
        the synced drain wall clock is ``stats_wall``."""
        out = {}
        for k in _OP_STATE:
            out[k] = {key: int(self._m[key].labels(kind=k).value)
                      for key in _STAT_KEYS}
            out[k]["seconds"] = float(
                self._m["dispatch_s"].labels(kind=k).value)
        return out

    @property
    def stats_wall(self) -> float:
        """Synchronized wall seconds across all drains (registry view of
        ``serve_wall_seconds_total``)."""
        return float(self._m["wall_s"].value)

    def compile_stats(self, clamped: bool = False) -> Dict[str, int]:
        """Distinct step shapes dispatched per op kind (shape-churn
        metric): the ``(op, lanes, token_len, masked)`` keys `_note_shape`
        has seen — what the reference's per-kind jit cache sizes count.
        The port has no jit cache, so the reference's ``-1`` "unmeasured"
        sentinel never occurs; ``clamped`` is accepted for the same
        signature."""
        del clamped
        out: Dict[str, int] = {op: 0 for op, _ in self._steps}
        for op, _lanes, _tl, _masked in self._seen_shapes:
            out[op] = out.get(op, 0) + 1
        return out

    # -- traffic-derived token buckets ---------------------------------
    @property
    def token_buckets(self):
        """The ACTIVE token-bucket ladder (None = exact-length
        grouping).  Static by default; ``bucket_policy='derived'``
        refits it from traffic (`refit_token_buckets`)."""
        return self._token_buckets

    def length_history(self) -> List[int]:
        """Recent offered request token lengths (bounded window) — the
        sample `derive_token_buckets` fits on."""
        return list(self._len_history)

    def derived_token_buckets(self,
                              compile_cost_tokens: Optional[float] = None
                              ) -> Tuple[int, ...]:
        """Fit a ladder to the observed length window WITHOUT applying
        it (`launch.specs.derive_token_buckets`).  Already-compiled
        padded lengths (the compile-churn counter's seen shapes) cost no
        churn, so refits gravitate to warm shapes; the result never
        pads worse than the configured static ladder on this window.
        With an empty window the static ladder comes back unchanged."""
        if not self.ragged:
            raise ValueError("bucket derivation needs ragged batching")
        compiled = {tl for (_op, _lanes, tl, _masked) in self._seen_shapes}
        return derive_token_buckets(
            list(self._len_history),
            max_buckets=self._bucket_max,
            compile_cost_tokens=(self._bucket_compile_cost
                                 if compile_cost_tokens is None
                                 else compile_cost_tokens),
            compiled_lens=compiled,
            baseline=self._static_token_buckets)

    def refit_token_buckets(self) -> Tuple[int, ...]:
        """Apply a fresh fit as the active ladder (scheduler pops and
        replay padding pick it up immediately; per-kind max_token_len
        caps still apply at pop time).  Counted in
        ``serve_bucket_refits_total``; the drain loop calls this
        automatically under ``bucket_policy='derived'`` every
        ``bucket_refit_interval`` submissions.

        ATOMICITY: a ladder swap must never land between a sharded
        pop's per-shard sub-batches (they would bucket to different
        token lengths and the (S, B, L) lanes could not stack).  While
        the drain loop is inside a pop (``_popping``) the refit is
        DEFERRED — recorded and applied at the next pop boundary — and
        the active ladder is returned unchanged."""
        if self._popping:
            self._refit_pending = True
            self._m_refits_deferred.inc()
            self.obs.recorder.note(
                "buckets", "refit deferred: pop in progress "
                           "(applied at the next pop boundary)")
            return self._token_buckets
        ladder = self.derived_token_buckets()
        self._token_buckets = ladder
        self.scheduler.token_buckets = ladder
        self._len_at_refit = self._len_seen
        self._m_refits.inc()
        self._g_ladder.set(len(ladder))
        self.obs.recorder.note(
            "buckets", f"refit token ladder -> {ladder}")
        return ladder

    def compiled_programs(self) -> int:
        """Total compiled programs across op kinds (compile-cache churn:
        compare exact-length vs token-bucketed scheduling on the same
        traffic).  Unmeasured kinds count as 0 (see ``compile_stats``)."""
        return sum(self.compile_stats(clamped=True).values())

    def batch_occupancy(self) -> Dict[str, float]:
        """Mean fraction of batch lanes holding a real request, per op
        kind (1.0 = no pad lanes; higher is better batch sharing)."""
        return {k: (s["requests"] / s["lanes"] if s["lanes"] else 0.0)
                for k, s in self.stats.items()}

    def occupancy(self) -> Dict[str, float]:
        return {k: m.arena.occupancy for k, m in self._mgr.items()}

    def resident(self) -> Dict[str, int]:
        return {k: m.n_resident for k, m in self._mgr.items()}

    def queue_depth(self) -> int:
        """Requests waiting anywhere: scheduler queue + admission
        backlog (the open-loop benchmark's saturation metric)."""
        return self.scheduler.pending + len(self.admission.backlog)

    def throughput(self) -> float:
        """Overall tokens/s across all drains (synced wall clock).
        Per-kind ``stats[kind]['seconds']`` are dispatch times only."""
        total = sum(s["tokens"] for s in self.stats.values())
        wall = self.stats_wall
        return total / wall if wall else 0.0

    # -- metrics export ------------------------------------------------
    def _sample_gauges(self) -> None:
        """Refresh point-in-time gauges and run the arena free-list
        integrity probe (probe/error counters) — called on every
        snapshot/export so gauges are current at read time."""
        g, probe = self._g, self._probe
        for kind, mgr in self._mgr.items():
            arena = mgr.arena
            sample = arena.metrics_sample()
            g["occupancy"].labels(arena=kind).set(sample["occupancy"])
            g["slots"].labels(arena=kind, state="live").set(sample["live"])
            g["slots"].labels(arena=kind, state="free").set(sample["free"])
            g["resident"].labels(arena=kind).set(mgr.n_resident)
            g["shared_rows"].labels(arena=kind).set(sample["shared"])
            errs = arena.consistency_errors()
            probe["probes"].labels(arena=kind).inc()
            if errs:
                probe["errors"].labels(arena=kind).inc(len(errs))
                self.obs.recorder.note(
                    "arena-integrity", f"{kind}: {errs}")
            gs = self._g_shard
            res_by_shard = [0] * self.n_shards
            for sess in mgr.sessions.values():
                if sess.resident:
                    res_by_shard[sess.shard] += 1
            for s, sh in enumerate(sample["shards"]):
                gs["occupancy"].labels(arena=kind, shard=str(s)).set(
                    sh["occupancy"])
                gs["resident"].labels(arena=kind, shard=str(s)).set(
                    res_by_shard[s])
        q_by_shard = [0] * self.n_shards
        for r in self.scheduler.queued():
            q_by_shard[r.shard] += 1
        for s, d in enumerate(q_by_shard):
            self._g_shard["queue_depth"].labels(shard=str(s)).set(d)
        g["queue_depth"].set(self.scheduler.pending)
        g["backlog_depth"].set(len(self.admission.backlog))
        if self.pressure is not None:
            self.pressure.sample_gauges()
        for tenant, quota in self.admission.quotas.items():
            if quota.max_queued_tokens:
                g["quota_pressure"].labels(tenant=tenant).set(
                    self.admission.queued_tokens(tenant)
                    / quota.max_queued_tokens)

    def metrics_snapshot(self) -> dict:
        """Full JSON-ready metrics export: every registry family plus a
        ``derived`` block of ratios the registry cannot express
        (throughput, occupancy, compile stats).  See
        docs/OBSERVABILITY.md for the catalog."""
        self._sample_gauges()
        return {
            "metrics": self.obs.registry.snapshot(),
            "derived": {
                "throughput_tok_per_s": self.throughput(),
                "batch_occupancy": self.batch_occupancy(),
                "arena_occupancy": self.occupancy(),
                "resident": self.resident(),
                "queue_depth": self.queue_depth(),
                "compile_stats": self.compile_stats(),
                "admission": dict(self.admission.stats),
            },
        }

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the registry (gauges freshly
        sampled).  Derived ratios are JSON-snapshot-only — Prometheus
        consumers compute rates from the raw counters."""
        self._sample_gauges()
        return self.obs.registry.to_prometheus()
