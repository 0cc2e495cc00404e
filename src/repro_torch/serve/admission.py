"""Admission control: bounded ingress, per-tenant quotas, overflow policy.

The paper's premise is inference "in a limited memory space": the arena
caps resident sessions, but without admission control the *queue* is
unbounded and `ArenaFull` can surface mid-drain.  This module makes
overflow a first-class contract: every `ServeEngine.submit` returns a
structured verdict and nothing past this layer can run out of room.

  Admitted  — the request is in the scheduler queue (possibly after
              shedding strictly-lower-priority victims, listed on the
              verdict).
  Queued    — backpressured (``block`` policy): held in an ingress
              backlog outside the scheduler queue; `pump()` admits it
              once queued-token capacity frees (the engine pumps after
              every popped batch).
  Shed      — dropped with a reason; the request is flagged
              ``shed``/``done`` and will never run.

Quotas are per *tenant* (a group of sessions — one user, org, or API
key; sessions default to the ``"default"`` tenant):

  max_resident       — cap on the tenant's device-resident sessions per
                       arena.  Enforced from both sides: batch formation
                       never takes more of a tenant's lanes than its
                       quota (`Scheduler.next_batch(tenant_lane_caps)`),
                       and activation evicts the tenant's own LRU
                       session once it is at quota
                       (`SessionManager.activate_batch`).
  max_queued_tokens  — cap on the tenant's tokens in the scheduler
                       queue; the controller's own ``max_queued_tokens``
                       bounds the global queue the same way.

Overflow policies (what happens when a submit would break a bound):

  block                — hold the request in the ingress backlog; FIFO
                         per tenant (cross-tenant overtaking allowed, so
                         one saturated tenant never head-of-line-blocks
                         the rest).
  shed-lowest-priority — make room by shedding queued requests whose
                         *effective* priority (aging included) is
                         STRICTLY lower than the incoming request's;
                         among those, victims that are ALREADY LATE on
                         their deadline go first (their SLO is lost
                         either way — `Scheduler.shed_preference_key`),
                         and victims are only ever a session's queued
                         suffix (program order is never punctured).  If
                         no such victim frees enough room, the incoming
                         request itself is shed.
  reject-new           — shed the incoming request immediately.

A request whose tokens alone exceed an applicable bound is shed under
every policy (``block`` would otherwise hold it forever).

Verdicts are counted in the engine's `MetricsRegistry`
(``admission_verdicts_total{verdict=...}``); the legacy ``stats`` dict
is a read-only view over those counters.  Every counter is MONOTONIC —
a pumped request counts under ``pumped``, not ``admitted`` (direct
admissions only), so rates computed from scrapes are always
well-defined.

Port of ``repro/serve/admission.py``, copied: pure Python.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.obs import MetricsRegistry
from repro_torch.serve.pressure import MemoryPressureController
from repro_torch.serve.scheduler import Request, Scheduler

POLICIES = ("block", "shed-lowest-priority", "reject-new")


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission bounds (None = unbounded).

    ``slo_seconds`` turns the quota into an SLO policy: a submit that
    carries no explicit deadline gets one derived as ``now + slo``.  A
    float applies to every op kind; a dict maps kinds (``ingest`` /
    ``query`` / ``stream``) to their own SLO, with missing kinds left
    deadline-less."""
    max_resident: Optional[int] = None       # resident sessions per arena
    max_queued_tokens: Optional[int] = None  # tokens in the scheduler queue
    slo_seconds: Union[float, Dict[str, float], None] = None

    def __post_init__(self):
        if self.max_resident is not None and self.max_resident < 1:
            raise ValueError("max_resident quota must be >= 1 "
                             "(0 would make the tenant unschedulable)")
        if self.max_queued_tokens is not None and self.max_queued_tokens < 1:
            raise ValueError("max_queued_tokens quota must be >= 1")
        slos = (self.slo_seconds.values()
                if isinstance(self.slo_seconds, dict)
                else (self.slo_seconds,))
        for s in slos:
            if s is not None and not s > 0:
                raise ValueError(f"slo_seconds must be > 0, got {s!r}")

    def slo_for(self, kind: str) -> Optional[float]:
        """Deadline budget (seconds from submit) for an op kind."""
        if isinstance(self.slo_seconds, dict):
            return self.slo_seconds.get(kind)
        return self.slo_seconds


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Structured outcome of an engine submit; ``request`` is the live
    handle (poll ``request.done`` / read ``request.result``).

    ``shard`` is the arena shard that owns the request's session (the
    engine fills it in from the session's fixed placement) — callers on
    a sharded engine can route follow-up control calls
    (`close_session` / `offload_session`) with it; it is ``None`` when
    the controller is used standalone."""
    request: Request
    shard: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Admitted(Verdict):
    shed_victims: Tuple[Request, ...] = ()   # displaced queued requests


@dataclasses.dataclass(frozen=True)
class Queued(Verdict):
    reason: str = ""                         # which bound backpressured it


@dataclasses.dataclass(frozen=True)
class Shed(Verdict):
    reason: str = ""


class AdmissionController:
    """Bounded ingress in front of a `Scheduler`.

    The controller owns the token accounting for the scheduler queue
    (incremented at enqueue, decremented when the engine reports popped
    batches / cancels) and the ``block``-policy backlog.  It never
    touches device state — pure control plane, which is what lets the
    property harness fuzz it exhaustively."""

    def __init__(self, scheduler: Scheduler, policy: str = "block",
                 max_queued_tokens: Optional[int] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 on_shed: Optional[Callable[[Request], None]] = None,
                 max_backlog: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 pressure: Optional[MemoryPressureController] = None):
        """``max_backlog``: cap on ``block``-policy backlog ENTRIES —
        beyond it even the block policy sheds newcomers, so a producer
        that ignores ``Queued`` verdicts cannot grow host memory without
        bound.  None (default) leaves the backlog unbounded (the
        caller's waiters are then the backstop).

        ``pressure``: a `serve.pressure.MemoryPressureController` adds
        the device-memory budget as one more admission bound — and,
        crucially, a memory deficit is handed to the controller's
        degradation ladder (recompress -> offload) BEFORE any overflow
        policy sheds work; only an unrelievable remainder reaches the
        shed path."""
        if policy not in POLICIES:
            raise ValueError(f"unknown overflow policy {policy!r}; "
                             f"pick one of {POLICIES}")
        self.scheduler = scheduler
        self.policy = policy
        self.max_queued_tokens = max_queued_tokens
        self.max_backlog = max_backlog
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota or TenantQuota()
        self.pressure = pressure
        self._on_shed = on_shed
        self._queued_tokens: Dict[str, int] = {}   # per tenant, in queue
        self._queued_total = 0
        self._backlog: List[Request] = []          # block-policy holding pen
        # bounded audit trail of shed-lowest-priority decisions, recorded
        # AT decision time (candidate preference order, lateness flags,
        # deficits, chosen victims) — the property harness replays the
        # two-pass selection from it and asserts the victims match
        self.shed_decisions: collections.deque = collections.deque(
            maxlen=512)
        self._verdicts = (metrics or MetricsRegistry()).counter(
            "admission_verdicts_total",
            "admission outcomes: admitted (direct), queued "
            "(backpressured), pumped (backlog -> queue), shed_new "
            "(newcomer dropped), shed_victim (queued request displaced)",
            labels=("verdict",))
        for v in ("admitted", "queued", "pumped", "shed_new",
                  "shed_victim"):       # explicit zeros in exports
            self._verdicts.labels(verdict=v)

    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counter view over ``admission_verdicts_total``.  All
        values are monotonic: ``admitted`` counts DIRECT admissions;
        backlog entries admitted later count under ``pumped`` (their
        backpressure is already counted under ``queued``)."""
        v = self._verdicts
        return {"admitted": int(v.labels(verdict="admitted").value),
                "queued": int(v.labels(verdict="queued").value),
                "shed_new": int(v.labels(verdict="shed_new").value),
                "shed_victims": int(v.labels(verdict="shed_victim").value),
                "pumped": int(v.labels(verdict="pumped").value)}

    # -- introspection -------------------------------------------------
    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def queued_tokens(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return self._queued_total
        return self._queued_tokens.get(tenant, 0)

    @property
    def backlog(self) -> Tuple[Request, ...]:
        return tuple(self._backlog)

    def lane_caps(self) -> Tuple[Optional[Dict[str, Optional[int]]],
                                 Optional[int]]:
        """(per-tenant batch lane caps, default cap) for
        `Scheduler.next_batch`.  Explicitly-quota'd tenants appear in
        the dict with their own ``max_resident`` — including ``None``
        for residency-unbounded, which fully OVERRIDES the default
        (matches quota()/SessionManager eviction semantics); every
        other tenant falls back to the default quota's cap.  O(quotas),
        independent of queue depth — called before every batch pop."""
        caps: Dict[str, Optional[int]] = {
            t: q.max_resident for t, q in self.quotas.items()}
        default = self.default_quota.max_resident
        if default is None and not any(c is not None
                                       for c in caps.values()):
            return None, None
        return caps, default

    # -- bound checks --------------------------------------------------
    def _headroom(self, tenant: str) -> Tuple[Optional[int], Optional[str]]:
        """(smallest applicable token headroom, limiting bound's name);
        (None, None) when unbounded."""
        room, bound = None, None
        q = self.quota(tenant).max_queued_tokens
        if q is not None:
            room = q - self.queued_tokens(tenant)
            bound = f"tenant {tenant!r} queued-token quota ({q})"
        if self.max_queued_tokens is not None:
            g = self.max_queued_tokens - self._queued_total
            if room is None or g < room:
                room, bound = g, (f"global queued-token bound "
                                  f"({self.max_queued_tokens})")
        if self.pressure is not None:
            m = self.pressure.headroom()
            if room is None or m < room:
                room, bound = m, (f"device-memory budget "
                                  f"({self.pressure.capacity} tokens)")
        return room, bound

    def _hard_cap(self, tenant: str) -> Optional[int]:
        """Largest request this tenant could EVER fit (even into an
        empty queue); None = unbounded."""
        caps = [c for c in (self.quota(tenant).max_queued_tokens,
                            self.max_queued_tokens) if c is not None]
        if self.pressure is not None:
            caps.append(self.pressure.capacity)
        return min(caps) if caps else None

    # -- submit --------------------------------------------------------
    def submit(self, sid: str, kind: str, tokens, priority: int = 0,
               tenant: str = "default",
               deadline: Optional[float] = None) -> Verdict:
        if deadline is None:
            slo = self.quota(tenant).slo_for(kind)
            if slo is not None:
                deadline = self.scheduler.clock.now() + slo
        return self.submit_request(
            self.scheduler.make_request(sid, kind, tokens, priority,
                                        tenant, deadline=deadline))

    def submit_request(self, req: Request) -> Verdict:
        """Admit an already-made request (the engine makes the request
        first so validation errors raise before any resource is
        reserved against it)."""
        tenant = req.tenant
        hard = self._hard_cap(tenant)
        if hard is not None and req.token_len > hard:
            return self._shed_new(
                req, f"request ({req.token_len} tokens) exceeds the "
                     f"smallest applicable queued-token bound ({hard}); "
                     "it could never be admitted")
        if self.pressure is not None:
            # THE LADDER: a memory deficit goes to the degradation
            # controller (recompress, then offload) before any policy
            # is allowed to shed or backpressure for memory.  Only the
            # memory bound is relievable — queued-token bounds are not
            # about device memory and fall through untouched.
            mh = self.pressure.headroom()
            if req.token_len > mh:
                self.pressure.relieve(req.token_len - mh)
        room, bound = self._headroom(tenant)
        blocked_behind = self.policy == "block" and any(
            r.tenant == tenant for r in self._backlog)
        if (room is None or req.token_len <= room) and not blocked_behind:
            return self._admit(req)
        if self.policy == "reject-new":
            return self._shed_new(req, f"over {bound} (reject-new)")
        if self.policy == "block":
            if (self.max_backlog is not None
                    and len(self._backlog) >= self.max_backlog):
                return self._shed_new(
                    req, f"backlog full ({self.max_backlog} entries)")
            self._backlog.append(req)
            self._verdicts.labels(verdict="queued").inc()
            # honest reason: a request that FITS current headroom was
            # backpressured purely by per-tenant FIFO ordering, not by
            # the bound _headroom happened to name
            fits_now = room is None or req.token_len <= room
            return Queued(req, reason=(
                f"FIFO behind tenant {tenant!r} backlog" if fits_now
                else bound))
        return self._shed_for(req, bound)

    # -- policy internals ----------------------------------------------
    def _admit(self, req: Request, victims: Tuple[Request, ...] = (),
               from_pump: bool = False) -> Admitted:
        self.scheduler.enqueue(req)
        self._queued_tokens[req.tenant] = (
            self._queued_tokens.get(req.tenant, 0) + req.token_len)
        self._queued_total += req.token_len
        # pump admissions get their own counter so both stay monotonic
        # (the old dict did `admitted -= 1` here, breaking rate queries)
        self._verdicts.labels(
            verdict="pumped" if from_pump else "admitted").inc()
        return Admitted(req, shed_victims=victims)

    def _shed_new(self, req: Request, reason: str) -> Shed:
        req.shed = True
        req.done = True
        self._verdicts.labels(verdict="shed_new").inc()
        if self._on_shed is not None:
            self._on_shed(req)
        return Shed(req, reason=reason)

    def _shed_for(self, req: Request, bound: Optional[str]) -> Verdict:
        """shed-lowest-priority: displace queued session-tail requests
        whose effective priority is STRICTLY lower (numerically greater
        — lower drains first) than the incoming request's.  Candidates
        are preferred in `Scheduler.shed_preference_key` order: already-
        late requests first (their deadline is lost whether they run or
        not), then lowest effective priority, tightest deadline,
        youngest.  Victim selection is transactional: the set is chosen
        first and applied only if it frees enough room — otherwise
        NOTHING is shed except the newcomer.  A tenant-quota deficit can
        only be covered by the same tenant's work; the global bound
        sheds from anywhere.  Only current session tails are considered
        (one shed never cascades into a session's earlier program)."""
        new_eff = req.priority       # just arrived: no aging yet
        tq = self.quota(req.tenant).max_queued_tokens
        need_t = 0 if tq is None else max(
            0, self.queued_tokens(req.tenant) + req.token_len - tq)
        need_g = 0 if self.max_queued_tokens is None else max(
            0, self._queued_total + req.token_len - self.max_queued_tokens)
        if self.pressure is not None:
            # residual memory deficit (the ladder already did what it
            # could in submit_request) — shedding queued tokens frees
            # budget 1:1 from any tenant, so it folds into the global
            # pass
            need_g = max(need_g,
                         req.token_len - self.pressure.headroom())
        cands = [r for r in self.scheduler.session_tails(
                     self.scheduler.queued())
                 if self.scheduler.effective_priority(r) > new_eff
                 and r.sid != req.sid]   # never puncture the submitter's
                                         # own program to admit its tail
        now = self.scheduler.clock.now()
        cands.sort(key=lambda r: self.scheduler.shed_preference_key(r, now))
        decision = {
            "now": now,
            "incoming": {"sid": req.sid, "tenant": req.tenant,
                         "priority": req.priority,
                         "token_len": req.token_len,
                         "deadline": req.deadline},
            "need_t": need_t, "need_g": need_g,
            "candidates": [
                {"seq": r.seq, "sid": r.sid, "tenant": r.tenant,
                 "token_len": r.token_len, "deadline": r.deadline,
                 "eff": self.scheduler.effective_priority(r),
                 "late": self.scheduler.is_late(r, now)}
                for r in cands],
        }
        victims: List[Request] = []
        vset = set()
        freed_t = freed_g = 0
        for r in cands:                      # pass 1: tenant deficit
            if freed_t >= need_t:
                break
            if r.tenant == req.tenant:
                victims.append(r)
                vset.add(id(r))
                freed_t += r.token_len
                freed_g += r.token_len
        for r in cands:                      # pass 2: global deficit
            if freed_g >= need_g:
                break
            if id(r) not in vset:
                victims.append(r)
                vset.add(id(r))
                freed_g += r.token_len
        decision["victims"] = [v.seq for v in victims]
        decision["ok"] = not (freed_t < need_t or freed_g < need_g)
        self.shed_decisions.append(decision)
        if freed_t < need_t or freed_g < need_g:
            return self._shed_new(
                req, f"over {bound}; no strictly-lower-priority victims "
                     "free enough room")
        self._remove_from_queue(victims)
        for v in victims:
            v.shed = True
            v.done = True
            self._verdicts.labels(verdict="shed_victim").inc()
            if self._on_shed is not None:
                self._on_shed(v)
        return self._admit(req, tuple(victims))

    # -- queue bookkeeping (engine callbacks) --------------------------
    def _debit(self, reqs) -> None:
        """Tokens left the scheduler queue (popped / dropped / shed)."""
        for r in reqs:
            self._queued_tokens[r.tenant] = (
                self._queued_tokens.get(r.tenant, 0) - r.token_len)
            self._queued_total -= r.token_len

    def _remove_from_queue(self, reqs) -> None:
        self.scheduler.drop(reqs)
        self._debit(reqs)

    def note_popped(self, reqs) -> None:
        """The engine popped these requests into a batch — their tokens
        left the queue (the scheduler already removed them)."""
        self._debit(reqs)

    def cancel(self, sid: str) -> List[Request]:
        """Drop a closed session's work everywhere: backlog entries and
        queued requests (accounting adjusted); returns all dropped."""
        held = [r for r in self._backlog if r.sid == sid]
        self._backlog = [r for r in self._backlog if r.sid != sid]
        for r in held:
            r.cancelled = True
            r.done = True
        # debit BEFORE scheduler.cancel drops them from the queue
        self._debit(self.scheduler.queued(sid=sid))
        return held + self.scheduler.cancel(sid)

    def pump(self) -> List[Request]:
        """Drain the backlog into the queue while capacity allows: FIFO
        per tenant (an entry never overtakes an earlier entry of its own
        tenant — program order per session is preserved a fortiori),
        cross-tenant overtaking allowed.  Returns the requests admitted
        by this pump."""
        admitted: List[Request] = []
        blocked_tenants = set()
        remaining: List[Request] = []
        for r in self._backlog:
            if r.tenant in blocked_tenants:
                remaining.append(r)
                continue
            room, _ = self._headroom(r.tenant)
            if room is None or r.token_len <= room:
                self._admit(r, from_pump=True)
                admitted.append(r)
            else:
                blocked_tenants.add(r.tenant)
                remaining.append(r)
        self._backlog = remaining
        return admitted
