"""Continuous-batching scheduler for session requests.

Requests (``ingest`` / ``query`` / ``stream``) queue per session and are
drained as ``ScheduledBatch``es.  All requests in a batch share an op
kind and a *token bucket* (`launch.specs.SERVE_TOKEN_BUCKETS`): the batch
head's token length picks the bucket, and any eligible request whose
length fits is padded up to it (carrying its ``valid_len`` so the masked
session ops can freeze the pad lanes — see `core.inference`).  The batch
itself is padded up to a bucketed batch size
(`launch.specs.SERVE_BATCH_BUCKETS`, capped by the op kind's arena
capacity — the cap acts as one final bucket), so a handful of step
shapes covers any mixed-length arrival pattern — no shape churn as
traffic fluctuates.  ``token_buckets=None`` restores exact token-length
grouping (required for SSM/hybrid archs, whose recurrent scans cannot
mask pad tokens).

Admission is priority-with-aging: lower *effective* priority drains
first, where a request's effective priority decreases by one for every
``aging`` batches popped since it was submitted — a starved low-priority
session always drains eventually under sustained high-priority load.
Within one effective-priority class, requests carrying a *deadline*
drain earliest-deadline-first (EDF); deadline-less requests sort after
every deadline inside the class, and submission order breaks the
remaining ties.  The whole ordering lives in ONE function —
`Scheduler.effective_key` — so aging and EDF can never disagree about
who goes first (aging still rescues a starved request: one more aging
step drops it into a strictly better class, where it beats any deadline).
Two invariants keep batching safe:

  * program order per session — a request is only eligible once it is
    its session's earliest pending request (priority never reorders one
    session's own ops);
  * one request per session per batch — a session's state row is read
    once and written once per step, so a second op on the same session
    must wait for the next batch.

Port of ``repro/serve/scheduler.py``, copied: pure Python.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.launch.specs import (SERVE_BATCH_BUCKETS, SERVE_TOKEN_BUCKETS,
                                      batch_bucket, token_bucket)
from repro_torch.obs import MetricsRegistry, MonotonicClock

_KINDS = ("ingest", "query", "stream", "fork")


@dataclasses.dataclass
class Request:
    sid: str
    kind: str                      # 'ingest' | 'query' | 'stream' | 'fork'
    tokens: np.ndarray             # (1, token_len) int32
    priority: int = 0              # lower drains first
    tenant: str = "default"        # admission-quota group (serve.admission)
    deadline: Optional[float] = None  # absolute scheduler-clock seconds by
    #                                which the result should be delivered
    #                                (None = no SLO); EDF key within the
    #                                request's effective-priority class
    shard: int = 0                 # owning arena shard (set at submit from
    #                                the session's placement; the sharded
    #                                pop groups lanes by this)
    seq: int = -1                  # submission order (set at enqueue)
    round: int = 0                 # scheduler round at enqueue (aging clock)
    result: Any = None             # logits for query/stream; None for ingest
    done: bool = False
    cancelled: bool = False        # dropped by close_session, never ran
    shed: bool = False             # dropped by admission overflow, never ran
    fork_child: Optional[str] = None  # kind='fork' only: the child sid to
    #                                create when this request executes.
    #                                Fork requests queue on the PARENT sid
    #                                (zero tokens) so the snapshot point
    #                                respects the parent's program order

    @property
    def token_len(self) -> int:
        """The request's true (valid) token length — unchanged by any
        bucket padding applied at batch time."""
        return self.tokens.shape[-1]


@dataclasses.dataclass
class ScheduledBatch:
    kind: str
    token_len: int                 # padded (bucketed) token length
    bucket: int                    # padded batch size
    requests: List[Request]

    @property
    def pad(self) -> int:
        return self.bucket - len(self.requests)

    @property
    def valid_lens(self) -> List[int]:
        """Per-request valid token lengths (<= ``token_len``)."""
        return [r.token_len for r in self.requests]


@dataclasses.dataclass
class ShardedBatch:
    """One sharded pop: a same-kind, same-token-bucket, same-BATCH-bucket
    sub-batch PER arena shard (index = shard id).  Every sub-batch shares
    ``token_len`` and ``bucket`` so the stacked (n_shards, bucket, ...)
    lanes form one rectangular `shard_map` program; a shard with no
    eligible work contributes an empty sub-batch (all lanes padded with
    its scratch row)."""
    kind: str
    token_len: int                 # padded (bucketed) token length
    bucket: int                    # padded PER-SHARD batch size
    shards: List[ScheduledBatch]   # index s = shard s's sub-batch

    @property
    def requests(self) -> List[Request]:
        """All requests across shards, shard-major."""
        return [r for sb in self.shards for r in sb.requests]

    @property
    def n_requests(self) -> int:
        return sum(len(sb.requests) for sb in self.shards)


class Scheduler:
    def __init__(self, batch_buckets: Sequence[int] = SERVE_BATCH_BUCKETS,
                 max_batch=None,
                 token_buckets: Optional[Sequence[int]] = SERVE_TOKEN_BUCKETS,
                 max_token_len: Union[int, Dict[str, int], None] = None,
                 aging: Optional[int] = 32,
                 metrics: Optional[MetricsRegistry] = None,
                 edf: bool = True, clock=None):
        """``max_batch``: int cap for every op kind, or a dict
        ``{kind: cap}`` (a kind's batch must fit its arena).

        ``token_buckets``: padded token lengths for ragged batching; None
        disables padding (batches group by exact token length).
        ``max_token_len``: int or ``{kind: cap}`` upper bound on the
        padded length (e.g. a stream op must never pad past
        ``cfg.ccm.stream_chunk``); a request's own length is always
        allowed.  ``aging``: every ``aging`` popped batches a waiting
        request's effective priority improves by one (None/0 disables —
        pure FIFO-within-priority, which can starve).

        ``edf``: order deadline-carrying requests earliest-deadline-
        first WITHIN their effective-priority class (`effective_key`).
        With no deadlines submitted the ordering is identical either
        way, so the default is on.  ``clock`` is the time source for
        lateness checks (`is_late`) — the engine passes its
        observability clock so simulated traffic runs on logical
        time."""
        self.batch_buckets = tuple(sorted(batch_buckets))
        cap = self.batch_buckets[-1]
        if max_batch is None:
            max_batch = cap
        if isinstance(max_batch, int):
            max_batch = {k: max_batch for k in _KINDS}
        self.max_batch = {k: min(v, cap) for k, v in max_batch.items()}
        self.token_buckets = None if token_buckets is None \
            else tuple(sorted(token_buckets))
        if max_token_len is None:
            max_token_len = {}
        if isinstance(max_token_len, int):
            max_token_len = {k: max_token_len for k in _KINDS}
        self.max_token_len = dict(max_token_len)
        self.aging = int(aging) if aging else 0
        self.edf = bool(edf)
        self.clock = clock if clock is not None else MonotonicClock()
        self._queue: List[Request] = []
        self._held: set = set()
        self._seq = itertools.count()
        self._round = 0
        reg = metrics or MetricsRegistry()
        self._m_aged = reg.counter(
            "sched_aging_promotions_total",
            "requests popped into a batch with an aged (improved) "
            "effective priority — the anti-starvation mechanism firing")
        self._m_popped = reg.counter(
            "sched_batches_popped_total",
            "batches popped from the queue (the aging clock)")

    def make_request(self, sid: str, kind: str, tokens, priority: int = 0,
                     tenant: str = "default",
                     deadline: Optional[float] = None) -> Request:
        """Validate and wrap a submission WITHOUT queueing it — the
        admission controller holds backpressured requests outside the
        queue and enqueues them when capacity frees (``seq`` is assigned
        at enqueue time so drain order follows admission order).
        ``deadline`` is an absolute time on this scheduler's clock; it
        rides the request unchanged through every admission verdict."""
        if kind not in _KINDS:
            raise ValueError(f"unknown op kind {kind!r}")
        if deadline is not None and not math.isfinite(deadline):
            raise ValueError(f"deadline must be finite, got {deadline!r}")
        arr = np.asarray(tokens)
        if arr.ndim > 2 or (arr.ndim == 2 and arr.shape[0] != 1):
            # a (B, L) batch passed by mistake would silently become one
            # concatenated request
            raise ValueError(
                f"tokens must be one sequence (1-D or (1, L)); "
                f"got shape {arr.shape}")
        # copy: the queue holds tokens until run(); a no-copy view of a
        # caller buffer would alias later writes
        toks = np.array(arr, np.int32, copy=True).reshape(1, -1)
        return Request(sid=sid, kind=kind, tokens=toks, priority=priority,
                       tenant=tenant, deadline=deadline)

    def enqueue(self, req: Request) -> Request:
        """Admit a made request into the queue (stamps seq + aging round)."""
        req.seq = next(self._seq)
        req.round = self._round
        self._queue.append(req)
        return req

    def submit(self, sid: str, kind: str, tokens, priority: int = 0,
               tenant: str = "default",
               deadline: Optional[float] = None) -> Request:
        return self.enqueue(
            self.make_request(sid, kind, tokens, priority, tenant,
                              deadline=deadline))

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def round(self) -> int:
        """Logical aging clock: number of batches popped so far."""
        return self._round

    def aged_steps(self, req: Request, round_: Optional[int] = None) -> int:
        """How many aging promotions ``req`` has earned by ``round_``
        (default: the current round) — the ONE place the aging formula
        lives."""
        if not self.aging:
            return 0
        return ((self._round if round_ is None else round_)
                - req.round) // self.aging

    def effective_priority(self, req: Request) -> int:
        """Priority after aging: drops by one per ``aging`` rounds waited."""
        return req.priority - self.aged_steps(req)

    def effective_key(self, req: Request) -> Tuple[int, float, int]:
        """THE scheduler ordering — every drain, shed and fill decision
        sorts by this one key, so aging and EDF compose in exactly one
        place:

          (effective priority,   # aging-promoted class; strictly lower
                                 # beats ANY deadline in a higher class
           deadline,             # EDF within the class; no deadline
                                 # sorts after every deadline (+inf)
           seq)                  # submission order breaks ties

        With ``edf=False`` (or no deadline on the request) the middle
        component is +inf for everyone, which reproduces the pre-EDF
        ``(effective_priority, seq)`` ordering bit for bit.  Aging still
        rescues a starved deadline-less request: one more aging step
        drops its class below the deadline traffic's, and the first
        component dominates."""
        dl = req.deadline if (self.edf and req.deadline is not None) \
            else math.inf
        return (self.effective_priority(req), dl, req.seq)

    def is_late(self, req: Request, now: Optional[float] = None) -> bool:
        """Whether ``req``'s deadline has already passed (deadline-less
        requests are never late)."""
        if req.deadline is None:
            return False
        return (self.clock.now() if now is None else now) > req.deadline

    def shed_preference_key(self, req: Request,
                            now: Optional[float] = None
                            ) -> Tuple[int, int, float, int]:
        """Victim-preference ordering for shed/offload levers — sort
        ascending and take from the front.  Prefer, in order: requests
        that are ALREADY LATE (their SLO is lost whether we run them or
        not), then lower effective priority, then the tightest deadline
        (closest to becoming late — least salvageable; deadline-less
        last), then the youngest submission.  Without deadlines this
        degrades to exactly the old (lowest-effective-priority,
        youngest-first) victim order."""
        eff, dl, seq = self.effective_key(req)
        late = self.edf and self.is_late(req, now)
        return (0 if late else 1, -eff, dl, -seq)

    def queued(self, tenant: Optional[str] = None,
               sid: Optional[str] = None) -> List[Request]:
        """Queued requests, optionally filtered by tenant / session."""
        return [r for r in self._queue
                if (tenant is None or r.tenant == tenant)
                and (sid is None or r.sid == sid)]

    def drop(self, reqs: Sequence[Request]) -> None:
        """Remove specific queued requests (admission shed victims).  The
        caller flags the outcome on the requests; unknown entries are
        ignored."""
        ids = set(id(r) for r in reqs)
        self._queue = [r for r in self._queue if id(r) not in ids]

    def session_tails(self, reqs: Sequence[Request]) -> List[Request]:
        """Subset of ``reqs`` that are their session's LAST queued
        request.  Shedding only ever removes a session-program suffix —
        dropping a middle request would leave later ops of the same
        session running against a state that skipped one."""
        last_seq = {}
        for r in self._queue:
            if r.sid not in last_seq or r.seq > last_seq[r.sid]:
                last_seq[r.sid] = r.seq
        return [r for r in reqs if last_seq.get(r.sid) == r.seq]

    def cancel(self, sid: str) -> List[Request]:
        """Drop every queued request for a session (closed sessions must
        not reach a batch).  Dropped requests are flagged ``cancelled``
        (with ``done=True``) so waiters observe the outcome; returns
        them."""
        dropped = [r for r in self._queue if r.sid == sid]
        self._queue = [r for r in self._queue if r.sid != sid]
        for r in dropped:
            r.cancelled = True
            r.done = True
        return dropped

    def hold(self, sid: str) -> None:
        """Gate a session's queued requests out of eligibility until
        `release`.  The engine holds a fork CHILD from `fork_session`
        until the creating fork request executes: the child's program
        starts at the fork, so no priority/deadline reordering may run a
        child op before the session exists — the cross-session half of
        the program-order invariant."""
        self._held.add(sid)

    def release(self, sid: str) -> None:
        """Lift a `hold` (the fork executed, or was cancelled/shed and
        the child's queued requests were dropped by the engine)."""
        self._held.discard(sid)

    def _eligible(self) -> List[Request]:
        """Pending requests that are their session's earliest, ordered by
        `effective_key` (effective priority, deadline-EDF, submission).
        Held sessions (fork children awaiting creation) are skipped."""
        earliest = {}
        for r in self._queue:
            if r.sid in self._held:
                continue
            if r.sid not in earliest or r.seq < earliest[r.sid].seq:
                earliest[r.sid] = r
        return sorted(earliest.values(), key=self.effective_key)

    def _head_token_len(self, head: Request) -> int:
        """Padded token length for a batch led by ``head``: its token
        bucket, capped per kind — never below the head's own length."""
        if self.token_buckets is None:
            return head.token_len
        tlen = token_bucket(head.token_len, self.token_buckets)
        cap = self.max_token_len.get(head.kind)
        if cap is not None:
            tlen = min(tlen, cap)
        return max(tlen, head.token_len)

    def next_batch(self,
                   tenant_lane_caps: Optional[Dict[str,
                                                   Optional[int]]] = None,
                   default_lane_cap: Optional[int] = None
                   ) -> Optional[ScheduledBatch]:
        """Pop the next batch: head of the eligible order defines the op
        kind and token bucket; fill with any eligible request of that
        kind whose token length fits the bucket (padded lanes carry
        their ``valid_len``).

        ``tenant_lane_caps``: max lanes per tenant in this batch; a
        tenant missing from the dict falls back to
        ``default_lane_cap``, and an explicit ``None`` value means
        uncapped (an explicit quota overrides the default).  The serve
        engine passes each tenant's resident-slot quota so a single
        batch can never pin more of a tenant's sessions than its quota
        allows — the batch-formation half of the per-tenant residency
        invariant (`serve.admission`; eviction in `SessionManager` is
        the other half)."""
        elig = self._eligible()
        if not elig:
            return None
        round0 = self._round     # the round the eligible order was built
        self._round += 1         # under, BEFORE this pop advanced aging
        self._m_popped.inc()
        head = elig[0]
        tlen = self._head_token_len(head)
        cap = self.max_batch.get(head.kind, self.batch_buckets[-1])
        if self.token_buckets is None:
            fits = [r for r in elig
                    if r.kind == head.kind and r.token_len == tlen]
        else:
            fits = [r for r in elig
                    if r.kind == head.kind and r.token_len <= tlen]
        taken, lanes_of = [], {}
        for r in fits:
            if len(taken) >= cap:
                break
            if tenant_lane_caps is not None or default_lane_cap is not None:
                tcap = (tenant_lane_caps or {}).get(r.tenant,
                                                    default_lane_cap)
                if tcap is not None and lanes_of.get(r.tenant, 0) >= tcap:
                    continue
            taken.append(r)
            lanes_of[r.tenant] = lanes_of.get(r.tenant, 0) + 1
        if self.aging:
            self._m_aged.inc(sum(
                1 for r in taken if self.aged_steps(r, round0) > 0))
        taken_set = set(id(r) for r in taken)
        self._queue = [r for r in self._queue if id(r) not in taken_set]
        bucket = min(batch_bucket(len(taken), self.batch_buckets), cap)
        bucket = max(bucket, len(taken))
        return ScheduledBatch(kind=head.kind, token_len=tlen,
                              bucket=bucket, requests=taken)

    def next_sharded_batches(self, n_shards: int,
                             tenant_lane_caps: Optional[
                                 Dict[str, Optional[int]]] = None,
                             default_lane_cap: Optional[int] = None,
                             per_shard_cap: Union[int, Dict[str, int],
                                                  None] = None,
                             max_total: Union[int, Dict[str, int],
                                              None] = None
                             ) -> Optional["ShardedBatch"]:
        """Pop ONE batch per arena shard in a single scheduling decision
        (a `ShardedBatch`): the global eligible head defines the op kind
        and token bucket exactly as in `next_batch`, then each shard
        fills its own sub-batch from the eligible requests routed to it
        (``Request.shard``), all sharing one common batch bucket — the
        max over shards, so the stacked lanes are rectangular for the
        `shard_map` hot path.  Shards with no eligible work of the
        head's kind/bucket get empty sub-batches (all-pad lanes compute
        on their scratch row).

        Counts as ONE pop for the aging clock and the popped-batches
        counter: the sharded engine retires up to ``n_shards`` sub-
        batches per drain iteration, and aging measures drain progress,
        not device count.

        ``per_shard_cap`` bounds each shard's lane count and
        ``max_total`` the pop's TOTAL lane count — each an int or a
        per-kind dict (the engine passes the per-shard slot capacity
        and the arena's ``max_resident``, so a sharded pop never pins
        more sessions than one `activate_batch` call can hold).
        ``tenant_lane_caps`` apply across the WHOLE sharded pop, not
        per shard: the engine activates every sub-batch's sessions in
        one `activate_batch` call, so the pop as a whole must not pin
        more of a tenant's sessions than its quota allows (conservative
        — a tenant spread over shards still gets at most its quota in
        lanes per pop)."""
        def _resolve(v, kind):
            if isinstance(v, dict):
                return v.get(kind)
            return v

        elig = self._eligible()
        if not elig:
            return None
        round0 = self._round
        self._round += 1
        self._m_popped.inc()
        head = elig[0]
        tlen = self._head_token_len(head)
        cap = self.max_batch.get(head.kind, self.batch_buckets[-1])
        psc = _resolve(per_shard_cap, head.kind)
        if psc is not None:
            cap = min(cap, psc)
        total_cap = _resolve(max_total, head.kind)
        if self.token_buckets is None:
            fits = [r for r in elig
                    if r.kind == head.kind and r.token_len == tlen]
        else:
            fits = [r for r in elig
                    if r.kind == head.kind and r.token_len <= tlen]
        taken: List[List[Request]] = [[] for _ in range(n_shards)]
        lanes_of: Dict[str, int] = {}
        total = 0
        for r in fits:
            if total_cap is not None and total >= total_cap:
                break
            if not 0 <= r.shard < n_shards:
                raise ValueError(
                    f"request for session {r.sid!r} routed to shard "
                    f"{r.shard}, but the pop spans {n_shards} shards")
            if len(taken[r.shard]) >= cap:
                continue             # this shard is full; others may fit
            if tenant_lane_caps is not None or default_lane_cap is not None:
                tcap = (tenant_lane_caps or {}).get(r.tenant,
                                                    default_lane_cap)
                if tcap is not None and lanes_of.get(r.tenant, 0) >= tcap:
                    continue
            taken[r.shard].append(r)
            lanes_of[r.tenant] = lanes_of.get(r.tenant, 0) + 1
            total += 1
        if self.aging:
            self._m_aged.inc(sum(
                1 for g in taken for r in g
                if self.aged_steps(r, round0) > 0))
        taken_set = set(id(r) for g in taken for r in g)
        self._queue = [r for r in self._queue if id(r) not in taken_set]
        n_max = max(len(g) for g in taken)
        bucket = min(batch_bucket(n_max, self.batch_buckets), cap)
        bucket = max(bucket, n_max)
        return ShardedBatch(
            kind=head.kind, token_len=tlen, bucket=bucket,
            shards=[ScheduledBatch(kind=head.kind, token_len=tlen,
                                   bucket=bucket, requests=g)
                    for g in taken])
