"""Unified memory-pressure controller: recompress -> offload -> shed.

The paper's premise is inference "in a limited memory space", but the
serve stack's three memory levers used to act in isolation: compression
ratio was static config (`CCMConfig.comp_len`), the `OffloadCostModel`
ran on operator-guessed constants, and admission shed load without ever
trying to compress or offload first.  This module makes degradation a
LADDER walked strictly cheapest-first whenever the device-memory budget
runs short:

  1. recompress — collapse resident LRU sessions' compressed memory at
     a higher ratio (`core.memory.recompress_memory` through
     the `launch.serve.recompress_arena_slots` arena step).  Costs only
     reconstruction fidelity; the session stays resident and attendable.
  2. offload    — push idle resident LRU sessions' state to host via
     the (optionally calibrated) `OffloadCostModel` path
     (`SessionManager.offload_batch`).  Costs restore latency later.
  3. shed       — only once the first two levers are exhausted does the
     admission controller drop work (its existing overflow policies).

The BUDGET is logical, in token units — arena slabs are fixed-shape, so
recompression cannot free physical bytes; what it frees is *accounted*
memory, exactly like vLLM's block watermark: a session's footprint is
its live KV-cache tokens plus ``mem_groups * comp_len`` memory tokens,
and queued request tokens count as memory already promised.  Admission
enforces ``used + incoming <= capacity_tokens`` as one more bound
(`AdmissionController._headroom`); on a deficit it calls
:meth:`MemoryPressureController.relieve` BEFORE falling into its shed
policy, and the engine's drain hook (`maybe_relieve`) walks the same
ladder when utilization crosses the high watermark.

Every lever decision is appended to :attr:`decisions` (bounded ring)
and counted in the metrics registry
(``pressure_decisions_total{lever=...}``,
``pressure_tokens_freed_total{lever=...}``, used/utilization gauges) —
the property suite proves LADDER MONOTONICITY from that log: a ``shed``
entry may only appear with zero remaining recompress AND offload
candidates at decision time (tests/test_pressure_properties.py).

The controller is pure control plane over injected callables — no
engine import, no device access of its own — so the hypothesis suite
can drive it against fully synthetic session tables as well as the real
`ServeEngine` (which wires the callables in its constructor).

Port of ``repro/serve/pressure.py``, copied: pure Python.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional

from repro_torch.obs import Observability

LEVERS = ("recompress", "offload", "shed")


@dataclasses.dataclass(frozen=True)
class PressurePolicy:
    """Degradation-ladder configuration (all token counts are logical
    memory tokens — see module docstring).

    ``capacity_tokens``: the device-memory budget admission enforces.
    ``recompress_group``: ratio step per recompression — every ``group``
    consecutive filled <COMP> groups collapse into one.
    ``min_groups``: never recompress a session below this many filled
    groups (a quality guardrail: the last group standing is the whole
    conversation).
    ``enable_recompress`` / ``enable_offload``: lever switches — with
    both off the budget is still enforced but every deficit goes
    straight to shed (the controller-off benchmark arm).
    ``high_watermark`` / ``low_watermark``: the engine's drain hook
    relieves down to ``low * capacity`` once usage exceeds
    ``high * capacity`` (post-admission footprint growth — an admitted
    ingest materializes ``comp_len`` memory tokens its queue estimate
    did not include — is re-absorbed here).
    ``offload_late_sessions``: widen the offload lever to sessions whose
    pending work is ENTIRELY past its deadline (``unsalvageable_fn``) —
    their SLO is lost whether they stay resident or not, so they are
    preferred AHEAD of idle LRU victims.  Off by default: without
    deadlines the lever keeps its idle-sessions-only behavior."""
    capacity_tokens: int
    recompress_group: int = 2
    min_groups: int = 2
    enable_recompress: bool = True
    enable_offload: bool = True
    high_watermark: float = 0.9
    low_watermark: float = 0.75
    offload_late_sessions: bool = False

    def __post_init__(self):
        if self.capacity_tokens < 1:
            raise ValueError("capacity_tokens must be >= 1")
        if self.recompress_group < 2:
            raise ValueError("recompress_group must be >= 2 "
                             "(1 would free nothing)")
        if self.min_groups < 1:
            raise ValueError("min_groups must be >= 1")
        if not 0.0 < self.low_watermark <= self.high_watermark <= 1.0:
            raise ValueError(
                f"need 0 < low_watermark <= high_watermark <= 1, got "
                f"low={self.low_watermark} high={self.high_watermark}")


class MemoryPressureController:
    """Walks the recompress -> offload ladder against a token budget.

    Injected callables (the engine wires these; tests may pass plain
    lambdas over synthetic tables):

      sessions_fn()       -> iterable of session records with ``.sid``,
                             ``.resident``, ``.last_used``,
                             ``.mem_groups`` (`serve.session.Session`
                             satisfies this)
      footprint_fn(sid)   -> resident device-memory tokens of a session
                             (KV-cache tokens + mem_groups * comp_len)
      queued_tokens_fn()  -> tokens currently promised in the scheduler
                             queue (admission accounting)
      has_queued_fn(sid)  -> whether the session has pending work
                             anywhere (queue or backlog) — such sessions
                             are never offload victims: they would
                             restore on the very next batch
      recompress_fn(sid)  -> perform the device recompression, return
                             tokens freed (0 = nothing to shrink)
      offload_fn(sid)     -> perform the offload, return an
                             `OffloadResult`-like with ``.moved``
      unsalvageable_fn(sid) -> whether the session's pending work is
                             entirely past its deadline (optional; only
                             consulted when
                             ``policy.offload_late_sessions`` is on —
                             such sessions become PREFERRED offload
                             victims despite having queued work)
    """

    def __init__(self, policy: PressurePolicy, *,
                 sessions_fn: Callable[[], Iterable],
                 footprint_fn: Callable[[str], int],
                 queued_tokens_fn: Callable[[], int],
                 has_queued_fn: Callable[[str], bool],
                 recompress_fn: Callable[[str], int],
                 offload_fn: Callable[[str], object],
                 unsalvageable_fn: Optional[Callable[[str], bool]] = None,
                 obs: Optional[Observability] = None,
                 max_decisions: int = 4096):
        self.policy = policy
        self._sessions = sessions_fn
        self._footprint = footprint_fn
        self._queued_tokens = queued_tokens_fn
        self._has_queued = has_queued_fn
        self._recompress = recompress_fn
        self._offload = offload_fn
        self._unsalvageable = unsalvageable_fn or (lambda sid: False)
        self.obs = obs if obs is not None else Observability()
        # bounded decision ring: the property suite reads whole (small)
        # traces; a long-lived engine keeps only the recent window
        self.decisions: Deque[Dict] = deque(maxlen=max_decisions)
        self._seq = 0
        reg = self.obs.registry
        self._m_decisions = reg.counter(
            "pressure_decisions_total",
            "memory-pressure ladder decisions: recompress / offload "
            "lever firings, and shed handoffs (a deficit survived both "
            "levers and fell through to the admission shed policy)",
            labels=("lever",))
        self._m_freed = reg.counter(
            "pressure_tokens_freed_total",
            "logical memory tokens freed per lever", labels=("lever",))
        self._g_used = reg.gauge(
            "pressure_memory_used_tokens",
            "logical device-memory tokens in use: queued request tokens "
            "+ resident session footprints (KV cache + compressed "
            "memory)")
        self._g_util = reg.gauge(
            "pressure_memory_utilization",
            "pressure_memory_used_tokens / the policy's capacity_tokens")
        for lever in LEVERS:                 # explicit zeros in exports
            self._m_decisions.labels(lever=lever)
        for lever in ("recompress", "offload"):
            self._m_freed.labels(lever=lever)

    # -- accounting ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.policy.capacity_tokens

    def used_tokens(self) -> int:
        """Queued request tokens + every resident session's footprint."""
        used = self._queued_tokens()
        for sess in self._sessions():
            if sess.resident:
                used += self._footprint(sess.sid)
        return used

    def headroom(self) -> int:
        """Tokens left under the budget (negative = overshoot from
        post-admission footprint growth; the drain hook re-absorbs)."""
        return self.capacity - self.used_tokens()

    def utilization(self) -> float:
        return self.used_tokens() / self.capacity

    # -- candidate enumeration (LRU order) ------------------------------
    def _lru(self, sessions) -> List:
        return sorted(sessions, key=lambda s: s.last_used)

    def recompress_candidates(self) -> List:
        """Resident sessions whose memory would actually shrink, LRU
        first (empty when the lever is disabled)."""
        if not self.policy.enable_recompress:
            return []
        r = self.policy.recompress_group
        out = []
        for s in self._sessions():
            if not s.resident or s.mem_groups < self.policy.min_groups:
                continue
            if -(-s.mem_groups // r) < s.mem_groups:   # frees >= 1 group
                out.append(s)
        return self._lru(out)

    def offload_candidates(self) -> List:
        """Resident sessions with a nonzero footprint that are safe to
        offload: idle ones (queued work would restore on the next batch,
        so offloading them frees nothing durable) and — with
        ``policy.offload_late_sessions`` — sessions whose pending work
        is ENTIRELY past deadline.  The late ones are preferred first
        (their SLO is lost either way; an idle session may still serve a
        future request on time), then LRU within each group."""
        if not self.policy.enable_offload:
            return []
        late_ok = self.policy.offload_late_sessions
        out = []
        for s in self._sessions():
            if not s.resident or self._footprint(s.sid) <= 0:
                continue
            if not self._has_queued(s.sid):
                out.append((1, s))
            elif late_ok and self._unsalvageable(s.sid):
                out.append((0, s))
        out.sort(key=lambda g_s: (g_s[0], g_s[1].last_used))
        return [s for _, s in out]

    # -- the ladder -----------------------------------------------------
    def _decide(self, lever: str, **fields) -> None:
        self._seq += 1
        self.decisions.append({"seq": self._seq, "lever": lever, **fields})
        self._m_decisions.labels(lever=lever).inc()

    def relieve(self, deficit: int) -> int:
        """Free at least ``deficit`` logical tokens if the ladder's
        cheap levers can; returns tokens actually freed.  Strict order:
        every recompression candidate is consumed before the first
        offload, and a ``shed`` decision is logged ONLY when both
        candidate lists are empty and the deficit still stands — the
        monotonicity invariant the property suite checks."""
        freed = 0
        if deficit <= 0:
            return 0
        # candidates are re-enumerated per round: one recompression step
        # (group g -> ceil(g/r)) may leave the session shrinkable again,
        # and monotonicity demands EVERY such step fires before a shed
        while freed < deficit:
            cands = self.recompress_candidates()
            if not cands:
                break
            progress = False
            for sess in cands:
                if freed >= deficit:
                    break
                got = int(self._recompress(sess.sid))
                if got > 0:
                    progress = True
                    freed += got
                    self._m_freed.labels(lever="recompress").inc(got)
                    self._decide("recompress", sid=sess.sid, freed=got)
                    self.obs.recorder.note(
                        "pressure",
                        f"recompress sid={sess.sid} freed={got}")
            if not progress:     # callbacks refused: don't spin
                break
        if freed < deficit:
            for sess in self.offload_candidates():
                if freed >= deficit:
                    break
                tokens = self._footprint(sess.sid)
                # recorded BEFORE the offload runs: whether this victim
                # was taken despite queued work (only legal when the
                # late-sessions lever is on and the work is all late)
                late_work = self._has_queued(sess.sid)
                res = self._offload(sess.sid)
                if getattr(res, "moved", False):
                    freed += tokens
                    self._m_freed.labels(lever="offload").inc(tokens)
                    self._decide("offload", sid=sess.sid, freed=tokens,
                                 late_work=late_work)
                    self.obs.recorder.note(
                        "pressure",
                        f"offload sid={sess.sid} freed={tokens}")
        if freed < deficit:
            # both levers exhausted: whatever remains is the admission
            # policy's problem (shed / block / reject).  Candidate
            # counts are re-enumerated AT DECISION TIME so the log
            # itself witnesses "no cheaper lever was available".
            self._decide(
                "shed", deficit=deficit, freed=freed,
                unmet=deficit - freed,
                recompress_candidates=len(self.recompress_candidates()),
                offload_candidates=len(self.offload_candidates()))
            self.obs.recorder.note(
                "pressure", f"shed-handoff deficit={deficit} freed={freed}")
        self.sample_gauges()
        return freed

    def maybe_relieve(self) -> int:
        """Drain hook: once usage crosses the high watermark, relieve
        down to the low watermark (0 tokens freed otherwise)."""
        used = self.used_tokens()
        if used <= self.policy.high_watermark * self.capacity:
            self.sample_gauges()
            return 0
        target = int(self.policy.low_watermark * self.capacity)
        return self.relieve(used - target)

    def sample_gauges(self) -> None:
        used = self.used_tokens()
        self._g_used.set(used)
        self._g_util.set(used / self.capacity)
