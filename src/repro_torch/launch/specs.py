"""Serving bucket helpers (port of ``repro/launch/specs.py``, the serve
engine's batch and token buckets only, copied: pure Python).

The reference module's dry-run cell builders (shape specs and sharded
step programs per architecture) are ROADMAP queue 1 item 4b-ii (part 2
of tensor parallelism) and are not ported yet.
"""
from __future__ import annotations

# Serve-engine batch-size buckets: a short continuous-batching batch is
# padded up to the next bucket so only these batch dims ever compile.
SERVE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# Serve-engine token-length buckets: a request shorter than its batch
# head's bucket is padded up to it (pad tokens masked out of attention,
# state writes frozen — see core.inference valid_len), so mixed-length
# traffic shares batches and only these token dims ever compile.
SERVE_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def batch_bucket(n: int, buckets=SERVE_BATCH_BUCKETS) -> int:
    """Smallest bucket >= n (largest bucket if n exceeds them all)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def token_bucket(n: int, buckets=SERVE_TOKEN_BUCKETS) -> int:
    """Smallest token bucket >= n; ``n`` itself beyond the largest bucket
    (a too-long request runs at its exact length rather than truncating)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return n


def pad_waste(lengths, buckets) -> int:
    """Total pad tokens a ladder spends on a trace of request lengths:
    ``sum(token_bucket(l) - l)``.  Adding buckets to a ladder can only
    shrink this (every length maps to a bucket at least as tight), which
    is what makes `derive_token_buckets`'s no-regression clamp sound."""
    return sum(token_bucket(n, buckets) - n for n in lengths)


def derive_token_buckets(lengths, *, max_buckets: int = 8,
                         compile_cost_tokens: float = 128.0,
                         compiled_lens=(),
                         baseline=SERVE_TOKEN_BUCKETS):
    """Fit a token-bucket ladder to OBSERVED request lengths by exact
    dynamic programming over a pad-waste-vs-compile-churn cost model:

        cost(ladder) = pad_waste(lengths, ladder)
                     + compile_cost_tokens * #{new shapes in ladder}

    ``compile_cost_tokens`` prices one extra compiled program in pad-
    token units (calibrate it from the serve engine's
    ``serve_compiled_programs_total`` / ``serve_pad_tokens_total``
    counters: how many pad tokens one compile is worth amortizing).
    ``compiled_lens`` are padded lengths the engine has ALREADY compiled
    (`ServeEngine.compile_stats`) — a bucket placed on one of those
    costs no churn, so refits gravitate to warm shapes.

    Every optimal ladder puts buckets only at observed lengths (moving a
    bucket down to the largest length it serves never increases pad),
    so the DP is exact in O(U^2 * max_buckets) over U = distinct
    lengths.  The result is clamped to never regress on the very trace
    it was fit to: if the fitted ladder pads worse than ``baseline``
    (possible when churn pricing buys fewer buckets), the baseline's
    hit buckets are unioned in — a strict pad improvement by the
    monotonicity fact above.  Deterministic for a fixed history; with
    an empty history the baseline is returned unchanged."""
    if max_buckets < 1:
        raise ValueError("max_buckets must be >= 1")
    if compile_cost_tokens < 0:
        raise ValueError("compile_cost_tokens must be >= 0")
    lengths = [int(n) for n in lengths]
    if any(n < 1 for n in lengths):
        raise ValueError("request lengths must be >= 1")
    if not lengths:
        return tuple(sorted(baseline))
    compiled = set(int(n) for n in compiled_lens)
    uniq = sorted(set(lengths))
    cnt = {u: 0 for u in uniq}
    for n in lengths:
        cnt[n] += 1
    U = len(uniq)
    K = min(max_buckets, U)
    # prefix sums: pad cost of serving uniq[i..j] from one bucket at
    # uniq[j] is uniq[j] * (count of i..j) - (token sum of i..j)
    pc = [0] * (U + 1)       # prefix counts
    ps = [0] * (U + 1)       # prefix token sums
    for i, u in enumerate(uniq):
        pc[i + 1] = pc[i] + cnt[u]
        ps[i + 1] = ps[i] + cnt[u] * u

    def seg(i, j):           # pad cost, bucket at uniq[j] serving i..j
        return uniq[j] * (pc[j + 1] - pc[i]) - (ps[j + 1] - ps[i])

    def churn(j):            # compile price of a bucket at uniq[j]
        return 0.0 if uniq[j] in compiled else compile_cost_tokens

    INF = float("inf")
    # best[k][j]: min cost covering uniq[0..j] with exactly k buckets,
    # the last at uniq[j] (a ladder must cover its largest length)
    best = [[INF] * U for _ in range(K + 1)]
    back = [[-1] * U for _ in range(K + 1)]
    for j in range(U):
        best[1][j] = seg(0, j) + churn(j)
    for k in range(2, K + 1):
        for j in range(k - 1, U):
            for i in range(k - 2, j):
                c = best[k - 1][i] + seg(i + 1, j) + churn(j)
                if c < best[k][j]:
                    best[k][j] = c
                    back[k][j] = i
    k_best = min(range(1, K + 1), key=lambda k: best[k][U - 1])
    ladder = []
    k, j = k_best, U - 1
    while j >= 0 and k >= 1:
        ladder.append(uniq[j])
        j = back[k][j]
        k -= 1
    ladder = tuple(sorted(ladder))
    if baseline and pad_waste(lengths, ladder) > pad_waste(lengths,
                                                          baseline):
        hit = set(token_bucket(n, baseline) for n in lengths)
        ladder = tuple(sorted(set(ladder) | hit))
    return ladder

