"""(architecture x input-shape) cells and the serving buckets (port of
``repro/launch/specs.py``).

A cell is one step of one registry architecture at one production shape,
with its argument tree on the ``meta`` device: shapes and dtypes, no
data (the port's ``ShapeDtypeStruct``; ``init_lm(device="meta")`` builds
a 400B tree without allocating it).  The dry run (`launch.dryrun`) runs
the step on that tree and counts what a device holds, computes and
moves; ``chip_smoke.py`` phase 18 materialises the same trees on the card
and runs them.

Shape semantics (the reference's):
  train_4k    seq 4,096  batch 256 -- CCM parallel train_step
  prefill_32k seq 32,768 batch 32  -- serve prefill (I(t) over Mem)
  decode_32k  seq 32,768 batch 128 -- one-token decode, KV cache = seq
  long_500k   seq 524,288 batch 1  -- long-context decode:
      dense/moe/vlm/encdec -> the CCM streaming step (bounded window +
      compressed memory; the dense 500k-KV decode is skipped, as in the
      reference);
      ssm    -> the native O(1) state decode;
      hybrid -> O(1) SSM states + CCM-bounded attention sites.

HOST COUNTERS.  The reference's counters are traced scalars, so its
compiled step takes any value.  The port's are host ints
(``KVCache.length``, ``MemState.slots/steps/stream_pos``, ``pos``), so a
cell picks them, at the step's costliest, and its ``note`` says which:
a decode sees a cache full after this token's write and a full memory,
a long step evicts (its window full, its memory full), a prefill starts
from the counters at 0, as the reference's init gives them.

With ``dist`` (a ``DistContext``; a shape-only mesh in the dry run,
`launch.mesh.make_shape_mesh`), ``fn`` is the step every rank runs (the
train step's `PlacedStep`, the serve builders' `ShardedStep`) and
``args`` hold this rank's shards of the weights, moments and state, with
the global batch or tokens, which the step cuts to the rank's rows;
``local_args`` is what the rank holds of them (the rows cut).  Under
ZeRO-3 (``sharding_strategy="fsdp"``, `distributed.fsdp`) the weights
and moments are the rank's ``param_spec`` blocks, and the train cell
lays its batch over every mesh axis, as the reference's does; the
serve cells keep the states' specs.

The serving buckets (``SERVE_*_BUCKETS`` and the helpers below them) are
the serve engine's, copied as they are (pure Python).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import inference as I
from repro_torch.core import masks as M
from repro_torch.core import streaming as STR
from repro_torch.distributed.context import DistContext
from repro_torch.launch import serve as S
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import partition as PT
from repro_torch.optim.adamw import AdamWConfig, init_adamw

I32 = torch.int32
F32 = torch.float32
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    kind: str
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode", 32768, 128),
    "long_500k": ShapeSpec("long", 524288, 1),
}

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



def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the shape and dtype of an argument, no data."""
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# training layout per (arch, seq)
# ---------------------------------------------------------------------------

def train_layout(cfg: ModelConfig, seq: int) -> M.SegmentLayout:
    t, m = cfg.ccm.max_steps, cfg.ccm.comp_len
    tail = max(128, seq // 16)
    chunk = (seq - tail) // t - m
    assert chunk >= 2, (cfg.name, seq)
    tail = seq - t * (chunk + m)
    return M.segment_layout(t, chunk, m, tail)


def _scaled_shape(spec: ShapeSpec, smoke: bool) -> ShapeSpec:
    if not smoke:
        return spec
    return ShapeSpec(spec.kind, 512, 4 if spec.kind == "train" else 2)


# ---------------------------------------------------------------------------
# batch / state / params trees on the meta device
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, layout: M.SegmentLayout,
                      batch: int, enc_len: int = 0) -> Dict[str, torch.Tensor]:
    out = {"tokens": sds((batch, layout.seq_len), I32),
           "loss_mask": sds((batch, layout.tail_len - 1), F32)}
    if cfg.family == "encdec":
        out["frames"] = sds((batch, enc_len, cfg.d_model), F32)
    if cfg.family == "vlm":
        out["patches"] = sds((batch, cfg.n_frontend_tokens, 1024), F32)
    return out


def state_specs(cfg: ModelConfig, batch: int, cache_len: int,
                enc_len: int = 0) -> I.OnlineState:
    """``init_online_state`` on the meta device (its counters at 0), with
    the encoder-decoder's cross K/V at ``enc_len`` frames."""
    st = I.init_online_state(cfg, batch, cache_len, device=META)
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
        st = st._replace(cross=(sds(shape, cfg.cdtype),
                                sds(shape, cfg.cdtype)))
    return st


def stream_state_specs(cfg: ModelConfig, batch: int) -> STR.StreamState:
    return STR.init_stream_state(cfg, batch, device=META)


def params_specs(cfg: ModelConfig):
    return T.init_lm(cfg, 0, device=META)


def _full_memory(cfg: ModelConfig, mem):
    """``mem`` with every slot filled (``slots`` = ``steps`` = its groups)."""
    if mem is None:
        return None
    g = mem.max_slots(cfg.ccm.comp_len)
    return mem._replace(slots=g, steps=g)


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable            # the step: fn(*args)
    args: Tuple             # meta tensors (and host counters, None)
    note: str = ""
    # what this rank holds of ``args`` (the batch or tokens cut to its
    # rows); ``args`` itself without a mesh
    local_args: Optional[Tuple] = None

    def __post_init__(self):
        if self.local_args is None:
            self.local_args = self.args


def _enc_split(cfg: ModelConfig, seq: int) -> Tuple[int, int]:
    """(the decoder's tokens, the encoder's frames): the encoder-decoder
    splits a shape's sequence in half between them."""
    if cfg.family == "encdec":
        return seq // 2, seq // 2
    return seq, 0


def build_train_cell(cfg: ModelConfig, spec: ShapeSpec,
                     dist: Optional[DistContext]) -> Cell:
    seq, enc_len = _enc_split(cfg, spec.seq)
    if seq >= 2048:
        cfg = cfg.replace(attn_impl="chunked")
    layout = train_layout(cfg, seq)
    pshapes = params_specs(cfg)
    trainable = TR.trainable_mask_for(cfg, pshapes)
    tp_s, fp_s = PT.partition(pshapes, trainable)
    opt_s = init_adamw(tp_s)
    batch_s = train_batch_specs(cfg, layout, spec.batch, enc_len)
    step = TR.make_train_step(cfg, layout, AdamWConfig(), dist)
    note = f"mode={cfg.train_mode}"
    if dist is None:
        return Cell(f"{cfg.name}:train", step, (tp_s, fp_s, opt_s, batch_s,
                                                None), note)
    fn = TR.jit_train_step(step, cfg, dist, pshapes, opt_s, batch_s,
                           trainable)
    tp_s, fp_s, opt_s = fn.place(tp_s, fp_s, opt_s)
    return Cell(f"{cfg.name}:train", fn, (tp_s, fp_s, opt_s, batch_s, None),
                note, (tp_s, fp_s, opt_s,
                       TR.local_rows(batch_s, dist, TR.row_axes(cfg, dist)),
                       None))


def _serve_cell(name: str, fn, cfg: ModelConfig, dist, params, state,
                tokens, extra=(), note: str = "") -> Cell:
    """A serve step's cell: with a mesh, ``fn`` is a `ShardedStep` and
    the params and state are this rank's shards."""
    if dist is None:
        return Cell(name, fn, (params, state, tokens) + extra, note)
    params, state = fn.place(params, state)
    return Cell(name, fn, (params, state, tokens) + extra, note,
                (params, state) + fn.rows(tokens, *extra))


def build_prefill_cell(cfg: ModelConfig, spec: ShapeSpec,
                       dist: Optional[DistContext]) -> Cell:
    seq, enc_len = _enc_split(cfg, spec.seq)
    B = spec.batch
    cfg = cfg.replace(attn_impl="chunked") if seq > 4096 else cfg
    st = state_specs(cfg, B, cache_len=seq, enc_len=enc_len)
    extra = (sds((B, cfg.n_frontend_tokens, 1024), F32),) \
        if cfg.family == "vlm" else ()
    fn = S.make_prefill_step(cfg, dist, batch_sharded=True)
    return _serve_cell(f"{cfg.name}:prefill", fn, cfg, dist,
                       params_specs(cfg), st, sds((B, seq), I32), extra,
                       "counters at 0 (the reference's init)")


def build_decode_cell(cfg: ModelConfig, spec: ShapeSpec,
                      dist: Optional[DistContext],
                      cache_len: Optional[int] = None) -> Cell:
    B = spec.batch
    enc_len = 1024 if cfg.family == "encdec" else 0
    clen = cache_len if cache_len is not None else \
        (cfg.serve_cache_len or spec.seq)
    st = state_specs(cfg, B, cache_len=clen, enc_len=enc_len)
    # decode with a FULL cache: clen - 1 rows, and this token's write
    if st.cache is not None:
        st = st._replace(cache=st.cache._replace(length=clen - 1),
                         mem=_full_memory(cfg, st.mem), pos=clen - 1)
    note = (f"cache {clen - 1} of {clen} rows before the token's write, "
            "every memory slot filled" if st.cache is not None else
            "no cache")
    # the batch split over the data axes where every rank gets a row
    rows = {} if dist is None else dict(batch_sharded=B >= dist.n_data)
    fn = S.make_decode_step(cfg, dist, **rows)
    return _serve_cell(f"{cfg.name}:decode", fn, cfg, dist,
                       params_specs(cfg), st, sds((B, 1), I32), note=note)


def build_long_cell(cfg: ModelConfig, spec: ShapeSpec,
                    dist: Optional[DistContext]) -> Cell:
    B = spec.batch
    if cfg.family == "ssm":
        # native O(1) decode; 500k context lives in the SSD state
        return dataclasses.replace(
            build_decode_cell(cfg, dataclasses.replace(spec, seq=8), dist),
            name=f"{cfg.name}:long",
            note="native SSM decode: O(1) state, no KV cache")
    if cfg.family == "hybrid":
        cell = build_decode_cell(cfg, spec, dist,
                                 cache_len=cfg.ccm.stream_window)
        return dataclasses.replace(
            cell, name=f"{cfg.name}:long",
            note="SSM states O(1); attention sites CCM-bounded "
                 f"(window {cfg.ccm.stream_window}); {cell.note}")
    # attention archs: CCM streaming (paper Fig. 9): bounded window + mem
    c = cfg.ccm
    st = stream_state_specs(cfg, B)
    st = st._replace(win_len=c.stream_window, mem=_full_memory(cfg, st.mem),
                     pos=spec.seq)
    note = ("CCM streaming: the dense 500k-KV decode skipped, as in the "
            f"reference; window {c.stream_window} + {c.stream_mem_slots} "
            f"mem slots; the window full (this step evicts), the memory "
            f"full, pos {spec.seq}")
    fn = S.make_stream_step(cfg, dist, batch_sharded=False)
    return _serve_cell(f"{cfg.name}:long", fn, cfg, dist, params_specs(cfg),
                       st, sds((B, 1), I32), note=note)


def build_cell(cfg: ModelConfig, shape_name: str,
               dist: Optional[DistContext], smoke: bool = False) -> Cell:
    spec = _scaled_shape(SHAPES[shape_name], smoke)
    if spec.kind == "train":
        cell = build_train_cell(cfg, spec, dist)
    elif spec.kind == "prefill":
        cell = build_prefill_cell(cfg, spec, dist)
    elif spec.kind == "decode":
        cell = build_decode_cell(cfg, spec, dist)
    else:
        cell = build_long_cell(cfg, spec, dist)
    cell.name = f"{cfg.name}:{shape_name}"
    return cell
