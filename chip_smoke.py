#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --phase2   # the card, the build and phase 2 only
    python3 chip_smoke.py --phase12  # the card, the build and phase 12 only
    python3 chip_smoke.py --phase12 pixtral-12b   # ... for these archs
    python3 chip_smoke.py --phase13  # the card, the build and phase 13 only
    python3 chip_smoke.py --phase14  # the card, the build and phase 14 only
    python3 chip_smoke.py --phase15  # the card, the build and phase 15 only
    python3 chip_smoke.py --phase16  # the card, the build and phase 16 only
    python3 chip_smoke.py --phase17  # the card, the build and phase 17 only
    python3 chip_smoke.py --phase18  # the card, the build and phase 18 only
    python3 chip_smoke.py --phase19  # the card, the build and phase 19 only
    python3 chip_smoke.py --phase20  # the card, the build and phase 20 only

Phases (any failure raises, and the script exits non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the build of the
     hand-written kernels from ``src/repro_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (and, for segmented attention, GQA / int8 /
     layer- and lane-major / per-lane lengths / empty memory / a fully
     masked row, in float32 and bf16, and a split-K decode over lanes of
     {0, 1, capacity} keys run twice), with its time, the plain
     version's, one library call's and the least time the card could
     take (the bound): cond_lora at M = 288 / 576 / 4864, segmented
     attention at decode (bf16, int8, GQA 32/8), ingest, prefill and a
     lane-major serve query; the merge update as one launch for k and
     v (shared and per-lane weights, lane- and layer-major, a transposed
     or misaligned h, float32 and bf16 mixed, the one-element path)
     against the library pair (two ``lerp_``);
  3. the main path at the full width and depth of LLaMA-7B
     (``configs/llama_7b_paper.config()``, random bf16 weights from seed
     0): B=4 lanes, 4 ingests of 64-token contexts, a 448-token prefill
     into a 512-token cache and 32 greedy tokens, for concat + bf16 cache,
     concat + int8 cache and merge + bf16 cache, with the launches of
     every kernel counted;
  4. a cross-check of the whole path: 2 layers at full width in float32,
     once on CUDA with the kernels and once on the CPU with the plain
     versions;
  5. the training path at the full width and depth of LLaMA-7B: 3 concat
     and 2 merge AdamW steps through ``make_train_step`` (B=4, the
     segment layout of 16 steps of 64 + 8 <COMP> tokens and a 64-token
     tail, S=1216), with the launches of every kernel counted, every
     trainable leaf updated and every frozen leaf bitwise unchanged; a
     gradient-free ``train_forward``; a profiled step;
  6. a cross-check of training: 2 layers at full width in float32, loss,
     tail logits and gradients on CUDA against the CPU, and the parallel
     forward against t ingests + prefill on the card;
  7. the multi-tenant serve engine (``repro_torch.serve.ServeEngine``) at
     the full width and depth of LLaMA-7B (concat, bf16 cache, 8 slots
     of a 256-token cache, default buckets, prefix cache on): 12
     sessions over 3 tenants, 3 ragged contexts each, a fork, a
     prefix-cache hit, LRU offload and restore, one query per session,
     each held against the session run alone (B=1); a profiled drain;
     then two 4-layer engines at full width (merge + bf16 with per-lane
     merge weights and async offload; concat + int8 cache with a
     pressure recompression), the merge engine with one merge launch
     per ingest batch;
  8. CCM streaming (``repro_torch.core.streaming``): (a) LLaMA-7B at
     full width and depth, B=2, the default stream config (window 4096,
     sink 4, chunk 64, 64 memory groups): 72 chunks of 64 tokens and 16
     single tokens through ``stream_step`` (9 evictions), the window
     bound, the group count and finite logits checked every step, the
     second eviction step held to ``impl="concat"``, host ms per step
     kind, one profiled eviction step; (b) 4 layers at full width,
     window 512: concat through the memory-full branch, merge and the
     StreamingLLM baseline, 16 chunks each, then ``stream_step_lanes``
     over 4 staggered lanes held to each lane alone, the lanes with no
     eviction bit-equal; (c) 2 layers in float32, CUDA against the CPU
     across evictions and a full memory; (d) ``ServeEngine`` stream
     sessions (32 layers, window 512): 6 sessions on 4 stream slots, 12
     requests of 33-64 tokens each, every answer held to the session
     run alone;
  9. the dense model zoo of the port's registry (SmolLM-360M,
     Qwen2-0.5B, CodeQwen1.5-7B, Gemma-2B) at their published widths,
     random weights from seed 0 in each config's own ``param_dtype``,
     one model at a time: (a) phase 3's online path at full depth,
     concat and merge with a bf16 cache (and concat with an int8 cache
     for Gemma-2B), with a profiled decode and its float32 weight-cast
     share; (b) phase 4's cross-check; (d) phase 7's serve engine; (e)
     8b's streaming at 4 layers; (c) 2 AdamW steps with the config's own
     ``train_mode`` (full training for all but CodeQwen1.5-7B), every
     trainable leaf moved and every frozen one unchanged, with phase 6's
     cross-check for Qwen2-0.5B and Gemma-2B.  CodeQwen1.5-7B trains and
     serves at 4 layers;
 10. (run between phases 8 and 9, on the LLaMA-7B weights phases 3-8
     hold) the paper's §4.1 baselines and the rest of the dense family's
     single-device surface: (a) 2 AdamW steps of Gisting-online and 2 of
     the Compressive Transformer at LLaMA-7B's full width and depth (B=4,
     S=1216, LoRA-only; compressive's LoRA gradients are exactly 0, as
     in the reference), each with a profiled step; (b) phase 6's
     cross-check of 2 float32 layers for both (compressive in full
     training); (c) the gradient codecs (int8, top-k, 3 error-feedback
     rounds) on the card against the CPU on a gradient tree shaped as
     LLaMA-7B's LoRA leaves; (d) ``scripts/serve_metrics_torch.py``'s
     demo engine on the card against the CPU;
 11. (run after phase 9) the recurrent families of the port's registry,
     mamba2-370m (48 Mamba2 layers, no CCM) and zamba2-1.2b (38 Mamba2
     layers and 6 shared-attention sites, MHA 32/32 hd 64, CCM at the
     sites) at their published widths and full depth, random float32
     weights from seed 0, one model at a time: (a) B=4, 4 ingests, a
     256-token prefill and 32 greedy tokens (zamba2 in concat and merge),
     launches held to the path, a profiled decode; (b) float32 CUDA vs CPU
     cross-check of the online path and ``train_forward`` with gradients
     at a depth cut (zamba2: 2 groups of 4 and a remainder of 1); (d) the
     serve engine, 12 sessions on 8 slots with a fork and offload/restore,
     at full depth: in float32, every answer held to its session run
     alone in float64 on the CPU; in bf16, the witness of the bf16 batch
     gap (batched and alone both against float32, and batched against 8
     copies of the session in one batch); (c)
     2-3 full-training AdamW steps (zamba2: 2 concat and 1 merge), every
     leaf moved; (e) the SSD scan alone beside its bound;
 12. (run after phase 11) the last three families of the port's
     registry at their published widths, random weights from seed 0 in
     each config's ``param_dtype``, one model at a time: whisper-tiny (4
     + 4 layers, 1500 random frames, 448-token prefills), pixtral-12b
     (12 of its 40 layers, bf16, 1024 random patch rows of width 1024),
     phi3.5-moe (4 of its 32 layers, bf16) and llama4-maverick (1 of 48
     layers, 128 experts top-1): (a) the online path (B4, 4 ingests of
     64, 32 greedy tokens; whisper's ``encode_cross`` at B4 through the
     CCM kernel with every key <COMP>, then concat and merge; pixtral's
     prefill of 1024 patch positions + 64 text tokens), launches held to
     the path, a profiled decode; (d) 2 layers (whisper 2 + 2) in
     float32, CUDA vs CPU, online state and full-training gradients
     within 1e-3 x max|.| (not llama4); (c) the serve engine, 12 sessions
     on 8 slots (text-only sessions, as the reference's engine; phi3.5
     with the engine's expert ids pinned in each session run alone); (e)
     streaming at 4 layers (MoE with the expert ids pinned in the run it
     is held to); (b) 2-3 AdamW steps with the config's ``train_mode``
     (whisper full, with its frames through the encoder; pixtral LoRA
     with patches, S 1216; phi3.5 LoRA); llama4 runs (a)
     only;
 13. (run after phase 7, on the weights it served) multi-device, part 1:
     (a) phase 7's traffic through a ``ServeEngine`` of 2 session shards
     (the loop over shards, 4 of the 8 slots each) at full width and
     depth: placement alternating over the shards, no session moved
     between them, every answer within ``bf16_tol_paths`` of the 1-shard
     engine's (phase 7's) beside each engine against the session alone,
     ms per batch and a profiled drain; (b) 2 float32 layers, 2 shards
     against 1: bit-equal where the card gives it, else within
     ``f32_lane_tol`` with a GEMM's rows at the two batch widths checked;
     (c) the session mesh of the visible cards (``make_session_mesh()``:
     one shard, its row block on its device) through
     ``make_sharded_arena_step``, bit-equal to phase 7's answers; (d) the
     data-parallel step in an NCCL world of one rank at phase 5's cell, 2
     AdamW steps with ``grad_codec`` none (concat and merge), int8 and
     top-k, bit-equal to ``dist=None`` and to ``compress_with_ef`` + the
     update, the error-feedback residual on the card, the codecs' and the
     all-reduce's times;
 14. (after 13) tensor parallelism, part 1 (the dense family): (a) an
     NCCL world of one rank on a (1, 1) mesh through every ``dist=``
     entry point, each bit-equal to ``dist=None``: ``jit_train_step``'s
     placed step at phase 5's cell (concat and merge), the three
     ``dist=`` serve builders and ``generate`` at phase 3's, the sharded
     stream step at 8b's; (b) one full-width block of LLaMA-7B at n = 2,
     4, 8 and of Gemma-2B at n = 2 (its "query" regime), the ranks of a
     ``tensor_parallel.LocalGroup`` in turn on the card (each on its
     shard, the partial sums added on the card): the training forward
     and the vocab-parallel loss, an ingest, a prefill and a decode step,
     concat and merge, against the unsharded block within ``bf16_tol``,
     with the kernels' launches at the shard shapes and the loop's time;
     (c) the segmented kernel's log-sum-exp route against its plain
     version and a 32768-key decode at LLaMA-7B's heads cut in 4 blocks,
     combined, against the kernel over the whole cache, and its plain
     version's and the library's flash attention's times with the lse;
 15. (after 12) tensor parallelism, part 2 (the MoE family): (a)
     phi3.5-moe's first 2 layers at full width under each ``moe_impl`` in
     an NCCL world of one rank through every ``dist=`` entry point, each
     bit-equal to ``dist=None``, then the split path itself at n = 1
     over the NCCL model-axis group (ragged_tp's reduce, ep's
     all-to-alls) and the sequence-sharded decode; (b) one full-width
     block of phi3.5-moe at n = 2 and 4 under each impl and of
     llama4-maverick under ep at n = 8, the ranks of a ``LocalGroup`` in
     turn, against the unsharded block within ``bf16_tol`` with the
     expert ids pinned (and ep's drops computed there), with the
     dropped assignments, the times and the peak memory;
 16. (after 15) tensor parallelism, part 3 (the recurrent,
     encoder-decoder and VLM families): (a) mamba2-370m (2 layers),
     zamba2-1.2b (one group of 6 Mamba2 layers and its shared site),
     whisper-tiny (4 + 4 layers) and pixtral-12b (2 layers) at full
     width in an NCCL world of one rank through every ``dist=`` entry
     point (the placed train step, ``encode_cross``, the builders with
     pixtral's patches, ``generate``, the stream step), each bit-equal
     to ``dist=None``, then the split path itself at n = 1 over the NCCL
     model-axis group and zamba2's sequence-sharded decode; (b) the
     ranks of a ``LocalGroup`` in turn at full width: one zamba2 site
     after one Mamba2 layer and one mamba2 layer with the split head at
     n = 2, 4, 8, whisper-tiny whole at n = 2 and 4, one pixtral-12b
     block with its patches at n = 2, 4, 8, against the unsharded run
     (float32 configs within ``f32_lane_tol``, pixtral within
     ``bf16_tol``), with a rank's share of the time and the peak memory;
 17. (after 14) the sequence-sharded prefill and ingest: (a) the
     mma.sync route's log-sum-exp against the plain version (LLaMA-7B's
     448-row prefill block, hd 64 and 256, an int8 cache under an ingest
     block, a lane that sees no key), the output bit-equal with and
     without it, its cost, and the library's flash attention with lse;
     (b) a 448-row prefill block and a 64 + 8-row ingest block over a
     32768-key cache cut in 4 blocks, each block's kernel with its lse
     combined over a ``LocalGroup`` of 4, against the whole-cache kernel;
     (c) the ``shard_cache_seq=True`` builders and ``generate(seq_shard=
     True)`` in an NCCL world of one rank, bit-equal to ``dist=None`` on
     LLaMA-7B's 32 layers, concat and merge; (d) 4 data ranks in turn
     over a 32768-token cache at full width (an ingest, a prefill whose
     block crosses a rank edge, one that clamps at the buffer's end, 8
     greedy tokens) against the whole cache within ``bf16_tol_paths``
     beside a witness, every unwritten cache row bit-equal; (e) the batch
     split too (``batch_sharded=True``): B4 over an 8192-token cache cut
     in 2 and in 4 data blocks, each rank B/n lanes of the tokens and the
     memory (an ingest, a prefill across a rank edge, 4 decode steps),
     bit-equal to the same ranks under ``batch_sharded=False`` and
     within ``bf16_tol_paths`` of the whole cache, or 2 x the other cut's
     distance where larger; 17b also
     times the plain version and the library's flash attention with the
     lse over the whole cache;
 18. (after 16) the cells of ``launch/specs.py`` and the dry run of
     ``launch/dryrun.py``: (a) every registry arch (LLaMA-7B on phase 3's
     weights at its 32 layers, and the ten of ``ASSIGNED``) x the four
     shapes, ``build_cell(..., smoke=True)`` (seq 512; batch 4 for train,
     2 otherwise; pixtral-12b's train and prefill at 1536 tokens, which
     hold its 1024 patch positions), ``dist=None``, at full width with
     phase 12's depth cuts and zamba2-1.2b at its 6 whole attention sites
     (36 of 38 layers), the cell's meta arguments made on the card from
     random weights of seed 0, then LLaMA-7B's train cell with the
     ``merge`` variant and its decode with ``int8kv``: host ms, finite
     outputs, launches; (b) each kind at LLaMA-7B's first 2 layers in
     float32, card against CPU within 1e-3 x max|.| (loss and every
     moment, logits and every state leaf); (c) each kind's ``dist`` cell
     on a (1, 1) mesh in an NCCL world of one, bit-equal to ``dist=None``;
     (d) each 18a cell's dry-run record on the meta device: its argument
     bytes equal to the card args' bytes, its peak bytes beside
     ``max_memory_allocated``, its FLOPs over the measured ms; (e) the dry
     run of LLaMA-7B's four shapes on the 16 x 16 shape-only mesh, the
     seconds per cell;
 19. (after 18) ZeRO-3 (``sharding_strategy="fsdp"``) on LLaMA-7B: (a)
     in an NCCL world of one on a (1, 1) mesh, the fsdp train step
     (concat, merge), ``TrainLoop`` for 2 steps, the three ``dist=``
     builders with ``generate`` and ``make_stream_step``, each bit-equal
     to ``dist=None``; (c) the dry run's four fsdp cells on the meta
     device against the same cells on the card (argument bytes equal,
     the peak beside ``max_memory_allocated``); (b) 14b's full-width
     block at n = 2, 4, 8: the ranks' ZeRO-3 blocks gathered and cut per
     layer, bit-equal to the tensor-parallel loop, with one layer's
     gather time, and the ZeRO-3 training forward, each rank on its own
     rows of a B8 batch, within ``bf16_tol`` of the unsharded loss; (d)
     ``moe_impl="ep"`` under ZeRO-3 on phi3.5-moe: 19a's entry points in
     an NCCL world of one (4 of 32 layers) bit-equal to ``dist=None``,
     and one full-width block at n = 2, 4: the ZeRO-3 training forward
     and backward on B8 (each rank its rows, the ids of the data block
     gathered) within ``bf16_tol`` of the unsharded block under ep's
     drops, its drops equal to the tensor-parallel ep loop's, serving
     bit-equal to that loop; a rank's ms beside the TP ep rank's and the
     ids gather's;
 20. the paper's learn-and-answer loop (``launch/paper_loop.py``) and the
     example CLIs: (a) ``tests/test_system.py``'s recipe on the card
     (``bench_cfg()`` in float32: ``pretrain_base`` 800 steps, then
     ``train_compression`` 800) and its four claims at its thresholds:
     accuracy at t = 4 from memory above the base's with no context by
     0.08; over the whole key space (eval seeds 99-103) acc(t=4) >=
     acc(t=1) + 0.02; 4 ingests and a prefill within 5e-3 of
     ``train_forward``'s last-row logits; the memory at t*m KV tokens
     with an empty cache; the ms per training step; (b) LLaMA-7B (phase
     3's weights, 32 layers, bf16): ``train_compression`` for 4 steps at
     B32 x S264 (comp_len 8, 16 steps; no ``pretrain_base``: a full
     fine-tune's moments do not fit one card), then ``eval_at_timesteps``
     and ``eval_no_context``: a finite loss, every adapter leaf moved,
     accuracies in [0, 1], ms per step and peak GiB; (c) the five
     ``examples/*_torch.py`` CLIs at 20 training steps, each returning 0;
then one ``{"kernels": [...]}`` line (with each tensor-core route's
launches in phases 3, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
19 and 20 (phase 20's float32-route launches beside them),
the mma.sync route's launches with the lse in phase 17, and
the CCM kernel's phase-12 launches by whisper's encoder, read from the
counters around each of its launches), then the result line.  Phase 2 also
holds the training kernels (CCM flash attention forward and backward on
its float32 and bf16 routes, the bf16 cases with per-lane (B, S)
metadata, a layout with no <COMP> key and hd 72, the backward run twice
and bit-equal; kv_cummean forward and reverse as one launch for the
k + v groups of a layer, read in place from strided <COMP> groups and
sliced gradients, timed as the median of three profiler windows;
cond_lora's autograd, dW included) and the arena's session
gather/scatter against their plain versions, and times the zoo's
shapes: segmented attention at 15/5, 14/2 (hd 64) and 8/1 (hd 256),
cond_lora at the zoo's projections, CCM attention at 8/1 hd 256 and
14/2 hd 64, the merge update at Gemma-2B's memory; and zamba2-1.2b's
as phase 11 runs them: segmented attention at 32/32 hd 64 (decode, a
256-token prefill, a 64-token ingest, the lane-major serve query),
cond_lora at M 256 and 512, K 2048 N 2048, the merge update at its
memory (6, 4, 8, 32, 64) layer-major and lane-major, CCM attention and
the kv_cummean pair at its S 1152 layout; and phase 12's: CCM attention
forward and backward in whisper's encoder regime (B4, 6/6 hd 64, 1500
frames, every key <COMP> at index 0; library: SDPA with no mask),
cond_lora at pixtral's q, k/v and o projections (M 288), segmented
attention decode and prefill at 32/8 and 40/8 hd 128, decode at 6/6 hd
64; and tensor parallelism's shard shapes: a LLaMA-7B rank's at n = 2,
4, 8 (phase 14), phi3.5-moe's 8/2 heads at n = 4 and llama4-maverick's
5/1 at n = 8, its column q K 5120 N 640 (phase 15), and phase 16's:
segmented attention at zamba2-1.2b's 16/16 and 8/8 hd 64, pixtral-12b's
4/1 hd 128 and whisper-tiny's 3/3 hd 64, CCM attention in whisper's
encoder regime at 3/3, at zamba2's 16/16 and 8/8 and pixtral's 4/1; and
phase 20's: the paper loop's bench_cfg in float32 on the CUDA-core
routes (GQA 4/2 hd 32: segmented attention at its ingest, prefill,
decode and serve query; CCM attention forward and backward at B32 x S
48; cond_lora at M 1536, K 128 to N 128 and 64) and LLaMA-7B's adapter
step in bf16 (CCM attention at B32 x S 264, cond_lora at M 8448), and
the bf16 CCM route's plan cache over the loop's layouts (t = 16, 1, 4,
16, 1 at LLaMA-7B's heads, each held built and served from the cache).
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES = 3.35e12            # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12              # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12                # H100 SXM float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations
    / peak rate for the inputs' type."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, iters: int = 40, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events.  Where the host takes longer to issue a call
    than the device takes to run it, this is the host's issue rate."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


EVENT_TIMED = []     # the device_ms calls that fell back to CUDA events


def device_ms(torch, fn, iters: int = 20, only: str = None,
              windows: int = 6) -> float:
    """Mean DEVICE time per call of ``fn``: the summed durations of the
    device events that ``torch.profiler`` records over ``iters`` calls
    after a warm-up (with ``only``, just the kernels whose name contains
    it).  Host launch overhead is excluded.  A window in which the
    profiler delivered no device event at all is measured again after a
    pause (up to ``windows`` windows); it never stands in for a time.
    Where every window came back empty, the time is that of ``iters``
    back-to-back calls between two CUDA events (``time_ms``: every kernel
    of ``fn``, and the host's issue time where that is longer), an upper
    bound of the device time; the log line and ``EVENT_TIMED`` say so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    for w in range(windows):
        if w:
            time.sleep(0.1 * w)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        evs = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and (only is None or only in e.name())]
        if evs:
            return sum(e.duration_ns() for e in evs) / 1e6 / iters
        log("  (the profiler delivered no device events; measuring again)")
    ms = time_ms(torch, fn, iters)
    EVENT_TIMED.append(only or "a whole call")
    log(f"  (the profiler delivered no device events in {windows} windows: "
        f"{ms:.4f} ms per call of {only or 'a whole call'} timed with CUDA "
        f"events instead, host issue included)")
    return ms


def timings(torch, kernel, kernel_name: str, plain, library, iters: int = 20):
    """Device ms per call of the kernel (its own kernel only), its plain
    version and the library call, plus the kernel wrapper's event-timed
    ms per back-to-back call (which includes host launch overhead)."""
    return dict(ms=device_ms(torch, kernel, iters, only=kernel_name),
                call_ms=time_ms(torch, kernel, iters),
                plain_ms=device_ms(torch, plain, max(iters // 2, 5)),
                library_ms=device_ms(torch, library, iters))


def report(label: str, t, bms: float, by: str, card: str):
    log(f"  {label}: kernel {t['ms']:.4f} ms (device; {t['call_ms']:.4f} ms "
        f"per back-to-back wrapper call), plain {t['plain_ms']:.4f} ms, "
        f"library {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}) "
        f"[{card}]")


def shape_rows(res):
    """Phase 2's {shape: row} results as a list for the kernels line."""
    return [dict(shape=str(k), **v) for k, v in res.items()]


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_tol(want) -> float:
    """Two bf16 ulps of the largest value: both versions compute in
    float32 and round once to bf16, so float32 sums taken in another
    order can land them one ulp apart (an ulp of x is <= 2**-7 |x|)."""
    return 2.0 ** -6 * want.float().abs().max().item()


def bf16_tol_paths(want) -> float:
    """Four bf16 ulps of the largest value, for two bf16 runs of several
    layers that differ in more than the order of one sum: the kernels
    against ``impl="concat"`` (whose dense attend rounds q.k to bf16
    before the softmax), or a session in a batch against the session
    alone through 32 layers (cuBLAS picks other GEMM algorithms for
    another M).  Each run's logits then carry about two ulps of
    rounding, so their difference can reach four:
    ``scripts/stream_precision_probe.py`` measures 0.85-1.35 x
    ``bf16_tol`` for such pairs at 32 layers, and 1.16-1.19 x between the
    dense oracle and the same oracle with a float32 attention; 8d's
    ``batch_witness`` shows the online prefill's 4-lane batch as far
    from its lanes run alone as the engine's stream batch is."""
    return 2.0 ** -5 * want.float().abs().max().item()


def f32_lane_tol(want) -> float:
    """1e-3 of the largest logit: a float32 answer against its session
    alone (float32 sums in another order, as phase 4's cross-check)."""
    return 1e-3 * want.float().abs().max().item()


def check(name: str, err: float, tol: float):
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def seg_dict(k, v, **kw):
    d = dict(k=k, v=v, k_scale=None, v_scale=None, length=None, layer=None,
             lane_major=False, idx=None, seg=None, comp=None, valid=None)
    d.update(kw)
    return d


def check_segmented(torch, F, dattn, quantize_kv, card):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- GQA, int8 layered segments in both layouts, per-lane lengths,
    #    an empty memory lane and a fully masked row; head dims 72 (not a
    #    multiple of 16: the tensor-core route pads its last k-step) and
    #    256 (the largest taken); Sq 1 and 2 take the split-K decode route
    #    in bf16, Sq 5 the mma.sync route.  float32 q (the CUDA-core
    #    route): 1e-4; bf16 q with bf16 memory and self keys: bf16_tol
    B, Hq, Hkv, L, S = 3, 14, 2, 3, 100
    for dt in (torch.float32, torch.bfloat16):
        for D, Sq in ((64, 5), (64, 1), (72, 5), (72, 1), (72, 2), (256, 5),
                      (256, 1)):
            q = rn(B, Sq, Hq, D, dtype=dt)
            mk, mv = rn(B, 16, Hkv, D, dtype=dt), rn(B, 16, Hkv, D, dtype=dt)
            ck8, cks = quantize_kv(rn(L, B, S, Hkv, D))
            cv8, cvs = quantize_kv(rn(L, B, S, Hkv, D))
            sk, sv = rn(B, Sq, Hkv, D, dtype=dt), rn(B, Sq, Hkv, D, dtype=dt)
            ar = torch.arange(Sq, device=dev, dtype=torch.int32)
            qi = ar.clone()
            if Sq > 2:
                qi[2] = -5                   # row 2 sees no key at all
            self_seg = seg_dict(sk, sv, idx=ar, seg=torch.ones_like(ar),
                                comp=torch.zeros_like(ar, dtype=torch.bool),
                                valid=ar < Sq - 1 if Sq > 1 else None)
            mem_len = torch.tensor([0, 5, 16], device=dev, dtype=torch.int32)
            lens = torch.tensor([37, 0, 100], device=dev, dtype=torch.int32)
            layouts = {
                "layer-major": seg_dict(ck8, cv8, k_scale=cks, v_scale=cvs,
                                        length=lens, layer=1),
                "lane-major": seg_dict(
                    ck8.transpose(0, 1).contiguous(),
                    cv8.transpose(0, 1).contiguous(),
                    k_scale=cks.transpose(0, 1).contiguous(),
                    v_scale=cvs.transpose(0, 1).contiguous(), length=lens,
                    layer=torch.tensor([1, 0, 2], device=dev,
                                       dtype=torch.int32),
                    lane_major=True),
            }
            for name, cache_seg in layouts.items():
                segs = [seg_dict(mk, mv, length=mem_len), cache_seg, self_seg]
                one = torch.ones_like(qi)
                out = dattn.segmented_flash_attention(q, segs, qi, one,
                                                      D ** -0.5)
                want = dattn.plain(q, segs, qi, one, D ** -0.5)
                torch.cuda.synchronize()
                tol = 1e-4 if dt == torch.float32 else bf16_tol(want)
                check(f"segmented GQA 14/2 hd{D} int8 {name} Sq={Sq} "
                      f"{str(dt)[6:]}", max_err(out, want), tol)
                if Sq > 2 and not bool((out[:, 2] == 0).all()):
                    raise AssertionError("fully masked row is not exactly 0")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError("non-finite attention output")

    # -- a split-K decode whose lanes hold {0, 1, capacity} keys (lane 0
    #    sees no key at all: exactly 0), run twice: the second call shows
    #    that the combine counters were reset by the first
    B, H, D, L, S = 3, 8, 128, 2, 512
    mk, mv = rn(B, 64, H, D, dtype=torch.bfloat16), \
        rn(B, 64, H, D, dtype=torch.bfloat16)
    ck, cv = rn(L, B, S, H, D, dtype=torch.bfloat16), \
        rn(L, B, S, H, D, dtype=torch.bfloat16)
    q = rn(B, 1, H, D, dtype=torch.bfloat16)
    sk, sv = rn(B, 1, H, D, dtype=torch.bfloat16), \
        rn(B, 1, H, D, dtype=torch.bfloat16)
    qi = torch.full((1,), 2 ** 30, device=dev, dtype=torch.int32)
    one = torch.ones_like(qi)
    segs = [seg_dict(mk, mv, length=torch.tensor([0, 1, 64], device=dev,
                                                 dtype=torch.int32)),
            seg_dict(ck, cv, layer=1, length=torch.tensor(
                [0, 1, S], device=dev, dtype=torch.int32)),
            seg_dict(sk, sv, idx=qi, seg=one,
                     comp=torch.zeros(1, device=dev, dtype=torch.bool),
                     valid=torch.tensor([[False], [True], [True]],
                                        device=dev))]
    first = dattn.segmented_flash_attention(q, segs, qi, one, D ** -0.5)
    again = dattn.segmented_flash_attention(q, segs, qi, one, D ** -0.5)
    want = dattn.plain(q, segs, qi, one, D ** -0.5)
    torch.cuda.synchronize()
    check("segmented decode lanes of {0, 1, capacity} keys", max_err(first,
                                                                     want),
          bf16_tol(want))
    if not torch.equal(first, again):
        raise AssertionError("a second identical decode call differs")
    if not bool((first[0] == 0).all()):
        raise AssertionError("decode lane with no key is not exactly 0")

    results = {}
    for case in SEG_CASES + SEG_ZOO_CASES:
        results[case["label"]] = timed_segmented(torch, F, dattn, quantize_kv,
                                                 rn, card, **case)
    return results


# the phase-2 shapes of segmented attention (LLaMA-7B heads, bf16 q):
# decode over a 480-token cache (bf16 and int8), a streaming single
# token (B2 over a 72-key memory and a full 4096-token window: phase
# 8a's split-K shape), an ingest (64 tokens + 8 <COMP>), a 448-token
# prefill, a serve query over lane-major stacks with per-lane lengths
# and layer ids, and a GQA decode (32/8 heads)
SEG_CASES = [
    dict(label="decode", Sq=1, clen=480),
    dict(label="decode int8", Sq=1, clen=480, int8=True),
    dict(label="stream decode", Sq=1, clen=4096, B=2, cap=4096, mem=72),
    dict(label="ingest", Sq=72, clen=0, ncomp=8),
    dict(label="prefill", Sq=448, clen=0),
    dict(label="serve query", Sq=32, clen=None, B=8, cap=256),
    dict(label="decode GQA 32/8", Sq=1, clen=480, Hkv=8),
]
# the zoo's heads (phase 9): decode over a 480-token cache at SmolLM's
# 15/5, Qwen2's 14/2 (hd 64) and Gemma's 8/1 (hd 256), and a 448-token
# prefill at Qwen2's and Gemma's
SEG_ZOO_CASES = [
    dict(label="decode 15/5 hd64", Sq=1, clen=480, H=15, Hkv=5, D=64),
    dict(label="decode 14/2 hd64", Sq=1, clen=480, H=14, Hkv=2, D=64),
    dict(label="decode 8/1 hd256", Sq=1, clen=480, H=8, Hkv=1, D=256),
    dict(label="prefill 14/2 hd64", Sq=448, clen=0, H=14, Hkv=2, D=64),
    dict(label="prefill 8/1 hd256", Sq=448, clen=0, H=8, Hkv=1, D=256),
    # zamba2-1.2b's shared attention (phase 11): MHA 32/32 at hd 64, a
    # decode over a 480-token cache, its 256-token prefill, its ingest (56
    # tokens + 8 <COMP>) and its serve query (11d: B8, 32 tokens over the
    # lane-major stacks of its 6 sites, a 64-token cache)
    dict(label="decode 32/32 hd64 zamba2", Sq=1, clen=480, H=32, Hkv=32,
         D=64),
    dict(label="prefill 32/32 hd64 zamba2", Sq=256, clen=0, H=32, Hkv=32,
         D=64),
    dict(label="ingest 32/32 hd64 zamba2", Sq=64, clen=0, ncomp=8, H=32,
         Hkv=32, D=64),
    dict(label="serve query 32/32 hd64 zamba2", Sq=32, clen=None, B=8,
         cap=64, Lr=6, H=32, Hkv=32, D=64),
    # phase 12's decoders: pixtral-12b's GQA 32/8 and llama4-maverick's
    # 40/8 (G = 5) at hd 128, a decode over a 480-token cache and a
    # 448-token prefill each; whisper-tiny's MHA 6/6 at hd 64
    dict(label="decode 32/8 hd128 pixtral", Sq=1, clen=480, H=32, Hkv=8,
         D=128),
    dict(label="prefill 32/8 hd128 pixtral", Sq=448, clen=0, H=32, Hkv=8,
         D=128),
    dict(label="decode 40/8 hd128 llama4", Sq=1, clen=480, H=40, Hkv=8,
         D=128),
    dict(label="prefill 40/8 hd128 llama4", Sq=448, clen=0, H=40, Hkv=8,
         D=128),
    dict(label="decode 6/6 hd64 whisper", Sq=1, clen=480, H=6, Hkv=6,
         D=64),
    # phase 14's shard shapes: a LLaMA-7B rank's heads at n = 2, 4 and 8
    # (16, 8 and 4 of its 32 x 128), a decode over a 480-token cache and a
    # 448-token prefill each
    dict(label="decode 16/16 hd128 TP n=2", Sq=1, clen=480, H=16, Hkv=16),
    dict(label="decode 8/8 hd128 TP n=4", Sq=1, clen=480, H=8, Hkv=8),
    dict(label="decode 4/4 hd128 TP n=8", Sq=1, clen=480, H=4, Hkv=4),
    dict(label="prefill 16/16 hd128 TP n=2", Sq=448, clen=0, H=16, Hkv=16),
    dict(label="prefill 8/8 hd128 TP n=4", Sq=448, clen=0, H=8, Hkv=8),
    dict(label="prefill 4/4 hd128 TP n=8", Sq=448, clen=0, H=4, Hkv=4),
    # phase 15's shard shapes: phi3.5-moe's 32/8 heads at n = 4 (8/2) and
    # llama4-maverick's 40/8 at n = 8 (5/1), hd 128
    dict(label="decode 8/2 hd128 MoE TP n=4", Sq=1, clen=480, H=8, Hkv=2),
    dict(label="decode 5/1 hd128 MoE TP n=8", Sq=1, clen=480, H=5, Hkv=1),
    dict(label="prefill 8/2 hd128 MoE TP n=4", Sq=448, clen=0, H=8, Hkv=2),
    dict(label="prefill 5/1 hd128 MoE TP n=8", Sq=448, clen=0, H=5, Hkv=1),
    # phase 16's shard shapes: zamba2-1.2b's shared site (32/32 hd 64) at
    # n = 2 and 4, pixtral-12b's 32/8 at n = 8 (its 8/2 at n = 4 is
    # phi3.5-moe's row above), and whisper-tiny's decoder (6/6 hd 64) at
    # n = 2
    dict(label="decode 16/16 hd64 zamba2 TP n=2", Sq=1, clen=480, H=16,
         Hkv=16, D=64),
    dict(label="decode 8/8 hd64 zamba2 TP n=4", Sq=1, clen=480, H=8, Hkv=8,
         D=64),
    dict(label="prefill 16/16 hd64 zamba2 TP n=2", Sq=256, clen=0, H=16,
         Hkv=16, D=64),
    dict(label="prefill 8/8 hd64 zamba2 TP n=4", Sq=256, clen=0, H=8, Hkv=8,
         D=64),
    dict(label="decode 4/1 hd128 pixtral TP n=8", Sq=1, clen=480, H=4,
         Hkv=1),
    dict(label="prefill 4/1 hd128 pixtral TP n=8", Sq=448, clen=0, H=4,
         Hkv=1),
    dict(label="decode 3/3 hd64 whisper TP n=2", Sq=1, clen=480, H=3, Hkv=3,
         D=64),
    # phase 20's paper loop (``paper_loop.bench_cfg``: GQA 4/2 at hd 32,
    # float32, the CUDA-core route): the last of 4 ingests of 8 tokens + 2
    # <COMP> over 6 memory tokens and the 8-token prefill over 8 (20a's
    # B8 online hold), a decode over a 64-token cache (the streaming
    # demo's 80-key budget) and a serve query over the lane-major stacks
    # of its 2 layers (the serve examples, B8)
    dict(label="ingest 4/2 hd32 bench f32", Sq=10, clen=0, ncomp=2, B=8,
         mem=6, H=4, Hkv=2, D=32, dt="float32"),
    dict(label="prefill 4/2 hd32 bench f32", Sq=8, clen=0, B=8, mem=8, H=4,
         Hkv=2, D=32, dt="float32"),
    dict(label="decode 4/2 hd32 bench f32", Sq=1, clen=64, B=2, cap=80,
         mem=16, H=4, Hkv=2, D=32, dt="float32"),
    dict(label="serve query 4/2 hd32 bench f32", Sq=8, clen=None, B=8,
         cap=64, Lr=2, H=4, Hkv=2, D=32, dt="float32"),
]


def timed_segmented(torch, F, dattn, quantize_kv, rn, card, *, label, Sq,
                    clen, int8=False, B=4, Hkv=32, cap=512, mem=32, H=32,
                    D=128, ncomp=0, Lr=8, dt="bfloat16"):
    """One segmented-attention shape: checked against the plain version,
    then timed beside it, SDPA over the explicit concatenation of the
    valid keys (with the CCM mask; GQA through ``enable_gqa``) and the
    bound.  Four layers (or four layer-id sets) rotate so that the timed
    reads exceed the 50 MB L2.  The last ``ncomp`` query rows are <COMP>
    rows (an ingest).  ``clen=None`` is the serve query: lane-major (B,
    Lr, S, H, D) memory (128 rows) and cache (``cap`` rows) with per-lane
    lengths and per-lane layer ids.  The zoo's GQA and MQA caches (0.5-2 MB a layer)
    stay in the 50 MB L2 across the four layers rotated here, where a
    model's other work between two layers would evict them.  ``dt``
    "float32" takes the CUDA-core route (held at 1e-4 x max|plain|, bound
    at the float32 rate)."""
    dev = "cuda"
    L = 32
    G = H // Hkv
    decode = Sq <= 2
    serve = clen is None
    bf = getattr(torch, dt)
    es = torch.finfo(bf).bits // 8
    scale = D ** -0.5
    q = rn(B, Sq, H, D, dtype=bf)
    sk, sv = rn(B, Sq, Hkv, D, dtype=bf), rn(B, Sq, Hkv, D, dtype=bf)
    ar = torch.arange(Sq, device=dev, dtype=torch.int32)
    idx = ar + 2 ** 30 if decode else ar
    comp = torch.zeros(Sq, device=dev, dtype=torch.bool)
    if ncomp:                                     # ingest: <COMP> rows last
        comp[Sq - ncomp:] = True
    one = torch.ones_like(idx)
    self_seg = seg_dict(sk, sv, idx=idx, seg=one, comp=comp)
    if serve:
        mk, mv = rn(B, Lr, 128, Hkv, D, dtype=bf), rn(B, Lr, 128, Hkv, D,
                                                      dtype=bf)
        ck, cv = rn(B, Lr, cap, Hkv, D, dtype=bf), rn(B, Lr, cap, Hkv, D,
                                                      dtype=bf)
        ml = torch.tensor([128, 0, 8, 64, 120, 16, 128, 40][:B], device=dev,
                          dtype=torch.int32)
        cl = torch.tensor([min(c, cap) for c in (cap, 0, 1, 100, 200, 37,
                                                 cap - 1, 128)][:B],
                          device=dev, dtype=torch.int32)
        gl = torch.Generator(device=dev).manual_seed(9)
        lids = [torch.randint(0, Lr, (B,), generator=gl, device=dev,
                              dtype=torch.int32) for _ in range(4)]

        def segs_at(i):
            return [seg_dict(mk, mv, length=ml, layer=lids[i], lane_major=True),
                    seg_dict(ck, cv, length=cl, layer=lids[i], lane_major=True),
                    self_seg]
    else:
        mk, mv = rn(B, 128, Hkv, D, dtype=bf), rn(B, 128, Hkv, D, dtype=bf)
        ck, cv = rn(L, B, cap, Hkv, D, dtype=bf), rn(L, B, cap, Hkv, D,
                                                     dtype=bf)
        if int8:
            ck8, cks = quantize_kv(ck)
            cv8, cvs = quantize_kv(cv)

        def segs_at(i):
            layer = 5 + i
            cache = seg_dict(ck8, cv8, k_scale=cks, v_scale=cvs, length=clen,
                             layer=layer) if int8 else \
                seg_dict(ck, cv, length=clen, layer=layer)
            return [seg_dict(mk, mv, length=mem), cache, self_seg]
    segs4 = [segs_at(i) for i in range(4)]
    out = dattn.segmented_flash_attention(q, segs4[0], idx, one, scale)
    want = dattn.plain(q, segs4[0], idx, one, scale)
    torch.cuda.synchronize()
    err = max_err(out, want)
    check(f"segmented {label} B{B} Sq{Sq} H{H}/{Hkv} hd{D}", err,
          1e-4 * want.abs().max().item() if bf == torch.float32
          else bf16_tol(want))
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"segmented {label}: non-finite output")

    # library yardstick: SDPA over the explicit concatenation of each
    # lane's valid keys, with the CCM mask (built outside the timing)
    def lane_keys(seg, b):
        k, v = seg["k"], seg["v"]
        if seg.get("layer") is not None:
            li = seg["layer"]
            li = int(li[b]) if isinstance(li, torch.Tensor) else int(li)
            k, v = (k[b, li], v[b, li]) if seg.get("lane_major") \
                else (k[li, b], v[li, b])
            if seg.get("k_scale") is not None:
                ks = seg["k_scale"][li, b]
                vs = seg["v_scale"][li, b]
                k = (k.float() * ks[..., None]).to(bf)
                v = (v.float() * vs[..., None]).to(bf)
        else:
            k, v = k[b], v[b]
        n = seg.get("length")
        n = k.shape[0] if n is None else (int(n[b]) if isinstance(
            n, torch.Tensor) else int(n))
        return k[:n], v[:n]

    cats, nkeys, pairs = [], [], []
    for segs in segs4:
        per_lane = []
        for b in range(B):
            kk = [lane_keys(s, b) for s in segs[:2]]
            nmem = kk[0][0].shape[0] + kk[1][0].shape[0]
            kc = torch.cat([kk[0][0], kk[1][0], sk[b]], 0)
            vc = torch.cat([kk[0][1], kk[1][1], sv[b]], 0)
            kidx = torch.cat([torch.full((nmem,), -1, device=dev,
                                         dtype=torch.int32), idx])
            kcomp = torch.cat([torch.ones(nmem, device=dev, dtype=torch.bool),
                               comp])
            kseg = torch.cat([torch.zeros(nmem, device=dev,
                                          dtype=torch.int32), one])
            mask = None if decode else (kidx[None] <= idx[:, None]) & \
                ((kseg[None] == one[:, None]) | kcomp[None])
            per_lane.append((kc.transpose(0, 1)[None].contiguous(),
                             vc.transpose(0, 1)[None].contiguous(), mask))
        cats.append(per_lane)
        nkeys.append(sum(c[0].shape[2] for c in per_lane))
        # the (q row, key) pairs the mask lets through: the work this
        # data needs (every key at decode)
        pairs.append(sum(Sq * c[0].shape[2] if c[2] is None
                         else int(c[2].sum().item()) for c in per_lane))
    if serve:
        # lanes hold different key counts: one SDPA call per lane
        qts = [q[b:b + 1].transpose(1, 2).contiguous() for b in range(B)]

        def library(i):
            for b, (kc, vc, mask) in enumerate(cats[i % 4]):
                F.scaled_dot_product_attention(qts[b], kc, vc, attn_mask=mask,
                                               enable_gqa=G > 1)
    else:
        qt = q.transpose(1, 2).contiguous()
        stacked = [(torch.cat([c[0] for c in lanes]),
                    torch.cat([c[1] for c in lanes]), lanes[0][2])
                   for lanes in cats]

        def library(i):
            kc, vc, mask = stacked[i % 4]
            return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                                  enable_gqa=G > 1)
    t = timings(
        torch,
        lambda i: dattn.segmented_flash_attention(q, segs4[i % 4], idx, one,
                                                  scale),
        "segmented_attention",
        lambda i: dattn.plain(q, segs4[i % 4], idx, one, scale), library)
    n = nkeys[0]                                  # keys over all lanes
    kv_bytes = n * Hkv * D * es * 2
    if int8:                                      # the cache part is int8
        nc = B * clen
        kv_bytes -= nc * Hkv * D * es * 2
        kv_bytes += nc * Hkv * (D + 4) * 2
    nbytes = kv_bytes + 2 * q.numel() * es
    ops_ = 4.0 * H * D * pairs[0]
    bms, by = bound(nbytes, ops_,
                    PEAK_F32 if bf == torch.float32 else PEAK_BF16)
    report(f"segmented {label} (library: SDPA)", t, bms, by, card)
    return dict(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=bms, bound_by=by)


def check_cond_lora(torch, clora, card):
    """cond_lora against its plain version: edge shapes (ragged M, N and
    K, ranks 1/13/64 that the wrapper pads to a multiple of 8, float32 on
    the CUDA-core route at 1e-4 x max|plain|), then the main path's
    shapes (K = N = 4096, r = 8) gated, ungated and with bias, each timed
    beside its plain version, the library call and the bound, then the
    zoo's projections at M = 288 (SmolLM's K 960 -> N 320, Qwen2's
    896 -> 128, Gemma's 2048 -> 256, and 2048 -> 2048 with a bias), then
    phase 20's (LLaMA-7B's at M 8448, bench_cfg's in float32 at 1e-4 x
    max|plain|).  Returns {M (LLaMA-7B) or "M K N": row}."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    for M, K, N, r, dt in ((216, 4096, 4096, 8, bf), (37, 200, 136, 13, bf),
                           (130, 520, 1000, 64, bf), (1, 8, 8, 1, bf),
                           (100, 96, 80, 5, torch.float32)):
        x, w = rn(M, K, dtype=dt), rn(K, N, std=K ** -0.5, dtype=dt)
        a, b = rn(r, K, std=K ** -0.5, dtype=dt), rn(r, N, std=0.05, dtype=dt)
        bias = rn(N, dtype=dt)
        gate = (torch.arange(M, device=dev) % 3 == 0).float()
        out = clora.cond_lora_matmul(x, w, a, b, gate, 2.0, bias=bias)
        want = clora.plain(x, w, a, b, gate, 2.0, bias=bias)
        torch.cuda.synchronize()
        tol = 1e-4 * want.abs().max().item() if dt == torch.float32 \
            else bf16_tol(want)
        check(f"cond_lora M{M} K{K} N{N} r{r} {str(dt)[6:]} with bias",
              max_err(out, want), tol)

    r = 8
    rows = {}
    # M = 288: an online ingest (4 lanes x 72); 576: an 8-lane serve
    # ingest; 4864: a training step (4 x 1216).  The zoo's weights
    # (0.2-8.4 MB; zamba2-1.2b's M 256) stay in the L2 across the four
    # rotated here.
    for M, K, N, with_bias, *rest in ((288, 4096, 4096, False),
                               (576, 4096, 4096, False),
                               (4864, 4096, 4096, False),
                               (288, 960, 320, False), (288, 896, 128, False),
                               (288, 2048, 256, False),
                               (288, 2048, 2048, True),
                               # zamba2-1.2b's shared block at an online
                               # ingest (4 lanes x 64, MHA 32 x 64) and
                               # at a serve ingest (8 lanes x 64)
                               (256, 2048, 2048, False),
                               (512, 2048, 2048, False),
                               # pixtral-12b's q, k/v and o projections
                               # at an online ingest (phase 12)
                               (288, 5120, 4096, False),
                               (288, 5120, 1024, False),
                               (288, 4096, 5120, False),
                               # phase 14's shard shapes of LLaMA-7B's
                               # projections: column-parallel q/k/v (N
                               # 2048, 1024, 512 at n = 2, 4, 8) and the
                               # row-parallel wo (K 2048, 1024, 512)
                               (288, 4096, 2048, False),
                               (288, 4096, 1024, False),
                               (288, 4096, 512, False),
                               (288, 2048, 4096, False),
                               (288, 1024, 4096, False),
                               (288, 512, 4096, False),
                               # phase 15's: llama4-maverick's column-
                               # parallel q at n = 8 (40 x 128 / 8)
                               (288, 5120, 640, False),
                               # phase 20's: LLaMA-7B's adapter step (B32
                               # x S 264); the paper loop's training step
                               # (bench_cfg, B32 x S 48: q and o 128 ->
                               # 128, k and v 128 -> 64), float32 on the
                               # CUDA-core route
                               (8448, 4096, 4096, False),
                               (1536, 128, 128, False, "float32"),
                               (1536, 128, 64, False, "float32")):
        dt = getattr(torch, rest[0]) if rest else bf
        f32 = dt == torch.float32
        ws = [rn(K, N, std=K ** -0.5, dtype=dt)
              for _ in range(4)]                           # LLaMA: > L2
        a, b = rn(r, K, std=K ** -0.5, dtype=dt), rn(r, N, std=0.05, dtype=dt)
        bias = rn(N, dtype=dt)
        tb = bias if with_bias else None
        x = rn(M, K, dtype=dt)
        gate = ((torch.arange(M, device=dev) % 72) >= 64).float()
        errs = []
        for gname, gt, bs in (("gated", gate, None),
                              ("gate all zero", torch.zeros_like(gate), None),
                              ("gated with bias", gate, bias)):
            out = clora.cond_lora_matmul(x, ws[0], a, b, gt, 2.0, bias=bs)
            want = clora.plain(x, ws[0], a, b, gt, 2.0, bias=bs)
            torch.cuda.synchronize()
            errs.append(max_err(out, want))
            check(f"cond_lora {gname} M{M} K{K} N{N} r{r}"
                  f"{' float32' if f32 else ''}", errs[-1],
                  1e-4 * want.abs().max().item() if f32 else bf16_tol(want))
        g2 = gate.to(dt)[:, None]
        lb = 0 if tb is None else tb
        t = timings(
            torch,
            lambda i: clora.cond_lora_matmul(x, ws[i % 4], a, b, gate, 2.0,
                                             bias=tb),
            "cond_lora",
            lambda i: clora.plain(x, ws[i % 4], a, b, gate, 2.0, bias=tb),
            lambda i: x @ ws[i % 4] + lb + g2 * ((x @ a.T) @ b) * 2.0)
        nbytes = (4 if f32 else 2) * (M * K + K * N + r * K + r * N + M * N
                                      + (N if with_bias else 0)) + 4 * M
        ops_ = 2.0 * M * K * N + 2.0 * M * K * r + 2.0 * M * r * N
        bms, by = bound(nbytes, ops_, PEAK_F32 if f32 else PEAK_BF16)
        key = M if (K, N) == (4096, 4096) else \
            f"M{M} K{K} N{N}{' bias' if with_bias else ''}" \
            f"{' float32' if f32 else ''}"
        report(f"cond_lora {key} (library: x@W + gate*(x@A^T@B)*s)", t, bms,
               by, card)
        rows[key] = dict(max_abs_err=errs[2 if with_bias else 0], ms=t["ms"],
                         plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                         bound_ms=bms, bound_by=by)
        del x
    return rows


def check_kv_merge(torch, kvm, card):
    """Kernel 3, one launch per merge g_update (k and v together), against
    its plain version: bf16 memory within bf16_tol (both round one float32
    value once; the kernel's fused multiply-add may land one ulp away),
    float32 memory within 1e-6 x max|want| (the same fma, no rounding to
    bf16).  Cases: k + v at the phase-2 shape (LLaMA-7B merge memory, B4)
    with a shared a; lane-major memory with per-lane a and h a transposed
    view (the serve engine's call); layer-major with per-lane a; float32
    h into bf16 memory; float32 memory (bf16 and float32 h); hd 72; the
    one-element path for an inner run that is not a multiple of 8 and for
    an h that is not 16-byte aligned.  Times the shared-a pair (the
    online path's call) and the lane-major per-lane pair."""
    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(3)
    L, B, m, H, hd = 32, 4, 8, 32, 128
    shape = (L, B, m, H, hd)
    lanes = [1.0, 0.5, 1.0 / 3, 0.3]

    def rn(shp, dtype=bf):
        return torch.randn(shp, generator=g, device=dev).to(dtype)

    def transposed(shp, dtype=bf):
        """An h of shape ``shp`` that is the transpose of axes 0 and 1."""
        return rn((shp[1], shp[0]) + tuple(shp[2:]), dtype).transpose(0, 1)

    errs = []

    def case(name, mems, hs, a, axis, vec):
        want = [kvm.plain_lanes(x, h, a, axis) for x, h in zip(mems, hs)]
        got = [x.clone() for x in mems]
        width = kvm.vector_width(got, hs, a)
        if width != vec:
            raise AssertionError(f"kv_merge {name}: vector width {width}, "
                                 f"want {vec}")
        kvm.kv_merge_update_lanes_(got, hs, a, axis)
        torch.cuda.synchronize()
        err = max(max_err(x, w) for x, w in zip(got, want))
        tol = max(bf16_tol(w) if w.dtype == bf else
                  1e-6 * w.abs().max().item() for w in want)
        errs.append(err)
        check(f"kv_merge {name} (width {width})", err, tol)

    for a in (1.0, 1.0 / 3, 0.3):
        case(f"k+v a={a:.4f} {shape}", [rn(shape), rn(shape)],
             [rn(shape), rn(shape)], a, 1, 8)
    lm = (B, L, m, H, hd)
    case(f"lane-major {lm}, per-lane a, h transposed", [rn(lm), rn(lm)],
         [transposed(lm), transposed(lm)], lanes, 0, 8)
    case(f"layer-major {shape}, per-lane a", [rn(shape), rn(shape)],
         [rn(shape), rn(shape)], lanes, 1, 8)
    case("float32 h into bf16 memory, lane-major, per-lane a",
         [rn(lm), rn(lm)], [transposed(lm, f32), transposed(lm, f32)],
         lanes, 0, 8)
    case("float32 memory, bf16 h, a=1/3", [rn(shape, f32), rn(shape, f32)],
         [rn(shape), rn(shape)], 1.0 / 3, 1, 8)
    case("float32 memory, float32 h transposed, per-lane a",
         [rn(lm, f32), rn(lm, f32)],
         [transposed(lm, f32), transposed(lm, f32)], lanes, 0, 4)
    s72 = (B, L, m, H, 72)
    case(f"hd 72 {s72}, per-lane a, h transposed", [rn(s72), rn(s72)],
         [transposed(s72), transposed(s72)], lanes, 0, 8)
    odd = (3, B, 1, 5, 37)
    case(f"inner run 185 {odd}, per-lane a", [rn(odd), rn(odd)],
         [rn(odd), rn(odd)], lanes, 1, 1)
    n = math.prod(shape)
    off = [rn((n + 1,))[1:].view(shape) for _ in range(2)]
    case("h 2 bytes off 16-byte alignment, per-lane a",
         [rn(shape), rn(shape)], off, lanes, 1, 1)

    sets = [[rn(shape) for _ in range(4)] for _ in range(4)]   # > 50 MB L2

    def pair(i):
        mk, mv, hk, hv = sets[i % 4]
        kvm.kv_merge_update_lanes_((mk, mv), (hk, hv), 1.0 / 3, 1)

    def plain_pair(i):
        mk, mv, hk, hv = sets[i % 4]
        mk.copy_(kvm.plain_lanes(mk, hk, 1.0 / 3, 1))
        mv.copy_(kvm.plain_lanes(mv, hv, 1.0 / 3, 1))

    def lerp_pair(i):
        mk, mv, hk, hv = sets[i % 4]
        mk.lerp_(hk, 1.0 / 3)
        mv.lerp_(hv, 1.0 / 3)

    t = timings(torch, pair, "kv_merge_kernel", plain_pair, lerp_pair)
    bms, by = bound(2 * 3 * n * 2, 2 * 3.0 * n, PEAK_F32)
    report("kv_merge k+v, shared a (library: two torch.lerp_)", t, bms, by,
           card)
    log(f"  kv_merge k+v: {bms / t['ms']:.3f} of the bytes bound, "
        f"{t['library_ms'] / t['ms']:.3f}x the library pair; wrapper call "
        f"{t['call_ms'] - t['ms']:+.4f} ms over device time [{card}]")
    lsets = [(rn(lm), rn(lm), transposed(lm), transposed(lm))
             for _ in range(4)]

    def lane_pair(i):
        mk, mv, hk, hv = lsets[i % 4]
        kvm.kv_merge_update_lanes_((mk, mv), (hk, hv), lanes, 0)

    a_lm = torch.tensor(lanes, device=dev, dtype=bf).reshape(B, 1, 1, 1, 1)

    def lane_lerp(i):
        mk, mv, hk, hv = lsets[i % 4]
        mk.lerp_(hk, a_lm)
        mv.lerp_(hv, a_lm)
    tl = dict(ms=device_ms(torch, lane_pair, 20, only="kv_merge_kernel"),
              call_ms=time_ms(torch, lane_pair, 20),
              library_ms=device_ms(torch, lane_lerp, 20))
    log(f"  kv_merge k+v lane-major {lm}, per-lane a, h transposed: kernel "
        f"{tl['ms']:.4f} ms (device; {tl['call_ms']:.4f} ms per "
        f"back-to-back wrapper call), library {tl['library_ms']:.4f} ms "
        f"(two torch.lerp_ with a (B,) bf16 weight tensor), bound "
        f"{bms:.4f} ms ({by}) [{card}]")
    del sets, lsets, off

    def zoo_row(label, shp, a, axis, nsets):
        """One zoo merge memory: checked, then timed (``nsets`` sets of
        four rotate past the 50 MB L2) beside its plain version, two
        ``lerp_`` and the bound.  Lane-major (``axis`` 0) takes per-lane
        ``a`` and an h that is a transposed view, as the serve engine
        does."""
        def h_of(shape):
            return transposed(shape) if axis == 0 else rn(shape)
        case(f"k+v {label} {shp}", [rn(shp), rn(shp)], [h_of(shp), h_of(shp)],
             a, axis, 8)
        err = errs[-1]
        zs = [[rn(shp), rn(shp), h_of(shp), h_of(shp)] for _ in range(nsets)]
        w = a if axis else torch.tensor(a, device=dev, dtype=bf).reshape(
            (-1,) + (1,) * (len(shp) - 1))

        def z_pair(i):
            mk, mv, hk, hv = zs[i % nsets]
            kvm.kv_merge_update_lanes_((mk, mv), (hk, hv), a, axis)

        def z_plain(i):
            mk, mv, hk, hv = zs[i % nsets]
            mk.copy_(kvm.plain_lanes(mk, hk, a, axis))
            mv.copy_(kvm.plain_lanes(mv, hv, a, axis))

        def z_lerp(i):
            mk, mv, hk, hv = zs[i % nsets]
            mk.lerp_(hk, w)
            mv.lerp_(hv, w)
        tz = timings(torch, z_pair, "kv_merge_kernel", z_plain, z_lerp)
        zn = math.prod(shp)
        zbms, zby = bound(2 * 3 * zn * 2, 2 * 3.0 * zn, PEAK_F32)
        report(f"kv_merge k+v {label} {shp} (library: two torch.lerp_)", tz,
               zbms, zby, card)
        return dict(shape=f"k+v {shp} bf16 ({label})", max_abs_err=err,
                    ms=tz["ms"], plain_ms=tz["plain_ms"],
                    library_ms=tz["library_ms"], bound_ms=zbms, bound_by=zby)

    # Gemma-2B's merge memory (18 layers, B4, 8 <COMP> rows, MQA hd 256):
    # 0.3 MB a tensor, so 48 sets of four rotate past the 50 MB L2;
    # zamba2-1.2b's (6 sites, B4, 8 rows, MHA 32 x 64; 0.8 MB a tensor,
    # 24 sets): the online path's call (shared a) and, lane-major with
    # per-lane a, the serve engine's
    zoo = [zoo_row("Gemma-2B", (18, B, m, 1, 256), 1.0 / 3, 1, 48),
           zoo_row("zamba2-1.2b", (6, B, m, 32, 64), 1.0 / 3, 1, 24),
           zoo_row("zamba2-1.2b lane-major, per-lane a, h transposed",
                   (B, 6, m, 32, 64), lanes, 0, 24)]
    return dict(max_abs_err=max(errs), ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=bms, bound_by=by,
                shapes=zoo)


def check_session_gather(torch, sg, card):
    """Arena gather/scatter against their plain versions, bit-exact: 2-D
    and 5-D leaves of float32, bf16 and int8 (a 37-element row is 37
    bytes: the kernel's narrow-unit path), duplicate gather ids, a
    scatter whose duplicates all hit the scratch row (each of its
    elements from one of their rows), ids 0 and S-1; then
    the arena's real LLaMA-7B leaves (a concat bf16 cache k row at
    cache_len 256, 64 MiB; a memory k row of 16 slots x 8, 32 MiB), timed
    at B=4.  Returns the (gather, scatter) rows of the kernels line."""
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    S = 6
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        for row in ((37,), (2, 1, 4, 2, 8)):
            slab = torch.randint(-127, 128, (S,) + row, generator=g,
                                 device=dev).to(dt)
            for ids in ([0, S - 1, 2], [3, 3, 0, 3]):
                got = sg.session_gather(slab, ids)
                if not torch.equal(got, ref.session_gather_ref(slab, ids)):
                    raise AssertionError(f"session_gather {dt} {row} {ids}")
            rows = torch.randint(-127, 128, (5,) + row, generator=g,
                                 device=dev).to(dt)
            ids = [0, 2, S - 1, S - 1, S - 1]
            got = sg.session_scatter(slab.clone(), ids, rows)
            want = ref.session_scatter_ref(slab.clone(), ids, rows)
            torch.cuda.synchronize()
            # the three writers of the scratch row race: each element
            # holds one writer's value, not necessarily all the same one's
            if not torch.equal(got[:S - 1], want[:S - 1]) or not bool(
                    (got[S - 1][None] == rows[2:5]).any(0).all()):
                raise AssertionError(f"session_scatter {dt} {row}")
    log("  session gather/scatter: float32, bf16, int8 x 2-D (37-element "
        "rows) and 5-D leaves, duplicate ids, ids 0 and S-1: bit-exact")
    B, ids = 4, [5, 0, 8, 3]
    ids_t = torch.tensor(ids, device=dev)
    out = {}
    for name, toks in (("cache k row (32, 1, 256, 32, 128)", 256),
                       ("memory k row (32, 1, 128, 32, 128)", 128)):
        slab = torch.randn((9, 32, 1, toks, 32, 128), generator=g,
                           device=dev).to(torch.bfloat16)
        rows = torch.randn((B,) + tuple(slab.shape[1:]), generator=g,
                           device=dev).to(torch.bfloat16)
        got = sg.session_gather(slab, ids)
        if not torch.equal(got, ref.session_gather_ref(slab, ids)):
            raise AssertionError(f"session_gather {name}")
        a = sg.session_scatter(slab.clone(), ids, rows)
        if not torch.equal(a, ref.session_scatter_ref(slab.clone(), ids,
                                                      rows)):
            raise AssertionError(f"session_scatter {name}")
        del a, got
        row_bytes = slab[0].numel() * 2
        bms, by = bound(2 * B * row_bytes, 0.0, PEAK_BF16)
        tg = timings(torch, lambda i: sg.session_gather(slab, ids),
                     "session_copy_kernel",
                     lambda i: ref.session_gather_ref(slab, ids),
                     lambda i: torch.index_select(slab, 0, ids_t))
        report(f"session_gather B4 {name} {row_bytes / 2 ** 20:.0f} MiB "
               "(library: torch.index_select)", tg, bms, by, card)
        ts = timings(torch, lambda i: sg.session_scatter(slab, ids, rows),
                     "session_copy_kernel",
                     lambda i: ref.session_scatter_ref(slab, ids, rows),
                     lambda i: slab.index_copy_(0, ids_t, rows))
        report(f"session_scatter B4 {name} (library: index_copy_)", ts, bms,
               by, card)
        if not out:                      # the cache row goes in the line
            out = {"gather": tg, "scatter": ts, "bound": (bms, by)}
        del slab, rows
    torch.cuda.empty_cache()
    bms, by = out["bound"]
    return tuple(dict(max_abs_err=0.0, ms=out[k]["ms"],
                      plain_ms=out[k]["plain_ms"],
                      library_ms=out[k]["library_ms"], bound_ms=bms,
                      bound_by=by) for k in ("gather", "scatter"))


def ccm_meta(torch, layout, dev):
    """Concat-mode metadata of ``layout`` on ``dev`` (int32 idx/seg, bool
    comp), as ``train_forward`` hands it to the kernel."""
    S = layout.seq_len
    idx = torch.arange(S, device=dev, dtype=torch.int32)
    seg = layout.seg_ids.to(dev)
    comp = layout.comp_mask.to(dev)
    return idx, seg, comp


def check_ccm_attention(torch, F, ca, segment_layout, card):
    """Kernel 4: forward and backward against the plain version (and its
    autograd) on the card, then the training shape's times."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def grads(fn, q, k, v, do):
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = fn(q, k, v)
        return (out,) + torch.autograd.grad(out, (q, k, v), do)

    # -- GQA 14/2, 8/2, 8/8, 4/4 and 4/1, head dims 40/64/72/128/256, S
    #    not a multiple of the tiles, padded keys, a fully masked row; float32
    #    (the CUDA-core route) and bf16 (the tensor-core route; per-lane
    #    (B, S) metadata with a different layout per lane, a layout with
    #    no <COMP> key).  float32: 1e-4 x max|plain| (float32 sums over up
    #    to 1216 keys in another order); bf16: 2 ulps of the largest output
    #    for the forward and 4 for gradients (the backward rounds O, dQ,
    #    dK, dV to bf16 and recomputes P from the float32 log-sum-exp).
    S = 110
    lays = [segment_layout(3, 29, 4, 11), segment_layout(5, 14, 4, 20),
            segment_layout(2, 40, 8, 14)]                # S = 110 each
    f32, bf = torch.float32, torch.bfloat16
    cases = [(2, 14, 2, 64, f32, "shared"), (2, 14, 2, 72, f32, "shared"),
             (1, 4, 4, 256, f32, "shared"), (2, 14, 2, 128, bf, "shared"),
             (1, 6, 2, 256, bf, "shared"), (3, 8, 2, 128, bf, "per-lane"),
             (2, 8, 8, 128, bf, "no-comp"), (2, 14, 2, 72, bf, "shared"),
             (2, 4, 1, 40, bf, "per-lane")]
    mma0 = (ca.mma_launches, ca.bwd_mma_launches)
    for B, Hq, Hkv, D, dt, kind in cases:
        if kind == "per-lane":                           # lane b: lays[b]
            idx = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
            seg = torch.stack([lay.seg_ids for lay in lays[:B]]).to(dev)
            comp = torch.stack([lay.comp_mask for lay in lays[:B]]).to(dev)
            valid = torch.ones(B, S, dtype=torch.bool, device=dev)
            valid[1, -5:] = False
            valid[B - 1, 40:48] = False                  # invalid keys
        else:
            idx, seg, comp = ccm_meta(torch, lays[0], dev)
            if kind == "no-comp":
                comp = torch.zeros_like(comp)
            valid = torch.ones(S, dtype=torch.bool, device=dev)
        valid[..., -3:] = False                          # padded keys
        qi = idx.clone()
        qi[..., 5] = -7                                  # sees no key
        meta = (qi, seg, idx, seg, comp, valid)
        q = rn(B, Hq, S, D, dtype=dt)
        k, v = rn(B, Hkv, S, D, dtype=dt), rn(B, Hkv, S, D, dtype=dt)
        do = rn(B, Hq, S, D, dtype=dt)
        got = grads(lambda a, b, c: ca.ccm_attention(a, b, c, *meta, D ** -0.5),
                    q, k, v, do)
        want = grads(lambda a, b, c: ca.plain(a, b, c, *meta, D ** -0.5),
                     q, k, v, do)
        torch.cuda.synchronize()
        for name, a, b in zip(("fwd", "dq", "dk", "dv"), got, want):
            top = b.float().abs().max().item()
            tol = 1e-4 * top if dt == torch.float32 else \
                2.0 ** (-6 if name == "fwd" else -5) * top
            check(f"ccm_attention {name} B{B} GQA {Hq}/{Hkv} hd{D} S{S} "
                  f"{str(dt)[6:]} {kind}", max_err(a, b), tol)
        if not bool((got[0][:, :, 5] == 0).all()):
            raise AssertionError("fully masked row is not exactly 0")
    n_bf = sum(c[4] == bf for c in cases)
    if (ca.mma_launches - mma0[0], ca.bwd_mma_launches - mma0[1]) \
            != (n_bf, n_bf):
        raise AssertionError("a bf16 case missed the tensor-core route")

    # -- the training shape: LLaMA-7B heads, concat layout, bf16; then
    #    the zoo's at the same layout: Gemma's MQA 8/1 at hd 256 and
    #    Qwen2's GQA 14/2 at hd 64; then zamba2-1.2b's shared attention
    #    (MHA 32/32 hd 64) at its training layout (phase 11c, S 1152); then
    #    whisper-tiny's encoder (MHA 6/6 hd 64 over its 1500 frames, every
    #    key a <COMP> key at index 0 of segment 0: bidirectional)
    fwd_row, bwd_row = timed_ccm(torch, F, ca, segment_layout, card, rn,
                                 32, 32, 128)
    zoo = []
    for Hq, Hkv, D, lay, tag in ((8, 1, 256, ZOO_LAYOUT, ""),
                                 (14, 2, 64, ZOO_LAYOUT, ""),
                                 (32, 32, 64, ZAMBA_LAYOUT, " zamba2"),
                                 (6, 6, 64, WHISPER_FRAMES,
                                  " whisper encoder"),
                                 # phase 14's shard shapes: a LLaMA-7B
                                 # rank's heads at n = 2, 4, 8
                                 (16, 16, 128, ZOO_LAYOUT, " TP n=2"),
                                 (8, 8, 128, ZOO_LAYOUT, " TP n=4"),
                                 (4, 4, 128, ZOO_LAYOUT, " TP n=8"),
                                 # phase 15's: phi3.5-moe's 32/8 heads at
                                 # n = 4
                                 (8, 2, 128, ZOO_LAYOUT, " MoE TP n=4"),
                                 # phase 16's: whisper-tiny's encoder at n
                                 # = 2, zamba2-1.2b's site at n = 2 and 4,
                                 # pixtral-12b's 32/8 at n = 8
                                 (3, 3, 64, WHISPER_FRAMES,
                                  " whisper encoder TP n=2"),
                                 (16, 16, 64, ZAMBA_LAYOUT, " zamba2 TP n=2"),
                                 (8, 8, 64, ZAMBA_LAYOUT, " zamba2 TP n=4"),
                                 (4, 1, 128, ZOO_LAYOUT,
                                  " pixtral TP n=8"),
                                 # phase 20: the paper loop's training step
                                 # (bench_cfg, float32: B32 x S 48) and
                                 # LLaMA-7B's adapter step at its comp_len
                                 # 8 and 16 steps (B32 x S 264, bf16)
                                 (4, 2, 32, BENCH_LAYOUT, " bench f32"),
                                 (32, 32, 128, P20_FULL_LAYOUT,
                                  " paper loop")):
        B = 32 if lay in (BENCH_LAYOUT, P20_FULL_LAYOUT) else 4
        dt = "float32" if lay == BENCH_LAYOUT else "bfloat16"
        f, b = timed_ccm(torch, F, ca, segment_layout, card, rn, Hq, Hkv, D,
                         lay, B=B, dt=dt)
        S = lay if isinstance(lay, int) else segment_layout(*lay).seq_len
        zoo += [dict(f, shape=f"forward B{B} S{S} {Hq}/{Hkv} hd{D}{tag}"),
                dict(b, shape=f"backward B{B} S{S} {Hq}/{Hkv} hd{D}{tag}")]
    ccm_plan_cache(torch, ca, segment_layout, rn)
    fwd_row["shapes"] = [r for r in zoo if r["shape"].startswith("forward")]
    bwd_row["shapes"] = [r for r in zoo if r["shape"].startswith("backward")]
    return fwd_row, bwd_row


# the training layouts (t_steps, chunk, comp_len, tail): phases 5 and 9
# (S 1216), and zamba2-1.2b's in phase 11c (S 1152, nine SSD chunks of
# 128)
ZOO_LAYOUT = (16, 64, 8, 64)
ZAMBA_LAYOUT = (16, 56, 8, 128)
# whisper's encoder regime (phase 12): Whisper's published n_audio_ctx,
# 1500 frames, not a multiple of the 64-row tile
WHISPER_FRAMES = 1500
# phase 20's layouts: ``paper_loop.layout_for`` at bench_cfg's 4 steps of
# 8 + 2 <COMP> and an 8-token tail (S 48), and at LLaMA-7B's comp_len 8
# and max_steps 16 (S 264)
BENCH_LAYOUT = (4, 8, 2, 8)
P20_FULL_LAYOUT = (16, 8, 8, 8)


def ccm_plan_cache(torch, ca, segment_layout, rn):
    """The bf16 route's plan cache across one run of the paper loop at
    LLaMA-7B's heads, in its order: the training layout (t = 16, B32),
    the eval's t = 1 and t = 4 (B16), then the training layout and t = 1
    again, each with metadata built anew as ``train_forward`` builds it
    and each layout called twice (the second call is served from the
    cache, as a model's second layer is): forward and gradients held to
    the plain version at ``timed_ccm``'s bf16 tolerances."""
    dev = "cuda"
    mma0 = (ca.mma_launches, ca.bwd_mma_launches)
    for t, B in ((16, 32), (1, 16), (4, 16), (16, 32), (1, 16)):
        lay = segment_layout(t, *P20_FULL_LAYOUT[1:])
        S = lay.seq_len
        idx, seg, comp = ccm_meta(torch, lay, dev)
        meta = (idx, seg, idx, seg, comp, None)
        x = [rn(B, 32, S, 128, dtype=torch.bfloat16) for _ in range(4)]
        want = None
        for call in ("built", "cached"):
            q, k, v = (y.detach().requires_grad_(True) for y in x[:3])
            got = ca.ccm_attention(q, k, v, *meta, 128 ** -0.5)
            got = (got,) + torch.autograd.grad(got, (q, k, v), x[3])
            if want is None:
                q, k, v = (y.detach().requires_grad_(True) for y in x[:3])
                want = ca.plain(q, k, v, *meta, 128 ** -0.5)
                want = (want,) + torch.autograd.grad(want, (q, k, v), x[3])
            torch.cuda.synchronize()
            for name, a, b in zip(("fwd", "dq", "dk", "dv"), got, want):
                check(f"ccm_attention plan cache t={t} B{B} S{S} {call} "
                      f"{name}", max_err(a, b), 2.0 ** (-6 if name == "fwd"
                                                       else -5)
                      * b.float().abs().max().item())
        del x, got, want
    if (ca.mma_launches - mma0[0], ca.bwd_mma_launches - mma0[1]) != (10, 10):
        raise AssertionError("plan cache: a call missed the tensor-core route")


def timed_ccm(torch, F, ca, segment_layout, card, rn, Hq, Hkv, D,
              layout=ZOO_LAYOUT, B=4, dt="bfloat16"):
    """CCM attention at a training shape (B lanes; by default the concat
    layout of 16 steps of 64 + 8 <COMP> and a 64-token tail, S 1216) with
    Hq query and Hkv key/value heads of width D, bf16: forward and
    backward held to the plain version, then each timed beside it, SDPA
    with the CCM mask (``enable_gqa`` where Hq > Hkv) and the bound.
    ``layout`` an int S is the encoder regime: every key a <COMP> key at
    index 0 of segment 0, so every query sees every key, and the library
    call is SDPA without a mask.  ``dt`` "float32" takes the CUDA-core
    route (held at 1e-4 x max|plain|, bound at the float32 rate; it builds
    no plan).  Returns the (forward, backward) rows."""
    dev = "cuda"
    encoder = isinstance(layout, int)
    if encoder:
        S = layout
        idx = seg = torch.zeros(S, device=dev, dtype=torch.int32)
        comp = torch.ones(S, device=dev, dtype=torch.bool)
    else:
        lay = segment_layout(*layout)
        S = lay.seq_len
        idx, seg, comp = ccm_meta(torch, lay, dev)
    H = Hq
    gqa = Hq != Hkv
    bf = getattr(torch, dt)
    f32 = bf == torch.float32
    es = torch.finfo(bf).bits // 8
    tag = (f"B{B} {Hq}/{Hkv} S{S} hd{D}{' encoder' if encoder else ''}"
           f"{' float32' if f32 else ''}")
    meta = (idx, seg, idx, seg, comp, None)
    scale = D ** -0.5
    # 4 sets (LLaMA-7B: 4 x 160 MB > L2)
    sets = [(rn(B, Hq, S, D, dtype=bf), rn(B, Hkv, S, D, dtype=bf),
             rn(B, Hkv, S, D, dtype=bf), rn(B, Hq, S, D, dtype=bf))
            for _ in range(4)]

    def grads(fn, q, k, v, do):
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = fn(q, k, v)
        return (out,) + torch.autograd.grad(out, (q, k, v), do)

    q, k, v, do = sets[0]
    got = grads(lambda a, b, c: ca.ccm_attention(a, b, c, *meta, scale),
                q, k, v, do)
    want = grads(lambda a, b, c: ca.plain(a, b, c, *meta, scale), q, k, v, do)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("fwd", "dq", "dk", "dv"), got, want):
        errs[name] = max_err(a, b)
        top = b.float().abs().max().item()
        check(f"ccm_attention {name} {tag}{'' if f32 else ' bf16'} "
              "(training shape)", errs[name],
              1e-4 * top if f32 else 2.0 ** (-6 if name == "fwd" else -5) * top)
    del got, want
    # the (q, k) pairs the CCM mask lets through: the work this data needs
    mask = (idx[None, :] <= idx[:, None]) \
        & ((seg[None, :] == seg[:, None]) | comp[None, :])
    pairs = int(mask.sum().item()) * B * H
    if encoder:
        if pairs != B * H * S * S:
            raise AssertionError(f"{tag}: the encoder mask hides a pair")
        mask = None              # the same function: SDPA with no mask
    if (Hq, Hkv, D, B) == (32, 32, 128, 4) and layout == ZOO_LAYOUT:
        nq, nk = -(-S // 16), -(-S // 32)  # the float32 route's 16 x 32 tiles
        padded = torch.zeros(nq * 16, nk * 32, dtype=torch.bool, device=dev)
        padded[:S, :S] = mask
        kept = int(padded.reshape(nq, 16, nk, 32).any(3).any(1).sum().item())
        pl = ca.plan(*meta, B, S, S, dev)
        nat = int(pl.k_count[:, :pl.nk].sum().item())
        cmp_ = int(pl.k_count[:, pl.nk:].sum().item())
        log(f"  ccm_attention training shape: {pairs / (B * H * S * S):.4f} "
            f"of the S x S pairs visible; the float32 route's tile skip "
            f"keeps {kept} of {nq * nk} 16 x 32 tiles, the bf16 route's two "
            f"streams {nat} natural + {cmp_} <COMP> = {nat + cmp_} of "
            f"{pl.nq * pl.nk} 64 x 64 tiles "
            f"({pairs / (B * H) / ((nat + cmp_) * 64 * 64):.3f} of their "
            "pairs visible)")
    plan_ms = None
    if not f32:
        plan_ms = device_ms(torch, lambda i: ca.plan(*meta, B, S, S, dev), 10)
        log(f"  ccm_attention plan() at {tag}: {plan_ms:.4f} ms device, built "
            f"once per set of metadata [{card}]")

    def fwd_k(i):
        return ca.ccm_attention_fwd(*sets[i % 4][:3], *meta, scale)

    def fwd_p(i):
        return ca.plain(*sets[i % 4][:3], *meta, scale)

    def fwd_l(i):
        return F.scaled_dot_product_attention(*sets[i % 4][:3],
                                              attn_mask=mask, scale=scale,
                                              enable_gqa=gqa)
    t_f = timings(torch, fwd_k, "ccm_attention_fwd", fwd_p, fwd_l)
    qo = 2 * B * Hq * S * D                       # q and o (or dO, dq)
    kv = 2 * B * Hkv * S * D                      # k and v (or dk, dv)
    nb = es * (qo + kv) + 4 * B * Hq * S          # + the log-sum-exp
    peak = PEAK_F32 if f32 else PEAK_BF16
    bms, by = bound(nb, 4.0 * D * pairs, peak)
    report(f"ccm_attention forward {tag} (library: SDPA with the CCM mask)",
           t_f, bms, by, card)
    fwd_row = dict(max_abs_err=errs["fwd"], ms=t_f["ms"],
                   plain_ms=t_f["plain_ms"], library_ms=t_f["library_ms"],
                   bound_ms=bms, bound_by=by, plan_ms=plan_ms)
    log(f"  ccm_attention forward {tag}: {bms / t_f['ms']:.3f} of the bound, "
        f"{t_f['library_ms'] / t_f['ms']:.2f}x the library's speed [{card}]")

    # backward only: the graphs are built once, outside the timing
    saved = []
    for qq, kk, vv, dd in sets:
        o, lse = ca.ccm_attention_fwd(qq, kk, vv, *meta, scale)
        saved.append((qq, kk, vv, o, lse, dd))
    # two backward calls on the same inputs are bit-equal (no atomics)
    g1 = ca.ccm_attention_bwd(*saved[0], *meta, scale)
    g2 = ca.ccm_attention_bwd(*saved[0], *meta, scale)
    if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        raise AssertionError(f"ccm_attention backward {tag}: two calls "
                             "differ")
    log(f"  ccm_attention backward {tag}: two calls on the same inputs "
        "bit-equal")
    del g1, g2

    def retained(fn):
        out = []
        for qq, kk, vv, dd in sets:
            xs = [x.detach().requires_grad_(True) for x in (qq, kk, vv)]
            out.append((fn(*xs), xs, dd))
        return out
    plain_g = retained(lambda a, b, c: ca.plain(a, b, c, *meta, scale))

    def bwd_k(i):
        return ca.ccm_attention_bwd(*saved[i % 4], *meta, scale)

    def bwd_p(i):
        o, xs, dd = plain_g[i % 4]
        return torch.autograd.grad(o, xs, dd, retain_graph=True)
    t_pb = dict(plain_ms=device_ms(torch, bwd_p, 5))
    del plain_g
    lib_g = retained(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=mask, scale=scale, enable_gqa=gqa))

    def bwd_l(i):
        o, xs, dd = lib_g[i % 4]
        return torch.autograd.grad(o, xs, dd, retain_graph=True)
    t_b = dict(ms=device_ms(torch, bwd_k, 20, only="ccm_attention_bwd"),
               call_ms=time_ms(torch, bwd_k, 20),
               library_ms=device_ms(torch, bwd_l, 20), **t_pb)
    del lib_g
    # q k v o dO -> dq dk dv, the log-sum-exp and the row sums of dO * O
    nb = es * (2 * qo + 2 * kv) + 8 * B * Hq * S
    bms, by = bound(nb, 10.0 * D * pairs, peak)
    report(f"ccm_attention backward {tag} (library: SDPA backward)", t_b,
           bms, by, card)
    log(f"  ccm_attention backward {tag}: {bms / t_b['ms']:.3f} of the "
        f"bound, {t_b['library_ms'] / t_b['ms']:.2f}x the library's speed "
        f"[{card}]")
    bwd_row = dict(max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                   ms=t_b["ms"], plain_ms=t_b["plain_ms"],
                   library_ms=t_b["library_ms"], bound_ms=bms, bound_by=by)
    del sets, saved
    torch.cuda.empty_cache()
    return fwd_row, bwd_row


def windows(torch, fn, only=None, n: int = 3, iters: int = 20):
    """(median, min, max) of the device ms per call over ``n`` profiler
    windows (``device_ms``): one window can read 10% slow."""
    ts = sorted(device_ms(torch, fn, iters, only=only) for _ in range(n))
    return ts[n // 2], ts[0], ts[-1]


def check_kv_cummean(torch, kvm, card):
    """Kernel 5, one launch for the k + v groups of a layer, forward and
    reverse (autograd), against the plain versions: float32 within 1e-6 x
    max|want|, bf16 within bf16_tol (both accumulate in float32 and round
    once; the kernel multiplies by 1/(t+1) where the plain version
    divides).  Each case asserts its route (the vector width) and one
    launch per direction.  Cases: the training pair read in place from
    the strided <COMP> groups of two (B, S, H, D) activations, with
    gradients sliced out of a larger one (as torch.cat's backward gives
    them); contiguous float32 pairs; the single (1, 16, 131072) tensor;
    T = 1 and T = 37; R = 185 and a base 2 bytes off 16-byte alignment
    (the one-element path).  Then times, as the median of three profiler
    windows with the min-max beside it, the pair forward and reverse at
    the training shape and the single tensor, each against its bytes
    bound and the library calls.  Returns the forward's and the
    reverse's rows."""
    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(6)
    T, B, m, H, D, lc = 16, 4, 8, 32, 128, 64
    R = m * H * D                      # 32768 columns of a <COMP> group
    S = T * (lc + m) + 64              # the training layout, S = 1216

    def rn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs, errs_r = [], []

    def case(name, hs, gs, vec):
        width = kvm.cummean_vector_width(hs)
        if width != vec:
            raise AssertionError(f"kv_cummean {name}: vector width {width}, "
                                 f"want {vec}")
        xs = [h.detach().requires_grad_(True) for h in hs]  # same strides
        before = (kvm.cummean_launches, kvm.cummean_bwd_launches)
        outs = kvm.kv_cummean(*xs)
        dhs = torch.autograd.grad(outs, xs, gs)
        torch.cuda.synchronize()
        after = (kvm.cummean_launches, kvm.cummean_bwd_launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 1):
            raise AssertionError(f"kv_cummean {name}: launches {before} -> "
                                 f"{after}, want one per direction")
        for h, gr, out, dh in zip(hs, gs, outs, dhs):
            want = kvm.plain_cummean(h, 1)
            dwant = kvm.plain_reverse(gr, 1)
            tol = bf16_tol if h.dtype == bf \
                else (lambda w: 1e-6 * w.abs().max().item())
            errs.append(max_err(out, want))
            errs_r.append(max_err(dh, dwant))
            check(f"kv_cummean forward {name} (width {width})", errs[-1],
                  tol(want))
            check(f"kv_cummean reverse {name} (width {width})", errs_r[-1],
                  tol(dwant))

    def groups(x, lc=lc):
        """The (B, T, m*H*D) <COMP> groups of x (B, S, H, D), in place."""
        Hx, Dx = x.shape[2:]
        return x[:, :T * (lc + m)].reshape(B, T, lc + m, Hx * Dx)[
            :, :, lc:].flatten(2)

    def cat_grad(S=S, H=H, D=D):
        """The slot part of the gradient of cat([slots, raw], 1)."""
        full = rn(B, T * m + S, H, D)
        return full[:, :T * m].reshape(B, T, m * H * D)

    case(f"k+v <COMP> groups of (B, S, H, D) = {(B, S, H, D)}, gradient "
         f"sliced from cat's", [groups(rn(B, S, H, D)) for _ in range(2)],
         [cat_grad(), cat_grad()], 8)
    # zamba2-1.2b's training layout (16, 56, 8, 128): S 1152, MHA 32 x 64
    ZT, zlc, ZH, ZD = ZAMBA_LAYOUT[0], ZAMBA_LAYOUT[1], 32, 64
    ZS, ZR = ZT * (zlc + m) + ZAMBA_LAYOUT[3], m * ZH * ZD
    case(f"k+v <COMP> groups of (B, S, H, D) = {(B, ZS, ZH, ZD)} "
         "(zamba2-1.2b), gradient sliced from cat's",
         [groups(rn(B, ZS, ZH, ZD), zlc) for _ in range(2)],
         [cat_grad(ZS, ZH, ZD), cat_grad(ZS, ZH, ZD)], 8)
    case(f"k+v {(B, T, R)} float32", [rn(B, T, R, dtype=f32)
                                      for _ in range(2)],
         [rn(B, T, R, dtype=f32) for _ in range(2)], 4)
    for dt, vec in ((bf, 8), (f32, 4)):
        case(f"single (1, {T}, {B * R}) {str(dt)[6:]}",
             [rn(1, T, B * R, dtype=dt)], [rn(1, T, B * R, dtype=dt)], vec)
    case(f"k+v T=1 {(B, 1, R)}", [rn(B, 1, R) for _ in range(2)],
         [rn(B, 1, R) for _ in range(2)], 8)
    case("k+v T=37 (2, 37, 4096)", [rn(2, 37, 4096) for _ in range(2)],
         [rn(2, 37, 4096) for _ in range(2)], 8)
    case("k+v R=185 (3, 37, 185)", [rn(3, 37, 185) for _ in range(2)],
         [rn(3, 37, 185) for _ in range(2)], 1)
    n = B * T * 4096
    case("k+v, k 2 bytes off 16-byte alignment (4, 16, 4096)",
         [rn(n + 1)[1:].view(B, T, 4096), rn(B, T, 4096)],
         [rn(B, T, 4096) for _ in range(2)], 1)

    # timing: 8 pairs of 4 MiB tensors in turn, more than the 50 MB L2
    sets = [(rn(B, T, R), rn(B, T, R)) for _ in range(8)]
    ar = torch.arange(1, T + 1, device=dev, dtype=f32)[:, None]

    def lib_fwd(x):
        return torch.cumsum(x.float(), 1) / ar

    def lib_rev(x):
        return torch.cumsum((x.float() / ar).flip(1), 1).flip(1)

    def timed(label, kern, plain, library, nb, n_el):
        ms, lo, hi = windows(torch, kern, "kv_cummean_kernel")
        lib, lib_lo, lib_hi = windows(torch, library)
        t = dict(ms=ms, ms_min=lo, ms_max=hi,
                 call_ms=time_ms(torch, kern, 20),
                 plain_ms=device_ms(torch, plain, 10), library_ms=lib)
        bms, by = bound(nb, 2.0 * n_el, PEAK_F32)
        report(label, t, bms, by, card)
        log(f"    median of 3 windows {ms:.4f} ms (min {lo:.4f}, max "
            f"{hi:.4f}), library {lib:.4f} ({lib_lo:.4f}-{lib_hi:.4f}): "
            f"{bms / ms:.3f} of the bound, {lib / ms:.2f}x the library's "
            f"speed [{card}]")
        return dict(ms=ms, ms_min=lo, ms_max=hi, plain_ms=t["plain_ms"],
                    library_ms=lib, bound_ms=bms, bound_by=by)

    n_el = 2 * B * T * R
    fwd = timed(
        f"kv_cummean k+v {(B, T, R)} bf16 (library: two torch.cumsum("
        f"h.float(), 1) / arange)",
        lambda i: kvm.kv_cummean_launch(sets[i % 8]),
        lambda i: [kvm.plain_cummean(x, 1) for x in sets[i % 8]],
        lambda i: [lib_fwd(x) for x in sets[i % 8]], 2 * n_el * 2, n_el)
    rev = timed(
        f"kv_cummean reverse k+v {(B, T, R)} bf16 (library: two "
        f"torch.cumsum of g / (t+1) flipped along T)",
        lambda i: kvm.kv_cummean_launch(sets[i % 8], reverse=True),
        lambda i: [kvm.plain_reverse(x, 1) for x in sets[i % 8]],
        lambda i: [lib_rev(x) for x in sets[i % 8]], 2 * n_el * 2, n_el)
    singles = [x.view(1, T, B * R) for pair in sets for x in pair]
    n_el = T * B * R
    single = [timed(
        f"kv_cummean{name} single (1, {T}, {B * R}) bf16",
        lambda i: kvm.kv_cummean_launch([singles[i % 16]], reverse=r),
        lambda i: plain(singles[i % 16], 1),
        lambda i: lib(singles[i % 16]), 2 * n_el * 2, n_el)
        for name, r, plain, lib in (
            ("", False, kvm.plain_cummean, lib_fwd),
            (" reverse", True, kvm.plain_reverse, lib_rev))]
    del sets, singles
    # zamba2-1.2b's pair, read in place from the <COMP> groups of its
    # S 1152 layout as its merge training step reads them (4 sets of two
    # 18.9 MB activations rotate past the L2)
    zsets = [tuple(groups(rn(B, ZS, ZH, ZD), zlc) for _ in range(2))
             for _ in range(4)]
    n_el = 2 * B * ZT * ZR
    zamba = [timed(
        f"kv_cummean{name} k+v {(B, ZT, ZR)} bf16 from the <COMP> groups of "
        f"{(B, ZS, ZH, ZD)} (zamba2-1.2b)",
        lambda i: kvm.kv_cummean_launch(zsets[i % 4], reverse=r),
        lambda i: [plain(x, 1) for x in zsets[i % 4]],
        lambda i: [lib(x) for x in zsets[i % 4]], 2 * n_el * 2, n_el)
        for name, r, plain, lib in (
            ("", False, kvm.plain_cummean, lib_fwd),
            (" reverse", True, kvm.plain_reverse, lib_rev))]
    del zsets
    zshape = f"k+v {(B, ZT, ZR)} bf16 (zamba2-1.2b, strided)"
    zamba[0].update(shape=zshape, max_abs_err=max(errs[2:4]))
    zamba[1].update(shape=zshape, max_abs_err=max(errs_r[2:4]))
    fwd.update(max_abs_err=max(errs), shape=f"k+v {(B, T, R)} bf16",
               single=single[0], shapes=[zamba[0]])
    rev.update(max_abs_err=max(errs_r), shape=f"k+v {(B, T, R)} bf16",
               single=single[1], shapes=[zamba[1]])
    return fwd, rev


def check_cond_lora_grad(torch, clora, card):
    """cond_lora under autograd (kernel forward, matmul backward) against
    autograd through the plain version: dx, dW (full training), dA, dB
    and dbias."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    for M, K, N, dt in ((288, 512, 384, torch.float32),
                        (4 * 1216, 4096, 4096, torch.bfloat16)):
        def rn(*shape, std=1.0):
            return (torch.randn(shape, generator=g, device=dev) * std).to(dt)
        x, w = rn(M, K), rn(K, N, std=K ** -0.5)
        a, b = rn(8, K, std=K ** -0.5), rn(8, N, std=0.05)
        bias, dy = rn(N), rn(M, N)
        gate = ((torch.arange(M, device=dev) % 72) >= 64).float()
        res = []
        for fn in (clora.cond_lora, clora.plain):
            xs = [t.detach().requires_grad_(True)
                  for t in (x, w, a, b, bias)]
            y = fn(*xs[:4], gate, 2.0, xs[4])
            res.append(torch.autograd.grad(y, xs, dy))
        torch.cuda.synchronize()
        for name, got, want in zip(("dx", "dW", "dA", "dB", "dbias"), *res):
            top = want.float().abs().max().item()
            # bf16: the base product dy @ W^T is rounded to bf16 before the
            # LoRA term is added, then the sum is rounded again (4 ulps)
            tol = 1e-4 * top if dt == torch.float32 else 2.0 ** -5 * top
            check(f"cond_lora autograd {name} M{M} K{K} N{N} {str(dt)[6:]}",
                  max_err(got, want), tol)


# ---------------------------------------------------------------------------
# phase 3: the main path at full width and depth
# ---------------------------------------------------------------------------

def profile_window(torch, fn, label: str, card: str, warmup: bool = True,
                   stats: dict = None):
    """Device busy time, span and top kernels of one call of ``fn`` under
    ``torch.profiler`` (after one warm-up call unless ``warmup`` is
    False); returns {kernel name: device ms} (None when the profiler
    recorded no device event) and, with ``stats``, stores busy_ms,
    span_ms and idle there.  The profiler's own host overhead stretches
    the span, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not evs:
        log(f"  profile {label}: no device events recorded (not measured)")
        return None
    busy = sum(e.duration_ns() for e in evs) / 1e6
    span = (max(e.end_ns() for e in evs) - min(e.start_ns() for e in evs)) / 1e6
    by_name = {}
    for e in evs:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    log(f"  profile {label}: device busy {busy:.3f} ms of a {span:.3f} ms "
        f"span, idle share {1 - busy / span:.3f}, {len(evs)} device events "
        f"[{card}]")
    if stats is not None:
        stats.update(busy_ms=busy, span_ms=span, idle=1 - busy / span)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    return by_name

def randomize_lora_b(torch, params, seed: int, std: float = 0.05):
    """The reference initialises LoRA b = 0, which would leave the gate
    unexercised: draw it at random (comp_embed is random already).  The
    hybrid's LoRA is its shared attention block's."""
    lora = params.get("shared_attn", params["layers"])["attn"]["lora"]
    for i, name in enumerate(("q", "k", "v", "o")):
        b = lora[name]["b"]
        gen = torch.Generator(device=b.device).manual_seed(seed + i)
        b.copy_(torch.randn(b.shape, generator=gen, device=b.device) * std)


def clone_state(torch, st):
    def c(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_replace"):
            return type(x)(*[c(y) for y in x])
        return x
    return c(st)


def f32_cast_ms(by_name) -> float:
    """Device ms of the copy kernels that read float32 (their element
    lambda takes a ``float``): the casts of float32 weights to the bf16
    compute dtype, with the few small float32 activation casts (norm
    outputs) beside them."""
    return sum(ms for name, ms in (by_name or {}).items()
               if "copy" in name and "(float)" in name)


def main_path(torch, PI, ops, params, cfg, mode, cache_dtype, card,
              profile: bool = False, record: dict = None,
              prompt_len: int = 448, cache_len: int = 512, cross=None,
              patches=None, tag: str = ""):
    """B=4 lanes, 4 ingests of 64-token contexts, a ``prompt_len``-token
    prefill (448) into a ``cache_len``-token cache (512) and 32 greedy
    tokens (twice: the explicit loop and ``generate``), with the launches
    of every kernel held to what the path implies; with ``record``, host
    ms per step kind (and, with ``profile``, the profiled decode steps'
    idle share and float32 cast share) are stored there.  ``cross``
    (encdec) starts the state with the encoder's cross K/V; ``patches``
    (vlm) go into the prefill, and ``generate`` (which takes none, as
    the reference's) then runs the same prompt as text only and is held
    to in-vocabulary tokens, not to the loop's.  Messages start with
    ``tag``.  Returns the launch counts."""
    B, T, LC, PROMPT, CACHE, NEW = 4, 4, 64, prompt_len, cache_len, 32
    ccm = dataclasses.replace(cfg.ccm, mode=mode)
    rcfg = cfg.replace(kv_cache_dtype=cache_dtype, ccm=ccm)
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(11)
    chunks = [torch.randint(0, cfg.vocab_size, (B, LC), generator=gen,
                            device=dev) for _ in range(T)]
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                           device=dev)
    st = PI.init_online_state(rcfg, B, CACHE, device=dev)._replace(
        cross=cross)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ingest_ms = []
    for ch in chunks:
        t0 = time.perf_counter()
        st = PI.ingest_context(params, rcfg, st, ch)
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
    st_ingested = clone_state(torch, st)
    t0 = time.perf_counter()
    logits, st = PI.prefill(params, rcfg, st, prompt, patches=patches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks = [logits[:, -1].argmax(-1)]
    finite = bool(torch.isfinite(logits).all())
    t0 = time.perf_counter()
    for _ in range(NEW - 1):
        lg, st = PI.decode_step(params, rcfg, st, toks[-1][:, None])
        finite &= bool(torch.isfinite(lg).all())
        toks.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    manual = torch.stack(toks, 1).to(torch.int32)
    t0 = time.perf_counter()
    gen_toks = PI.generate(params, rcfg, st_ingested, prompt, NEW)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()

    name = f"{tag}{mode}+{cache_dtype}"
    if not finite:
        raise AssertionError(f"{name}: non-finite logits")
    if patches is not None:
        if gen_toks.shape != manual.shape or not bool(
                ((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
            raise AssertionError(f"{name}: text-only generate tokens")
    elif not torch.equal(gen_toks, manual):
        raise AssertionError(f"{name}: generate tokens differ from the "
                             "prefill + decode_step loop")
    L, m = cfg.n_layers, cfg.ccm.comp_len
    # one attend per layer per pass: T ingests, then prefill + NEW - 1
    # decode steps twice (the explicit loop and generate); one merge
    # launch (k and v together) per ingest in merge mode
    want_counts = {k: 0 for k in counts}
    # the attends of ingest (Sq 72) and prefill (Sq 448) take the mma.sync
    # route, decode steps the split-K route; every cond_lora is bf16 (wgmma)
    want_counts.update({"segmented_attention": L * (T + 2 * NEW),
                        "segmented_attention_mma": L * (T + 2),
                        "segmented_attention_splitk": L * 2 * (NEW - 1),
                        "cond_lora": 4 * L * T, "cond_lora_wgmma": 4 * L * T,
                        "kv_merge_update": T if mode == "merge" else 0})
    if counts != want_counts:
        raise AssertionError(f"{name}: launches {counts} != {want_counts}")
    mem, cache = st.mem, st.cache
    want_state = dict(pos=T * (LC + m) + PROMPT + NEW - 1,
                      slots=T if mode == "concat" else 1, steps=T,
                      stream_pos=T * (LC + m), length=PROMPT + NEW - 1)
    got_state = dict(pos=st.pos, slots=mem.slots, steps=mem.steps,
                     stream_pos=mem.stream_pos, length=cache.length)
    if got_state != want_state:
        raise AssertionError(f"{name}: state {got_state} != {want_state}")
    M = (cfg.ccm.max_steps if mode == "concat" else 1) * m
    shapes = {"mem.k": (L, B, M, cfg.n_kv_heads, cfg.hd),
              "cache.k": (L, B, CACHE, cfg.n_kv_heads, cfg.hd)}
    if tuple(mem.k.shape) != shapes["mem.k"] or \
            tuple(cache.k.shape) != shapes["cache.k"]:
        raise AssertionError(f"{name}: state shapes {mem.k.shape} "
                             f"{cache.k.shape}")
    if cache_dtype == "int8" and cache.k.dtype != torch.int8:
        raise AssertionError("int8 cache is not int8")
    log(f"  {name}: ingest ms {[round(t, 2) for t in ingest_ms]}, prefill "
        f"{PROMPT} tok x {B} {prefill_ms:.2f} ms, decode "
        f"{B * (NEW - 1) / decode_ms * 1e3:.2f} tok/s ({decode_ms / (NEW - 1):.2f} "
        f"ms/step), generate {B * NEW / generate_ms * 1e3:.2f} tok/s "
        f"({generate_ms:.1f} ms) [{card}]")
    log(f"  {name}: launches {counts} (as the path implies)")
    if record is not None:
        record.update(ingest_ms=ingest_ms, prefill_ms=prefill_ms,
                      decode_ms=decode_ms / (NEW - 1),
                      generate_ms=generate_ms)
    if profile:         # after the counts: these launches are not counted
        def decode3():
            nonlocal st
            for _ in range(3):
                _, st = PI.decode_step(params, rcfg, st, toks[-1][:, None])

        def ingest1():
            nonlocal st
            st = PI.ingest_context(params, rcfg, st, chunks[0])
        stats = {}
        by = profile_window(torch, decode3, f"{name} 3 decode steps", card,
                            stats=stats)
        if stats:
            cast = f32_cast_ms(by)
            stats.update(cast_ms=cast, cast_share=cast / stats["busy_ms"])
            log(f"  {name}: float32 -> bf16 copies {cast:.3f} ms of the "
                f"{stats['busy_ms']:.3f} busy ms of 3 decode steps "
                f"({stats['cast_share']:.3f}) [{card}]")
        if record is not None:
            record["decode_profile"] = stats
        profile_window(torch, ingest1, f"{name} 1 ingest", card)
    return counts


def fp32_layers(torch, tree, dev, n: int = 2, layers: bool = False):
    """A float32 copy on ``dev`` of a parameter tree cut to its first
    ``n`` layers."""
    if isinstance(tree, dict):
        return {k: fp32_layers(torch, v, dev, n, layers or k == "layers")
                for k, v in tree.items()}
    t = tree[:n] if layers else tree
    return t.detach().to(device=dev, dtype=torch.float32).contiguous()


# ---------------------------------------------------------------------------
# phase 4: the whole path, CUDA kernels vs CPU plain versions
# ---------------------------------------------------------------------------

def cross_check(torch, PI, params_bf16, cfg, devices=("cuda", "cpu")):
    B, T, LC, PROMPT, CACHE = 2, 17, 32, 64, 66
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32")

    runs = {}
    gen = torch.Generator().manual_seed(5)
    chunks = [torch.randint(0, c2.vocab_size, (B, LC), generator=gen)
              for _ in range(T)]
    prompt = torch.randint(0, c2.vocab_size, (B, PROMPT), generator=gen)
    forced = [torch.randint(0, c2.vocab_size, (B, 1), generator=gen)
              for _ in range(4)]
    for dev in devices:
        t0 = time.perf_counter()
        pp = fp32_layers(torch, params_bf16, dev)
        st = PI.init_online_state(c2, B, CACHE, device=dev)
        for ch in chunks:
            st = PI.ingest_context(pp, c2, st, ch.to(dev))
        logits = []
        lg, st = PI.prefill(pp, c2, st, prompt.to(dev), full_logits=True)
        logits.append(lg)
        for tok in forced:                  # teacher-forced decode
            lg, st = PI.decode_step(pp, c2, st, tok.to(dev))
            logits.append(lg)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (logits, st, time.perf_counter() - t0)
        del pp
    (lc, sc, tc), (lp, sp, tp) = (runs[d] for d in devices)
    worst = 0.0
    for i, (a, b) in enumerate(zip(lc, lp)):
        a = a.cpu()
        lim = 1e-3 * b.abs().max().item()
        err = max_err(a, b)
        worst = max(worst, err / lim)
        if not err <= lim:
            raise AssertionError(f"cross-check logits {i}: {err} > {lim}")
    leaves = {"mem.k": (sc.mem.k, sp.mem.k), "mem.v": (sc.mem.v, sp.mem.v),
              "cache.k": (sc.cache.k, sp.cache.k),
              "cache.v": (sc.cache.v, sp.cache.v)}
    for name, (a, b) in leaves.items():
        lim = 1e-3 * b.abs().max().item()
        err = max_err(a.cpu(), b)
        log(f"  cross-check {name}: max|d| {err:.3e} (limit {lim:.3e})")
        if not err <= lim:
            raise AssertionError(f"cross-check {name}: {err} > {lim}")
    ints_c = (sc.pos, sc.mem.slots, sc.mem.steps, sc.mem.stream_pos,
              sc.cache.length)
    ints_p = (sp.pos, sp.mem.slots, sp.mem.steps, sp.mem.stream_pos,
              sp.cache.length)
    if ints_c != ints_p or sc.mem.slots != cfg.ccm.max_steps:
        raise AssertionError(f"cross-check counters {ints_c} vs {ints_p}")
    log(f"  cross-check 2 layers fp32, {T} ingests (concat clamp fired: slots "
        f"{sc.mem.slots}/{cfg.ccm.max_steps}), prefill {PROMPT}, 4 forced "
        f"decode steps (cache length {sc.cache.length} > {CACHE}): worst "
        f"logits max|d| / (1e-3 max|logit|) = {worst:.3f}; cuda {tc:.1f} s, "
        f"cpu {tp:.1f} s")


# ---------------------------------------------------------------------------
# phase 5: training at full width and depth
# ---------------------------------------------------------------------------

def train_steps(torch, ops, clora, TR, PD, PA, PP, segment_layout, params,
                cfg, card, modes, label: str, layout=ZOO_LAYOUT, extra=None):
    """AdamW steps through ``make_train_step``, one per entry of ``modes``
    ("concat", "merge", or the paper's baselines "gisting" and
    "compressive", which take precedence over the mode), with the
    config's own ``train_mode`` (B=4, by default the layout of 16 steps
    of 64 + 8 <COMP> and a 64-token tail, S=1216; the kernels launch at
    the attention layers, none for mamba2-370m and at the 6 shared sites
    for zamba2-1.2b): each step's launches held to
    the path's, every trainable leaf moved at every step (seen on a
    strided sample of at most 2^20 of its elements: no second copy of a
    model's parameters) and every frozen leaf bitwise unchanged.
    Compressive pools raw tokens only, so the <COMP> rows where the LoRA
    fires reach no loss position: under LoRA-only training its gradient
    norm must be exactly 0 and every trainable leaf bitwise unchanged,
    as in the reference.  ``extra`` adds the family's inputs to the batch
    (``frames`` for encdec, whose encoder attends through the CCM kernel
    in every mode, ``patches`` for vlm).  Returns a namespace with the step functions
    and configs by mode, the partition, the optimizer state, the batch
    and layout, the launch counts and {step_ms, peak_gib, losses,
    grad_norms, backward_calls}."""
    from repro_torch.core.memory import mem_layers
    dev = params["embed"].device
    layout = segment_layout(*layout)
    B = 4
    batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, B).key_for(0),
                               layout, B, device=dev)
    batch.update(extra or {})
    tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
    opt = PA.init_adamw(tp)
    # lr 1e-3 from step 1: an update of ~lr moves every bf16 comp_embed
    # value (|x| ~ 0.02, one bf16 ulp ~ 1.2e-4)
    ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    cfgs = {"concat": cfg, "merge": cfg.replace(ccm=dataclasses.replace(
        cfg.ccm, mode="merge", merge_alpha=None))}
    for method in ("gisting", "compressive"):
        cfgs[method] = cfg.replace(ccm=dataclasses.replace(cfg.ccm,
                                                           method=method))
    fns = {m: TR.make_train_step(cfgs[m], layout, ocfg) for m in set(modes)}
    L = mem_layers(cfg)                   # the attention layers
    lora = {"cond_lora": 4 * 2 * L, "cond_lora_wgmma": 4 * 2 * L}
    # the encoder's layers (encdec): one CCM forward each, recomputed
    # and differentiated when its weights train
    E = cfg.n_enc_layers if cfg.family == "encdec" else 0
    Ef, Eb = (2 * E, E) if cfg.train_mode == "full" else (E, 0)
    enc = {"ccm_attention": Ef, "ccm_attention_backward": Eb,
           "ccm_attention_mma": Ef, "ccm_attention_backward_mma": Eb}
    want_step = {
        "concat": {"ccm_attention": 2 * L + Ef,
                   "ccm_attention_backward": L + Eb,
                   "ccm_attention_mma": 2 * L + Ef,
                   "ccm_attention_backward_mma": L + Eb, **lora},
        "merge": {"kv_cummean": 2 * L, "kv_cummean_backward": L, **lora,
                  **enc},
        # the baselines attend densely, as the reference does
        "gisting": lora, "compressive": lora}
    want_step = {m: {k: v for k, v in w.items() if v}
                 for m, w in want_step.items()}

    def sample(x):
        flat = x.detach().reshape(-1)
        return flat[::max(1, flat.numel() >> 20)].clone()
    # the frozen leaves' copy for the bitwise check lives on the card where
    # it takes at most half the free memory (LLaMA-7B's 12.6 GB beside a
    # step's 17.3 GiB peak), else on the host (phi3.5-moe's frozen leaves
    # at the 16 layers it had before ``FAM_DEPTH`` cut it to 4 would not
    # fit twice); the steps' peaks leave out its ``held`` bytes
    t0 = time.perf_counter()
    nbytes = sum(x.numel() * x.element_size() for _, x in PP.leaves(fp))
    keep = dev if nbytes <= torch.cuda.mem_get_info()[0] // 2 else "cpu"
    held = torch.cuda.memory_allocated()
    frozen0 = {"/".join(p): x.to(keep, copy=True) for p, x in PP.leaves(fp)}
    held = torch.cuda.memory_allocated() - held
    copy_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    clora.backward_calls = 0
    ms, losses, norms, bwd, peak = [], [], [], [], 0.0
    for i, mode in enumerate(modes):
        before = {"/".join(p): sample(x) for p, x in PP.leaves(tp)}
        c0, b0 = ops.launch_counts(), clora.backward_calls
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tp, opt, metrics, _ = fns[mode](tp, fp, opt, batch, None)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, (torch.cuda.max_memory_allocated() - held)
                   / 2 ** 30)
        c1 = ops.launch_counts()
        got = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        norms.append(metrics["grad_norm"].item())
        bwd.append(clora.backward_calls - b0)
        log(f"  {label} step {i + 1} ({mode}, {cfg.train_mode}): loss "
            f"{losses[-1]:.4f}, grad norm {norms[-1]:.4f}, {ms[-1]:.1f} ms, "
            f"peak {peak:.2f} GiB, launches {got}, cond_lora autograd "
            f"backwards {bwd[-1]} [{card}]")
        if got != want_step[mode] or not math.isfinite(losses[-1]):
            raise AssertionError(f"{label} step {i + 1}: loss {losses[-1]}, "
                                 f"launches {got} != {want_step[mode]}")
        still = [k for k, x in (("/".join(p), x) for p, x in PP.leaves(tp))
                 if torch.equal(sample(x), before[k])]
        if mode == "compressive" and cfg.train_mode == "lora":
            moved = sorted(set(before) - set(still))
            if norms[-1] != 0.0 or moved:
                raise AssertionError(f"{label} step {i + 1}: compressive "
                                     f"grad norm {norms[-1]}, LoRA leaves "
                                     f"moved {moved}; want 0 and none")
        elif still:
            raise AssertionError(f"{label} step {i + 1}: trainable leaves "
                                 f"unchanged {still}")
    t0 = time.perf_counter()
    for k, x in PP.leaves(fp):              # one leaf at a time on the card
        if not torch.equal(x, frozen0["/".join(k)].to(dev)):
            raise AssertionError(f"{label}: frozen leaf {'/'.join(k)} "
                                 "changed")
    copy_s += time.perf_counter() - t0
    if clora.backward_calls != len(modes) * 4 * L:
        raise AssertionError(f"{label}: cond_lora autograd backward ran "
                             f"{clora.backward_calls} times, want "
                             f"{len(modes) * 4 * L}")
    moved = "none of the" if "compressive" in modes \
        and cfg.train_mode == "lora" else "all"
    n_frozen = len(frozen0)
    del frozen0
    log(f"  {label}: {moved} {len(PP.leaves(tp))} trainable leaves moved "
        f"at every step, {n_frozen} frozen leaves bitwise unchanged "
        f"({'card' if keep == dev else 'host'} copy and compare {copy_s:.1f} s); opt step {opt.step}, peak "
        f"{peak:.2f} GiB")
    return types.SimpleNamespace(
        fns=fns, cfgs=cfgs, tp=tp, fp=fp, opt=opt, batch=batch,
        layout=layout, counts=ops.launch_counts(),
        record=dict(step_ms=ms, peak_gib=peak, losses=losses,
                    grad_norms=norms, backward_calls=bwd))


def train_phase(torch, ops, clora, TR, T, PD, PA, PP, segment_layout,
                params, cfg, card):
    """3 concat + 2 merge AdamW steps of LLaMA-7B (``train_steps``), then
    one gradient-free ``train_forward`` and one profiled step of each
    mode; returns the launch counts of the 5 steps."""
    run = train_steps(torch, ops, clora, TR, PD, PA, PP, segment_layout,
                      params, cfg, card, ["concat"] * 3 + ["merge"] * 2,
                      "train")
    batch, layout = run.batch, run.layout
    for mode, c in run.cfgs.items():
        with torch.no_grad():
            T.train_forward(params, c, batch["tokens"], layout)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = T.train_forward(params, c, batch["tokens"], layout)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(lg).all()) \
                or lg.shape != (4, 64, cfg.vocab_size):
            raise AssertionError(f"train_forward {mode}: bad logits")
        log(f"  train_forward {mode} (no grad, B4 S1216, tail logits): "
            f"{ms:.1f} ms [{card}]")
    # one profiled step of each mode (after the counts: not counted)
    for mode in ("concat", "merge"):
        by = profile_window(torch, lambda: run.fns[mode](
            run.tp, run.fp, run.opt, batch, None), f"1 {mode} train step",
            card)
        ccm = {n.split("<")[0].split()[-1]: ms for n, ms in (by or {}).items()
               if "ccm_attention" in n}
        if ccm:
            log(f"  CCM attention in the profiled {mode} step: "
                + ", ".join(f"{n} {ms:.3f} ms" for n, ms in sorted(ccm.items()))
                + f"; {sum(ccm.values()):.3f} ms in all [{card}]")
    return run.counts


# ---------------------------------------------------------------------------
# phase 6: training cross-check (CUDA vs CPU) and parallel = online
# ---------------------------------------------------------------------------

# train_cross_check's cases: (label, CCMConfig fields, train_mode or None
# for the config's own, whether the path has an online counterpart)
CCM_CASES = (("concat", dict(mode="concat"), None, True),
             ("merge", dict(mode="merge"), None, True))
# the paper's baselines live in the training forward only; compressive
# trains in full, its LoRA and comp_embed gradients being exactly 0
BASELINE_CASES = (("gisting", dict(method="gisting"), None, False),
                  ("compressive", dict(method="compressive", mode="merge"),
                   "full", False))


def train_cross_check(torch, PI, TR, PT, PD, PP, segment_layout, params_bf16,
                      cfg, devices=("cuda", "cpu"), cases=CCM_CASES):
    """2 layers at full width in float32: (a) loss, tail logits and every
    trainable gradient leaf on CUDA (kernels) against the CPU (plain
    versions), for each of ``cases``; (b) on the card, for the CCM
    modes, the parallel forward's tail logits against t ingests +
    prefill (the online kernels).  Tolerance 1e-3 x max|.| per tensor
    (float32 sums in other orders); a compressive LoRA or comp_embed
    gradient must be exactly 0 on both devices."""
    import dataclasses as dc
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32")
    layout = segment_layout(4, 32, 8, 32)                 # S = 192
    B = 2
    batch = PD.sample_kv_batch(PD.ShardableIndexIterator(3, B).key_for(0),
                               layout, B, device="cpu")

    def close(name, a, b):
        lim = 1e-3 * b.abs().max().item()
        err = max_err(a.cpu(), b)
        if not err <= lim:
            raise AssertionError(f"{name}: {err} > {lim}")
        return err / lim

    for mode, fields, train_mode, online in cases:
        cm = c2.replace(ccm=dc.replace(c2.ccm, **fields),
                        train_mode=train_mode or c2.train_mode)
        res = {}
        for dev in devices:
            t0 = time.perf_counter()
            pp = fp32_layers(torch, params_bf16, dev)
            tp, fp = PP.partition(pp, TR.trainable_mask_for(cm, pp))
            leaves = PP.leaves(tp)
            for _, x in leaves:
                x.requires_grad_(True)
            b = {k: v.to(dev) for k, v in batch.items()}
            params = PP.merge(tp, fp)
            logits = PT.train_forward(params, cm, b["tokens"], layout)
            tail = b["tokens"][:, layout.seq_len - layout.tail_len:]
            loss = TR.next_token_loss(logits, tail, b["loss_mask"])
            grads = torch.autograd.grad(loss, [x for _, x in leaves])
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            res[dev] = (loss.detach(), logits.detach(),
                        {"/".join(p): g for (p, _), g in zip(leaves, grads)},
                        time.perf_counter() - t0)
            del pp, tp, fp, params
        (lc, gc_, grc, tc), (lp, gp, grp, tpu) = (res[d] for d in devices)
        worst = max(close(f"{mode} loss", lc, lp),
                    close(f"{mode} tail logits", gc_, gp))
        zero = []
        for k in grp:
            if mode == "compressive" and ("lora" in k or "comp_embed" in k):
                if grp[k].any() or grc[k].any():
                    raise AssertionError(f"{mode} gradient {k} is not 0")
                zero.append(k)
                continue
            if not grp[k].abs().max().item() > 0:
                raise AssertionError(f"{mode} gradient {k} is all zero")
            worst = max(worst, close(f"{mode} grad {k}", grc[k], grp[k]))
        log(f"  train cross-check {mode} ({cm.train_mode}): loss "
            f"{lc.item():.6f} vs {lp.item():.6f}, logits + {len(grp)} "
            f"gradient leaves ({len(zero)} exactly 0 on both), worst "
            f"max|d| / limit {worst:.3f}; cuda {tc:.1f} s, cpu {tpu:.1f} s")
        if not online:
            continue

        # (b) parallel = online on the card
        pp = fp32_layers(torch, params_bf16, devices[0])
        toks = batch["tokens"].to(devices[0])
        with torch.no_grad():
            lg = PT.train_forward(pp, cm, toks, layout)
            st = PI.init_online_state(cm, B, layout.tail_len + 8,
                                      device=devices[0])
            step = layout.chunk_len + layout.comp_len
            for j in range(layout.t_steps):
                st = PI.ingest_context(pp, cm, st, toks[:, j * step:(j + 1)
                                                        * step - layout.comp_len])
            on, _ = PI.prefill(pp, cm, st, toks[:, layout.t_steps * step:],
                               full_logits=True)
        r = close(f"{mode} parallel vs online", on, lg.cpu())
        log(f"  parallel = online ({mode}, cuda): tail logits max|d| / "
            f"(1e-3 max|logit|) = {r:.3f}")
        del pp


# ---------------------------------------------------------------------------
# phase 7: the multi-tenant serve engine
# ---------------------------------------------------------------------------

def first_layers(tree, n: int):
    """A parameter tree cut to its first ``n`` layers (views)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return {k: cut(v) if k == "layers" else v for k, v in tree.items()}


@contextlib.contextmanager
def moe_routes(pick):
    """Runs ``pick(cfg, router_w, xf, route)`` in place of the MoE router
    (``models/moe._route``; ``route`` is the port's own), and puts the
    port's back after.  In bf16 a session batched with others and the
    same session alone round differently, and where two experts' router
    probabilities lie within that rounding, top-k picks another expert,
    a different function of the token: the MoE checks record the expert
    ids of one run and pin them in the run they compare it with."""
    from repro_torch.models import moe as MOE
    route = MOE._route
    MOE._route = lambda cfg, w, xf: pick(cfg, w, xf, route)
    try:
        yield
    finally:
        MOE._route = route


def recorded_routes(calls):
    """A ``moe_routes`` pick that routes as the port does and appends each
    call's expert ids (N, k) to ``calls``."""
    def pick(cfg, w, xf, route):
        tw, ti = route(cfg, w, xf)
        calls.append(ti)
        return tw, ti
    return pick


def pinned_routes(torch, calls, flips):
    """A ``moe_routes`` pick that takes each call's expert ids from the
    front of ``calls`` in place of the router's top-k, with the combine
    weights ``_route`` gives its own picks: the router's float32 softmax
    at those ids, renormalised.  Appends to ``flips`` the number of rows
    whose own top-k (as a set) differs from the pinned one."""
    def pick(cfg, w, xf, route):
        if not calls:
            raise AssertionError("pinned MoE routes: more router calls "
                                 "than recorded")
        ids = calls.pop(0)
        if tuple(ids.shape) != (xf.shape[0], cfg.top_k):
            raise AssertionError(f"pinned MoE routes: ids {tuple(ids.shape)}"
                                 f" for {xf.shape[0]} rows")
        own = route(cfg, w, xf)[1]
        flips.append(int((own.sort(-1).values != ids.sort(-1).values)
                         .any(-1).sum()))
        probs = torch.softmax(xf.float() @ w.float(), dim=-1)
        tw = probs.gather(1, ids)
        return tw / tw.sum(-1, keepdim=True).clamp_min(1e-9), ids
    return pick


@contextlib.contextmanager
def engine_routes(eng, ctx, routes):
    """Records, while ``eng`` runs, the expert ids that the MoE router
    picks for each request's real rows, as ``routes[(sid, stage, layer)]``:
    stage is the index of the session's context that an ingest lane holds
    (its tokens, then its <COMP> rows), or "q" for a query lane.  A
    batch's lanes are its requests in order (``ServeEngine._run_batch``),
    each padded to the batch's token bucket."""
    import numpy as np
    cur = {}
    run_batch = eng._run_batch

    def traced(batch):
        cur.update(batch=batch, layer=0)
        try:
            run_batch(batch)
        finally:
            cur.clear()

    def pick(cfg, w, xf, route):
        tw, ti = route(cfg, w, xf)
        if not cur:
            raise AssertionError("the MoE router ran outside a batch")
        b = cur["batch"]
        ids = ti.view(b.bucket, -1, ti.shape[-1])
        T = ids.shape[1]
        extra = cfg.ccm.comp_len if b.kind == "ingest" else 0
        if T != b.token_len + extra:
            raise AssertionError(f"{b.kind} batch: {T} rows a lane")
        for i, r in enumerate(b.requests):
            vl = int(b.valid_lens[i])
            toks = np.asarray(r.tokens[0])[:vl]
            if b.kind == "ingest":
                stage = [j for j, c in enumerate(ctx[r.sid])
                         if len(c) == vl and np.array_equal(c, toks)]
                if len(stage) != 1:
                    raise AssertionError(f"{r.sid}: ingest of no context")
                stage = stage[0]
            else:
                stage = "q"
            rows = list(range(vl)) + list(range(b.token_len, T))
            key = (r.sid, stage, cur["layer"])
            if key in routes:
                raise AssertionError(f"{key} routed twice")
            routes[key] = ids[i, rows]
        cur["layer"] += 1
        return tw, ti
    eng._run_batch = traced
    try:
        with moe_routes(pick):
            yield routes
    finally:
        del eng._run_batch


def serve_phase(torch, ops, PI, params, cfg, card, *, label: str,
                n_sessions: int, n_slots: int, seed: int,
                async_offload: bool = False, recompress: bool = False,
                stagger: bool = False, detail: bool = False,
                record: dict = None, paths_witness: bool = False,
                n_shards: int = 1, mesh=None):
    """Drive ``ServeEngine`` through its entry points: ``n_sessions``
    sessions over 3 tenants, two of them opened with the same
    ``prefix_tokens`` (a prefix-cache hit), 3 ragged contexts of 33-64
    tokens each (token bucket 64), one fork, then one 17-32-token query
    per session.  ``stagger`` gives half the sessions their second
    context a round early, so one ingest batch mixes lanes at t = 2 and
    t = 3 (per-lane merge weights); ``recompress`` triggers one pressure
    recompression after the ingests.  Every query's logits are then held
    against the same session run alone (B=1) through ``ingest_context``
    / ``prefill`` on the card; an offloaded-then-restored row must come
    back bit-equal.  With ``paths_witness`` the queries are held to
    ``bf16_tol_paths`` and ``serve_witness`` runs.  A float32 config is
    held to ``f32_lane_tol``.  MoE in bf16 records the engine's expert
    ids (``engine_routes``) and runs each session alone with them pinned
    (``pinned_routes``), held to ``bf16_tol_paths``; the session alone
    with its own routing is measured beside it.  Returns the kernel
    launches of the engine's run; with ``record``, ms per ingest and
    query batch, the arena row's MB and the worst query error (x
    bf16_tol) are stored there, with each query's answer and its session
    alone, the traffic, the shards the sessions were placed on and (with
    ``detail``) the profiled drain's idle share.  ``n_shards`` / ``mesh``
    shard the engine (phase 13): sessions then alternate over the shards
    as they are created (the prefix hit and the fork pin to their source's
    shard) and no session may move between shards."""
    import numpy as np
    from repro_torch.core.memory import recompress_memory
    from repro_torch.serve import PressurePolicy, ServeEngine
    from repro_torch.serve.arena import tree_leaves

    rs = np.random.default_rng(seed)
    dev = params["embed"].device
    V = cfg.vocab_size
    sids = [f"s{i}" for i in range(n_sessions)]
    tenant = {sid: f"t{i % 3}" for i, sid in enumerate(sids)}
    p1, p2 = sids[-2], sids[-1]
    tenant[p1] = tenant[p2] = "t1"
    ctx = {sid: [rs.integers(0, V, int(rs.integers(33, 65))).astype(np.int32)
                 for _ in range(3)] for sid in sids}
    ctx[p2][0] = ctx[p1][0]                       # the shared prefix
    qry = {sid: rs.integers(0, V, int(rs.integers(17, 33))).astype(np.int32)
           for sid in sids + ["fork"]}
    policy = PressurePolicy(capacity_tokens=10 ** 9) if recompress else None
    eng = ServeEngine(params, cfg, n_slots=n_slots, cache_len=256,
                      async_offload=async_offload, pressure_policy=policy,
                      n_shards=n_shards, mesh=mesh, device=dev)
    mgr = eng._mgr["online"]
    pin = cfg.family == "moe" and cfg.cdtype == torch.bfloat16
    routes, pinning = {}, contextlib.ExitStack()
    if pin:
        pinning.enter_context(engine_routes(eng, ctx, routes))

    def tally():
        """Batches, host seconds of step dispatch (activation included),
        and sessions moved and host seconds per transfer direction."""
        snap = eng.metrics_snapshot()["metrics"]

        def tot(name, **lab):
            return sum(v["value"] for v in snap[name]["values"]
                       if all(v["labels"].get(k) == x for k, x in lab.items()))
        return dict(batches=int(tot("serve_batches_total")),
                    dispatch_s=tot("serve_dispatch_seconds_total"),
                    **{f"{d}{x}": tot(f"offload_{m}_total", dir=d)
                       for d in ("offload", "restore")
                       for x, m in (("", "sessions"),
                                    ("_s", "transfer_seconds"))})

    def batches():
        return tally()["batches"]

    def drain(what: str):
        a = tally()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        b = {k: v - a[k] for k, v in tally().items()}
        nb = b["batches"]
        log(f"  {label}: {what}: {nb} batches, {ms:.1f} ms, "
            f"{ms / max(nb, 1):.1f} ms per batch; host: dispatch "
            f"{b['dispatch_s'] * 1e3:.1f} ms, of it offload "
            f"{int(b['offload'])} rows {b['offload_s'] * 1e3:.1f} ms, restore "
            f"{int(b['restore'])} rows {b['restore_s'] * 1e3:.1f} ms [{card}]")
        return ms / max(nb, 1), nb

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for sid in sids[:-1]:
        eng.create_session(sid, tenant=tenant[sid],
                           prefix_tokens=ctx[sid][0] if sid == p1 else None)
    drain("prefix ingest")          # compressed once, pinned in the cache
    eng.create_session(p2, tenant=tenant[p2], prefix_tokens=ctx[p2][0])
    for sid in sids[:-2]:
        eng.ingest(sid, ctx[sid][0])
    ingest_ms = [drain("ingest round 1")[0]]
    rounds = [[sid for i, sid in enumerate(sids) if i % 2 == 0], sids,
              [sid for i, sid in enumerate(sids) if i % 2 == 1]] \
        if stagger else [sids, sids]
    done = {sid: 1 for sid in sids}
    for r, group in enumerate(rounds):
        for sid in group:
            eng.ingest(sid, ctx[sid][done[sid]])
            done[sid] += 1
        if detail and r == len(rounds) - 1:
            n0 = batches()
            drain_stats = {}
            by_name = profile_window(torch, eng.run, f"{label} ingest drain",
                                     card, warmup=False, stats=drain_stats)
            nb = batches() - n0
            if by_name is not None:
                gms = sum(v for k, v in by_name.items()
                          if "session_copy_kernel" in k
                          and ("<false>" in k or "ILb0E" in k))
                sms = sum(v for k, v in by_name.items()
                          if "session_copy_kernel" in k
                          and ("<true>" in k or "ILb1E" in k))
                log(f"  {label}: profiled drain of {nb} ingest batches: "
                    f"gather {gms / max(nb, 1):.4f} ms, scatter "
                    f"{sms / max(nb, 1):.4f} ms of device time per batch "
                    f"[{card}]")
        else:
            ingest_ms.append(drain(f"ingest round {r + 2}")[0])
    if any(v != 3 for v in done.values()):
        raise AssertionError(f"{label}: contexts per session {done}")
    recompressed = None
    if recompress:
        freed = eng.pressure.relieve(cfg.ccm.comp_len)
        rc = [d for d in eng.pressure.decisions if d["lever"] == "recompress"]
        if freed <= 0 or len(rc) != 1:
            raise AssertionError(f"{label}: recompress {freed} {rc}")
        recompressed = rc[0]["sid"]
        log(f"  {label}: pressure recompress of {recompressed} freed "
            f"{freed} memory tokens")
    # fork a session that is resident now, so that its first write (the
    # queries) breaks the shared row copy-on-write
    parent = next(s for s in reversed(sids[:-2]) if mgr.sessions[s].resident)
    eng.fork_session(parent, "fork")
    eng.run()                               # the fork: control plane only
    order = [parent, "fork"] + [s for s in sids if s != parent]
    reqs = {sid: eng.query(sid, qry[sid]).request for sid in order}
    query_ms, _ = drain("queries")
    counts = ops.launch_counts()
    pinning.close()

    snap = eng.metrics_snapshot()["metrics"]
    moved = {v["labels"]["dir"]: int(v["value"])
             for v in snap["offload_sessions_total"]["values"]}
    hits = int(snap["serve_prefix_dedup_hits_total"]["values"][0]["value"])
    forks = int(snap["serve_fork_total"]["values"][0]["value"])
    cow = int(sum(v["value"]
                  for v in snap["serve_cow_breaks_total"]["values"]))
    errs = mgr.arena.consistency_errors()
    if errs or moved["offload"] <= 0 or moved["restore"] <= 0 \
            or hits < 1 or forks != 1 or cow < 1:
        raise AssertionError(f"{label}: consistency {errs}, moved {moved}, "
                             f"prefix hits {hits}, forks {forks}, COW {cow}")
    shards = [eng.shard_of(s) for s in sids]
    if eng.n_shards > 1:
        want = [i % eng.n_shards for i in range(n_sessions - 1)]
        cross = int(eng._m_cross_shard.value)
        if shards[:-1] != want or shards[-1] != shards[-2] or cross \
                or eng.shard_of("fork") != eng.shard_of(parent):
            raise AssertionError(f"{label}: placement {shards}, fork on "
                                 f"{eng.shard_of('fork')}, cross-shard "
                                 f"moves {cross}")
        log(f"  {label}: placement {shards} (the prefix hit on its cached "
            f"row's shard, the fork on its parent's), cross-shard moves 0")
    if mesh is not None:
        slabs = mgr.arena.slabs
        on = [str(b.cache.k.device) for b in slabs.blocks]
        if on != [str(d) for d in mesh.devices] or not eng._sharded_steps:
            raise AssertionError(f"{label}: row blocks on {on}, mesh "
                                 f"{mesh.devices}, sharded steps "
                                 f"{list(eng._sharded_steps)}")
        log(f"  {label}: {len(on)} row block(s) of {slabs.stride} rows on "
            f"{on}; steps through make_sharded_arena_step "
            f"{sorted(eng._sharded_steps)}")
    # the tensor-core routes take bf16 operands (float32 the CUDA-core ones)
    tc = ("segmented_attention_mma", "cond_lora_wgmma") \
        if cfg.cdtype == torch.bfloat16 else ()
    for k in ("session_gather", "session_scatter", "segmented_attention",
              "cond_lora") + tc:
        if counts[k] <= 0:
            raise AssertionError(f"{label}: {k} never launched")
    ingest_batches = int(sum(v["value"]
                             for v in snap["serve_batches_total"]["values"]
                             if v["labels"].get("kind") == "ingest"))
    if cfg.ccm.mode == "merge":
        # one merge launch (k and v, a weight per lane) per ingest batch,
        # also for the staggered batch that mixes lanes at t = 2 and 3
        if counts["kv_merge_update"] != ingest_batches:
            raise AssertionError(f"{label}: {counts['kv_merge_update']} merge "
                                 f"launches for {ingest_batches} ingest "
                                 "batches")
        log(f"  {label}: {ingest_batches} ingest batches, one kv_merge "
            "launch each")
    log(f"  {label}: offloads {moved['offload']}, restores "
        f"{moved['restore']}, prefix hits {hits}, COW breaks {cow}, "
        f"launches {counts}")

    # every query against the session run alone (B=1) on the card
    worst, alone, ratio = 0.0, {}, {}
    hold = f32_lane_tol if cfg.cdtype == torch.float32 else \
        bf16_tol_paths if paths_witness or pin else bf16_tol
    unpinned = {}               # MoE in bf16: the session alone unpinned

    def alone_routes(sid):
        """The engine's expert ids for ``sid`` alone, call by call: its
        three contexts (a fork's are its parent's, and a prefix hit's
        first is the cached session's), then its query."""
        src = parent if sid == "fork" else sid
        nl = 1 + max(k[2] for k in routes)
        out = []
        for j in range(3):
            s = src if (src, j, 0) in routes else p1
            out += [routes[(s, j, li)] for li in range(nl)]
        return out + [routes[(sid, "q", li)] for li in range(nl)]

    def run_alone(c, sid):
        src = parent if sid == "fork" else sid
        st = PI.init_online_state(c, 1, 256, device=dev)
        for x in ctx[src]:
            st = PI.ingest_context(params, c, st,
                                   torch.as_tensor(x, device=dev)[None])
        if src == recompressed:
            st = st._replace(mem=recompress_memory(
                c, st.mem, eng.pressure.policy.recompress_group))
        lg, _ = PI.prefill(params, c, st,
                           torch.as_tensor(qry[sid], device=dev)[None],
                           full_logits=True)
        return lg[0].float().cpu()
    for sid, req in reqs.items():
        if not req.done or req.result is None:
            raise AssertionError(f"{label}: query of {sid} not delivered")
        if pin:
            queue, flips = alone_routes(sid), []
            n_rows = sum(x.shape[0] for x in queue)
            with moe_routes(pinned_routes(torch, queue, flips)):
                want = run_alone(cfg, sid)
            if queue:
                raise AssertionError(f"{label}: {sid} alone left "
                                     f"{len(queue)} router calls unpinned")
            nat = run_alone(cfg, sid)
            unpinned[sid] = (sum(flips), n_rows, max_err(
                torch.from_numpy(req.result), nat) / bf16_tol(nat))
        else:
            want = run_alone(cfg, sid)
        got = torch.from_numpy(req.result)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: {sid} logits {got.shape}")
        err, tol = max_err(got, want), hold(want)
        ratio[sid] = err / bf16_tol(want)
        worst = max(worst, ratio[sid])
        alone[sid] = want
        if not err <= tol:
            raise AssertionError(f"{label}: {sid} logits differ from the "
                                 f"single-session run: {err} > {tol}")
    if pin:
        log(f"  {label}: each session alone with the engine's expert ids "
            f"pinned, per session (rows its own router sends elsewhere / "
            f"rows routed, served vs alone unpinned x bf16_tol, pinned x "
            f"bf16_tol): "
            + ", ".join(f"{s} {f}/{n} {u:.2f} {ratio[s]:.2f}"
                        for s, (f, n, u) in unpinned.items())
            + f" [{card}]")
    log(f"  {label}: {len(reqs)} queries match their single-session runs"
        f"{' (expert ids pinned)' if pin else ''} within {hold.__name__}: "
        f"worst max_abs_err / bf16_tol = {worst:.3f}")
    if paths_witness:
        for s in ("fork", recompressed):        # not one session's contexts
            ratio.pop(s, None)
        serve_witness(torch, PI, params, cfg, ctx, qry, ratio, alone,
                      {s: reqs[s].result for s in ratio}, label=label)

    # an offloaded row comes back bit-equal (host clock for the rates)
    sid = next(s for s in sids if mgr.sessions[s].resident)
    before = mgr.arena.read_slot(mgr.sessions[sid].slot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.offload_session(sid)
    mgr.sync()
    t_off = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.activate_batch([sid])
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    after = mgr.arena.read_slot(mgr.sessions[sid].slot)
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(tree_leaves(before), tree_leaves(after)))
    if not same:
        raise AssertionError(f"{label}: {sid}'s row changed over an "
                             "offload and restore")
    gb = mgr.arena.state_bytes / 1e9
    log(f"  {label}: {sid} offloaded ({'async' if async_offload else 'sync'})"
        f" and restored bit-equal; {gb * 1e3:.1f} MB per row, offload "
        f"{gb / t_off:.2f} GB/s, restore {gb / t_res:.2f} GB/s (host clock, "
        f"gather/scatter included) [{card}]")
    if detail:
        log(f"  {label}: ms per ingest batch {[round(x, 1) for x in ingest_ms]}, "
            f"per query batch {query_ms:.1f} [{card}]")
    if record is not None:
        record.update(ingest_ms=ingest_ms, query_ms=query_ms,
                      row_mb=gb * 1e3, worst_x_bf16_tol=worst,
                      answers={s: reqs[s].result for s in reqs}, alone=alone,
                      ctx=ctx, qry=qry, shards=shards,
                      idle=drain_stats.get("idle") if detail else None,
                      weights=weights_fingerprint(params))
    del eng
    torch.cuda.empty_cache()
    return counts


def weights_fingerprint(params):
    """Sums of the leaves training moves (LoRA factors, ``comp_embed``):
    answers recorded on one set of weights are compared on the same."""
    lora = params.get("shared_attn", params["layers"])["attn"]["lora"]
    return [float(lora[n][f].float().sum()) for n in sorted(lora)
            for f in ("a", "b")] + [float(params["comp_embed"].float().sum())]


def serve_witness(torch, PI, params, cfg, ctx, qry, ratio, alone, engine, *,
                  label: str, n: int = 8):
    """Where a served answer's gap to its session alone comes from.  The
    ``n`` sessions whose engine answers (E) lie farthest from their runs
    alone (A) are driven again outside the engine, as one batch of ``n``
    lanes (B) through ``ingest_context`` and ``prefill`` with per-lane
    ``valid_len``: each round's contexts padded to the engine's 64-token
    bucket, the queries to 32.  B vs A as large as E vs A says that the
    gap is a batch's (cuBLAS picks other GEMM algorithms for another M,
    as ``bf16_tol_paths`` says), not the engine's."""
    import numpy as np
    dev = params["embed"].device
    sids = sorted(ratio, key=lambda s: -ratio[s])[:n]

    def padded(seqs, width):
        vl = np.array([len(x) for x in seqs], np.int64)
        buf = np.zeros((len(seqs), width), np.int32)
        for i, x in enumerate(seqs):
            buf[i, :vl[i]] = x
        return torch.as_tensor(buf, device=dev), vl
    st = PI.init_online_state(cfg, len(sids), 256, device=dev)
    zero = np.zeros(len(sids), np.int64)       # per-lane counters, as packed
    st = st._replace(cache=st.cache._replace(length=zero.copy()),
                     mem=st.mem._replace(slots=zero.copy(), steps=zero.copy(),
                                         stream_pos=zero.copy()),
                     pos=zero.copy())
    for r in range(3):
        tk, vl = padded([ctx[s][r] for s in sids], 64)
        st = PI.ingest_context(params, cfg, st, tk, valid_len=vl)
    tq, vq = padded([qry[s] for s in sids], 32)
    lg, _ = PI.prefill(params, cfg, st, tq, full_logits=True, valid_len=vq)
    out = {"E vs A": [], "B vs A": [], "E vs B": []}
    for i, s in enumerate(sids):
        b, e = lg[i, :vq[i]].float().cpu(), torch.from_numpy(engine[s])
        for name, x, y in (("E vs A", e, alone[s]), ("B vs A", b, alone[s]),
                           ("E vs B", e, b)):
            out[name].append(max_err(x, y) / bf16_tol(y))
    log(f"  {label} witness, the {len(sids)} farthest sessions again as one "
        f"batch outside the engine (x bf16_tol per lane; {sids}): "
        + "; ".join(f"{k} {[round(x, 3) for x in v]}"
                    for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 8: CCM streaming (sink + sliding window + compressed memory)
# ---------------------------------------------------------------------------

def stack_lanes(torch, STR, states):
    """B=1 stream states -> one lane-batched state (lane-major tensors,
    per-lane counters: the layout the serve engine's arena step packs)."""
    import numpy as np
    from repro_torch.core.memory import MemState

    def t(get):
        return torch.stack([get(s)[:, 0] for s in states])

    def c(get):
        return np.array([get(s) for s in states], np.int64)
    mem = MemState(k=t(lambda s: s.mem.k), v=t(lambda s: s.mem.v),
                   slots=c(lambda s: s.mem.slots),
                   steps=c(lambda s: s.mem.steps),
                   stream_pos=c(lambda s: s.mem.stream_pos), lane_major=True)
    return STR.StreamState(win_k=t(lambda s: s.win_k),
                           win_v=t(lambda s: s.win_v),
                           win_len=c(lambda s: s.win_len), mem=mem,
                           pos=c(lambda s: s.pos), lane_major=True)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def stream_full_width(torch, STR, ops, params, cfg, card, *, B: int = 2,
                      n_chunks: int = 72, n_single: int = 16):
    """8a: ``n_chunks`` chunks of ``stream_chunk`` tokens then
    ``n_single`` single-token steps through ``stream_step`` (the default
    stream config: W 4096, sink 4, chunk 64, 64 memory groups), checking
    the window bound, the memory's group count and finite logits after
    every step.  The step of the second eviction (the mma.sync route)
    and the last single-token step (the split-K route over the full
    window and the memory) are each held to the same step with
    ``impl="concat"`` (the dense oracle attend) from a clone.
    Returns (launch counts, host ms per step kind, the eviction count)."""
    c = cfg.ccm
    W, cc, m = c.stream_window, c.stream_chunk, c.comp_len
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (B, n_chunks * cc + n_single),
                         generator=gen, device=dev)
    steps = [toks[:, i * cc:(i + 1) * cc] for i in range(n_chunks)] \
        + [toks[:, n_chunks * cc + j:][:, :1] for j in range(n_single)]
    torch.cuda.reset_peak_memory_stats()
    st = STR.init_stream_state(cfg, B, device=dev)
    ms = {"chunk": [], "evict": [], "single": []}
    evictions, held = 0, None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i, t in enumerate(steps):
        evicting = bool(STR.eviction_pending(cfg, st, t.shape[1]))
        if evicting and evictions == 1:
            held = [clone_state(torch, st), t]
        if i == len(steps) - 1:
            single = (clone_state(torch, st), t)
        t0 = time.perf_counter()
        lg, st = STR.stream_step(params, cfg, st, t)
        finite = bool(torch.isfinite(lg).all())
        ms["evict" if evicting else "chunk" if t.shape[1] > 1
           else "single"].append((time.perf_counter() - t0) * 1e3)
        evictions += evicting
        if held is not None and len(held) == 2:
            held += [lg.clone(), st.mem.k[:, :, (evictions - 1) * m:
                                           evictions * m].clone()]
        if not finite or not st.win_len <= W or st.mem.slots != evictions:
            raise AssertionError(
                f"8a step {i}: finite {finite}, win_len {st.win_len}, "
                f"slots {st.mem.slots} after {evictions} evictions")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if evictions < 1 or held is None:
        raise AssertionError(f"8a: {evictions} evictions")
    # the held steps again from their clones, with the dense oracle attend
    before, t, got, grp = held
    want, wst = STR.stream_step(params, cfg, before, t, impl="concat")
    wgrp = wst.mem.k[:, :, m:2 * m]
    del before, wst
    before, t = single
    if st.win_len != before.win_len + 1:
        raise AssertionError(f"8a: the held single-token step evicted "
                             f"({before.win_len} -> {st.win_len})")
    keys = before.mem.slots * m + before.win_len + 1    # memory, window, self
    want1, _ = STR.stream_step(params, cfg, before, t, impl="concat")
    del before
    for name, a, b in (("eviction step logits", got, want),
                       ("eviction step compressed group", grp, wgrp),
                       (f"single-token step ({keys} keys) logits", lg,
                        want1)):
        err = max_err(a, b)
        check(f"8a {name} vs impl=concat ({err / bf16_tol(b):.3f} x "
              "bf16_tol)", err, bf16_tol_paths(b))
    mean = {k: sum(v) / max(len(v), 1) for k, v in ms.items()}
    log(f"  8a: {len(steps)} steps ({n_chunks} x {cc} + {n_single} x 1 "
        f"tokens, B={B}), {evictions} evictions, final win_len "
        f"{st.win_len}, slots {st.mem.slots}, pos {st.pos}; host ms per "
        f"chunk step {mean['chunk']:.2f}, per eviction step "
        f"{mean['evict']:.2f} (each: {[round(x, 1) for x in ms['evict']]}),"
        f" per single-token step {mean['single']:.2f}; peak {peak:.2f} GiB "
        f"[{card}]")
    log(f"  8a: launches {counts}")
    # one eviction step under the profiler (after the counts: not counted)
    chunk = steps[0]

    def evict1():
        nonlocal st
        if not STR.eviction_pending(cfg, st, cc):
            raise AssertionError("8a: the profiled step would not evict")
        _, st = STR.stream_step(params, cfg, st, chunk)
    profile_window(torch, evict1, f"8a 1 eviction step (chunk {cc}, B={B})",
                   card)
    # the window shift alone, on the (now spent) window's k: the rows
    # behind the first block read once and written once, the last block
    # zeroed
    x = st.win_k
    row = x.numel() // W * x.element_size()
    nbytes = row * (2 * (W - c.stream_sink - cc) + cc)
    bms, by = bound(nbytes, 0, PEAK_BF16)
    shift = device_ms(torch, lambda i: STR._shift_window(
        x, c.stream_sink, cc, False, None), iters=5)
    log(f"  8a: window shift of one tensor ({tuple(x.shape)} bf16, "
        f"{nbytes / 2 ** 30:.2f} GiB moved): {shift:.4f} ms device, bound "
        f"{bms:.4f} ms ({by}); an eviction shifts k and v [{card}]")
    del st, x
    torch.cuda.empty_cache()
    return counts, mean, evictions


def stream_modes(torch, STR, ops, params, cfg, card, *, n_chunks: int = 16,
                 tag: str = "8b"):
    """8b: 4 layers at full width, W 512, chunk 64, 4 memory groups:
    concat through the memory-full branch, merge and the StreamingLLM
    baseline (ccm_on=False), ``n_chunks`` chunks each, the last step held
    to ``impl="concat"``; then ``stream_step_lanes`` over 4 lanes with
    staggered fill, each lane held to its run alone and the lanes with no
    eviction pending left bit-equal (messages tagged ``tag``).  MoE pins
    the expert ids of the run under test in the run it is held to
    (``moe_routes``).  Returns the launch counts."""
    import numpy as np
    pin = cfg.family == "moe"

    def routes(pick):
        return moe_routes(pick) if pin else contextlib.nullcontext()
    c = dataclasses.replace(cfg.ccm, stream_window=512, stream_chunk=64,
                            stream_mem_slots=4)
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(32)
    cc, W = c.stream_chunk, c.stream_window
    total = {}
    for label, mode, ccm_on in (("concat", "concat", True),
                                ("merge", "merge", True),
                                ("baseline", "concat", False)):
        rcfg = cfg.replace(ccm=dataclasses.replace(c, mode=mode))
        toks = torch.randint(0, cfg.vocab_size, (2, n_chunks * cc),
                             generator=gen, device=dev)
        st = STR.init_stream_state(rcfg, 2, device=dev)
        evictions = 0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for i in range(n_chunks):
            t = toks[:, i * cc:(i + 1) * cc]
            evictions += bool(STR.eviction_pending(rcfg, st, cc))
            calls = []
            if i == n_chunks - 1:
                before = clone_state(torch, st)
            with routes(recorded_routes(calls)):
                lg, st = STR.stream_step(params, rcfg, st, t, ccm_on=ccm_on)
            if not bool(torch.isfinite(lg).all()) or st.win_len > W:
                raise AssertionError(f"{tag} {label} step {i}: win_len "
                                     f"{st.win_len}")
        add_counts(total, ops.launch_counts())
        want_slots = (min(evictions, 4) if mode == "concat" else 1) \
            if ccm_on else 0
        if st.mem.slots != want_slots or evictions != n_chunks - W // cc:
            raise AssertionError(f"{tag} {label}: slots {st.mem.slots} after "
                                 f"{evictions} evictions")
        flips = []
        with routes(pinned_routes(torch, calls, flips)):
            want, _ = STR.stream_step(params, rcfg, before, t,
                                      ccm_on=ccm_on, impl="concat")
        if calls:
            raise AssertionError(f"{tag} {label}: {len(calls)} router calls "
                                 "not replayed")
        pinned = f", expert ids pinned ({sum(flips)} rows routed elsewhere" \
            " unpinned)" if pin else ""
        err = max_err(lg, want)
        check(f"{tag} {label}: last step vs impl=concat ({evictions} "
              f"evictions, slots {st.mem.slots}; {err / bf16_tol(want):.3f}"
              f" x bf16_tol{pinned})", err, bf16_tol_paths(want))
        del st, before

    # stream_step_lanes over staggered lanes: lane 0 evicts with a full
    # memory (its oldest group drops), lane 2 evicts for the first time,
    # lanes 1 and 3 do not evict
    rcfg = cfg.replace(ccm=c)
    warm = [12, 3, 8, 0]
    ops.reset_launch_counts()
    lanes = []
    for n in warm:
        st = STR.init_stream_state(rcfg, 1, device=dev)
        for _ in range(n):
            t = torch.randint(0, cfg.vocab_size, (1, cc), generator=gen,
                              device=dev)
            _, st = STR.stream_step(params, rcfg, st, t)
        lanes.append(st)
    packed = stack_lanes(torch, STR, lanes)
    pending = STR.eviction_pending(rcfg, packed, np.full(4, cc))
    if list(pending) != [True, False, True, False]:
        raise AssertionError(f"{tag} lanes: pending {pending}")
    keep = clone_state(torch, packed)
    toks = torch.randint(0, cfg.vocab_size, (4, 1, cc), generator=gen,
                         device=dev)
    calls = []
    with routes(recorded_routes(calls)):
        lg, new = STR.stream_step_lanes(params, rcfg, packed, toks)
    torch.cuda.synchronize()
    add_counts(total, ops.launch_counts())
    worst, flips = 0.0, []
    # MoE: the router ran over the 2 pending lanes' <COMP> rows (the
    # evictions), then over the 4 lanes' chunks, once a layer each
    nl = len(calls) // 2
    for i, lane in enumerate(lanes):
        j = [x for x in range(4) if pending[x]].index(i) if pending[i] \
            else None
        mine = ([c.view(2, -1, c.shape[-1])[j] for c in calls[:nl]]
                if pending[i] else []) \
            + [c.view(4, -1, c.shape[-1])[i] for c in calls[nl:]]
        with routes(pinned_routes(torch, mine, flips)):
            want, _ = STR.stream_step(params, rcfg, lane, toks[i])
        if pin and mine:
            raise AssertionError(f"{tag} lane {i}: {len(mine)} router calls "
                                 "not replayed")
        err, tol = max_err(lg[i, 0], want[0]), bf16_tol(want)
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"{tag} lane {i}: {err} > {tol}")
    for i in (1, 3):
        wl = int(keep.win_len[i])
        same = torch.equal(new.mem.k[i], keep.mem.k[i]) \
            and torch.equal(new.mem.v[i], keep.mem.v[i]) \
            and torch.equal(new.win_k[i][:, :wl], keep.win_k[i][:, :wl]) \
            and torch.equal(new.win_v[i][:, :wl], keep.win_v[i][:, :wl]) \
            and new.mem.slots[i] == keep.mem.slots[i] \
            and new.mem.steps[i] == keep.mem.steps[i]
        if not same:
            raise AssertionError(f"{tag} lane {i} (no eviction) changed")
    if list(new.mem.slots) != [4, 0, 1, 0]:
        raise AssertionError(f"{tag} lanes: slots {new.mem.slots}")
    log(f"  {tag} lanes: stream_step_lanes over 4 lanes (pending "
        f"{[bool(p) for p in pending]}): worst max_abs_err / bf16_tol "
        f"against each lane alone {worst:.3f}"
        + (f" (expert ids pinned; {sum(flips)} rows routed elsewhere "
           "unpinned)" if pin else "") + "; the 2 lanes with no eviction "
        "bit-equal")
    log(f"  {tag}: launches {total}")
    return total


def stream_cross_check(torch, STR, params_bf16, cfg,
                       devices=("cuda", "cpu")):
    """8c: 2 layers at full width in float32, CUDA against the CPU's
    plain versions, over 10 chunks of 32 through a 128-token window and a
    2-group memory (6 evictions; the memory is full from the second on,
    so the oldest group drops 4 times)."""
    B, N = 2, 10
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32",
                     ccm=dataclasses.replace(cfg.ccm, stream_window=128,
                                             stream_chunk=32,
                                             stream_mem_slots=2))
    cc = c2.ccm.stream_chunk
    gen = torch.Generator().manual_seed(33)
    toks = torch.randint(0, c2.vocab_size, (B, N * cc), generator=gen)
    runs = {}
    for dev in devices:
        t0 = time.perf_counter()
        pp = fp32_layers(torch, params_bf16, dev)
        st = STR.init_stream_state(c2, B, device=dev)
        logits = []
        for i in range(N):
            lg, st = STR.stream_step(pp, c2, st,
                                     toks[:, i * cc:(i + 1) * cc].to(dev))
            logits.append(lg)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (logits, st, time.perf_counter() - t0)
        del pp
    (lc, sc, tc), (lp, sp, tp) = (runs[d] for d in devices)
    worst = 0.0
    pairs = [(f"logits {i}", a, b) for i, (a, b) in enumerate(zip(lc, lp))]
    pairs += [("win_k", sc.win_k, sp.win_k), ("win_v", sc.win_v, sp.win_v),
              ("mem.k", sc.mem.k, sp.mem.k), ("mem.v", sc.mem.v, sp.mem.v)]
    for name, a, b in pairs:
        lim = 1e-3 * b.abs().max().item()
        err = max_err(a.cpu(), b)
        worst = max(worst, err / lim)
        if not err <= lim:
            raise AssertionError(f"8c {name}: {err} > {lim}")
    ints = [(s.win_len, s.pos, s.mem.slots, s.mem.steps, s.mem.stream_pos)
            for s in (sc, sp)]
    if ints[0] != ints[1] or sc.mem.slots != 2 or sc.mem.steps != 6:
        raise AssertionError(f"8c counters {ints}")
    log(f"  8c: 2 layers fp32, {N} chunks of {cc} through a "
        f"{c2.ccm.stream_window}-token window, {sc.mem.steps} evictions "
        f"(memory full: slots {sc.mem.slots}/2): worst max|d| / (1e-3 "
        f"max|.|) = {worst:.3f} over logits and state; cuda {tc:.1f} s, "
        f"cpu {tp:.1f} s")


def stream_serve_phase(torch, STR, ops, params, cfg, card, *,
                       n_sessions: int = 6, n_slots: int = 4,
                       n_req: int = 12, seed: int = 41):
    """8d: ``ServeEngine`` stream sessions (``stream_window=512``):
    ``n_sessions`` sessions on ``n_slots`` stream slots, ``n_req`` rounds
    of one 33-64-token request each (token bucket 64 = the stream chunk),
    so evictions fire on some lanes of a batch and not on others and
    stream rows are offloaded and restored by LRU.  Every answer is held
    to the session run alone through ``stream_step`` on the card.
    Returns the launch counts of the engine's drains."""
    import numpy as np
    from repro_torch.serve import ServeEngine
    scfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, stream_window=512))
    W, cc = scfg.ccm.stream_window, scfg.ccm.stream_chunk
    dev = params["embed"].device
    rs = np.random.default_rng(seed)
    sids = [f"s{i}" for i in range(n_sessions)]
    chunks = {sid: [rs.integers(0, cfg.vocab_size, int(rs.integers(33, 65))
                                ).astype(np.int32) for _ in range(n_req)]
              for sid in sids}
    # the rounds in which some sessions' windows overflow and others' not
    fill = {sid: 0 for sid in sids}
    mixed = 0
    for r in range(n_req):
        ev = []
        for sid in sids:
            n = len(chunks[sid][r])
            ev.append(fill[sid] + n > W)
            fill[sid] = fill[sid] + n - (cc if ev[-1] else 0)
        mixed += any(ev) and not all(ev)
    if not mixed:
        raise AssertionError("8d: no round mixes evicting and other lanes")
    eng = ServeEngine(params, scfg, n_slots=1, cache_len=64,
                      stream_slots=n_slots, device=dev)
    mgr = eng._mgr["stream"]
    for sid in sids:
        eng.create_session(sid, kind="stream")
    reqs = {sid: [] for sid in sids}

    def tally():
        snap = eng.metrics_snapshot()["metrics"]

        def tot(name, **lab):
            return sum(v["value"] for v in snap[name]["values"]
                       if all(v["labels"].get(k) == x for k, x in lab.items()))
        return (int(tot("serve_batches_total", kind="stream")),
                int(tot("offload_sessions_total", dir="offload")),
                int(tot("offload_sessions_total", dir="restore")),
                tot("serve_dispatch_seconds_total", kind="stream"))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(n_req):
        for sid in sids[r % n_sessions:] + sids[:r % n_sessions]:
            reqs[sid].append(eng.stream(sid, chunks[sid][r]).request)
        eng.run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    nb, off, res, disp = tally()
    errs = mgr.arena.consistency_errors()
    if errs or off <= 0 or res <= 0:
        raise AssertionError(f"8d: consistency {errs}, offloads {off}, "
                             f"restores {res}")
    log(f"  8d: {n_sessions} stream sessions on {n_slots} slots, {n_req} "
        f"requests each ({mixed} rounds mix evicting and other lanes): "
        f"{nb} stream batches, {ms:.1f} ms, {ms / nb:.1f} ms per batch; "
        f"host dispatch {disp * 1e3:.1f} ms; offload {off} rows, restore "
        f"{res} rows of {mgr.arena.state_bytes / 1e6:.1f} MB [{card}]")
    log(f"  8d: launches {counts}")
    worst, alone = 0.0, {}
    for sid in sids:
        st = STR.init_stream_state(scfg, 1, device=dev)
        for t, req in zip(chunks[sid], reqs[sid]):
            want, st = STR.stream_step(params, scfg, st,
                                       torch.as_tensor(t, device=dev)[None])
            want = want[0].float().cpu()
            alone.setdefault(sid, want)
            if not req.done or req.result is None:
                raise AssertionError(f"8d: {sid} request not delivered")
            got = torch.from_numpy(req.result)
            err, tol = max_err(got, want), bf16_tol_paths(want)
            worst = max(worst, err / bf16_tol(want))
            if got.shape != want.shape or not err <= tol:
                raise AssertionError(f"8d: {sid} logits differ from the "
                                     f"session run alone: {err} > {tol}")
    log(f"  8d: {n_sessions * n_req} answers match their single-session "
        f"runs within bf16_tol_paths: worst max_abs_err / bf16_tol = "
        f"{worst:.3f}")
    batch_witness(torch, STR, params, scfg,
                  {sid: chunks[sid][0] for sid in sids[:n_slots]},
                  {sid: reqs[sid][0].result for sid in sids[:n_slots]},
                  alone)
    del eng
    torch.cuda.empty_cache()
    return counts


def batch_witness(torch, STR, params, cfg, toks, engine, alone):
    """Where 8d's gap to the session alone comes from.  A first request
    starts from an empty window and memory, so the engine's 4-lane batch
    of first requests can be run again outside it, from the same padded
    tokens: through ``stream_step_lanes`` (S4) and through the online
    path's ``prefill`` (P4, phase 7's path).  Each lane is then compared
    with the engine (E), with the session's stream step alone (A) and
    with the online prefill alone (P1).  S4 and P4 must agree with E
    within bf16_tol; the logged ratios S4 vs A and P4 vs P1 show how far
    a 4-lane batch of 64-token rows lands from one unpadded row, with no
    engine and no stream op involved in the second."""
    import numpy as np
    from repro_torch.core import inference as PI
    dev = params["embed"].device
    sids = list(toks)
    cc = cfg.ccm.stream_chunk
    n = np.array([len(toks[s]) for s in sids])
    buf = np.zeros((len(sids), 1, cc), np.int32)
    for i, s in enumerate(sids):
        buf[i, 0, :n[i]] = toks[s]
    tk = torch.as_tensor(buf, device=dev)
    lanes = stack_lanes(torch, STR, [STR.init_stream_state(cfg, 1, device=dev)
                                     for _ in sids])
    s4, _ = STR.stream_step_lanes(params, cfg, lanes, tk, lengths=n)
    on = PI.init_online_state(cfg, len(sids), cfg.ccm.stream_window,
                              device=dev)
    zero = np.zeros(len(sids), np.int64)       # per-lane counters, as packed
    on = on._replace(cache=on.cache._replace(length=zero), pos=zero)
    p4, _ = PI.prefill(params, cfg, on, tk[:, 0], full_logits=True,
                       valid_len=n)
    ratios = {"E vs S4": [], "S4 vs P4": [], "S4 vs A": [], "P4 vs P1": []}
    for i, s in enumerate(sids):
        one = torch.as_tensor(toks[s], device=dev)[None]
        p1, _ = PI.prefill(params, cfg, PI.init_online_state(
            cfg, 1, cfg.ccm.stream_window, device=dev), one, full_logits=True)
        e = torch.from_numpy(engine[s])
        s4_i, p4_i = s4[i, 0, :n[i]].float().cpu(), p4[i, :n[i]].float().cpu()
        pairs = (("E vs S4", e, s4_i), ("S4 vs P4", s4_i, p4_i),
                 ("S4 vs A", s4_i, alone[s]),
                 ("P4 vs P1", p4_i, p1[0].float().cpu()))
        for name, a, b in pairs:
            ratios[name].append(max_err(a, b) / bf16_tol(b))
        for name in ("E vs S4", "S4 vs P4"):
            if not ratios[name][-1] <= 1.0:
                raise AssertionError(f"8d witness {s}: {name} "
                                     f"{ratios[name][-1]:.3f} x bf16_tol")
    log("  8d witness, the first requests' 4-lane batch again outside the "
        "engine (x bf16_tol per lane): " + "; ".join(
            f"{k} {[round(x, 3) for x in v]}" for k, v in ratios.items()))


# ---------------------------------------------------------------------------
# phase 9: the dense model zoo at full width
# ---------------------------------------------------------------------------

# the dense configs of the port's registry (configs/registry.py)
ZOO = ("smollm-360m", "qwen2-0.5b", "codeqwen1.5-7b", "gemma-2b")
# depth cuts of 9c and 9d (never width): CodeQwen1.5-7B trains and serves
# at 4 layers, its kernel shapes being LLaMA-7B's of phases 5 and 7
ZOO_DEPTH = {"codeqwen1.5-7b": 4}
# the configs whose served answers land more than bf16_tol from their
# sessions alone (up to 1.54 x for SmolLM-360M and 1.46 x for Qwen2-0.5B
# on an H100, PERF.md), held to bf16_tol_paths beside serve_witness
ZOO_BATCH_GAP = ("smollm-360m", "qwen2-0.5b")


def zoo_train(torch, ops, clora, TR, PD, PA, PP, segment_layout, params,
              cfg, card):
    """9c: 2 concat steps (``train_steps``), then one more under the
    profiler (not counted).  Returns (launch counts, {step_ms, peak_gib,
    losses, profile})."""
    run = train_steps(torch, ops, clora, TR, PD, PA, PP, segment_layout,
                      params, cfg, card, ["concat"] * 2, f"9c {cfg.name}")
    stats = {}
    profile_window(torch, lambda: run.fns["concat"](
        run.tp, run.fp, run.opt, run.batch, None),
        f"9c {cfg.name} 1 train step", card, warmup=False, stats=stats)
    for _, x in PP.leaves(run.tp):
        x.requires_grad_(False)
    del run.opt, run.tp, run.fp
    torch.cuda.empty_cache()
    return run.counts, dict(run.record, profile=stats)


def zoo_phase(torch, m, card):
    """Phase 9: each dense config of the port's registry at its published
    widths, random weights from seed 0 in its own ``param_dtype``:
    9a the online path at full depth (concat and merge with a bf16
    cache, and concat with an int8 cache for Gemma-2B's hd 256), 9b the
    cross-check of 2 float32 layers (CUDA against the CPU), 9d the serve
    engine (12 sessions on 8 slots, as phase 7), 9e streaming at 4
    layers (as 8b), then 9c training with the config's ``train_mode``
    (and, for Qwen2-0.5B and Gemma-2B, phase 6's cross-check of 2
    float32 layers).  Each model is freed before the next.  Returns (the
    launch counts of 9a, 9c, 9d and 9e, {arch: record})."""
    total, rec = {}, {}
    for arch in ZOO:
        cfg = m.get_config(arch)
        log(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.hd}, d_ff {cfg.d_ff} "
            f"({cfg.activation}), vocab {cfg.vocab_size}, qkv_bias "
            f"{cfg.qkv_bias}, tied {cfg.tie_embeddings}, embed_scale "
            f"{cfg.embed_scale}, rope theta {cfg.rope_theta:g}, "
            f"{cfg.param_dtype} params, train_mode {cfg.train_mode}, "
            f"{cfg.param_count() / 1e9:.3f} B params")
        t0 = time.perf_counter()
        params = m.init_lm(cfg, seed=0)
        randomize_lora_b(torch, params, seed=100)
        torch.cuda.synchronize()
        log(f"  {arch}: init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
        r = rec[arch] = {}
        modes = [("concat", "bfloat16"), ("merge", "bfloat16")]
        if arch == "gemma-2b":
            modes.append(("concat", "int8"))
        for mode, cdt in modes:
            add_counts(total, main_path(
                torch, m.PI, m.ops, params, cfg, mode, cdt, card,
                profile=(mode, cdt) == ("concat", "bfloat16"),
                record=r.setdefault(f"{mode}+{cdt}", {})))
        log(f"  9b {arch}: cross-check, 2 layers full width fp32, CUDA vs "
            "CPU")
        cross_check(torch, m.PI, params, cfg)
        n = ZOO_DEPTH.get(arch, cfg.n_layers)
        pn, cn = first_layers(params, n), cfg.replace(n_layers=n)
        log(f"  9d {arch}: the serve engine ({n} layers, concat, bf16 "
            "cache): 12 sessions on 8 slots, 3 tenants")
        add_counts(total, serve_phase(
            torch, m.ops, m.PI, pn, cn, card, label=f"9d {arch} {n}L",
            n_sessions=12, n_slots=8, seed=24, record=r.setdefault(
                "serve", {}), paths_witness=arch in ZOO_BATCH_GAP))
        log(f"  9e {arch}: streaming, 4 layers at full width, W 512")
        add_counts(total, stream_modes(
            torch, m.STR, m.ops, first_layers(params, 4),
            cfg.replace(n_layers=4), card, tag=f"9e {arch}"))
        log(f"  9c {arch}: training ({cfg.train_mode}, {n} layers, B4 "
            "S1216)")
        counts, r["train"] = zoo_train(torch, m.ops, m.clora, m.TR, m.PD,
                                       m.PA, m.PP, m.segment_layout, pn, cn,
                                       card)
        add_counts(total, counts)
        if arch in ("qwen2-0.5b", "gemma-2b"):
            train_cross_check(torch, m.PI, m.TR, m.PT, m.PD, m.PP,
                              m.segment_layout, params, cfg)
        del params, pn
        gc.collect()
        torch.cuda.empty_cache()
    for arch, r in rec.items():
        on = r["concat+bfloat16"]
        prof = on.get("decode_profile", {})
        log(f"  9 summary {arch}: concat+bf16 host ms per ingest "
            f"{[round(x, 2) for x in on['ingest_ms']]}, prefill "
            f"{on['prefill_ms']:.2f}, decode step {on['decode_ms']:.2f} "
            f"(merge {r['merge+bfloat16']['decode_ms']:.2f}); decode idle "
            f"{prof.get('idle', float('nan')):.3f}, float32 casts "
            f"{prof.get('cast_share', float('nan')):.3f} of busy; serve ms "
            f"per query batch {r['serve']['query_ms']:.1f}, row "
            f"{r['serve']['row_mb']:.1f} MB; train ms "
            f"{[round(x, 1) for x in r['train']['step_ms']]} (idle "
            f"{r['train']['profile'].get('idle', float('nan')):.3f}), peak "
            f"{r['train']['peak_gib']:.2f} GiB [{card}]")
    return total, rec


# ---------------------------------------------------------------------------
# phase 10: the paper's baselines in training, the gradient codecs and the
# serve-metrics demo
# ---------------------------------------------------------------------------

def baselines_train(torch, m, params, cfg, card):
    """10a: 2 AdamW steps of each baseline (``train_steps``: Gisting-online,
    then the Compressive Transformer, LoRA-only) at the full width and
    depth of ``params``, then one more step of each under the profiler
    (not counted).  Returns (launch counts, {method: record})."""
    counts, rec = {}, {}
    for method in ("gisting", "compressive"):
        run = train_steps(torch, m.ops, m.clora, m.TR, m.PD, m.PA, m.PP,
                          m.segment_layout, params, cfg, card, [method] * 2,
                          f"10a {method}")
        add_counts(counts, run.counts)
        stats = {}
        profile_window(torch, lambda: run.fns[method](
            run.tp, run.fp, run.opt, run.batch, None),
            f"10a 1 {method} train step", card, warmup=False, stats=stats)
        rec[method] = dict(run.record, profile=stats, counts={
            k: v for k, v in run.counts.items() if v})
        for _, x in m.PP.leaves(run.tp):
            x.requires_grad_(False)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    for method, r in rec.items():
        log(f"  10a summary {method}: ms per step "
            f"{[round(x, 1) for x in r['step_ms']]}, peak "
            f"{r['peak_gib']:.2f} GiB, idle share of a profiled step "
            f"{r['profile'].get('idle', float('nan')):.3f}, losses "
            f"{[round(x, 4) for x in r['losses']]} (finite), grad norms "
            f"{[round(x, 4) for x in r['grad_norms']]}, launches over the "
            f"2 steps {r['counts']}, cond_lora autograd backwards per step "
            f"{r['backward_calls']} [{card}]")
    return counts, rec


def codec_check(torch, PG, PP, like, card, rounds: int = 3):
    """10c: the gradient codecs on the card against the CPU on a gradient
    tree shaped as ``like`` (LLaMA-7B's trainable LoRA leaves and
    comp_embed, in their dtypes), drawn from seed 10: the int8 ``q``
    equal, ``scale`` within 1 float32 ulp, the top-k outputs (and so
    their masks) equal, and the residuals of ``rounds`` error-feedback
    rounds per codec within 1 float32 ulp of max|residual| per leaf.
    Returns {codec: event-timed ms per error-feedback round on the
    card}."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(10)

    def draw(r):
        return PP.tree_map(lambda _, x: None if x is None else (
            torch.randn(x.shape, generator=gen, device="cuda") * (r + 1)
        ).to(x.dtype), like)
    g0 = draw(0)
    n = sum(x.numel() for _, x in PP.leaves(g0))
    worst = dict(scale_ulps=0.0, q=0, topk=0)
    for path, x in PP.leaves(g0):
        xf = x.float()
        qc, sc = PG.quantize_int8(xf)
        qp, sp = PG.quantize_int8(xf.cpu())
        ulp = float(np.spacing(np.float32(sp.item())))
        worst["scale_ulps"] = max(worst["scale_ulps"],
                                  abs(sc.item() - sp.item()) / ulp)
        worst["q"] += int((qc.cpu() != qp).sum())
        tc, tp_ = PG.topk_sparsify(xf, 0.01), PG.topk_sparsify(xf.cpu(), 0.01)
        worst["topk"] += int(((tc.cpu() != 0) != (tp_ != 0)).sum()) \
            + int((tc.cpu() != tp_).sum())
    log(f"  10c int8 / topk on {len(PP.leaves(g0))} leaves, {n} elements: "
        f"q differs at {worst['q']}, scale within {worst['scale_ulps']:.1f} "
        f"ulp, topk outputs and masks differ at {worst['topk']}")
    if worst["q"] or worst["scale_ulps"] > 1.0 or worst["topk"]:
        raise AssertionError(f"10c codecs: card against CPU {worst}")
    ms = {}
    for codec in ("int8", "topk"):
        efc, efp = PG.init_ef(g0), PG.init_ef(PP.tree_map(
            lambda _, x: None if x is None else x.cpu(), g0))
        rel = 0.0
        for r in range(rounds):
            g = draw(r)
            _, efc = PG.compress_with_ef(g, efc, codec)
            _, efp = PG.compress_with_ef(PP.tree_map(
                lambda _, x: None if x is None else x.cpu(), g), efp, codec)
            for (path, a), (_, b) in zip(PP.leaves(efc.residual),
                                         PP.leaves(efp.residual)):
                lim = float(np.spacing(np.float32(b.abs().max().item())))
                err = max_err(a.cpu(), b)
                if not err <= lim:
                    raise AssertionError(f"10c {codec} round {r + 1} "
                                         f"{'/'.join(path)}: residual "
                                         f"max|d| {err} > {lim}")
                rel = max(rel, err / lim)
        ms[codec] = time_ms(torch, lambda i: PG.compress_with_ef(
            g0, efc, codec), iters=5, warmup=1)
        log(f"  10c {codec}: {rounds} error-feedback rounds, residuals "
            f"card vs CPU worst max|d| / (1 float32 ulp of max|r|) "
            f"{rel:.3f}; {ms[codec]:.3f} ms per round on the card [{card}]")
    return ms


def _metric_counters(snap):
    """The counter families of a metrics snapshot, timing families and
    the padded byte count excluded."""
    timing = ("seconds", "bandwidth", "lateness", "latency")
    return {name: fam["values"] for name, fam in snap.items()
            if fam["type"] == "counter" and name != "offload_bytes_total"
            and not any(t in name for t in timing)}


def _families(text):
    return sorted(ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE "))


def serve_metrics_check(torch, ops, card):
    """10d: ``scripts/serve_metrics_torch.py``'s demo engine on the card
    against the same demo on the CPU: equal counters (timing families
    excluded) and the same Prometheus families.  Returns the card run's
    launch counts."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_metrics_torch", ROOT / "scripts" / "serve_metrics_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card_eng = mod.demo_engine("cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    cpu_eng = mod.demo_engine("cpu")
    t_cpu = time.perf_counter() - t0
    a = _metric_counters(card_eng.metrics_snapshot()["metrics"])
    b = _metric_counters(cpu_eng.metrics_snapshot()["metrics"])
    fa = _families(card_eng.metrics_prometheus())
    fb = _families(cpu_eng.metrics_prometheus())
    if a != b or fa != fb:
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        raise AssertionError(f"10d: counters differ at {diff}, or the "
                             f"Prometheus families ({len(fa)} vs {len(fb)})")
    snap = card_eng.metrics_snapshot()["metrics"]
    offl = {v["labels"]["dir"]: v["value"]
            for v in snap["offload_sessions_total"]["values"]}
    log(f"  10d serve-metrics demo (n_shards=1): {len(a)} counter families "
        f"equal card vs CPU, {len(fa)} Prometheus families equal; offloads "
        f"{offl}; launches {({k: v for k, v in counts.items() if v})}; "
        f"card {t_card:.1f} s, cpu {t_cpu:.1f} s [{card}]")
    if not (counts["cond_lora"] and counts["segmented_attention"]
            and counts["session_gather"] and counts["session_scatter"]):
        raise AssertionError(f"10d: a kernel never launched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the recurrent families (Mamba2, the Zamba2 hybrid) at full width
# ---------------------------------------------------------------------------

RECURRENT = ("mamba2-370m", "zamba2-1.2b")
# per config: the online ingest's context tokens (with the <COMP> group at
# the hybrid's sites the SSD block is 64 tokens, within one chunk); the
# float32 depth cut of 11b (the hybrid's: 2 groups of 4 Mamba2 layers,
# each followed by the shared block, and a remainder of 1; float32
# gradients through more layers lie past the 1e-3 limit from float64,
# scripts/recurrent_xcheck_probe.py) and its context tokens; and the
# training layout (S 1280 = 5 SSD chunks of 256; S 1152 = 9 of 128: a
# block must be at most ssm_chunk tokens or a multiple of it); 11d's
# float32 engine depth, held against float64 sessions on the host (6
# layers; the hybrid 7: one group of 6 and its shared site, then 1; at
# 12 / 13 layers the float64 sessions took 65 s of a slow host's run)
REC = {"mamba2-370m": dict(lc=64, xcut=dict(n_layers=2), xlc=62,
                           ecut=dict(n_layers=6),
                           layout=(16, 62, 2, 256), modes=("concat",) * 2),
       "zamba2-1.2b": dict(lc=56, xcut=dict(n_layers=9, attn_every=4),
                           xlc=56, ecut=dict(n_layers=7),
                           layout=ZAMBA_LAYOUT,
                           modes=("concat", "concat", "merge"))}


def recurrent_online(torch, m, params, cfg, mode, card, record):
    """11a: B=4 lanes, 4 ingests of ``REC[...]["lc"]`` context tokens, a
    256-token prefill into a 320-token cache and 32 greedy tokens (twice:
    the explicit loop and ``generate``), the launches held to what the
    path implies (none for mamba2; at the hybrid's 6 shared-attention
    sites, as phase 3 per layer), the counters and state shapes checked;
    host ms per step kind and a profiled decode (idle share, float32
    cast share) stored in ``record``.  Returns the launch counts."""
    from repro_torch.core.memory import mem_layers
    PI, ops = m.PI, m.ops
    B, T, PROMPT, CACHE, NEW = 4, 4, 256, 320, 32
    lc = REC[cfg.name]["lc"]
    rcfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, mode=mode))
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(11)
    chunks = [torch.randint(0, cfg.vocab_size, (B, lc), generator=gen,
                            device=dev) for _ in range(T)]
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                           device=dev)
    st = PI.init_online_state(rcfg, B, CACHE, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ingest_ms = []
    for ch in chunks:
        t0 = time.perf_counter()
        st = PI.ingest_context(params, rcfg, st, ch)
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
    st_ingested = clone_state(torch, st)
    t0 = time.perf_counter()
    logits, st = PI.prefill(params, rcfg, st, prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks = [logits[:, -1].argmax(-1)]
    finite = bool(torch.isfinite(logits).all())
    t0 = time.perf_counter()
    for _ in range(NEW - 1):
        lg, st = PI.decode_step(params, rcfg, st, toks[-1][:, None])
        finite &= bool(torch.isfinite(lg).all())
        toks.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    manual = torch.stack(toks, 1).to(torch.int32)
    t0 = time.perf_counter()
    gen_toks = PI.generate(params, rcfg, st_ingested, prompt, NEW)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()

    name = f"11a {cfg.name} {mode if cfg.ccm.enabled else 'no CCM'}"
    if not finite or not bool(torch.isfinite(st.ssm.ssm).all()):
        raise AssertionError(f"{name}: non-finite logits or SSD state")
    if not torch.equal(gen_toks, manual):
        raise AssertionError(f"{name}: generate tokens differ from the "
                             "prefill + decode_step loop")
    sites, mlen = mem_layers(cfg), cfg.ccm.comp_len if cfg.ccm.enabled else 0
    want_counts = {k: 0 for k in counts}
    want_counts.update({"segmented_attention": sites * (T + 2 * NEW),
                        "segmented_attention_mma": sites * (T + 2),
                        "segmented_attention_splitk": sites * 2 * (NEW - 1),
                        "cond_lora": 4 * sites * T,
                        "cond_lora_wgmma": 4 * sites * T,
                        "kv_merge_update": T if sites and mode == "merge"
                        else 0})
    if counts != want_counts:
        raise AssertionError(f"{name}: launches {counts} != {want_counts}")
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    want_state = dict(pos=T * (lc + mlen) + PROMPT + NEW - 1,
                      ssm=(cfg.n_layers, B, H, P, N), dtype=cfg.cdtype)
    got_state = dict(pos=st.pos, ssm=tuple(st.ssm.ssm.shape),
                     dtype=st.ssm.ssm.dtype)
    if sites:
        want_state.update(slots=T if mode == "concat" else 1, steps=T,
                          length=PROMPT + NEW - 1,
                          cache=(sites, B, CACHE, cfg.n_kv_heads, cfg.hd))
        got_state.update(slots=st.mem.slots, steps=st.mem.steps,
                         length=st.cache.length,
                         cache=tuple(st.cache.k.shape))
    elif st.cache is not None or st.mem is not None:
        raise AssertionError(f"{name}: an ssm state with a cache or memory")
    if got_state != want_state:
        raise AssertionError(f"{name}: state {got_state} != {want_state}")
    log(f"  {name}: ingest ms {[round(t, 2) for t in ingest_ms]}, prefill "
        f"{PROMPT} tok x {B} {prefill_ms:.2f} ms, decode "
        f"{decode_ms / (NEW - 1):.2f} ms/step "
        f"({B * (NEW - 1) / decode_ms * 1e3:.1f} tok/s), generate "
        f"{generate_ms:.1f} ms [{card}]")
    log(f"  {name}: launches {({k: v for k, v in counts.items() if v})} "
        "(as the path implies)")
    record.update(ingest_ms=ingest_ms, prefill_ms=prefill_ms,
                  decode_ms=decode_ms / (NEW - 1), generate_ms=generate_ms)

    def decode3():              # after the counts: these are not counted
        nonlocal st
        for _ in range(3):
            _, st = PI.decode_step(params, rcfg, st, toks[-1][:, None])
    stats = {}
    by = profile_window(torch, decode3, f"{name} 3 decode steps", card,
                        stats=stats)
    if stats:
        cast = f32_cast_ms(by)
        stats.update(cast_ms=cast, cast_share=cast / stats["busy_ms"])
        log(f"  {name}: float32 -> bf16 copies {cast:.3f} ms of the "
            f"{stats['busy_ms']:.3f} busy ms of 3 decode steps "
            f"({stats['cast_share']:.3f}) [{card}]")
    record["decode_profile"] = stats
    return counts


def xcheck_inputs(torch, m, cfg, cut=None):
    """11b's config (``cut`` of the layers, by default ``REC[...]
    ["xcut"]``, in float32) and inputs on the host: 3 context chunks, a
    64-token prompt, 4 forced decode tokens (B=2), and a training batch
    over a 256-token layout."""
    cut = cut or REC[cfg.name]["xcut"]
    lc = REC[cfg.name]["xlc"]
    c2 = cfg.replace(compute_dtype="float32", param_dtype="float32", **cut)
    layout = m.segment_layout(3, lc, cfg.ccm.comp_len, 64)     # S = 256
    B = 2
    gen = torch.Generator().manual_seed(5)
    return types.SimpleNamespace(
        cfg=c2, layout=layout, B=B,
        chunks=[torch.randint(0, c2.vocab_size, (B, lc), generator=gen)
                for _ in range(3)],
        prompt=torch.randint(0, c2.vocab_size, (B, 64), generator=gen),
        forced=[torch.randint(0, c2.vocab_size, (B, 1), generator=gen)
                for _ in range(4)],
        batch=m.PD.sample_kv_batch(m.PD.ShardableIndexIterator(3, B)
                                   .key_for(0), layout, B, device="cpu"))


def xcheck_run(torch, m, params, inp, mode, dev):
    """One 11b run of ``inp.cfg`` on ``dev``, its weights ``params`` cut
    to its layers in its ``param_dtype``: the online path's logits and
    final state, then ``train_forward``'s loss, tail logits and every
    gradient (full training), all moved to the host."""
    PI, TR, PT, PP = m.PI, m.TR, m.PT, m.PP
    cm = inp.cfg.replace(ccm=dataclasses.replace(inp.cfg.ccm, mode=mode))
    t0 = time.perf_counter()
    pp = PP.tree_map(lambda _, x: x.to(cm.pdtype),
                     fp32_layers(torch, params, dev, cm.n_layers))
    st = PI.init_online_state(cm, inp.B, 72, device=dev)
    for ch in inp.chunks:
        st = PI.ingest_context(pp, cm, st, ch.to(dev))
    lg, st = PI.prefill(pp, cm, st, inp.prompt.to(dev), full_logits=True)
    logits = [lg]
    for tok in inp.forced:
        lg, st = PI.decode_step(pp, cm, st, tok.to(dev))
        logits.append(lg)
    tp, fp = PP.partition(pp, TR.trainable_mask_for(cm, pp))
    leaves = PP.leaves(tp)
    for _, x in leaves:
        x.requires_grad_(True)
    b = {k: v.to(dev) for k, v in inp.batch.items()}
    lay = inp.layout
    tl = PT.train_forward(PP.merge(tp, fp), cm, b["tokens"], lay)
    loss = TR.next_token_loss(tl, b["tokens"][:, lay.seq_len - lay.tail_len:],
                              b["loss_mask"])
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    state = {"ssm.ssm": st.ssm.ssm, "ssm.conv": st.ssm.conv}
    ints = (st.pos,)
    if st.cache is not None:
        state.update({"mem.k": st.mem.k, "mem.v": st.mem.v,
                      "cache.k": st.cache.k, "cache.v": st.cache.v})
        ints += (st.mem.slots, st.mem.steps, st.cache.length)
    return types.SimpleNamespace(
        logits=[x.detach().cpu() for x in logits],
        state={k: v.cpu() for k, v in state.items()}, ints=ints,
        loss=loss.detach().cpu(), train_logits=tl.detach().cpu(),
        grads={"/".join(p): g.cpu() for (p, _), g in zip(leaves, grads)},
        secs=time.perf_counter() - t0)


def xcheck_compare(a, b, mode, worst, over):
    """Every tensor of run ``a`` against run ``b`` at 1e-3 x max|b|:
    updates ``worst`` ({what: max|d| / limit}) and lists the tensors past
    the limit in ``over``.  Counters must be equal."""
    def close(what, x, y):
        lim = 1e-3 * y.abs().max().item()
        err = max_err(x, y)
        if not err <= lim:
            over.append(f"{what} {mode} {err / lim:.2f}x")
        key = " ".join(what.split()[:2])
        worst[key] = max(worst.get(key, 0.0), err / lim)
    for i, (x, y) in enumerate(zip(a.logits, b.logits)):
        close(f"online logits {i}", x, y)
    for k in b.state:
        close(f"state leaves {k}", a.state[k], b.state[k])
    if a.ints != b.ints:
        raise AssertionError(f"counters differ: {a.ints} vs {b.ints}")
    close("train loss", a.loss, b.loss)
    close("train logits", a.train_logits, b.train_logits)
    for k in b.grads:
        if not b.grads[k].abs().max().item() > 0:
            raise AssertionError(f"gradient {k} is all zero")
        close(f"train gradients {k}", a.grads[k], b.grads[k])


def recurrent_cross_check(torch, m, params, cfg, modes):
    """11b: the first layers at full width in float32 (``REC[...]
    ["xcut"]``: for the hybrid 2 groups of 4 Mamba2 layers, each followed
    by its shared-attention site, and a remainder of 1), CUDA (kernels)
    against the CPU (plain versions): the online path (3 ingests, a
    64-token prefill, 4 forced decode steps: logits and every state
    leaf) and ``train_forward`` over a 256-token layout (loss, tail
    logits and the gradient of every leaf, full training), each within
    1e-3 x max|.|; counters equal."""
    inp = xcheck_inputs(torch, m, cfg)
    worst, over, secs = {}, [], [0.0, 0.0]
    for mode in modes:
        a = xcheck_run(torch, m, params, inp, mode, "cuda")
        b = xcheck_run(torch, m, params, inp, mode, "cpu")
        xcheck_compare(a, b, mode, worst, over)
        secs = [secs[0] + a.secs, secs[1] + b.secs]
    log(f"  11b {cfg.name} ({inp.cfg.n_layers} layers fp32, "
        f"{REC[cfg.name]['xcut']}, {', '.join(modes)}): {len(b.state)} "
        f"state leaves, {len(b.grads)} gradient leaves; worst max|d| / "
        "(1e-3 max|.|): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + f"; cuda {secs[0]:.1f} s, cpu {secs[1]:.1f} s")
    if over:
        raise AssertionError(f"11b {cfg.name}: past 1e-3 x max|.|: {over}")


def recurrent_serve(torch, m, params, cfg, card, record):
    """11d: ``ServeEngine``, 12 sessions over 3 tenants on 8 slots (LRU
    offload and restore), 3 contexts of ``REC[...]["lc"]`` tokens each
    and one 32-token query (exact lengths: a recurrent state cannot skip
    pad tokens), one fork of a resident session.  Run twice on the same
    traffic.  (1) float32 compute at the depth ``REC[...]["ecut"]`` (the
    published layer pattern, its first 6 or 7 layers: the float64
    sessions on the CPU cost ~4 s a layer at full depth): every answer
    (B32) held within 1e-3 x max|logit| of its session run alone in
    float64 on the CPU (F64), the lane check at every layer of the cut
    (a lane leak puts another session's logits there, ~1000 x the
    limit); the session alone in float32 on the card (A32) is printed
    beside.  (2) the config's bf16 at full depth: each answer (B) and
    the session alone in bf16 (A) against the session alone in float32
    at full depth (F), in units of bf16_tol(F) (held: d(B, F) within 2x of
    d(A, F), largest and median), and d(B, A) against the spread of
    batching alone, d(A8, A), with A8 the session as lane 0 of an 8-lane
    online batch of its own copies (held: d(B, A) within 2x of d(A8, A),
    largest and median).  In bf16, d(A, F) reaches the scale of the
    logits at this depth, so (2) witnesses rounding and (1) is the lane
    check.  A row offloaded and restored comes back bit-equal.  Returns
    the bf16 run's launch counts."""
    import numpy as np
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.arena import tree_leaves
    PI, ops = m.PI, m.ops
    rs = np.random.default_rng(24)
    dev = params["embed"].device
    V, lc = cfg.vocab_size, REC[cfg.name]["lc"]
    sids = [f"s{i}" for i in range(12)]
    ctx = {s: [rs.integers(0, V, lc).astype(np.int32) for _ in range(3)]
           for s in sids}
    qry = {s: rs.integers(0, V, 32).astype(np.int32)
           for s in sids + ["fork"]}

    def alone(c, p, sid, lanes=1):
        """The session run alone, or as lane 0 of ``lanes`` copies of
        itself, on the device of ``p``."""
        src = sid if sid != "fork" else parent
        d = p["embed"].device
        st = PI.init_online_state(c, lanes, 64, device=d)
        for x in ctx[src]:
            st = PI.ingest_context(p, c, st, torch.as_tensor(
                x, device=d)[None].expand(lanes, -1))
        lg, _ = PI.prefill(p, c, st, torch.as_tensor(
            qry[sid], device=d)[None].expand(lanes, -1), full_logits=True)
        return lg[0].double().cpu()

    def serve(c, p, tag):
        nonlocal parent
        eng = ServeEngine(p, c, n_slots=8, cache_len=64, device=dev)
        mgr = eng._mgr["online"]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i, sid in enumerate(sids):
            eng.create_session(sid, tenant=f"t{i % 3}")
        for r in range(3):
            for sid in sids:
                eng.ingest(sid, ctx[sid][r])
            eng.run()
        parent = next(s for s in reversed(sids) if mgr.sessions[s].resident)
        eng.fork_session(parent, "fork")
        eng.run()
        torch.cuda.synchronize()
        ingest_ms = (time.perf_counter() - t0) * 1e3
        order = [parent, "fork"] + [s for s in sids if s != parent]
        reqs = {s: eng.query(s, qry[s]).request for s in order}
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        query_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        snap = eng.metrics_snapshot()["metrics"]
        moved = {v["labels"]["dir"]: int(v["value"])
                 for v in snap["offload_sessions_total"]["values"]}
        nb = {k: int(sum(v["value"] for v in snap["serve_batches_total"][
            "values"] if v["labels"].get("kind") == k))
            for k in ("ingest", "query")}
        forks = int(snap["serve_fork_total"]["values"][0]["value"])
        errs = mgr.arena.consistency_errors()
        if errs or moved["offload"] <= 0 or moved["restore"] <= 0 \
                or forks != 1 or eng.ragged:
            raise AssertionError(f"11d {cfg.name} {tag}: consistency {errs}, "
                                 f"moved {moved}, forks {forks}")
        out = {}
        for sid, req in reqs.items():
            if not req.done or req.result is None \
                    or req.result.shape != (32, V) \
                    or not np.isfinite(req.result).all():
                raise AssertionError(f"11d {cfg.name} {tag}: query of {sid}")
            out[sid] = torch.from_numpy(req.result)
        # an offloaded row comes back bit-equal
        sid = next(s for s in sids if mgr.sessions[s].resident)
        before = mgr.arena.read_slot(mgr.sessions[sid].slot)
        eng.offload_session(sid)
        mgr.sync()
        mgr.activate_batch([sid])
        after = mgr.arena.read_slot(mgr.sessions[sid].slot)
        if not all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else a == b for a, b in zip(tree_leaves(before),
                                               tree_leaves(after))):
            raise AssertionError(f"11d {cfg.name} {tag}: {sid}'s row "
                                 "changed over an offload and restore")
        row_mb = mgr.arena.state_bytes / 1e6
        log(f"  11d {cfg.name} {tag}: batches {nb}, offloads "
            f"{moved['offload']}, restores {moved['restore']}, fork 1; "
            f"ingests + fork {ingest_ms:.1f} ms, query drain {query_ms:.1f} "
            f"ms; row {row_mb:.1f} MB, restored bit-equal; launches "
            f"{({k: v for k, v in counts.items() if v})} [{card}]")
        del eng
        torch.cuda.empty_cache()
        return out, counts, dict(ingest_ms=ingest_ms, query_ms=query_ms,
                                 row_mb=row_mb, batches=nb, parent=parent)

    parent = None
    c32 = cfg.replace(compute_dtype="float32", **REC[cfg.name]["ecut"])
    p32 = fp32_layers(torch, params, dev, c32.n_layers)
    e32, _, rec32 = serve(c32, p32, f"float32 {c32.n_layers} layers")
    c64 = c32.replace(compute_dtype="float64", param_dtype="float64")
    p64 = m.PP.tree_map(lambda _, x: x.double(), fp32_layers(
        torch, params, "cpu", c32.n_layers))
    dB32, dA32 = {}, {}
    t0 = time.perf_counter()
    for sid, got in e32.items():
        f64 = alone(c64, p64, sid)
        lim = 1e-3 * f64.abs().max().item()
        dB32[sid] = max_err(got, f64) / lim
        dA32[sid] = max_err(alone(c32, p32, sid), f64) / lim
    del p64, p32
    f64_s = time.perf_counter() - t0
    c32 = cfg.replace(compute_dtype="float32")
    a32 = {sid: alone(c32, params, sid) for sid in e32}
    d32 = (("B32", dB32), ("A32", dA32))
    med32 = {k: float(np.median(list(d.values()))) for k, d in d32}
    top32 = {k: max(d.values()) for k, d in d32}
    log(f"  11d {cfg.name} float32 at {c64.n_layers} layers against the "
        "float64 sessions alone (x 1e-3 max|logit|): served B32 median "
        f"{med32['B32']:.4f} max {top32['B32']:.4f}, alone A32 median "
        f"{med32['A32']:.4f} max {top32['A32']:.4f}; {len(e32)} float64 "
        f"sessions on the CPU in {f64_s:.1f} s [{card}]")
    over = {k: v for k, v in dB32.items() if not v <= 1.0}
    if over:
        raise AssertionError(f"11d {cfg.name} float32: served answers past "
                             f"1e-3 x max|logit| from float64: {over}")

    # (2) bf16 at full depth: the witness of where the gap comes from
    ebf, counts, rec = serve(cfg, params, "bf16")
    if rec["parent"] != rec32["parent"]:
        raise AssertionError(f"11d {cfg.name}: the two runs forked "
                             f"{rec32['parent']} and {rec['parent']}")
    dA, dB, gap, spread, same = {}, {}, {}, {}, 0
    for sid, got in ebf.items():
        f32 = a32[sid]
        a = alone(cfg, params, sid)
        a8 = alone(cfg, params, sid, lanes=8)
        tol, tol_a = bf16_tol(f32), bf16_tol(a)
        dA[sid] = max_err(a, f32) / tol
        dB[sid] = max_err(got, f32) / tol
        gap[sid] = max_err(got, a) / tol_a
        spread[sid] = max_err(a8, a) / tol_a
        same += max_err(got, a8) == 0
    ds = (("A", dA), ("B", dB), ("gap", gap), ("spread", spread))
    med = {k: float(np.median(list(d.values()))) for k, d in ds}
    top = {k: max(d.values()) for k, d in ds}
    log(f"  11d {cfg.name} bf16 witness (x bf16_tol of the float32 session "
        f"alone F): served B vs F median {med['B']:.2f} max {top['B']:.2f}; "
        f"alone A vs F median {med['A']:.2f} max {top['A']:.2f}; B vs A "
        f"median {med['gap']:.2f} max {top['gap']:.2f}, A8 (8 copies) vs A "
        f"median {med['spread']:.2f} max {top['spread']:.2f} (x "
        f"bf16_tol(A)); B bit-equal to A8 in {same} of {len(ebf)}; per "
        "session B/A "
        f"{[round(dB[s] / dA[s], 2) for s in sorted(dA)]} [{card}]")
    for k in ("max", "median"):
        pick = top if k == "max" else med
        b, a = pick["B"], pick["A"]
        if not (b <= 2 * a and a <= 2 * b):
            raise AssertionError(
                f"11d {cfg.name}: bf16 served answers lie {b:.2f} x "
                f"bf16_tol from float32 ({k}), the sessions alone {a:.2f}: "
                "not within 2x")
        if not pick["gap"] <= 2 * pick["spread"]:
            raise AssertionError(
                f"11d {cfg.name}: bf16 served answers lie {pick['gap']:.2f} "
                f"x bf16_tol from their sessions alone ({k}), 8 copies of a "
                f"session {pick['spread']:.2f}: not within 2x")
    record.update(rec, witness=dict(median=med, max=top, same=same),
                  f64=dict(median=med32, max=top32, secs=f64_s))
    return counts


def ssm_ops(torch, m, card):
    """11e: the SSD pieces alone at the phase's shapes (plain PyTorch, no
    kernel: jnp in the reference too), device time beside the least time
    the card could take (float32 operations of the chunked scan, or the
    bytes of one decode step's state read and write)."""
    from repro_torch.models import ssm as SSM
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    for arch, B, S in (("mamba2-370m", 4, 256), ("mamba2-370m", 4, 1280),
                       ("zamba2-1.2b", 4, 1152)):
        cfg = m.get_config(arch)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        Q = min(cfg.ssm_chunk, S)
        x = torch.randn(B, S, H, P, generator=g, device="cuda").to(bf)
        dt = torch.rand(B, S, H, generator=g, device="cuda") * 0.1
        A = -torch.rand(H, generator=g, device="cuda")
        Bm = torch.randn(B, S, N, generator=g, device="cuda").to(bf)
        Cm = torch.randn(B, S, N, generator=g, device="cuda").to(bf)
        ms = device_ms(torch, lambda i: SSM.ssd_chunked(x, dt, A, Bm, Cm, Q),
                       10)
        call = time_ms(torch, lambda i: SSM.ssd_chunked(x, dt, A, Bm, Cm, Q),
                       10, 2)
        # multiply-adds per chunk: scores C.B^T (Q x Q x N) and y_diag
        # (Q x Q x P per head) in bf16, the chunk states and y_off (Q x P x
        # N per head each) in float32; the bf16 part counted at the
        # tensor cores' rate, in float32-equivalent operations
        nc = S // Q
        ops_bf = 2.0 * B * nc * (Q * Q * N + H * Q * Q * P)
        ops_f32 = 2.0 * B * nc * 2 * H * Q * P * N
        nbytes = 2 * (x.numel() + Bm.numel() + Cm.numel()) + 4 * dt.numel() \
            + 4 * A.numel() + 2 * x.numel() + 2 * B * H * P * N
        bms, by = bound(nbytes, ops_f32 + ops_bf * PEAK_F32 / PEAK_BF16,
                        PEAK_F32)
        key = f"ssd_chunked {arch} B{B} S{S}"
        rows[key] = dict(ms=ms, call_ms=call, bound_ms=bms, bound_by=by)
        log(f"  11e {key} H{H} P{P} N{N} chunk {Q}: {ms:.4f} ms device "
            f"({call:.4f} ms per back-to-back call), bound {bms:.4f} ms "
            f"({by}), {bms / ms:.3f} of the bound [{card}]")
    return rows


def recurrent_phase(torch, m, card):
    """Phase 11: each recurrent config of the port's registry at its
    published widths and full depth, random float32 weights from seed 0,
    one model at a time: 11a the online path (zamba2-1.2b in concat and
    merge), 11b the CUDA vs CPU cross-check, 11d the serve engine with
    the bf16 witness, then 11c full training; 11e the SSD ops alone.
    Returns (the launch counts of 11a, 11c and 11d's bf16 run, {arch:
    record})."""
    total, rec = {}, {}
    for arch in RECURRENT:
        cfg = m.get_config(arch)
        log(f"  {arch}: {cfg.family}, {cfg.n_layers} layers, d "
            f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads "
            f"x {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}"
            + (f", {cfg.n_layers // cfg.attn_every} shared attention sites "
               f"{cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.hd}, d_ff {cfg.d_ff},"
               f" CCM comp_len {cfg.ccm.comp_len}" if cfg.attn_every else
               ", no CCM")
            + f", {cfg.param_dtype} params, {cfg.compute_dtype} compute, "
            f"{cfg.param_count() / 1e9:.3f} B params")
        t0 = time.perf_counter()
        params = m.init_lm(cfg, seed=0)
        if cfg.ccm.enabled:
            randomize_lora_b(torch, params, seed=100)
        torch.cuda.synchronize()
        log(f"  {arch}: init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
        r = rec[arch] = {}
        modes = ("concat", "merge") if cfg.ccm.enabled else ("concat",)
        for mode in modes:
            add_counts(total, recurrent_online(
                torch, m, params, cfg, mode, card,
                r.setdefault(mode if cfg.ccm.enabled else "none", {})))
        log(f"  11b {arch}: cross-check, full width fp32 cut to "
            f"{REC[arch]['xcut']}, CUDA vs CPU (online path and "
            "train_forward with gradients)")
        recurrent_cross_check(torch, m, params, cfg, modes)
        log(f"  11d {arch}: the serve engine ({cfg.n_layers} layers, exact "
            "lengths): 12 sessions on 8 slots, 3 tenants")
        add_counts(total, recurrent_serve(torch, m, params, cfg, card,
                                          r.setdefault("serve", {})))
        lay = REC[arch]["layout"]
        log(f"  11c {arch}: full training, {len(REC[arch]['modes'])} AdamW "
            f"steps ({', '.join(REC[arch]['modes'])}"
            f"{'' if cfg.ccm.enabled else ': no CCM'}), B4, layout {lay}")
        run = train_steps(torch, m.ops, m.clora, m.TR, m.PD, m.PA, m.PP,
                          m.segment_layout, params, cfg, card,
                          list(REC[arch]["modes"]), f"11c {arch}",
                          layout=lay)
        add_counts(total, run.counts)
        stats = {}
        profile_window(torch, lambda: run.fns["concat"](
            run.tp, run.fp, run.opt, run.batch, None),
            f"11c {arch} 1 train step", card, warmup=False, stats=stats)
        r["train"] = dict(run.record, profile=stats)
        for _, x in m.PP.leaves(run.tp):
            x.requires_grad_(False)
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
    ops_rows = ssm_ops(torch, m, card)
    for arch, r in rec.items():
        for mode in ("none", "concat", "merge"):
            if mode not in r:
                continue
            on, prof = r[mode], r[mode].get("decode_profile", {})
            log(f"  11 summary {arch} {mode}: host ms per ingest "
                f"{[round(x, 2) for x in on['ingest_ms']]}, prefill "
                f"{on['prefill_ms']:.2f}, decode step {on['decode_ms']:.2f}; "
                f"decode idle {prof.get('idle', float('nan')):.3f}, float32 "
                f"casts {prof.get('cast_share', float('nan')):.3f} of busy "
                f"[{card}]")
        sv, tr = r["serve"], r["train"]
        log(f"  11 summary {arch}: serve ms per query drain "
            f"{sv['query_ms']:.1f}, row {sv['row_mb']:.1f} MB, float32 "
            f"answers at most {sv['f64']['max']['B32']:.4f} x 1e-3 "
            f"max|logit| from float64, bf16 witness max B "
            f"{sv['witness']['max']['B']:.2f} / A "
            f"{sv['witness']['max']['A']:.2f} x bf16_tol; train ms "
            f"{[round(x, 1) for x in tr['step_ms']]} (idle "
            f"{tr['profile'].get('idle', float('nan')):.3f}), peak "
            f"{tr['peak_gib']:.2f} GiB [{card}]")
    return total, rec, ops_rows


# ---------------------------------------------------------------------------
# phase 12: the encoder-decoder, the VLM and MoE
# ---------------------------------------------------------------------------

FAMILIES = ("whisper-tiny", "pixtral-12b", "phi3.5-moe-42b-a6.6b",
            "llama4-maverick-400b-a17b")
# depth cuts (never width): phi3.5-moe's 32 layers hold 84 GB of experts
# in bf16, llama4-maverick's 128 experts 32 GB a layer; phi3.5-moe and
# pixtral-12b are cut to keep the script within its time limit (at 16
# and 40 layers they were phase 12's two longest paths, 96.1 and 67.3 s
# on an NVIDIA H100 80GB HBM3 at 700 W; phi3.5-moe at 8 layers still
# took 92.5 s of a 1088 s run on a slow host), every check and launch
# kept
FAM_DEPTH = {"pixtral-12b": 12, "phi3.5-moe-42b-a6.6b": 4,
             "llama4-maverick-400b-a17b": 1}
# whisper's published n_text_ctx (Radford et al. 2022): 448-token prefills
WHISPER_TEXT = 448
# per config: the online prefill (vlm: 1024 patch positions + 64 text
# tokens) and its cache, the training layout and steps (None: online
# only), and whether the engine's answers are held to bf16_tol_paths
# beside serve_witness (pixtral's 12 bf16 layers; MoE's bf16 engine is
# held to bf16_tol_paths with its expert ids pinned, see serve_phase)
FAM = {"whisper-tiny": dict(prompt=WHISPER_TEXT, cache=512,
                            layout=(16, 64, 4, 64),
                            steps=("concat", "concat", "merge"),
                            paths=False),
       "pixtral-12b": dict(prompt=1024 + 64, cache=1152,
                           layout=(16, 64, 8, 64),
                           steps=("concat", "concat", "merge"), paths=True),
       "phi3.5-moe-42b-a6.6b": dict(prompt=448, cache=512,
                                    layout=(16, 64, 8, 64),
                                    steps=("concat", "merge"), paths=False),
       "llama4-maverick-400b-a17b": dict(prompt=448, cache=512,
                                         layout=None, steps=(),
                                         paths=False)}


def family_inputs(torch, cfg, B, dev, seed, n_patches=None, n_frames=None):
    """The family's non-token input, random from ``seed``: ``frames``
    (encdec, (B, 1500, d) in the compute dtype: the encoder's
    precomputed input) or ``patches`` (vlm, (B, 1024, 1024): ViT
    outputs), else {}."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": torch.randn(
            B, n_frames or WHISPER_FRAMES, cfg.d_model, generator=gen,
            device=dev).to(cfg.cdtype)}
    if cfg.family == "vlm":
        return {"patches": torch.randn(
            B, n_patches or cfg.n_frontend_tokens, 1024, generator=gen,
            device=dev).to(cfg.cdtype)}
    return {}


def family_xcheck(torch, m, params, cfg, card):
    """12d: the first 2 layers (whisper: 2 + 2) at full width in float32,
    CUDA (kernels) against the CPU (plain versions): the online path (3
    ingests of 32 tokens; for whisper the encoder's cross K/V of 1500
    frames first; a prefill of 64 text tokens, for pixtral after 64 patch
    positions; 4 forced decode steps: logits and every state leaf, cross
    K/V included) and ``train_forward`` over a 3-step layout (S 152 +
    3 m) with the family's input in full training (loss, tail logits and
    the gradient of every leaf: encoder, patch projection, experts and
    router included), each within 1e-3 x max|.|; counters equal.
    Returns {what: worst max|d| / limit}."""
    PI, TR, PT, PP = m.PI, m.TR, m.PT, m.PP
    c2 = cfg.replace(n_layers=2, n_enc_layers=min(cfg.n_enc_layers, 2),
                     compute_dtype="float32", param_dtype="float32",
                     train_mode="full")
    B = 2
    gen = torch.Generator().manual_seed(5)
    chunks = [torch.randint(0, c2.vocab_size, (B, 32), generator=gen)
              for _ in range(3)]
    n_p = 64 if cfg.family == "vlm" else 0
    prompt = torch.randint(0, c2.vocab_size, (B, n_p + 64), generator=gen)
    forced = [torch.randint(0, c2.vocab_size, (B, 1), generator=gen)
              for _ in range(4)]
    layout = m.segment_layout(3, 40, cfg.ccm.comp_len, 32)
    batch = m.PD.sample_kv_batch(m.PD.ShardableIndexIterator(3, B)
                                 .key_for(0), layout, B, device="cpu")
    extra = family_inputs(torch, c2, B, "cpu", 6, n_patches=64)
    batch.update(extra)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pp = fp32_layers(torch, params, dev)
        st = PI.init_online_state(c2, B, 160, device=dev)
        if cfg.family == "encdec":
            st = st._replace(cross=PI.encode_cross(
                pp, c2, extra["frames"].to(dev)))
        for ch in chunks:
            st = PI.ingest_context(pp, c2, st, ch.to(dev))
        kw = {"patches": extra["patches"].to(dev)} if n_p else {}
        lg, st = PI.prefill(pp, c2, st, prompt.to(dev), full_logits=True,
                            **kw)
        logits = [lg]
        for tok in forced:
            lg, st = PI.decode_step(pp, c2, st, tok.to(dev))
            logits.append(lg)
        state = {"mem.k": st.mem.k, "mem.v": st.mem.v,
                 "cache.k": st.cache.k, "cache.v": st.cache.v}
        if st.cross is not None:
            state.update({"cross.k": st.cross[0], "cross.v": st.cross[1]})
        ints = (st.pos, st.mem.slots, st.mem.steps, st.cache.length)
        tp, fp = PP.partition(pp, TR.trainable_mask_for(c2, pp))
        leaves = PP.leaves(tp)
        for _, x in leaves:
            x.requires_grad_(True)
        b = {k: v.to(dev) for k, v in batch.items()}
        tkw = {k: b[k] for k in ("frames", "patches") if k in b}
        tl = PT.train_forward(PP.merge(tp, fp), c2, b["tokens"], layout,
                              **tkw)
        loss = TR.next_token_loss(
            tl, b["tokens"][:, layout.seq_len - layout.tail_len:],
            b["loss_mask"])
        grads = torch.autograd.grad(loss, [x for _, x in leaves])
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = types.SimpleNamespace(
            logits=[x.detach().cpu() for x in logits],
            state={k: v.cpu() for k, v in state.items()}, ints=ints,
            loss=loss.detach().cpu(), train_logits=tl.detach().cpu(),
            grads={"/".join(p): g.cpu() for (p, _), g in zip(leaves,
                                                             grads)},
            secs=time.perf_counter() - t0)
        del pp, tp, fp, leaves, grads, st
        if dev == "cuda":
            torch.cuda.empty_cache()
    a, b = runs["cuda"], runs["cpu"]
    if a.ints != b.ints:
        raise AssertionError(f"12d {cfg.name}: counters {a.ints} vs {b.ints}")
    worst, over = {}, []

    def close(what, x, y, key):
        lim = 1e-3 * y.abs().max().item()
        err = max_err(x, y)
        if not err <= lim:
            over.append(f"{what} {err / lim:.2f}x")
        worst[key] = max(worst.get(key, 0.0), err / lim)
    for i, (x, y) in enumerate(zip(a.logits, b.logits)):
        close(f"online logits {i}", x, y, "online logits")
    for k in b.state:
        close(f"state {k}", a.state[k], b.state[k], "state leaves")
    close("train loss", a.loss, b.loss, "train loss")
    close("train logits", a.train_logits, b.train_logits, "train logits")
    for k in b.grads:
        if not b.grads[k].abs().max().item() > 0:
            raise AssertionError(f"12d {cfg.name}: gradient {k} is all zero")
        close(f"gradient {k}", a.grads[k], b.grads[k], "gradients")
    log(f"  12d {cfg.name} (2 layers fp32, full training): {len(b.state)} "
        f"state leaves, {len(b.grads)} gradient leaves; worst max|d| / "
        "(1e-3 max|.|): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + f"; cuda {a.secs:.1f} s, cpu {b.secs:.1f} s [{card}]")
    if over:
        raise AssertionError(f"12d {cfg.name}: past 1e-3 x max|.|: {over}")
    return worst


@contextlib.contextmanager
def encoder_ccm_launches(PT, ops, tally):
    """Adds to ``tally`` the CCM kernel's launches made for the encoder,
    read from the launch counters around each forward and backward launch
    whose key metadata ``PT.encode`` made: the launches inside ``encode``,
    and its recompute and backward, which run later under autograd with
    the same ``k_comp`` tensor."""
    from repro_torch.kernels import ccm_attention as ca
    fwd, bwd, encode = ca.ccm_attention_fwd, ca.ccm_attention_bwd, PT.encode
    mine, inside = [], [False]         # the encoder's k_comp tensors, alive

    def read(fn, comp_at):
        def call(*a):
            if inside[0] and not any(a[comp_at] is t for t in mine):
                mine.append(a[comp_at])
            c0 = ops.launch_counts()
            out = fn(*a)
            if any(a[comp_at] is t for t in mine):
                add_counts(tally, {k: v - c0[k]
                                   for k, v in ops.launch_counts().items()})
            return out
        return call

    def enc(*a, **kw):
        inside[0] = True
        try:
            return encode(*a, **kw)
        finally:
            inside[0] = False
    ca.ccm_attention_fwd, ca.ccm_attention_bwd = read(fwd, 7), read(bwd, 10)
    PT.encode = enc
    try:
        yield tally
    finally:
        ca.ccm_attention_fwd, ca.ccm_attention_bwd, PT.encode = \
            fwd, bwd, encode


def family_phase(torch, m, card, archs=FAMILIES):
    """Phase 12: whisper-tiny, pixtral-12b (12 of 40 layers), phi3.5-moe
    (4 of 32 layers) and llama4-maverick (1 of 48 layers) at their
    published widths, random weights from seed 0 in each config's
    ``param_dtype`` (LoRA b drawn at random), one model at a time: 12a
    the online path (B4, 4
    ingests of 64 tokens, 32 greedy tokens; whisper in concat and merge
    after ``encode_cross`` over 1500 frames, with a 448-token prefill;
    pixtral with a prefill of 1024 patch positions + 64 text tokens;
    profiled decodes), 12d the float32 CUDA vs CPU cross-check (not
    llama4), 12c the serve engine (12 sessions on 8 slots, text-only
    decoders as in the reference), 12e streaming at 4 layers (whisper's
    own depth), 12b 2-3 AdamW steps with the config's ``train_mode``
    (whisper full with 1500 frames through the encoder's CCM forward and
    backward; pixtral with patches).  Returns (the launch counts of 12a,
    12b, 12c and 12e, {arch: record})."""
    total, rec = {}, {}
    for arch in archs:
        f = FAM[arch]
        cfg = m.get_config(arch)
        if arch in FAM_DEPTH:
            cfg = cfg.replace(n_layers=FAM_DEPTH[arch])
        log(f"  {arch}: {cfg.family}, {cfg.n_layers} layers"
            + (f" (+ {cfg.n_enc_layers} encoder)" if cfg.n_enc_layers
               else "")
            + f", d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} hd "
            f"{cfg.hd}, d_ff {cfg.d_ff} ({cfg.activation}), vocab "
            f"{cfg.vocab_size}"
            + (f", {cfg.n_experts} experts top-{cfg.top_k}"
               if cfg.n_experts else "")
            + f", {cfg.pos_embed} positions, {cfg.param_dtype} params, "
            f"train_mode {cfg.train_mode}, "
            f"{cfg.param_count() / 1e9:.3f} B params at this depth")
        torch.cuda.reset_peak_memory_stats()
        t0 = t_arch = time.perf_counter()
        params = m.init_lm(cfg, seed=0)
        randomize_lora_b(torch, params, seed=100)
        torch.cuda.synchronize()
        r = rec[arch] = {"init_s": time.perf_counter() - t0,
                         "weights_gib": torch.cuda.memory_allocated() / 2 ** 30}
        log(f"  {arch}: init {r['init_s']:.1f} s, {r['weights_gib']:.2f} "
            "GiB allocated")
        dev = params["embed"].device
        cross, patches = None, None
        enc = {}                    # the encoder's CCM launches, as read
        if cfg.family == "encdec":
            frames = family_inputs(torch, cfg, 4, dev, 12)["frames"]
            m.ops.reset_launch_counts()
            ms = []
            with encoder_ccm_launches(m.PT, m.ops, enc):
                for _ in range(3):
                    t0 = time.perf_counter()
                    cross = m.PI.encode_cross(params, cfg, frames)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            counts = m.ops.launch_counts()
            E = cfg.n_enc_layers
            want = {k: 0 for k in counts}
            want.update(ccm_attention=3 * E, ccm_attention_mma=3 * E)
            shape = (cfg.n_layers, 4, WHISPER_FRAMES, cfg.n_kv_heads, cfg.hd)
            if counts != want or enc != want \
                    or tuple(cross[0].shape) != shape \
                    or not bool(torch.isfinite(cross[0]).all()):
                raise AssertionError(f"12a {arch} encode_cross: launches "
                                     f"{counts}, the encoder's {enc}, K "
                                     f"{tuple(cross[0].shape)}")
            add_counts(total, counts)
            r["encode_cross_ms"] = ms
            log(f"  12a {arch}: encode_cross B4 x {WHISPER_FRAMES} frames, "
                f"{E} encoder layers (the CCM kernel, every key <COMP>): "
                f"host ms {[round(x, 2) for x in ms]}; cross K/V "
                f"{shape}; launches {({k: v for k, v in counts.items() if v})}"
                f" [{card}]")
        if cfg.family == "vlm":
            patches = family_inputs(torch, cfg, 4, dev, 13)["patches"]
        modes = ("concat", "merge") if arch == "whisper-tiny" else \
            ("concat",)
        for mode in modes:
            add_counts(total, main_path(
                torch, m.PI, m.ops, params, cfg, mode, "bfloat16", card,
                profile=mode == "concat", record=r.setdefault(mode, {}),
                prompt_len=f["prompt"], cache_len=f["cache"], cross=cross,
                patches=patches, tag=f"12a {arch} "))
        r["online_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del cross, patches
        if f["layout"] is None:
            del params
            gc.collect()
            torch.cuda.empty_cache()
            r["seconds"] = time.perf_counter() - t_arch
            log(f"  12 {arch}: took {r['seconds']:.1f} s")
            continue
        log(f"  12d {arch}: cross-check, 2 layers full width fp32, CUDA vs "
            "CPU")
        r["xcheck"] = family_xcheck(torch, m, params, cfg, card)
        log(f"  12c {arch}: the serve engine ({cfg.n_layers} layers, concat, "
            "bf16 cache, text-only sessions): 12 sessions on 8 slots, 3 "
            "tenants")
        add_counts(total, serve_phase(
            torch, m.ops, m.PI, params, cfg, card,
            label=f"12c {arch} {cfg.n_layers}L", n_sessions=12, n_slots=8,
            seed=25, record=r.setdefault("serve", {}),
            paths_witness=f["paths"]))
        scfg = cfg.replace(n_layers=min(cfg.n_layers, 4))
        log(f"  12e {arch}: streaming, 4 layers at full width, W 512, "
            f"{scfg.compute_dtype}")
        add_counts(total, stream_modes(
            torch, m.STR, m.ops, first_layers(params, 4), scfg, card,
            tag=f"12e {arch}"))
        lay = f["layout"]
        S = m.segment_layout(*lay).seq_len
        log(f"  12b {arch}: training ({cfg.train_mode}, {cfg.n_layers} "
            f"layers, B4 S{S}, {', '.join(f['steps'])})")
        torch.cuda.reset_peak_memory_stats()
        extra = family_inputs(torch, cfg, 4, dev, 14)
        tr_enc = {}
        with encoder_ccm_launches(m.PT, m.ops, tr_enc):
            run = train_steps(torch, m.ops, m.clora, m.TR, m.PD, m.PA, m.PP,
                              m.segment_layout, params, cfg, card,
                              list(f["steps"]), f"12b {arch}", layout=lay,
                              extra=extra)
        add_counts(total, run.counts)
        if cfg.family == "encdec":
            # every step runs the encoder's forward, and in full training
            # its recompute and backward too
            E, n = cfg.n_enc_layers, len(f["steps"])
            Ef, Eb = (2 * E, E) if cfg.train_mode == "full" else (E, 0)
            want = {k: 0 for k in tr_enc}
            want.update(ccm_attention=Ef * n, ccm_attention_mma=Ef * n,
                        ccm_attention_backward=Eb * n,
                        ccm_attention_backward_mma=Eb * n)
            if tr_enc != want:
                raise AssertionError(f"12b {arch}: the encoder's CCM "
                                     f"launches {tr_enc}, want {want}")
            add_counts(enc, tr_enc)
            r["encoder_ccm_launches"] = dict(
                forward=enc["ccm_attention"],
                backward=enc["ccm_attention_backward"])
            log(f"  12b {arch}: the encoder's CCM launches in phase 12, read "
                f"around its launches: {r['encoder_ccm_launches']} (of them "
                f"encode_cross {3 * E}, training {tr_enc['ccm_attention']} "
                f"forward, {tr_enc['ccm_attention_backward']} backward)")
        stats = {}
        profile_window(torch, lambda: run.fns["concat"](
            run.tp, run.fp, run.opt, run.batch, None),
            f"12b {arch} 1 train step", card, warmup=False, stats=stats)
        r["train"] = dict(run.record, profile=stats)
        for _, x in m.PP.leaves(run.tp):
            x.requires_grad_(False)
        del params, run, extra
        gc.collect()
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t_arch
        log(f"  12 {arch}: took {r['seconds']:.1f} s")
    for arch, r in rec.items():
        for mode in ("concat", "merge"):
            if mode not in r:
                continue
            on, prof = r[mode], r[mode].get("decode_profile", {})
            log(f"  12 summary {arch} {mode}: host ms per ingest "
                f"{[round(x, 2) for x in on['ingest_ms']]}, prefill "
                f"{on['prefill_ms']:.2f}, decode step {on['decode_ms']:.2f}"
                f"; decode idle {prof.get('idle', float('nan')):.3f}; "
                f"weights {r['weights_gib']:.2f} GiB, online peak "
                f"{r['online_peak_gib']:.2f} GiB [{card}]")
        if "train" in r:
            sv, tr = r["serve"], r["train"]
            log(f"  12 summary {arch}: serve ms per query batch "
                f"{sv['query_ms']:.1f}, row {sv['row_mb']:.1f} MB, worst "
                f"query {sv['worst_x_bf16_tol']:.3f} x bf16_tol; train ms "
                f"{[round(x, 1) for x in tr['step_ms']]} (idle "
                f"{tr['profile'].get('idle', float('nan')):.3f}), peak "
                f"{tr['peak_gib']:.2f} GiB [{card}]")
    return total, rec




# ---------------------------------------------------------------------------
# phase 13: multi-device, part 1: session-sharded serving, the session
# mesh, and the data-parallel step on torch.distributed
# ---------------------------------------------------------------------------

def sharded_serve(torch, ops, PI, params, cfg, card, rec7):
    """13a-c: phase 7's traffic through a sharded engine.  (a) 32 layers
    bf16 at ``n_shards=2`` over 8 slots (4 a shard), every query held to
    the 1-shard engine's answer (``rec7``: phase 7's, the same traffic)
    within ``bf16_tol_paths``, beside the witness of where the gap comes
    from (each engine against the session alone); (b) 2 float32 layers at
    full width, ``n_shards=2`` against ``n_shards=1`` on the card:
    bit-equal where the card gives it, else within ``f32_lane_tol`` with
    the op that differs named (a GEMM's rows computed at the two batch
    widths); (c) the session mesh of the visible devices
    (``make_session_mesh()``: one shard on one card) through
    ``make_sharded_arena_step`` with local rows, bit-equal to the plain
    engine (phase 7's answers).  Returns the engines' launches and the
    records."""
    import numpy as np
    from repro_torch.launch.mesh import make_session_mesh
    counts, out = {}, {}
    kw = dict(n_sessions=12, n_slots=8, seed=21)
    if weights_fingerprint(params) != rec7["weights"]:
        raise AssertionError("phase 13 runs on other weights than the "
                             "1-shard answers it is held to")

    rec = out["a"] = {}
    add_counts(counts, serve_phase(
        torch, ops, PI, params, cfg, card, label="13a 32L 2 shards",
        detail=True, paths_witness=True, n_shards=2, record=rec, **kw))
    rows, worst = [], 0.0
    for sid, e2 in rec["answers"].items():
        e1, a = torch.from_numpy(rec7["answers"][sid]), rec7["alone"][sid]
        e2 = torch.from_numpy(e2)
        r = max_err(e2, e1) / bf16_tol(e1)
        worst = max(worst, r)
        rows.append(f"{sid} {r:.2f}/{max_err(e2, a) / bf16_tol(a):.2f}/"
                    f"{max_err(e1, a) / bf16_tol(a):.2f}")
    log("  13a witness, per session (x bf16_tol): 2 shards vs 1 shard / "
        "2 shards vs alone / 1 shard vs alone: " + ", ".join(rows))
    if worst > 2.0:                  # bf16_tol_paths = 2 x bf16_tol
        raise AssertionError(f"13a: the 2-shard engine's answers lie "
                             f"{worst:.2f} x bf16_tol from the 1-shard "
                             "engine's (bf16_tol_paths: 2)")
    log(f"  13a: every query within bf16_tol_paths of the 1-shard engine's "
        f"(worst {worst:.3f} x bf16_tol); ms per ingest batch "
        f"{[round(x, 1) for x in rec['ingest_ms']]} (1 shard "
        f"{[round(x, 1) for x in rec7['ingest_ms']]}), per query batch "
        f"{rec['query_ms']:.1f} (1 shard {rec7['query_ms']:.1f}), profiled "
        f"ingest drain idle {rec['idle']} (1 shard {rec7['idle']}) [{card}]")

    dev = params["embed"].device
    p2 = fp32_layers(torch, params, dev)
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32")
    one, two = {}, {}
    serve_phase(torch, ops, PI, p2, c2, card, label="13b 2L fp32 1 shard",
                record=one, **kw)
    add_counts(counts, serve_phase(
        torch, ops, PI, p2, c2, card, label="13b 2L fp32 2 shards",
        n_shards=2, record=two, **kw))
    same = [s for s in one["answers"]
            if np.array_equal(one["answers"][s], two["answers"][s])]
    ratio = max(max_err(torch.from_numpy(two["answers"][s]),
                        torch.from_numpy(one["answers"][s]))
                / f32_lane_tol(torch.from_numpy(one["answers"][s]))
                for s in one["answers"])
    out["b"] = dict(bit_equal=len(same), of=len(one["answers"]),
                    x_f32_lane_tol=ratio)
    if len(same) == len(one["answers"]):
        log(f"  13b: all {len(same)} float32 answers bit-equal, 2 shards "
            f"against 1 [{card}]")
    else:
        # the GEMM at the engines' batch widths: 4 lanes a shard against
        # 8 in one batch, the same rows
        x = torch.randn(8 * 24, c2.d_model, device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
        w = p2["layers"]["mlp"]["wi"][0]
        gemm = torch.equal((x[:4 * 24] @ w), (x @ w)[:4 * 24])
        log(f"  13b: {len(same)} of {len(one['answers'])} float32 answers "
            f"bit-equal, 2 shards against 1; worst {ratio:.4f} x "
            f"f32_lane_tol (1e-3 x max|logit|); a float32 GEMM's rows at "
            f"M 96 and M 192 {'agree' if gemm else 'differ'} bit for bit "
            f"(cuBLAS picks its algorithm by M) [{card}]")
        out["b"]["gemm_rows_bit_equal"] = gemm
        if ratio > 1.0:
            raise AssertionError(f"13b: 2 shards vs 1 at {ratio} x "
                                 "f32_lane_tol")
    del p2

    mesh = make_session_mesh()
    rec = out["c"] = {}
    add_counts(counts, serve_phase(
        torch, ops, PI, params, cfg, card, label="13c 32L session mesh",
        mesh=mesh, paths_witness=True, record=rec, **kw))
    diff = [s for s in rec7["answers"]
            if not np.array_equal(rec7["answers"][s], rec["answers"][s])]
    if diff or len(mesh.devices) != torch.cuda.device_count():
        raise AssertionError(f"13c: answers of {diff} differ from the plain "
                             f"engine's; mesh {mesh.devices}")
    log(f"  13c: the session mesh of {len(mesh.devices)} device(s): all "
        f"{len(rec['answers'])} answers bit-equal to the plain engine's; "
        f"ms per query batch {rec['query_ms']:.1f} [{card}]")
    return counts, out


def dp_phase(torch, ops, TR, PD, PA, PP, PG, segment_layout, params, cfg,
             card):
    """13d: the data-parallel step in an NCCL world of one rank (this
    process; the rendezvous on a localhost TCP port) at phase 5's cell
    (B4, S 1216, LoRA, remat): 2 AdamW steps with ``dist=`` for
    ``grad_codec`` "none" (concat and merge) against the ``dist=None``
    step, and "int8" / "topk" (concat) against ``compress_with_ef`` and
    the update on the card; all bit-equal (a sum over one rank and a
    division by one are exact).  The error-feedback residual stays on the
    card.  Times a step, the codec and the all-reduce of a LoRA gradient
    tree.  Returns the dist steps' launches and the record."""
    import torch.distributed as tdist
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    dev = init_world(0, 1, free_port(), params["embed"].device)   # NCCL
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        group = dist.group(dist.batch_axes)
        layout = segment_layout(*ZOO_LAYOUT)
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 4)
                                   .key_for(0), layout, 4, device=dev)
        tp0, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
        ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)

        def clone(t):
            return PP.tree_map(lambda _, x: None if x is None
                               else x.detach().clone(), t)

        def run(step, ef):
            tp = clone(tp0)
            opt = PA.init_adamw(tp)
            ms, losses = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tp, opt, m, ef = step(tp, fp, opt, batch, ef)
                losses.append(m["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            return types.SimpleNamespace(tp=tp, opt=opt, ef=ef, ms=ms,
                                         losses=losses)

        def codec_step(c, codec):
            """compress_with_ef and the update, no reduce."""
            def step(tp, fp, opt, batch, ef):
                leaves = [x for _, x in PP.leaves(tp)]
                for x in leaves:
                    x.requires_grad_(True)
                with torch.enable_grad():
                    loss = TR._loss_fn(tp, fp, c, layout, batch)
                    grads = iter(torch.autograd.grad(loss, leaves))
                g = PP.tree_map(lambda _, x: None if x is None
                                else next(grads), tp)
                g, ef = PG.compress_with_ef(g, ef, codec)
                tp, opt, m = PA.adamw_update(ocfg, tp, g, opt)
                m["loss"] = loss.detach()
                return tp, opt, m, ef
            return step

        def differ(a, b):
            a, b = dict(PP.leaves(a)), dict(PP.leaves(b))
            return ["/".join(k) for k in b if not torch.equal(a[k], b[k])]

        counts, rec = {}, {}
        merge = cfg.replace(ccm=dataclasses.replace(cfg.ccm, mode="merge",
                                                    merge_alpha=None))
        for codec, mode, c in (("none", "concat", cfg),
                               ("none", "merge", merge),
                               ("int8", "concat", cfg),
                               ("topk", "concat", cfg)):
            torch.cuda.synchronize()
            c0 = ops.launch_counts()
            got = run(TR.make_train_step(c, layout, ocfg, dist,
                                         grad_codec=codec),
                      None if codec == "none" else PG.init_ef(tp0))
            c1 = ops.launch_counts()
            add_counts(counts, {k: c1[k] - c0[k] for k in c1})
            want = run(TR.make_train_step(c, layout, ocfg) if codec == "none"
                       else codec_step(c, codec),
                       None if codec == "none" else PG.init_ef(tp0))
            diff = differ(got.tp, want.tp) + differ(got.opt.mu, want.opt.mu) \
                + differ(got.opt.nu, want.opt.nu)
            if got.ef is not None:
                diff += differ(got.ef.residual, want.ef.residual)
                if any(x.device != dev
                       for _, x in PP.leaves(got.ef.residual)):
                    raise AssertionError(f"13d {codec}: the residual left "
                                         "the card")
            if got.losses != want.losses or diff:
                raise AssertionError(f"13d {codec} {mode}: losses "
                                     f"{got.losses} vs {want.losses}, "
                                     f"differ {diff}")
            rb = 0 if got.ef is None else sum(
                x.numel() * x.element_size()
                for _, x in PP.leaves(got.ef.residual))
            rec[f"{codec}/{mode}"] = dict(step_ms=got.ms, losses=got.losses,
                                          residual_bytes=rb)
            held = "dist=None" if codec == "none" \
                else "compress_with_ef + the update"
            res = f", residual {rb / 2 ** 20:.1f} MiB on the card" if rb \
                else ""
            log(f"  13d {codec} ({mode}): 2 steps with dist= bit-equal to "
                f"{held} (losses {[round(x, 4) for x in got.losses]}, "
                f"leaves, moments{' and residual' if rb else ''}), "
                f"{got.ms[0]:.1f} / {got.ms[1]:.1f} ms a step (the held "
                f"path {want.ms[1]:.1f}){res} [{card}]")
        # the codec and the all-reduce alone, on a LoRA gradient tree
        gen = torch.Generator(dev).manual_seed(13)
        g = PP.tree_map(lambda _, x: None if x is None else torch.randn(
            x.shape, generator=gen, device=dev), tp0)
        ef = PG.init_ef(tp0)
        nbytes = sum(x.numel() * 4 for _, x in PP.leaves(g))
        for codec in ("int8", "topk"):
            rec[f"{codec}_ms"] = device_ms(
                torch, lambda i: PG.compress_with_ef(g, ef, codec))
        # NCCL over one rank in place moves no bytes and may launch no
        # kernel: the all-reduce is timed per call between CUDA events
        rec["all_reduce_call_ms"] = time_ms(
            torch, lambda i: PG.compressed_psum(g, group), iters=20)
        log(f"  13d: on a LoRA gradient tree of {nbytes / 2 ** 20:.1f} MiB "
            f"(float32): compress_with_ef int8 {rec['int8_ms']:.4f} ms, topk "
            f"{rec['topk_ms']:.4f} ms of device time; the NCCL all-reduce "
            f"of the tree over one rank {rec['all_reduce_call_ms']:.4f} ms "
            f"per call (CUDA events, host issue included) [{card}]")
        return counts, rec
    finally:
        tdist.destroy_process_group()


def phase13(torch, ops, PI, TR, PD, PA, PP, PG, segment_layout, params, cfg,
            card, rec7=None):
    """Phase 13 on LLaMA-7B's weights; without ``rec7`` (``--phase13``)
    phase 7's 1-shard engine runs first, on the same traffic."""
    if rec7 is None:
        # untrained LoRA here (phase 7 runs after phase 5's steps): its
        # answers are held to bf16_tol_paths beside the witness, as 13a's
        rec7 = {}
        serve_phase(torch, ops, PI, params, cfg, card,
                    label="32L concat+bf16, 1 shard", n_sessions=12,
                    n_slots=8, seed=21, detail=True, paths_witness=True,
                    record=rec7)
    t0 = time.perf_counter()
    counts, rec = sharded_serve(torch, ops, PI, params, cfg, card, rec7)
    log("  13d: data-parallel training, an NCCL world of 1 (B4, S1216, "
        "LoRA)")
    dp_counts, rec["d"] = dp_phase(torch, ops, TR, PD, PA, PP, PG,
                                   segment_layout, params, cfg, card)
    add_counts(counts, dp_counts)
    log(f"  phase 13 launches: {({k: v for k, v in counts.items() if v})}; "
        f"took {time.perf_counter() - t0:.1f} s")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 14: tensor parallelism, part 1 (the dense family)
# ---------------------------------------------------------------------------

# 14b's blocks: (arch, model-axis size); LLaMA-7B's 32/32 heads split in
# the "kv" regime, Gemma-2B's 8/1 in the "query" regime
TP_BLOCKS = (("llama-7b", 2), ("llama-7b", 4), ("llama-7b", 8),
             ("gemma-2b", 2))
# the kernels of the tensor-parallel path (14b's rank loops run forward
# only; 14a's steps add the backward kernels)
TP_KERNELS = ("cond_lora", "cond_lora_wgmma", "segmented_attention",
              "segmented_attention_splitk", "segmented_attention_mma",
              "ccm_attention", "ccm_attention_mma", "kv_merge_update",
              "kv_cummean")


def counted(ops, total, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, added into ``total``; returns ``fn()``'s result."""
    import torch
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    add_counts(total, ops.launch_counts())
    return out


def same_tree(torch, PP, a, b) -> list:
    """The leaves of two trees that are not bit-equal."""
    a, b = dict(PP.leaves(a)), dict(PP.leaves(b))
    return ["/".join(k) for k in b if not torch.equal(a[k], b[k])]


def online_builders_check(torch, m, params, cfg, dist, counts, tag: str):
    """The three ``dist=`` builders (ingest twice, a 448-token prefill, 4
    decode steps) and ``generate`` (8 tokens) at phase 3's cell (B4, a
    512-token cache) on ``dist``, bit-equal to ``dist=None`` (the dist
    runs' launches counted into ``counts``).  Returns the initial state,
    the contexts and the prompt."""
    from repro_torch.launch import serve as SRV
    PI = m.PI
    dev = params["embed"].device
    B, CACHE = 4, 512
    gen = torch.Generator(device=dev).manual_seed(140)
    ctx = [torch.randint(0, cfg.vocab_size, (B, 64), generator=gen,
                         device=dev) for _ in range(2)]
    prompt = torch.randint(0, cfg.vocab_size, (B, 448), generator=gen,
                           device=dev)
    ing, pre = SRV.make_ingest_step(cfg, dist), \
        SRV.make_prefill_step(cfg, dist)
    dec = SRV.make_decode_step(cfg, dist)

    def online(p, st, tp_dist):
        for c in ctx:
            st = ing(p, st, c) if tp_dist else \
                PI.ingest_context(params, cfg, st, c)
        lg, st = pre(p, st, prompt) if tp_dist else \
            PI.prefill(params, cfg, st, prompt)
        lgs = [lg]
        for _ in range(4):
            tok = lgs[-1][:, -1].argmax(-1)[:, None]
            lg, st = dec(p, st, tok) if tp_dist else \
                PI.decode_step(params, cfg, st, tok)
            lgs.append(lg)
        g = PI.generate(p, cfg, clone_state(torch, st), prompt[:, :64],
                        8, dist=dist if tp_dist else None)
        return lgs, st, g
    st0 = PI.init_online_state(cfg, B, CACHE, device=dev)
    p_d, st_d = ing.place(params, clone_state(torch, st0))
    got = counted(m.ops, counts, lambda: online(p_d, st_d, True))
    want = online(params, clone_state(torch, st0), False)
    bad = [i for i, (a, b) in enumerate(zip(got[0], want[0]))
           if not torch.equal(a, b)]
    for name in ("k", "v"):
        if not torch.equal(getattr(got[1].cache, name),
                           getattr(want[1].cache, name)) or not \
                torch.equal(getattr(got[1].mem, name),
                            getattr(want[1].mem, name)):
            bad.append(f"state {name}")
    if bad or not torch.equal(got[2], want[2]):
        raise AssertionError(f"{tag} builders: differ at {bad} or in "
                             "generate's tokens")
    log(f"  {tag} make_ingest_step / make_prefill_step / make_decode_step"
        "(dist=) and generate(dist=): logits of 2 ingests, a 448-token "
        "prefill and 4 decode steps, the cache and memory, 8 generated "
        f"tokens, bit-equal to dist=None (B4, {cfg.n_layers} layers"
        f"{', ' + cfg.sharding_strategy})")
    return st0, ctx, prompt


def stream_builder_check(torch, m, params, cfg, dist, counts, tag: str):
    """``make_stream_step`` on ``dist`` at phase 8b's cell (4 layers, W
    512, 10 chunks of 64: two evictions), bit-equal to ``dist=None``."""
    from repro_torch.launch import serve as SRV
    STR = m.STR
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(141)
    p4 = first_layers(params, 4)
    c4 = cfg.replace(n_layers=4, ccm=dataclasses.replace(
        cfg.ccm, stream_window=512, stream_chunk=64, stream_mem_slots=4))
    toks = torch.randint(0, cfg.vocab_size, (2, 640), generator=gen,
                         device=dev)
    sstep = SRV.make_stream_step(c4, dist)

    def stream(p, st, tp_dist):
        out = []
        for i in range(10):
            t = toks[:, i * 64:(i + 1) * 64]
            lg, st = sstep(p, st, t) if tp_dist else \
                STR.stream_step(p4, c4, st, t)
            out.append(lg)
        return out, st
    s0 = STR.init_stream_state(c4, 2, device=dev)
    p_d, s_d = sstep.place(p4, clone_state(torch, s0))
    got = counted(m.ops, counts, lambda: stream(p_d, s_d, True))
    want = stream(p4, clone_state(torch, s0), False)
    if not all(torch.equal(a, b) for a, b in zip(got[0], want[0])) or \
            not torch.equal(got[1].win_k, want[1].win_k) or \
            not torch.equal(got[1].mem.k, want[1].mem.k) or \
            got[1].mem.slots != want[1].mem.slots:
        raise AssertionError(f"{tag} make_stream_step(dist=) differs")
    log(f"  {tag} make_stream_step(dist=): 10 chunks of 64 (2 "
        f"evictions, {got[1].mem.slots} memory groups) bit-equal to "
        "dist=None (4 layers, W 512)")


def tp_world_of_one(torch, m, params, cfg, card):
    """14a: every new entry point with ``dist=`` in an NCCL world of one
    rank on a (1, 1) mesh, against ``dist=None``, bit-equal (NCCL cannot
    put two ranks on one card): ``jit_train_step``'s placed step at phase
    5's cell (B4, S1216, LoRA), one concat and one merge AdamW step; the
    three ``dist=`` builders (ingest twice, a 448-token prefill, 4 decode
    steps) and ``generate`` (8 tokens) at phase 3's cell (B4, a
    512-token cache, concat + bf16), then the split path itself at n = 1
    (a ``TensorParallel`` over the mesh's NCCL model-axis group: online
    logits bit-equal, the vocab-parallel loss and the LoRA gradients
    through NCCL's backward reduce held to ``dist=None``);
    ``make_stream_step`` at phase 8b's (4 layers, W 512, 10 chunks of 64:
    two evictions).  Returns the dist runs' launches (the dist=None runs
    are not counted)."""
    import torch.distributed as tdist
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    PI, TR, PD, PA, PP, ops = m.PI, m.TR, m.PD, m.PA, m.PP, m.ops
    dev = init_world(0, 1, free_port(), params["embed"].device)   # NCCL
    counts = {}
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        layout = m.segment_layout(*ZOO_LAYOUT)
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 4)
                                   .key_for(0), layout, 4, device=dev)
        tp0, fp0 = PP.partition(params, TR.trainable_mask_for(cfg, params))
        ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
        merge = cfg.replace(ccm=dataclasses.replace(cfg.ccm, mode="merge",
                                                    merge_alpha=None))

        def clone(t):
            return PP.tree_map(lambda _, x: None if x is None
                               else x.detach().clone(), t)
        for mode, c in (("concat", cfg), ("merge", merge)):
            tp, opt = clone(tp0), PA.init_adamw(tp0)
            step = TR.jit_train_step(
                TR.make_train_step(c, layout, ocfg, dist), c, dist, None,
                None, batch, None)
            tp, fp, opt = step.place(tp, fp0, opt)
            tp, opt, mt, _ = counted(ops, counts, lambda: step(
                tp, fp, opt, batch))
            tq, oq = clone(tp0), PA.init_adamw(tp0)
            tq, oq, mq, _ = TR.make_train_step(c, layout, ocfg)(
                tq, fp0, oq, batch)
            diff = same_tree(torch, PP, tp, tq) \
                + same_tree(torch, PP, opt.mu, oq.mu) \
                + same_tree(torch, PP, opt.nu, oq.nu)
            if mt["loss"].item() != mq["loss"].item() or diff:
                raise AssertionError(f"14a train {mode}: loss "
                                     f"{mt['loss'].item()} vs "
                                     f"{mq['loss'].item()}, differ {diff}")
            log(f"  14a jit_train_step(dist=) {mode}: one AdamW step "
                f"bit-equal to dist=None (loss {mt['loss'].item():.4f}, "
                "leaves, moments)")
        del tp, tq, opt, oq

        st0, ctx, prompt = online_builders_check(torch, m, params, cfg, dist,
                                                 counts, "14a")
        # the split path itself at n = 1: a TensorParallel view over the
        # mesh's NCCL model-axis group, so that the tensor-parallel code's
        # every reduce, max and gather (forward and backward) runs
        # through NCCL on the card
        tp1 = TPX.TensorParallel(cfg, 1, 0, TPX.collectives(dist))

        def split_online(tp):
            st = clone_state(torch, st0)
            for c in ctx:
                st = PI.ingest_context(params, cfg, st, c, dist=tp)
            lp, st = PI.prefill(params, cfg, st, prompt, dist=tp)
            tok = PI.greedy(lp[:, -1], cfg, tp)[:, None]
            ld, st = PI.decode_step(params, cfg, st, tok, dist=tp)
            return PI.gather_vocab(lp, cfg, tp), ld, tok
        got = counted(ops, counts, lambda: split_online(tp1))
        want = split_online(None)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("14a: the split path at n = 1 differs from "
                                 "dist=None online")
        tq = clone(tp0)

        def split_grads(tp):
            leaves = [x for _, x in PP.leaves(tq)]
            for x in leaves:
                x.requires_grad_(True)
            with torch.enable_grad():
                loss = TR._loss_fn(tq, fp0, cfg, layout, batch, dist=tp)
                return loss.detach(), torch.autograd.grad(loss, leaves)
        (la, ga), (lb, gb) = counted(ops, counts,
                                     lambda: split_grads(tp1)), \
            split_grads(None)
        check("14a split path at n = 1 over NCCL: the vocab-parallel loss "
              "vs logsumexp (float32)", abs(la.item() - lb.item()),
              1e-5 * abs(lb.item()))
        worst = max(max_err(a, b) / max(b.float().abs().max().item(), 1e-30)
                    for a, b in zip(ga, gb))
        check("14a split path at n = 1: every LoRA gradient, relative to its "
              "largest (the losses' float32 gradients round to bf16 for the "
              "backward)", worst, 2.0 ** -5)
        log("  14a the split path at n = 1 (copy / reduce / max / gather "
            "through the NCCL model-axis group): prefill and decode logits "
            "and the greedy pick bit-equal to dist=None")
        del got, want, st0, tq, ga, gb

        stream_builder_check(torch, m, params, cfg, dist, counts, "14a")
        return counts
    finally:
        tdist.destroy_process_group()


def rank_state(torch, st, tp):
    """A rank's copy of an online state: the KV heads of its block where
    the "kv" regime splits them (dim 3 of every cache, scale, memory and
    cross K/V leaf), else the whole state; the Mamba2 states whole (the
    ranks write in place: one copy each)."""
    from repro_torch.distributed import tensor_parallel as TPX

    def cut(x, _):
        if tp.attn != "kv":
            return x.clone()
        h = x.shape[3] // tp.n
        return x.narrow(3, tp.rank * h, h).contiguous()
    ssm = st.ssm
    return TPX.map_by_spec(cut, st._replace(ssm=None), None)._replace(
        ssm=None if ssm is None else ssm._replace(ssm=ssm.ssm.clone(),
                                                  conv=ssm.conv.clone()))


def tp_rank_loop(torch, m, card, blocks=TP_BLOCKS, zero3=None):
    """14b: one block at full width (``n_layers=1``) of LLaMA-7B at n = 2,
    4 and 8 and of Gemma-2B at n = 2, random weights (seed 14, LoRA b
    drawn), bf16.  The n ranks of a ``LocalGroup`` run on the card in
    turn (``tensor_parallel.shard_params`` gives each its shard; the
    block's partial sums go through the group's reduce, added on the
    card), forward only: the CCM training forward (B2, S1216) and its
    vocab-parallel loss in concat and merge mode, then the online path
    (B4: an ingest of 64 tokens, a 64-token prefill, a decode step;
    concat, then merge), each held against the unsharded block on the
    card within bf16_tol (logits gathered over the vocabulary blocks).
    The kernels' launches and the rank loop's time beside the unsharded
    block's.  Returns the rank loops' launches and the record.
    ``zero3`` (phase 19b, over ``blocks``): called after each mode's rank
    loop as ``zero3(cfg, params, train, online, st0, outs, n, here)``,
    which runs the ZeRO-3 checks on the same block and returns the mode's
    record (the tensor-parallel loop is then not timed)."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.optim.losses import next_token_loss
    PI, PT, PD, ops = m.PI, m.PT, m.PD, m.ops
    counts, rec = {}, {}
    layout = m.segment_layout(*ZOO_LAYOUT)
    for arch, n in blocks:
        base = m.get_config(arch).replace(n_layers=1)
        params = m.init_lm(base, seed=14)
        randomize_lora_b(torch, params, seed=114)
        dev = params["embed"].device
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 2)
                                   .key_for(0), layout, 2, device=dev)
        tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
        gen = torch.Generator(device=dev).manual_seed(141)
        ctx = torch.randint(0, base.vocab_size, (4, 64), generator=gen,
                            device=dev)
        prompt = torch.randint(0, base.vocab_size, (4, 64), generator=gen,
                               device=dev)
        here, r = {}, {}
        for mode in ("concat", "merge"):
            cfg = base.replace(ccm=dataclasses.replace(base.ccm, mode=mode))
            shards = [TPX.shard_params(params, cfg,
                                       TPX.TensorParallel(cfg, n, r, None))
                      for r in range(n)]

            def train(p, tp):
                lg = PT.train_forward(p, cfg, batch["tokens"], layout,
                                      dist=tp)
                loss = next_token_loss(lg, tail, batch["loss_mask"], tp=tp)
                return PI.gather_vocab(lg, cfg, tp), loss

            def online(p, st, tp):
                st = PI.ingest_context(p, cfg, st, ctx, dist=tp)
                lp, st = PI.prefill(p, cfg, st, prompt, dist=tp)
                ld, st = PI.decode_step(p, cfg, st, prompt[:, :1], dist=tp)
                return (PI.gather_vocab(lp, cfg, tp),
                        PI.gather_vocab(ld, cfg, tp))
            st0 = PI.init_online_state(cfg, 4, 256, device=dev)

            def whole():
                return train(params, None), online(
                    params, clone_state(torch, st0), None)

            def loop():
                grp = TPX.LocalGroup(n)
                ranks = TPX.local_ranks(cfg, grp)
                sts = [rank_state(torch, st0, tp) for tp in ranks]
                return grp.run(lambda i: (train(shards[i], ranks[i]),
                                          online(shards[i], sts[i],
                                                 ranks[i])))
            with torch.no_grad():
                want = whole()
                outs = counted(ops, here, loop)
                if zero3 is None:
                    t_whole = time_ms(torch, lambda i: whole(), iters=3,
                                      warmup=1)
                    t_loop = time_ms(torch, lambda i: loop(), iters=3,
                                     warmup=1)
            for rk, ((lg, loss), (lp, ld)) in enumerate(outs):
                for name, a, b in (("train logits", lg, want[0][0]),
                                   ("loss", loss, want[0][1]),
                                   ("prefill logits", lp, want[1][0]),
                                   ("decode logits", ld, want[1][1])):
                    err = max_err(a, b)
                    if rk == 0:
                        check(f"14b {arch} n={n} {mode} {name} (rank loop "
                              "vs unsharded)", err, bf16_tol(b))
                    elif not err <= bf16_tol(b):
                        raise AssertionError(f"14b {arch} n={n} rank {rk} "
                                             f"{name}: {err}")
            if zero3 is not None:
                r[mode] = zero3(cfg, params, train, online, st0, outs, n,
                                here)
                continue
            r[mode] = dict(whole_ms=t_whole, loop_ms=t_loop,
                           per_rank_ms=t_loop / n)
            log(f"  14b {arch} n={n} {mode}: the {n} ranks in turn "
                f"{t_loop:.2f} ms ({t_loop / n:.2f} ms a rank), the "
                f"unsharded block {t_whole:.2f} ms (training forward + "
                f"loss, ingest, prefill, decode; CUDA events) [{card}]")
        missing = [k for k in TP_KERNELS if here.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"14b {arch} n={n}: no launch of {missing}"
                                 f" ({here})")
        lc = TPX.local_config(base, TPX.TensorParallel(base, n, 0, None))
        log(f"  14b {arch} n={n}: launches "
            f"{({k: v for k, v in here.items() if v})} (a rank's shard: "
            f"{lc.n_heads}/{lc.n_kv_heads} heads, d_ff {lc.d_ff}, vocab "
            f"{lc.vocab_size})")
        add_counts(counts, here)
        rec[f"{arch} n={n}"] = dict(r, launches=here)
        del params, shards
        gc.collect()
        torch.cuda.empty_cache()
    return counts, rec


def seq_sharded_check(torch, dattn, card):
    """14c: the segmented kernel's log-sum-exp against its plain version
    (the float32 route at hd 128 and 256; the split-K route with one
    split and with several; a lane that sees no key gives -inf), then the
    sequence-sharded decode's combine at LLaMA-7B's heads (32 x 128, bf16, B1) over
    a 32768-key cache cut in 4 blocks: each block's kernel with its lse,
    combined (``models.attention.combine_blocks`` over a LocalGroup of 4)
    against the kernel over the whole cache, within bf16_tol.  Times the
    whole-cache kernel, the 4 block kernels and the combine."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models.attention import combine_blocks
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(142)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    rec = {}
    for label, dt, B, H, Hkv, D, S, lens in (
            ("float32 route", torch.float32, 3, 8, 2, 128, 300, [300, 17, 0]),
            ("float32 route, hd 256", torch.float32, 3, 8, 1, 256, 200,
             [200, 9, 0]),
            ("split-K, one split", torch.bfloat16, 3, 8, 2, 128, 100,
             [100, 40, 0]),
            ("split-K, several splits", torch.bfloat16, 3, 32, 32, 128, 4096,
             [4096, 2000, 0])):
        q = rn(B, 1, H, D, dtype=dt)
        k, v = rn(B, S, Hkv, D, dtype=dt), rn(B, S, Hkv, D, dtype=dt)
        qi = torch.full((1,), 2 ** 30, device=dev, dtype=torch.int32)
        one = torch.ones(1, device=dev, dtype=torch.int32)
        segs = [seg_dict(k, v, length=torch.tensor(lens, device=dev,
                                                   dtype=torch.int32))]
        out, lse = dattn.segmented_flash_attention(q, segs, qi, one,
                                                   D ** -0.5, lse=True)
        wo, wl = dattn.plain(q, segs, qi, one, D ** -0.5, lse=True)
        torch.cuda.synchronize()
        if not bool(torch.isneginf(lse[2]).all()) or not \
                torch.equal(out, dattn.segmented_flash_attention(
                    q, segs, qi, one, D ** -0.5)):
            raise AssertionError(f"14c lse {label}: an empty lane's lse is "
                                 "not -inf, or lse changed the output")
        live = torch.isfinite(wl)
        err = (lse[live] - wl[live]).abs().max().item()
        check(f"14c lse {label} B{B} {H}/{Hkv} hd{D} S{S} (kernel vs plain)",
              err, 1e-5 * wl[live].abs().max().item())
        rec[label] = err
    # the sequence-sharded decode's combine at full width
    B, H, D, S, n = 1, 32, 128, 32768, 4
    q = rn(B, 1, H, D)
    k, v = rn(B, S, H, D), rn(B, S, H, D)
    mk, mv = rn(B, 128, H, D), rn(B, 128, H, D)
    sk, sv = rn(B, 1, H, D), rn(B, 1, H, D)
    qi = torch.full((1,), 2 ** 30, device=dev, dtype=torch.int32)
    one = torch.ones(1, device=dev, dtype=torch.int32)
    self_seg = seg_dict(sk, sv, idx=qi, seg=one,
                        comp=torch.zeros(1, device=dev, dtype=torch.bool))
    blk = S // n
    whole = [seg_dict(mk, mv), seg_dict(k, v), self_seg]
    blocks = [([seg_dict(mk, mv)] if i == 0 else [])
              + [seg_dict(k[:, i * blk:(i + 1) * blk],
                          v[:, i * blk:(i + 1) * blk])]
              + ([self_seg] if i == 0 else []) for i in range(n)]
    scale = D ** -0.5
    want = dattn.segmented_flash_attention(q, whole, qi, one, scale)

    def sharded():
        grp = TPX.LocalGroup(n)

        def rank(i):
            o, l = dattn.segmented_flash_attention(q, blocks[i], qi, one,
                                                   scale, lse=True)
            return combine_blocks(o, l, grp.member(i))
        return grp.run(rank)
    outs = sharded()
    plain = dattn.plain(q, whole, qi, one, scale)
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        if i == 0:
            check(f"14c sequence-sharded decode, {n} blocks of {blk} keys, "
                  f"{H}x{D} bf16 (combined vs the whole-cache kernel)",
                  max_err(o, want), bf16_tol(want))
            check("14c sequence-sharded decode (combined vs plain)",
                  max_err(o, plain), bf16_tol(plain))
        elif not torch.equal(o, outs[0]):
            raise AssertionError("14c: the ranks' combined outputs differ")
    t_whole = device_ms(torch, lambda i: dattn.segmented_flash_attention(
        q, whole, qi, one, scale), only="segmented_attention")
    t_blocks = device_ms(torch, lambda i: [dattn.segmented_flash_attention(
        q, b, qi, one, scale, lse=True) for b in blocks],
        only="segmented_attention")
    t_all = time_ms(torch, lambda i: sharded(), iters=5, warmup=1)
    # the whole cache with the lse: the kernel, its plain version, and the
    # library's flash attention, whose second output is the log-sum-exp
    # (every key is visible at decode: no mask)
    t_lse = device_ms(torch, lambda i: dattn.segmented_flash_attention(
        q, whole, qi, one, scale, lse=True), only="segmented_attention")
    t_plain = device_ms(torch, lambda i: dattn.plain(q, whole, qi, one,
                                                     scale, lse=True), iters=5)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (torch.cat(x, 1).transpose(1, 2).contiguous()
              for x in ((mk, k, sk), (mv, v, sv)))

    def library(i):
        return torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, scale=scale)
    lib_out, lib_lse = library(0)[:2]
    check("14c the library's flash attention over the whole cache (vs the "
          "kernel)", max_err(lib_out.transpose(1, 2), want), bf16_tol(want))
    t_lib = device_ms(torch, library)
    nbytes = 2 * (S + 129) * H * D * 2
    bms, by = bound(nbytes, 4.0 * H * D * (S + 129), PEAK_BF16)
    log(f"  14c: the whole-cache kernel {t_whole:.4f} ms ({t_lse:.4f} ms "
        f"with its lse), its plain version with lse {t_plain:.4f} ms, the "
        f"library's flash attention with lse {t_lib:.4f} ms; the 4 block "
        f"kernels with lse {t_blocks:.4f} ms of device time together, "
        f"bound {bms:.4f} ms ({by}); the 4 ranks in turn with the combine "
        f"{t_all:.3f} ms (CUDA events, host included) [{card}]")
    rec.update(whole_ms=t_whole, whole_lse_ms=t_lse, plain_ms=t_plain,
               library_ms=t_lib, blocks_ms=t_blocks, loop_ms=t_all,
               bound_ms=bms)
    return rec


def phase14(torch, m, params, cfg, card):
    """Phase 14 on LLaMA-7B's weights (14a) and its own blocks (14b)."""
    t0 = time.perf_counter()
    log("  14a: every dist= entry point in an NCCL world of one rank, "
        "(1, 1) mesh")
    counts = tp_world_of_one(torch, m, params, cfg, card)
    need = ("cond_lora_wgmma", "segmented_attention_splitk",
            "segmented_attention_mma", "ccm_attention_mma",
            "ccm_attention_backward_mma", "kv_cummean", "kv_cummean_backward")
    if any(counts.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"14a launches {counts}")
    log("  14b: the rank loop at full width (LocalGroup, ranks in turn on "
        "the card)")
    loop_counts, rec = tp_rank_loop(torch, m, card)
    add_counts(counts, loop_counts)
    log("  14c: the log-sum-exp route and the sequence-sharded decode")
    rec["14c"] = seq_sharded_check(torch, m.dattn, card)
    log(f"  phase 14 launches: {({k: v for k, v in counts.items() if v})}; "
        f"took {time.perf_counter() - t0:.1f} s")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 15: tensor parallelism, part 2 (the MoE family)
# ---------------------------------------------------------------------------

MOE_TP_ARCH = "phi3.5-moe-42b-a6.6b"
# 15b's blocks: (arch, moe_impl, model-axis size).  llama4-maverick's block
# holds 32.2 GB of experts: its ep shards are views along E, ragged_tp's
# would be a second copy, so it runs ep alone
MOE_TP_BLOCKS = ((MOE_TP_ARCH, "ragged_tp", 2), (MOE_TP_ARCH, "ep", 2),
                 (MOE_TP_ARCH, "ragged_tp", 4), (MOE_TP_ARCH, "ep", 4),
                 ("llama4-maverick-400b-a17b", "ep", 8))
MOE_TP_KERNELS = ("cond_lora", "cond_lora_wgmma", "segmented_attention",
                  "segmented_attention_splitk", "segmented_attention_mma",
                  "ccm_attention", "ccm_attention_mma")


@contextlib.contextmanager
def ep_unsharded(n: int):
    """Within: the one-device MoE (``dist`` None) computes what ``ep`` at
    ``n`` computes (``models.moe.moe_ep_unsharded``: the dropless path
    under ep's keep mask), the unsharded counterpart of an ep rank loop."""
    from repro_torch.models import moe as MOE
    apply = MOE.apply_moe

    def swapped(cfg, p, x, dist=None):
        if dist is None:
            return MOE.moe_ep_unsharded(cfg, p, x, n)
        return apply(cfg, p, x, dist)
    MOE.apply_moe = swapped
    try:
        yield
    finally:
        MOE.apply_moe = apply


def rank_routes(torch, calls, flips):
    """A ``moe_routes`` pick for a ``LocalGroup`` rank loop: each rank (a
    thread of its own) takes the expert ids of ``calls`` in order from
    the first (every rank routes every row, as the unsharded block did),
    as ``pinned_routes`` gives them."""
    import threading
    picks = {}

    def pick(cfg, w, xf, route):
        me = threading.get_ident()
        if me not in picks:
            picks[me] = pinned_routes(torch, list(calls), flips)
        return picks[me](cfg, w, xf, route)
    return pick


def moe_world_of_one(torch, m, card):
    """15a: phi3.5-moe at full width, 2 of its 32 layers, bf16 (seed 15,
    LoRA b drawn), under each ``moe_impl``, in an NCCL world of one rank
    on a (1, 1) mesh: ``jit_train_step``'s placed step at phase 5's cell
    (B4, S1216, LoRA; concat and merge), the three ``dist=`` builders (2
    ingests of 64 tokens, a 448-token prefill, 4 decode steps; B4, a
    512-token cache) and ``generate`` (8 tokens), ``make_stream_step`` (10
    chunks of 64, W 512: 2 evictions), each bit-equal to ``dist=None``;
    then the split path itself at n = 1 (a ``TensorParallel`` over the
    NCCL model-axis group: ragged_tp's reduce, ep's two all-to-alls and
    its gather): online logits bit-equal to ``dist=None``, the
    vocab-parallel loss and the LoRA gradients held to it; and the
    sequence-sharded decode (``shard_cache_seq=True``, the split-K
    route's log-sum-exp) within bf16_tol of ``dist=None``.  Returns (the
    dist runs' launches, the sequence-sharded decode's split-K
    launches)."""
    import torch.distributed as tdist
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    PI, STR, TR, PD, PA, PP, ops = m.PI, m.STR, m.TR, m.PD, m.PA, m.PP, m.ops
    dev = init_world(0, 1, free_port(), "cuda")                 # NCCL
    counts, lse_launches = {}, 0
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        base = m.get_config(MOE_TP_ARCH).replace(n_layers=2)
        params = m.init_lm(base, seed=15)
        randomize_lora_b(torch, params, seed=115)
        layout = m.segment_layout(*ZOO_LAYOUT)
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 4)
                                   .key_for(0), layout, 4, device=dev)
        tp0, fp0 = PP.partition(params, TR.trainable_mask_for(base, params))
        ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
        B, CACHE = 4, 512
        gen = torch.Generator(device=dev).manual_seed(150)
        ctx = [torch.randint(0, base.vocab_size, (B, 64), generator=gen,
                             device=dev) for _ in range(2)]
        prompt = torch.randint(0, base.vocab_size, (B, 448), generator=gen,
                               device=dev)
        toks = torch.randint(0, base.vocab_size, (2, 640), generator=gen,
                             device=dev)

        def clone(t):
            return PP.tree_map(lambda _, x: None if x is None
                               else x.detach().clone(), t)
        for impl in ("ragged_tp", "ep"):
            cfg = base.replace(moe_impl=impl)
            merge = cfg.replace(ccm=dataclasses.replace(
                cfg.ccm, mode="merge", merge_alpha=None))
            for mode, c in (("concat", cfg), ("merge", merge)):
                tp, opt = clone(tp0), PA.init_adamw(tp0)
                step = TR.jit_train_step(
                    TR.make_train_step(c, layout, ocfg, dist), c, dist, None,
                    None, batch, None)
                tp, fp, opt = step.place(tp, fp0, opt)
                tp, opt, mt, _ = counted(ops, counts, lambda: step(
                    tp, fp, opt, batch))
                tq, oq = clone(tp0), PA.init_adamw(tp0)
                tq, oq, mq, _ = TR.make_train_step(c, layout, ocfg)(
                    tq, fp0, oq, batch)
                diff = same_tree(torch, PP, tp, tq) \
                    + same_tree(torch, PP, opt.mu, oq.mu) \
                    + same_tree(torch, PP, opt.nu, oq.nu)
                if mt["loss"].item() != mq["loss"].item() or diff:
                    raise AssertionError(f"15a {impl} train {mode}: loss "
                                         f"{mt['loss'].item()} vs "
                                         f"{mq['loss'].item()}, differ {diff}")
                log(f"  15a {impl} jit_train_step(dist=) {mode}: one AdamW "
                    f"step bit-equal to dist=None (loss "
                    f"{mt['loss'].item():.4f}, leaves, moments)")
            del tp, tq, opt, oq

            ing, pre = SRV.make_ingest_step(cfg, dist), \
                SRV.make_prefill_step(cfg, dist)
            dec = SRV.make_decode_step(cfg, dist)

            def online(st, tp_dist):
                for x in ctx:
                    st = ing(params, st, x) if tp_dist else \
                        PI.ingest_context(params, cfg, st, x)
                lg, st = pre(params, st, prompt) if tp_dist else \
                    PI.prefill(params, cfg, st, prompt)
                lgs = [lg]
                for _ in range(4):
                    tok = lgs[-1][:, -1].argmax(-1)[:, None]
                    lg, st = dec(params, st, tok) if tp_dist else \
                        PI.decode_step(params, cfg, st, tok)
                    lgs.append(lg)
                g = PI.generate(params, cfg, clone_state(torch, st),
                                prompt[:, :64], 8,
                                dist=dist if tp_dist else None)
                return lgs, st, g
            st0 = PI.init_online_state(cfg, B, CACHE, device=dev)
            _, st_d = ing.place(params, clone_state(torch, st0))
            got = counted(ops, counts, lambda: online(st_d, True))
            want = online(clone_state(torch, st0), False)
            bad = [i for i, (a, b) in enumerate(zip(got[0], want[0]))
                   if not torch.equal(a, b)]
            for name in ("k", "v"):
                if not torch.equal(getattr(got[1].cache, name),
                                   getattr(want[1].cache, name)) or not \
                        torch.equal(getattr(got[1].mem, name),
                                    getattr(want[1].mem, name)):
                    bad.append(f"state {name}")
            if bad or not torch.equal(got[2], want[2]):
                raise AssertionError(f"15a {impl} builders: differ at {bad} "
                                     "or in generate's tokens")
            log(f"  15a {impl} make_ingest_step / make_prefill_step / "
                "make_decode_step(dist=) and generate(dist=): 2 ingests, a "
                "448-token prefill, 4 decode steps, the cache and memory, 8 "
                "generated tokens, bit-equal to dist=None")
            del got, want, st_d

            scfg = cfg.replace(ccm=dataclasses.replace(
                cfg.ccm, stream_window=512, stream_chunk=64,
                stream_mem_slots=4))
            sstep = SRV.make_stream_step(scfg, dist)

            def stream(st, tp_dist):
                out = []
                for i in range(10):
                    t = toks[:, i * 64:(i + 1) * 64]
                    lg, st = sstep(params, st, t) if tp_dist else \
                        STR.stream_step(params, scfg, st, t)
                    out.append(lg)
                return out, st
            s0 = STR.init_stream_state(scfg, 2, device=dev)
            _, s_d = sstep.place(params, clone_state(torch, s0))
            got = counted(ops, counts, lambda: stream(s_d, True))
            want = stream(clone_state(torch, s0), False)
            if not all(torch.equal(a, b) for a, b in zip(got[0], want[0])) \
                    or not torch.equal(got[1].win_k, want[1].win_k) \
                    or not torch.equal(got[1].mem.k, want[1].mem.k) \
                    or got[1].mem.slots != want[1].mem.slots:
                raise AssertionError(f"15a {impl} make_stream_step(dist=) "
                                     "differs")
            log(f"  15a {impl} make_stream_step(dist=): 10 chunks of 64 (2 "
                f"evictions, {got[1].mem.slots} memory groups) bit-equal to "
                "dist=None (W 512)")
            del got, want, s_d

            # the split path itself at n = 1, over the NCCL model-axis group
            tp1 = TPX.TensorParallel(cfg, 1, 0, TPX.collectives(dist))

            def split_online(tp):
                st = clone_state(torch, st0)
                for x in ctx:
                    st = PI.ingest_context(params, cfg, st, x, dist=tp)
                lp, st = PI.prefill(params, cfg, st, prompt, dist=tp)
                tok = PI.greedy(lp[:, -1], cfg, tp)[:, None]
                ld, st = PI.decode_step(params, cfg, st, tok, dist=tp)
                return PI.gather_vocab(lp, cfg, tp), ld, tok
            got = counted(ops, counts, lambda: split_online(tp1))
            want = split_online(None)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"15a {impl}: the split path at n = 1 "
                                     "differs from dist=None online")
            tq = clone(tp0)

            def split_grads(tp):
                leaves = [x for _, x in PP.leaves(tq)]
                for x in leaves:
                    x.requires_grad_(True)
                with torch.enable_grad():
                    loss = TR._loss_fn(tq, fp0, cfg, layout, batch, dist=tp)
                    return loss.detach(), torch.autograd.grad(loss, leaves)
            (la, ga), (lb, gb) = counted(ops, counts,
                                         lambda: split_grads(tp1)), \
                split_grads(None)
            check(f"15a {impl} split path at n = 1 over NCCL: the "
                  "vocab-parallel loss vs logsumexp (float32)",
                  abs(la.item() - lb.item()), 1e-5 * abs(lb.item()))
            worst = max(max_err(a, b) / max(b.float().abs().max().item(),
                                            1e-30) for a, b in zip(ga, gb))
            check(f"15a {impl} split path at n = 1: every LoRA gradient, "
                  "relative to its largest", worst, 2.0 ** -5)
            log(f"  15a {impl} the split path at n = 1 (the experts through "
                + ("one NCCL all-reduce" if impl == "ragged_tp" else
                   "NCCL's all-to-all there and back and a gather")
                + "): prefill and decode logits and the greedy pick "
                "bit-equal to dist=None")
            del got, want, tq, ga, gb

        # the sequence-sharded decode: the split-K route with its lse
        sdec = SRV.make_decode_step(base, dist, shard_cache_seq=True,
                                    batch_sharded=False)
        st0 = PI.init_online_state(base, B, CACHE, device=dev)
        st0 = PI.prefill(params, base, st0, prompt)[1]
        _, st_s = sdec.place(params, clone_state(torch, st0))
        here = {}
        ls, _ = counted(ops, here, lambda: sdec(params, st_s,
                                                prompt[:, :1]))
        lw, _ = PI.decode_step(params, base, clone_state(torch, st0),
                               prompt[:, :1])
        check("15a sequence-sharded decode (one data rank, the split-K "
              "route's log-sum-exp) vs dist=None", max_err(ls, lw),
              bf16_tol(lw))
        lse_launches = here.get("segmented_attention_splitk", 0)
        if lse_launches <= 0:
            raise AssertionError(f"15a sequence-sharded decode: {here}")
        add_counts(counts, here)
        return counts, lse_launches
    finally:
        tdist.destroy_process_group()


def moe_rank_loop(torch, m, card):
    """15b: one block at full width (``n_layers=1``) of phi3.5-moe at n =
    2 and 4 under each ``moe_impl`` and of llama4-maverick under ``ep``
    at n = 8, random weights (seed 15, LoRA b drawn), bf16.  The n ranks
    of a ``LocalGroup`` run on the card in turn, forward only: the CCM
    training forward (B2, S1216) and its vocab-parallel loss, then an
    ingest of 64 tokens, a 64-token prefill and a decode step (B4); concat,
    and merge for phi3.5.  Each is held within bf16_tol of the unsharded
    block on the card (logits gathered over the vocabulary blocks), with
    the rank loop's expert ids pinned to the unsharded block's
    (``rank_routes``) and, under ``ep``, the unsharded block computing
    ep's drops (``ep_unsharded``: the same ids, so the same drop mask).
    Prints the assignments ep dropped, a rank's share in ms beside the
    unsharded block's (the port's own routes), the launches and
    ``max_memory_allocated``.  Returns the rank loops' launches and the
    record."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import moe as MOE
    from repro_torch.optim.losses import next_token_loss
    PI, PT, PD, ops = m.PI, m.PT, m.PD, m.ops
    counts, rec = {}, {}
    layout = m.segment_layout(*ZOO_LAYOUT)
    params = None
    for arch, impl, n in MOE_TP_BLOCKS:
        base = m.get_config(arch).replace(n_layers=1, moe_impl=impl)
        if params is None or params_arch != arch:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = m.init_lm(base, seed=15)
            randomize_lora_b(torch, params, seed=115)
            params_arch = arch
        dev = params["embed"].device
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 2)
                                   .key_for(0), layout, 2, device=dev)
        tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
        gen = torch.Generator(device=dev).manual_seed(151)
        ctx = torch.randint(0, base.vocab_size, (4, 64), generator=gen,
                            device=dev)
        prompt = torch.randint(0, base.vocab_size, (4, 64), generator=gen,
                               device=dev)
        here, r = {}, {}
        modes = ("concat", "merge") if arch == MOE_TP_ARCH else ("concat",)
        for mode in modes:
            cfg = base.replace(ccm=dataclasses.replace(base.ccm, mode=mode))
            shards = [TPX.shard_params(params, cfg,
                                       TPX.TensorParallel(cfg, n, i, None))
                      for i in range(n)]

            def train(p, tp):
                lg = PT.train_forward(p, cfg, batch["tokens"], layout,
                                      dist=tp)
                loss = next_token_loss(lg, tail, batch["loss_mask"], tp=tp)
                return PI.gather_vocab(lg, cfg, tp), loss

            def online(p, st, tp):
                st = PI.ingest_context(p, cfg, st, ctx, dist=tp)
                lp, st = PI.prefill(p, cfg, st, prompt, dist=tp)
                ld, st = PI.decode_step(p, cfg, st, prompt[:, :1], dist=tp)
                return (PI.gather_vocab(lp, cfg, tp),
                        PI.gather_vocab(ld, cfg, tp))
            st0 = PI.init_online_state(cfg, 4, 256, device=dev)

            def whole():
                with ep_unsharded(n) if impl == "ep" else \
                        contextlib.nullcontext():
                    return train(params, None), online(
                        params, clone_state(torch, st0), None)

            def loop():
                grp = TPX.LocalGroup(n)
                ranks = TPX.local_ranks(cfg, grp)
                sts = [rank_state(torch, st0, tp) for tp in ranks]
                return grp.run(lambda i: (train(shards[i], ranks[i]),
                                          online(shards[i], sts[i],
                                                 ranks[i])))
            calls, flips = [], []
            with torch.no_grad():
                with moe_routes(recorded_routes(calls)):
                    want = whole()
                MOE.EP_DROPS.update(assignments=0, dropped=0)
                with moe_routes(rank_routes(torch, calls, flips)):
                    outs = counted(ops, here, loop)
                drops = dict(MOE.EP_DROPS)
                t_whole = time_ms(torch, lambda i: whole(), iters=3,
                                  warmup=1)
                t_loop = time_ms(torch, lambda i: loop(), iters=3, warmup=1)
            for rk, ((lg, loss), (lp, ld)) in enumerate(outs):
                for name, a, b in (("train logits", lg, want[0][0]),
                                   ("loss", loss, want[0][1]),
                                   ("prefill logits", lp, want[1][0]),
                                   ("decode logits", ld, want[1][1])):
                    err = max_err(a, b)
                    if rk == 0:
                        check(f"15b {arch} {impl} n={n} {mode} {name} "
                              "(rank loop vs unsharded, ids pinned)", err,
                              bf16_tol(b))
                    elif not err <= bf16_tol(b):
                        raise AssertionError(f"15b {arch} {impl} n={n} "
                                             f"rank {rk} {name}: {err}")
            r[mode] = dict(whole_ms=t_whole, loop_ms=t_loop,
                           per_rank_ms=t_loop / n, dropped=drops["dropped"],
                           assignments=drops["assignments"],
                           route_flips=sum(flips))
            log(f"  15b {arch} {impl} n={n} {mode}: the {n} ranks in turn "
                f"{t_loop:.2f} ms ({t_loop / n:.2f} ms a rank), the "
                f"unsharded block {t_whole:.2f} ms (training forward + loss, "
                f"ingest, prefill, decode; CUDA events); ep dropped "
                f"{drops['dropped']} of {drops['assignments']} assignments; "
                f"{sum(flips)} rows whose own top-k differs from the pinned "
                f"[{card}]")
            del shards, outs, want
        missing = [k for k in MOE_TP_KERNELS if here.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"15b {arch} {impl} n={n}: no launch of "
                                 f"{missing} ({here})")
        lc = TPX.local_config(base, TPX.TensorParallel(base, n, 0, None))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  15b {arch} {impl} n={n}: launches "
            f"{({k: v for k, v in here.items() if v})} (a rank's shard: "
            f"{lc.n_heads}/{lc.n_kv_heads} heads, "
            + (f"{base.n_experts // n} of {base.n_experts} experts"
               if impl == "ep" else f"d_ff {lc.d_ff} of every expert")
            + f", vocab {lc.vocab_size}); max_memory_allocated {peak:.2f} "
            "GiB")
        add_counts(counts, here)
        rec[f"{arch} {impl} n={n}"] = dict(r, launches=here, peak_gib=peak)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def phase15(torch, m, card):
    """Phase 15: 15a on phi3.5-moe's first 2 layers, 15b its blocks and
    llama4-maverick's."""
    t0 = time.perf_counter()
    log("  15a: every dist= entry point with the MoE family in an NCCL "
        "world of one rank, (1, 1) mesh")
    counts, lse_launches = moe_world_of_one(torch, m, card)
    need = ("cond_lora_wgmma", "segmented_attention_splitk",
            "segmented_attention_mma", "ccm_attention_mma",
            "ccm_attention_backward_mma", "kv_cummean", "kv_cummean_backward")
    if any(counts.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"15a launches {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    log("  15b: the MoE rank loop at full width (LocalGroup, ranks in turn "
        "on the card)")
    loop_counts, rec = moe_rank_loop(torch, m, card)
    add_counts(counts, loop_counts)
    for k in ("kv_merge_update", "kv_cummean"):
        if loop_counts.get(k, 0) <= 0:
            raise AssertionError(f"15b: no launch of {k}")
    rec["lse_launches"] = lse_launches
    rec["seconds"] = time.perf_counter() - t0
    log(f"  phase 15 launches: {({k: v for k, v in counts.items() if v})} "
        f"(the sequence-sharded decode's split-K launches with lse: "
        f"{lse_launches}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; took "
        f"{rec['seconds']:.1f} s")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism, part 3 (the recurrent, encoder-decoder and
# VLM families)
# ---------------------------------------------------------------------------

TP_FAMILY_ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-tiny",
                   "pixtral-12b")
# 16a's depth cuts (never width): mamba2 2 of its 48 layers, zamba2 one
# group of 6 Mamba2 layers and the shared site after it, pixtral 2 of its
# 40; whisper-tiny whole (4 + 4 layers).  Per config: the context tokens
# of an ingest (with the <COMP> group within one SSD chunk), the prompt
# (pixtral: 1024 patch positions + 64 text tokens), the cache, and the
# training layout (phases 11c and 12b's)
TP16 = {"mamba2-370m": dict(cut=dict(n_layers=2), lc=64, prompt=128,
                            cache=256, layout=REC["mamba2-370m"]["layout"]),
        "zamba2-1.2b": dict(cut=dict(n_layers=6), lc=56, prompt=128,
                            cache=256, layout=ZAMBA_LAYOUT),
        "whisper-tiny": dict(cut={}, lc=64, prompt=64, cache=256,
                             layout=FAM["whisper-tiny"]["layout"]),
        "pixtral-12b": dict(cut=dict(n_layers=2), lc=64, prompt=1024 + 64,
                            cache=1280, layout=FAM["pixtral-12b"]["layout"])}
# 16b's blocks: (arch, model-axis sizes); the float32 configs run float32
# compute, pixtral bf16
TP16_BLOCKS = (("zamba2-1.2b", (2, 4, 8)), ("whisper-tiny", (2, 4)),
               ("pixtral-12b", (2, 4, 8)), ("mamba2-370m", (2, 4, 8)))


def tp16_config(m, arch, block: bool):
    """16a's config (the depth cut of ``TP16``), or 16b's block: zamba2's
    one Mamba2 layer and the shared site after it, one layer of mamba2 and
    pixtral, whisper-tiny whole; the float32 configs in float32 compute."""
    cfg = m.get_config(arch)
    if not block:
        return cfg.replace(**TP16[arch]["cut"])
    if arch == "zamba2-1.2b":
        cfg = cfg.replace(n_layers=1, attn_every=1)
    elif arch != "whisper-tiny":
        cfg = cfg.replace(n_layers=1)
    if cfg.param_dtype == "float32":
        cfg = cfg.replace(compute_dtype="float32")
    return cfg


def tp16_inputs(torch, m, cfg, B, dev, seed):
    """A training batch at the family's layout (with frames or patches)
    and the online tokens: 2 contexts, a prompt, and the family's input."""
    t = TP16[cfg.name]
    layout = m.segment_layout(*t["layout"])
    batch = m.PD.sample_kv_batch(m.PD.ShardableIndexIterator(seed, B)
                                 .key_for(0), layout, B, device=dev)
    extra = family_inputs(torch, cfg, B, dev, seed)
    batch.update(extra)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx = [torch.randint(0, cfg.vocab_size, (B, t["lc"]), generator=gen,
                         device=dev) for _ in range(2)]
    prompt = torch.randint(0, cfg.vocab_size, (B, t["prompt"]),
                           generator=gen, device=dev)
    return layout, batch, ctx, prompt, extra


@contextlib.contextmanager
def deterministic(torch):
    """Within: PyTorch's deterministic algorithms (warnings only where an
    op has none).  A full-training step's embedding gradient comes from
    the backward of a row gather (an accumulating index_put_), whose
    sums otherwise land in an order that differs from run to run; the
    two runs held bit-equal take it in the same order."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def same_state(torch, a, b) -> list:
    """The tensor leaves of two online states that are not bit-equal."""
    out = []
    for name in ("cache", "mem", "ssm"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            continue
        for f in x._fields:
            u, w = getattr(x, f), getattr(y, f)
            if isinstance(u, torch.Tensor) and not torch.equal(u, w):
                out.append(f"{name}.{f}")
    if a.cross is not None:
        out += [f"cross[{i}]" for i in (0, 1)
                if not torch.equal(a.cross[i], b.cross[i])]
    return out


def tp_family_world(torch, m, card):
    """16a: each family of ``TP_FAMILY_ARCHS`` at full width (depth cut by
    ``TP16``; random weights, seed 16, LoRA b drawn; the configs' own
    dtypes) in an NCCL world of one rank on a (1, 1) mesh, against
    ``dist=None``, bit-equal: ``jit_train_step``'s placed step (B2, one
    AdamW step; zamba2 concat and merge; both under `deterministic`),
    ``encode_cross(dist=)``
    (whisper, over 1500 frames), the three ``dist=`` builders (2 ingests,
    a prefill: pixtral's with its 1024 patches through the builder, 4
    decode steps) and ``generate`` (8 tokens), ``make_stream_step``
    (whisper and pixtral: W 512, 10 chunks of 64, 2 evictions); then the
    split path itself at n = 1 (a ``TensorParallel`` over the NCCL
    model-axis group: the vocab-parallel embed, head and learned
    positions, the split blocks' reduces): online logits bit-equal, the
    loss and the gradients held to ``dist=None``; and zamba2's
    sequence-sharded decode within bf16_tol.  Returns the dist runs'
    launches."""
    import torch.distributed as tdist
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    PI, STR, TR, PA, PP, ops = m.PI, m.STR, m.TR, m.PA, m.PP, m.ops
    dev = init_world(0, 1, free_port(), "cuda")                 # NCCL
    counts = {}

    def clone(t):
        return PP.tree_map(lambda _, x: None if x is None
                           else x.detach().clone(), t)
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        for arch in TP_FAMILY_ARCHS:
            t_arch = time.perf_counter()
            cfg = tp16_config(m, arch, block=False)
            params = m.init_lm(cfg, seed=16)
            if cfg.ccm.enabled:
                randomize_lora_b(torch, params, seed=116)
            B, CACHE = 2, TP16[arch]["cache"]
            layout, batch, ctx, prompt, extra = tp16_inputs(
                torch, m, cfg, B, dev, 160)
            tp0, fp0 = PP.partition(params, TR.trainable_mask_for(cfg,
                                                                  params))
            ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
            modes = [("concat", cfg)]
            if arch == "zamba2-1.2b":
                modes.append(("merge", cfg.replace(ccm=dataclasses.replace(
                    cfg.ccm, mode="merge", merge_alpha=None))))
            for mode, c in modes:
                tp, opt = clone(tp0), PA.init_adamw(tp0)
                step = TR.jit_train_step(
                    TR.make_train_step(c, layout, ocfg, dist), c, dist, None,
                    None, batch, None)
                tp, fp, opt = step.place(tp, fp0, opt)
                tq, oq = clone(tp0), PA.init_adamw(tp0)
                with deterministic(torch):
                    tp, opt, mt, _ = counted(ops, counts, lambda: step(
                        tp, fp, opt, batch))
                    tq, oq, mq, _ = TR.make_train_step(c, layout, ocfg)(
                        tq, fp0, oq, batch)
                diff = same_tree(torch, PP, tp, tq) \
                    + same_tree(torch, PP, opt.mu, oq.mu) \
                    + same_tree(torch, PP, opt.nu, oq.nu)
                if mt["loss"].item() != mq["loss"].item() or diff:
                    raise AssertionError(
                        f"16a {arch} train {mode}: loss {mt['loss'].item()} "
                        f"vs {mq['loss'].item()}, differ {diff}")
                del tp, tq, opt, oq
            log(f"  16a {arch} jit_train_step(dist=) "
                f"{'/'.join(k for k, _ in modes)}: one AdamW step "
                f"bit-equal to dist=None (loss {mt['loss'].item():.4f}, "
                "leaves, moments; B2, layout "
                f"{TP16[arch]['layout']})")

            st0 = PI.init_online_state(cfg, B, CACHE, device=dev)
            if cfg.family == "encdec":
                xd = counted(ops, counts, lambda: PI.encode_cross(
                    params, cfg, extra["frames"], dist=dist))
                xn = PI.encode_cross(params, cfg, extra["frames"])
                if not all(torch.equal(a, b) for a, b in zip(xd, xn)):
                    raise AssertionError("16a encode_cross(dist=) differs")
                st0 = st0._replace(cross=xn)
                log(f"  16a {arch} encode_cross(dist=): B2 x "
                    f"{WHISPER_FRAMES} frames, the cross K/V of "
                    f"{cfg.n_layers} layers bit-equal to dist=None")
            ing, pre = SRV.make_ingest_step(cfg, dist), \
                SRV.make_prefill_step(cfg, dist)
            dec = SRV.make_decode_step(cfg, dist)
            patches = extra.get("patches")

            def online(st, tp_dist):
                for x in ctx:
                    st = ing(params, st, x) if tp_dist else \
                        PI.ingest_context(params, cfg, st, x)
                lg, st = pre(params, st, prompt, patches) if tp_dist else \
                    PI.prefill(params, cfg, st, prompt, patches=patches)
                lgs = [lg]
                for _ in range(4):
                    tok = lgs[-1][:, -1].argmax(-1)[:, None]
                    lg, st = dec(params, st, tok) if tp_dist else \
                        PI.decode_step(params, cfg, st, tok)
                    lgs.append(lg)
                g = PI.generate(params, cfg, clone_state(torch, st),
                                prompt[:, :64], 8,
                                dist=dist if tp_dist else None)
                return lgs, st, g
            _, st_d = ing.place(params, clone_state(torch, st0))
            got = counted(ops, counts, lambda: online(st_d, True))
            want = online(clone_state(torch, st0), False)
            bad = [i for i, (a, b) in enumerate(zip(got[0], want[0]))
                   if not torch.equal(a, b)]
            bad += same_state(torch, got[1], want[1])
            if bad or not torch.equal(got[2], want[2]):
                raise AssertionError(f"16a {arch} builders: differ at {bad} "
                                     "or in generate's tokens")
            log(f"  16a {arch} make_ingest_step / make_prefill_step / "
                "make_decode_step(dist=) and generate(dist=): 2 ingests of "
                f"{TP16[arch]['lc']}, a {prompt.shape[1]}-token prefill"
                + (" with 1024 patches" if patches is not None else "")
                + ", 4 decode steps, every state leaf, 8 generated tokens, "
                "bit-equal to dist=None")
            del got, want, st_d

            if cfg.family in ("encdec", "vlm"):
                scfg = cfg.replace(ccm=dataclasses.replace(
                    cfg.ccm, stream_window=512, stream_chunk=64,
                    stream_mem_slots=4))
                sstep = SRV.make_stream_step(scfg, dist)
                gen = torch.Generator(device=dev).manual_seed(161)
                toks = torch.randint(0, cfg.vocab_size, (2, 640),
                                     generator=gen, device=dev)

                def stream(st, tp_dist):
                    out = []
                    for i in range(10):
                        t = toks[:, i * 64:(i + 1) * 64]
                        lg, st = sstep(params, st, t) if tp_dist else \
                            STR.stream_step(params, scfg, st, t)
                        out.append(lg)
                    return out, st
                s0 = STR.init_stream_state(scfg, 2, device=dev)
                _, s_d = sstep.place(params, clone_state(torch, s0))
                got = counted(ops, counts, lambda: stream(s_d, True))
                want = stream(clone_state(torch, s0), False)
                if not all(torch.equal(a, b) for a, b in zip(got[0],
                                                             want[0])) \
                        or not torch.equal(got[1].win_k, want[1].win_k) \
                        or not torch.equal(got[1].mem.k, want[1].mem.k) \
                        or got[1].mem.slots != want[1].mem.slots:
                    raise AssertionError(f"16a {arch} make_stream_step("
                                         "dist=) differs")
                log(f"  16a {arch} make_stream_step(dist=): 10 chunks of 64 "
                    f"(2 evictions, {got[1].mem.slots} memory groups) "
                    "bit-equal to dist=None (W 512)")
                del got, want, s_d

            # the split path itself at n = 1, over the NCCL model-axis group
            tp1 = TPX.TensorParallel(cfg, 1, 0, TPX.collectives(dist))

            def split_online(tp):
                st = clone_state(torch, st0)
                if cfg.family == "encdec":
                    st = st._replace(cross=PI.encode_cross(
                        params, cfg, extra["frames"], dist=tp))
                for x in ctx:
                    st = PI.ingest_context(params, cfg, st, x, dist=tp)
                lp, st = PI.prefill(params, cfg, st, prompt, patches=patches,
                                    dist=tp)
                tok = PI.greedy(lp[:, -1], cfg, tp)[:, None]
                ld, st = PI.decode_step(params, cfg, st, tok, dist=tp)
                return PI.gather_vocab(lp, cfg, tp), ld, tok
            got = counted(ops, counts, lambda: split_online(tp1))
            want = split_online(None)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"16a {arch}: the split path at n = 1 "
                                     "differs from dist=None online")
            tq = clone(tp0)

            def split_grads(tp):
                leaves = [x for _, x in PP.leaves(tq)]
                for x in leaves:
                    x.requires_grad_(True)
                with torch.enable_grad():
                    loss = TR._loss_fn(tq, fp0, cfg, layout, batch, dist=tp)
                    return loss.detach(), torch.autograd.grad(loss, leaves)
            with deterministic(torch):
                (la, ga), (lb, gb) = counted(ops, counts,
                                             lambda: split_grads(tp1)), \
                    split_grads(None)
            check(f"16a {arch} split path at n = 1 over NCCL: the "
                  "vocab-parallel loss vs logsumexp (float32)",
                  abs(la.item() - lb.item()), 1e-5 * abs(lb.item()))
            worst = max(max_err(a, b) / max(b.float().abs().max().item(),
                                            1e-30) for a, b in zip(ga, gb))
            check(f"16a {arch} split path at n = 1: every trainable "
                  "gradient, relative to its largest", worst, 2.0 ** -5)
            del tq, ga, gb

            if arch == "zamba2-1.2b":
                sdec = SRV.make_decode_step(cfg, dist, shard_cache_seq=True,
                                            batch_sharded=False)
                st1 = PI.prefill(params, cfg, clone_state(torch, st0),
                                 prompt)[1]
                _, st_s = sdec.place(params, clone_state(torch, st1))
                ls, _ = counted(ops, counts, lambda: sdec(params, st_s,
                                                          prompt[:, :1]))
                lw, _ = PI.decode_step(params, cfg, clone_state(torch, st1),
                                       prompt[:, :1])
                check("16a zamba2-1.2b sequence-sharded decode (one data "
                      "rank: the site's cache by the split-K route's "
                      "log-sum-exp, the Mamba2 state whole) vs dist=None",
                      max_err(ls, lw), bf16_tol(lw))
            log(f"  16a {arch}: the split path at n = 1 bit-equal online; "
                f"{cfg.n_layers} layers at d {cfg.d_model} took "
                f"{time.perf_counter() - t_arch:.1f} s")
            del params, tp0, fp0, batch, st0
            gc.collect()
            torch.cuda.empty_cache()
        return counts
    finally:
        tdist.destroy_process_group()


def tp_family_rank_loop(torch, m, card):
    """16b: the ``LocalGroup`` rank loop at full width (``TP16_BLOCKS``:
    one zamba2 site after one Mamba2 layer, whisper-tiny whole, one
    pixtral-12b block, one mamba2 layer and the split head), random
    weights (seed 16, LoRA b drawn), ranks in turn on the card, forward
    only: the CCM training forward (B2, the family's layout, with frames
    or patches) and its vocab-parallel loss, then ``encode_cross``
    (whisper), an ingest, a prefill (pixtral's with its 1024 patches) and
    a decode step; zamba2 in concat and merge.  Held against the
    unsharded run on the card: within bf16_tol for pixtral (bf16),
    within f32_lane_tol for the float32 configs.  A rank's share of the
    loop's ms beside the unsharded run's, the launches and
    ``max_memory_allocated``.  Returns the rank loops' launches and the
    record."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.optim.losses import next_token_loss
    PI, PT, ops = m.PI, m.PT, m.ops
    counts, rec = {}, {}
    for arch, sizes in TP16_BLOCKS:
        base = tp16_config(m, arch, block=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = m.init_lm(base, seed=16)
        if base.ccm.enabled:
            randomize_lora_b(torch, params, seed=116)
        dev = params["embed"].device
        layout, batch, ctx, prompt, extra = tp16_inputs(torch, m, base, 2,
                                                        dev, 162)
        tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
        patches = extra.get("patches")
        tol = bf16_tol if base.compute_dtype == "bfloat16" else f32_lane_tol
        modes = ("concat", "merge") if arch == "zamba2-1.2b" else ("concat",)
        for n in sizes:
            here, r = {}, {}
            for mode in modes:
                cfg = base.replace(ccm=dataclasses.replace(base.ccm,
                                                           mode=mode))
                shards = [TPX.shard_params(params, cfg,
                                           TPX.TensorParallel(cfg, n, i,
                                                              None))
                          for i in range(n)]

                def train(p, tp):
                    lg = PT.train_forward(p, cfg, batch["tokens"], layout,
                                          dist=tp, **extra)
                    loss = next_token_loss(lg, tail, batch["loss_mask"],
                                           tp=tp)
                    return PI.gather_vocab(lg, cfg, tp), loss

                def online(p, st, tp):
                    if cfg.family == "encdec":
                        st = st._replace(cross=PI.encode_cross(
                            p, cfg, extra["frames"], dist=tp))
                    st = PI.ingest_context(p, cfg, st, ctx[0], dist=tp)
                    lp, st = PI.prefill(p, cfg, st, prompt, patches=patches,
                                        dist=tp)
                    ld, st = PI.decode_step(p, cfg, st, prompt[:, :1],
                                            dist=tp)
                    return (PI.gather_vocab(lp, cfg, tp),
                            PI.gather_vocab(ld, cfg, tp))
                st0 = PI.init_online_state(cfg, 2, TP16[arch]["cache"],
                                           device=dev)

                def whole():
                    return train(params, None), online(
                        params, clone_state(torch, st0), None)

                def loop():
                    grp = TPX.LocalGroup(n)
                    ranks = TPX.local_ranks(cfg, grp)
                    sts = [rank_state(torch, st0, tp) for tp in ranks]
                    return grp.run(lambda i: (train(shards[i], ranks[i]),
                                              online(shards[i], sts[i],
                                                     ranks[i])))
                with torch.no_grad():
                    want = whole()
                    outs = counted(ops, here, loop)
                    t_whole = time_ms(torch, lambda i: whole(), iters=3,
                                      warmup=1)
                    t_loop = time_ms(torch, lambda i: loop(), iters=3,
                                     warmup=1)
                for rk, ((lg, loss), (lp, ld)) in enumerate(outs):
                    for name, a, b in (("train logits", lg, want[0][0]),
                                       ("loss", loss, want[0][1]),
                                       ("prefill logits", lp, want[1][0]),
                                       ("decode logits", ld, want[1][1])):
                        err = max_err(a, b)
                        if rk == 0:
                            check(f"16b {arch} n={n} {mode} {name} (rank "
                                  f"loop vs unsharded, "
                                  f"{base.compute_dtype})", err, tol(b))
                        elif not err <= tol(b):
                            raise AssertionError(f"16b {arch} n={n} rank "
                                                 f"{rk} {name}: {err}")
                r[mode] = dict(whole_ms=t_whole, loop_ms=t_loop,
                               per_rank_ms=t_loop / n)
                log(f"  16b {arch} n={n} {mode}: the {n} ranks in turn "
                    f"{t_loop:.2f} ms ({t_loop / n:.2f} ms a rank), the "
                    f"unsharded run {t_whole:.2f} ms (training forward + "
                    "loss, "
                    + ("encode_cross, " if base.family == "encdec" else "")
                    + f"ingest, prefill, decode; CUDA events) [{card}]")
                del shards, outs, want
            lc = TPX.local_config(base, TPX.TensorParallel(base, n, 0, None))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  16b {arch} n={n} ({TPX.attn_regime(base, n)}): launches "
                f"{({k: v for k, v in here.items() if v}) or 'none'} (a "
                f"rank's shard: "
                + (f"{lc.n_heads}/{lc.n_kv_heads} heads, "
                   if not base.is_attention_free else "Mamba2 whole, ")
                + f"d_ff {lc.d_ff}, vocab {lc.vocab_size}); "
                f"max_memory_allocated {peak:.2f} GiB")
            add_counts(counts, here)
            rec[f"{arch} n={n}"] = dict(r, launches=here, peak_gib=peak)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def phase16(torch, m, card):
    """Phase 16: 16a the four families through every dist= entry point,
    16b their rank loops."""
    t0 = time.perf_counter()
    log("  16a: every dist= entry point with the recurrent, encoder-decoder "
        "and VLM families in an NCCL world of one rank, (1, 1) mesh")
    counts = tp_family_world(torch, m, card)
    need = ("cond_lora_wgmma", "segmented_attention_splitk",
            "segmented_attention_mma", "ccm_attention_mma",
            "ccm_attention_backward_mma", "kv_cummean", "kv_cummean_backward")
    if any(counts.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"16a launches {counts}")
    t_a = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log("  16b: the rank loop at full width (LocalGroup, ranks in turn on "
        "the card)")
    loop_counts, rec = tp_family_rank_loop(torch, m, card)
    for k in ("cond_lora", "cond_lora_wgmma", "segmented_attention",
              "segmented_attention_mma", "segmented_attention_splitk",
              "ccm_attention", "ccm_attention_mma", "kv_merge_update",
              "kv_cummean"):
        if loop_counts.get(k, 0) <= 0:
            raise AssertionError(f"16b: no launch of {k} ({loop_counts})")
    add_counts(counts, loop_counts)
    rec["seconds"] = time.perf_counter() - t0
    log(f"  phase 16 launches: {({k: v for k, v in counts.items() if v})}; "
        f"16a took {t_a:.1f} s, phase 16 {rec['seconds']:.1f} s [{card}]")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 17: the sequence-sharded prefill and ingest
# ---------------------------------------------------------------------------

# 17a's shapes (B4, bf16 q; the last lane sees no key): LLaMA-7B's
# prefill block (Sq 448, 32 x 128, over 32 memory rows and a 480-token
# cache), Qwen2's 14/2 at hd 64 and Gemma-2B's 8/1 at hd 256 at the same
# block, and an ingest block (64 tokens + 8 <COMP>) over an int8 cache
MMA_LSE_CASES = [
    dict(label="prefill 32/32 hd128", Sq=448, H=32, Hkv=32, D=128),
    dict(label="prefill 14/2 hd64", Sq=448, H=14, Hkv=2, D=64),
    dict(label="prefill 8/1 hd256", Sq=448, H=8, Hkv=1, D=256),
    dict(label="ingest 32/32 hd128 int8", Sq=72, H=32, Hkv=32, D=128,
         ncomp=8, int8=True),
]


def mma_lse_inputs(torch, quantize_kv, *, label, Sq, H, Hkv, D, ncomp=0,
                   int8=False, B=4, seed=170):
    """17a's inputs from ``seed``: (q, segs, q_idx, q_seg, scale, the
    segments as the kernel reads them).  Per-lane metadata: lanes 0-2 see
    32 memory rows, a 480-token cache and their causal block; lane B-1
    sees no key (no memory, no cache, q_idx below every key's).  With
    ``int8`` the cache is int8 with float32 scales, and the last item
    holds it dequantized into bf16 (what the mma.sync route reads)."""
    del label
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q = rn(B, Sq, H, D)
    mk, mv = rn(B, 128, Hkv, D), rn(B, 128, Hkv, D)
    ck, cv = rn(B, 512, Hkv, D), rn(B, 512, Hkv, D)
    sk, sv = rn(B, Sq, Hkv, D), rn(B, Sq, Hkv, D)
    ar = torch.arange(Sq, device=dev, dtype=torch.int32)
    comp = torch.zeros(Sq, device=dev, dtype=torch.bool)
    if ncomp:
        comp[Sq - ncomp:] = True
    qi = ar.expand(B, Sq).clone()
    qi[B - 1] = -5
    qs = torch.ones_like(qi)
    lens = torch.tensor([32] * (B - 1) + [0], device=dev, dtype=torch.int32)
    clen = torch.tensor([480] * (B - 1) + [0], device=dev, dtype=torch.int32)
    self_seg = seg_dict(sk, sv, idx=ar, seg=torch.ones_like(ar), comp=comp)
    mem = seg_dict(mk, mv, length=lens)
    if int8:
        ck8, cks = quantize_kv(ck)
        cv8, cvs = quantize_kv(cv)
        cache = seg_dict(ck8, cv8, k_scale=cks, v_scale=cvs, length=clen)
        read = [mem, seg_dict((ck8.float() * cks[..., None]).bfloat16(),
                              (cv8.float() * cvs[..., None]).bfloat16(),
                              length=clen), self_seg]
    else:
        cache = seg_dict(ck, cv, length=clen)
        read = None
    segs = [mem, cache, self_seg]
    return q, segs, qi, qs, D ** -0.5, read or segs


def mma_lse_check(torch, dattn, quantize_kv, card):
    """17a: the mma.sync route (bf16 q, Sq > 2) with its log-sum-exp
    against the plain version, at ``MMA_LSE_CASES``: the output within
    bf16_tol (phase 2's), the lse within 1e-5 x its largest (14c's; an
    int8 cache's against the plain version over the keys dequantized into
    bf16, as the route reads them), the output bit-equal with and
    without the lse, the lane that sees no key exactly 0 with lse -inf.
    Times the route with and without the lse (device ms), its plain
    version with the lse and the library's flash attention, whose second
    output is the lse (no mask: every key of the concatenation visible),
    at the first case.  Returns the record."""
    rec = {}
    for case in MMA_LSE_CASES:
        label = case["label"]
        q, segs, qi, qs, scale, read = mma_lse_inputs(torch, quantize_kv,
                                                      **case)
        B, Sq, H, D = q.shape
        out, lse = dattn.segmented_flash_attention(q, segs, qi, qs, scale,
                                                   lse=True)
        out0 = dattn.segmented_flash_attention(q, segs, qi, qs, scale)
        wo = dattn.plain(q, segs, qi, qs, scale)
        _, wl = dattn.plain(q, read, qi, qs, scale, lse=True)
        torch.cuda.synchronize()
        if not torch.equal(out, out0):
            raise AssertionError(f"17a {label}: the lse changed the output")
        if not bool((out[B - 1] == 0).all()) or not \
                bool(torch.isneginf(lse[B - 1]).all()):
            raise AssertionError(f"17a {label}: the lane with no key is not "
                                 "exactly 0 with lse -inf")
        if not torch.equal(torch.isneginf(lse), torch.isneginf(wl)):
            raise AssertionError(f"17a {label}: -inf rows differ from the "
                                 "plain version's")
        err = max_err(out, wo)
        check(f"17a mma.sync route {label} B{B} Sq{Sq} output (kernel vs "
              "plain)", err, bf16_tol(wo))
        live = torch.isfinite(wl)
        lerr = (lse[live] - wl[live]).abs().max().item()
        check(f"17a mma.sync route {label} lse (kernel vs plain"
              + (" over the bf16 keys" if case.get("int8") else "") + ")",
              lerr, 1e-5 * wl[live].abs().max().item())
        rec[label] = dict(max_abs_err=err, lse_err=lerr)
    # times at LLaMA-7B's prefill block: four input sets in turn, so that
    # the reads of a call (~50 MB) do not stay in the 50 MB L2
    sets = [mma_lse_inputs(torch, quantize_kv, **MMA_LSE_CASES[0],
                           seed=180 + j) for j in range(4)]
    q, segs, qi, qs, scale, _ = sets[0]
    B, Sq, H, D = q.shape

    def kernel(lse):
        def call(i):
            q, segs, qi, qs, scale, _ = sets[i % 4]
            return dattn.segmented_flash_attention(q, segs, qi, qs, scale,
                                                   lse=lse)
        return call
    # with and without the lse in turns, three windows each: the medians
    # (a profiler window now and then reads far off)
    no, yes = [], []
    for _ in range(3):
        no.append(device_ms(torch, kernel(False), only="segmented_attention"))
        yes.append(device_ms(torch, kernel(True), only="segmented_attention"))
    t_no, t_lse = sorted(no)[1], sorted(yes)[1]
    t_plain = device_ms(torch, lambda i: dattn.plain(q, segs, qi, qs, scale,
                                                     lse=True), iters=5)
    # the library: lanes 0-2's keys (32 memory rows, 480 cached, the
    # block) concatenated, every key visible; the same four sets in turn
    def lanes(x):
        return x[:3].transpose(1, 2).contiguous()
    lib = [(lanes(st[0]),) + tuple(
        lanes(torch.cat([sg[kv][:, :n] for sg, n in
                         zip(st[1], (32, 480, Sq))], 1)) for kv in "kv")
        for st in sets]

    def library(i):
        return torch.ops.aten._scaled_dot_product_flash_attention(
            *lib[i % 4], scale=scale)
    t_lib = device_ms(torch, library)
    # bytes: q, o, the keys read once, the lse; operations: the pairs the
    # CCM mask lets through (lanes 0-2: every memory and cached key, the
    # causal block), two products of 2 H D each
    nk = 3 * (32 + 480) + 3 * Sq
    pairs = 3 * Sq * (32 + 480) + 3 * Sq * (Sq + 1) // 2
    nbytes = 2 * q.numel() * 2 + nk * H * D * 2 * 2 + B * H * Sq * 4
    bms, by = bound(nbytes, 4.0 * H * D * pairs, PEAK_BF16)
    cost = (t_lse - t_no) / t_no
    log(f"  17a mma.sync route, LLaMA-7B prefill block B{B} Sq{Sq} "
        f"{H}x{D}: {t_no:.4f} ms without the lse, {t_lse:.4f} ms with it "
        f"(medians of 3 windows in turns: {[round(x, 4) for x in no]} / "
        f"{[round(x, 4) for x in yes]}; the lse costs {100 * cost:.2f} %), "
        f"plain with lse {t_plain:.4f} ms, the "
        f"library's flash attention with lse (3 lanes, no mask) "
        f"{t_lib:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")
    first = rec[MMA_LSE_CASES[0]["label"]]
    rec["row"] = dict(max_abs_err=first["max_abs_err"],
                      lse_err=first["lse_err"], ms=t_lse,
                      no_lse_ms=t_no, lse_cost=cost, plain_ms=t_plain,
                      library_ms=t_lib, bound_ms=bms, bound_by=by)
    return rec


def seq_blocks_check(torch, dattn, card):
    """17b: a prefill block (448 rows at length 24400) and an ingest
    block (64 + 8 <COMP> rows at length 24500) of LLaMA-7B's heads (32 x
    128, bf16, B1) over a 32768-key cache cut in 4 blocks of 8192: each
    block's mma.sync kernel with its lse (the memory and the block's own
    keys on block 0), combined by ``models.attention.combine_blocks``
    over a LocalGroup of 4, against the kernel over the whole cache
    within bf16_tol, and against the plain version.  Times the
    whole-cache kernel, the 4 block kernels and the ranks with the
    combine, and over the whole cache with the lse its plain version and
    the library's flash attention."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models.attention import combine_blocks
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(171)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    B, H, D, S, n = 1, 32, 128, 32768, 4
    blk = S // n
    k, v = rn(B, S, H, D), rn(B, S, H, D)
    mk, mv = rn(B, 128, H, D), rn(B, 128, H, D)
    scale = D ** -0.5
    rec = {}
    for label, Sq, length, ncomp in (("prefill", 448, 24400, 0),
                                     ("ingest", 72, 24500, 8)):
        q = rn(B, Sq, H, D)
        sk, sv = rn(B, Sq, H, D), rn(B, Sq, H, D)
        ar = torch.arange(Sq, device=dev, dtype=torch.int32)
        comp = torch.zeros(Sq, device=dev, dtype=torch.bool)
        if ncomp:
            comp[Sq - ncomp:] = True
        one = torch.ones_like(ar)
        self_seg = seg_dict(sk, sv, idx=ar, seg=one, comp=comp)
        whole = [seg_dict(mk, mv), seg_dict(k, v, length=length), self_seg]
        blocks = [([seg_dict(mk, mv)] if i == 0 else [])
                  + [seg_dict(k[:, i * blk:(i + 1) * blk],
                              v[:, i * blk:(i + 1) * blk],
                              length=min(max(length - i * blk, 0), blk))]
                  + ([self_seg] if i == 0 else []) for i in range(n)]
        want = dattn.segmented_flash_attention(q, whole, ar, one, scale)

        def sharded():
            grp = TPX.LocalGroup(n)

            def rank(i):
                o, l = dattn.segmented_flash_attention(q, blocks[i], ar, one,
                                                       scale, lse=True)
                return combine_blocks(o, l, grp.member(i))
            return grp.run(rank)
        outs = sharded()
        plain = dattn.plain(q, whole, ar, one, scale)
        torch.cuda.synchronize()
        for i, o in enumerate(outs):
            if i == 0:
                check(f"17b {label} block of {Sq} rows over {n} cache blocks "
                      f"of {blk} keys at length {length}, {H}x{D} bf16 "
                      "(combined vs the whole-cache kernel)",
                      max_err(o, want), bf16_tol(want))
                check(f"17b {label} (combined vs plain)", max_err(o, plain),
                      bf16_tol(plain))
            elif not torch.equal(o, outs[0]):
                raise AssertionError(f"17b {label}: the ranks' combined "
                                     "outputs differ")
        t_whole = device_ms(torch, lambda i: dattn.segmented_flash_attention(
            q, whole, ar, one, scale), only="segmented_attention")
        t_blocks = device_ms(torch, lambda i: [
            dattn.segmented_flash_attention(q, b, ar, one, scale, lse=True)
            for b in blocks], only="segmented_attention")
        t_all = device_ms(torch, lambda i: sharded())
        t_loop = time_ms(torch, lambda i: sharded(), iters=5, warmup=1)
        # the whole cache with the lse: the plain version, and the
        # library's flash attention (its 2nd output the lse) over the
        # memory, the cache's first ``length`` keys and the block, every
        # key visible (no mask)
        t_plain = device_ms(torch, lambda i: dattn.plain(
            q, whole, ar, one, scale, lse=True), iters=3)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (torch.cat([a, c[:, :length], b], 1).transpose(1, 2)
                  .contiguous() for a, c, b in ((mk, k, sk), (mv, v, sv)))

        def library(i):
            return torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, scale=scale)
        t_lib = device_ms(torch, library)
        del qt, kt, vt
        keys = length + 128 + Sq
        pairs = Sq * (length + 128) + Sq * (Sq + 1) // 2
        bms, by = bound(2 * q.numel() * 2 + keys * H * D * 2 * 2,
                        4.0 * H * D * pairs, PEAK_BF16)
        log(f"  17b {label}: the whole-cache kernel {t_whole:.4f} ms, the 4 "
            f"block kernels with lse {t_blocks:.4f} ms of device time "
            f"together ({t_blocks / t_whole:.2f} x), with the combine "
            f"{t_all:.4f} ms ({t_all / t_whole:.2f} x), bound {bms:.4f} ms "
            f"({by}); the 4 ranks in turn with the combine {t_loop:.3f} ms "
            f"(CUDA events, host included); over the whole cache with "
            f"the lse, the plain version {t_plain:.4f} ms, the library's "
            f"flash attention (no mask) {t_lib:.4f} ms [{card}]")
        rec[label] = dict(whole_ms=t_whole, blocks_ms=t_blocks,
                          blocks_combine_ms=t_all, loop_ms=t_loop,
                          plain_ms=t_plain, library_ms=t_lib,
                          bound_ms=bms, bound_by=by)
    return rec


def seq_world_of_one(torch, m, params, cfg, card):
    """17c: ``make_ingest_step`` / ``make_prefill_step`` /
    ``make_decode_step`` with ``shard_cache_seq=True,
    batch_sharded=False`` and ``generate(seq_shard=True)`` in an NCCL
    world of one rank on a (1, 1) mesh, against ``dist=None``, bit-equal
    (a one-block combine is out x 1 / 1), on LLaMA-7B's 32 layers (B1, a
    2048-token cache): 2 ingests of 64 tokens, a 448-token prefill, a
    448-token prefill at length 1800 (clamped at the buffer's end), 4
    decode steps and 8 generated tokens, concat and merge: the logits,
    the cache and the memory.  Returns the sharded runs' launches."""
    import torch.distributed as tdist
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    PI, ops = m.PI, m.ops
    dev = init_world(0, 1, free_port(), params["embed"].device)   # NCCL
    counts = {}
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        gen = torch.Generator(device=dev).manual_seed(172)
        ctx = [torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                             device=dev) for _ in range(2)]
        prompt = torch.randint(0, cfg.vocab_size, (1, 448), generator=gen,
                               device=dev)
        for mode in ("concat", "merge"):
            c = cfg.replace(ccm=dataclasses.replace(cfg.ccm, mode=mode))
            kw = dict(shard_cache_seq=True, batch_sharded=False)
            ing, pre = SRV.make_ingest_step(c, dist, **kw), \
                SRV.make_prefill_step(c, dist, **kw)
            dec = SRV.make_decode_step(c, dist, **kw)

            def online(st, sharded):
                for x in ctx:
                    st = ing(params, st, x) if sharded else \
                        PI.ingest_context(params, c, st, x)
                lgs = []
                for at in (None, 1800):
                    if at is not None:
                        st = st._replace(cache=st.cache._replace(length=at))
                    lg, st = pre(params, st, prompt) if sharded else \
                        PI.prefill(params, c, st, prompt)
                    lgs.append(lg)
                for _ in range(4):
                    tok = lgs[-1][:, -1].argmax(-1)[:, None]
                    lg, st = dec(params, st, tok) if sharded else \
                        PI.decode_step(params, c, st, tok)
                    lgs.append(lg)
                g = PI.generate(params, c, clone_state(torch, st),
                                prompt[:, :64], 8,
                                dist=dist if sharded else None,
                                seq_shard=sharded)
                return lgs, st, g
            st0 = PI.init_online_state(c, 1, 2048, device=dev)
            _, st_d = pre.place(params, clone_state(torch, st0))
            got = counted(ops, counts, lambda: online(st_d, True))
            want = online(st0, False)
            bad = [i for i, (a, b) in enumerate(zip(got[0], want[0]))
                   if not torch.equal(a, b)]
            for name in ("k", "v"):
                if not torch.equal(getattr(got[1].cache, name),
                                   getattr(want[1].cache, name)) or not \
                        torch.equal(getattr(got[1].mem, name),
                                    getattr(want[1].mem, name)):
                    bad.append(f"state {name}")
            if bad or not torch.equal(got[2], want[2]):
                raise AssertionError(f"17c {mode}: differ at {bad} or in "
                                     "generate's tokens")
            log(f"  17c {mode}: the sequence-sharded builders (1 data rank "
                "over NCCL) and generate(seq_shard=True): logits of 2 "
                "ingests' state, 2 prefills of 448 (the second clamped at "
                "the buffer's end) and 4 decode steps, the cache and memory, "
                "8 generated tokens, bit-equal to dist=None (B1, "
                f"{c.n_layers} layers)")
            del got, want, st_d, st0
        return counts
    finally:
        tdist.destroy_process_group()


def seq_cache_layer(torch, cfg, li: int, which: int, S: int, dev):
    """Layer ``li`` of 17d's random cache (``which`` 0: k, 1: v) from its
    own seed: (1, S, Hkv, hd) bf16."""
    g = torch.Generator(device=dev).manual_seed(1700 + 2 * li + which)
    return torch.randn((1, S, cfg.n_kv_heads, cfg.hd), generator=g,
                       device=dev, dtype=torch.bfloat16)


def seq_rank_loop(torch, m, params, cfg, card):
    """17d: LLaMA-7B at full width (32 layers, bf16, B1) over a
    32768-token cache of random K/V, with the sequence split in 4 blocks
    of 8192 held by the 4 data ranks of a LocalGroup (each a ``SeqShard``
    over its member, in turn on the card), against the whole cache: an
    ingest (64 tokens) at length 24500, a 448-token prefill at length
    24400 (its block crosses 24576, from rank 2's range into rank 3's), a
    448-token prefill at length 32700 (it clamps at the buffer's end:
    rows 32320-32767) and 8 greedy decode tokens (each written on the
    last row).  Every run decodes the whole cache's greedy tokens, so
    that each step's logits are compared on the same input.  The witness
    is another bf16 path over the same cache, the same chain over 2
    blocks of 16384.  Held: the logits within bf16_tol_paths of the whole
    cache's, or within 2 x the witness's distance where that is larger
    (as 11d holds a bf16 session to its witness); the greedy picks equal
    (but at a near-tie of the whole cache's two best logits, which is
    logged); each rank's block against the whole run's rows there: layer
    0's written rows bit-equal, every layer's within bf16_tol_paths (or 2
    x the witness's distance), and bit-equal to the random cache where no
    step wrote.  Returns the 4-rank run's launches and the record."""
    import numpy as np
    from repro_torch.core import inference as I
    from repro_torch.distributed import tensor_parallel as TPX
    PI, ops = m.PI, m.ops
    dev = params["embed"].device
    S = 32768
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(173)
    ctx = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                        device=dev)
    p1, p2 = (torch.randint(0, cfg.vocab_size, (1, 448), generator=gen,
                            device=dev) for _ in range(2))

    def chain(st, step, feed=None):
        """ingest, prefill, prefill, 8 decode tokens; ``step(op, st, x)``
        runs one op.  The decode takes its own greedy picks, or ``feed``'s
        tokens where given (every run then decodes the same tokens).
        Returns (logits, its greedy picks, state)."""
        def at(st, n_):
            return st._replace(cache=st.cache._replace(length=n_))
        st = step("ingest", at(st, 24500), ctx)
        lgs = []
        for n_, p in ((24400, p1), (32700, p2)):
            lg, st = step("prefill", at(st, n_), p)
            lgs.append(lg[:, -1])
        toks = []
        for j in range(8):
            toks.append(lgs[-1].argmax(-1))
            tok = toks[-1] if feed is None else feed[:, j]
            lg, st = step("decode", st, tok[:, None])
            lgs.append(lg[:, -1])
        return lgs, torch.stack(toks, 1), st

    def run(seq=None):
        def step(op, st, x):
            if op == "ingest":
                return PI.ingest_context(params, cfg, st, x, seq_shard=seq)
            if op == "prefill":
                return PI.prefill(params, cfg, st, x, seq_shard=seq)
            return PI.decode_step(params, cfg, st, x, seq_shard=seq)
        return step

    def state(n, i):
        """Data rank i's state of n: its block of the random cache."""
        blk = S // n
        st = PI.init_online_state(cfg, 1, blk, device=dev)
        for li in range(L):
            for w, buf in enumerate((st.cache.k, st.cache.v)):
                buf[li].copy_(seq_cache_layer(torch, cfg, li, w, S, dev)
                              [:, i * blk:(i + 1) * blk])
        return st

    def sharded(n, feed, counts=None):
        """The chain on n data ranks in turn, decoding ``feed``: (rank 0's
        logits and greedy picks, every rank's state, host seconds)."""
        grp = TPX.LocalGroup(n)
        sts = [state(n, i) for i in range(n)]
        seqs = [I.SeqShard(grp.member(i), i, n) for i in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def ranks():
            return grp.run(lambda i: chain(sts[i], run(seqs[i]), feed))
        outs = counted(ops, counts, ranks) if counts is not None \
            else ranks()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for i, o in enumerate(outs[1:], 1):
            if not all(torch.equal(a, b) for a, b in zip(o[0], outs[0][0])) \
                    or not torch.equal(o[1], outs[0][1]):
                raise AssertionError(f"17d n={n}: rank {i}'s logits or "
                                     "tokens differ from rank 0's")
        return outs[0][0], outs[0][1], [o[2] for o in outs], secs

    def ratios(lgs, want):
        return [max_err(a, b) / bf16_tol(b) for a, b in zip(lgs, want)]

    def ratio(lgs, want):
        return max(ratios(lgs, want))

    def picks(toks, want_lgs, label):
        """The greedy picks against the whole cache's; a pick may differ
        only where the whole cache's two best logits lie within
        bf16_tol_paths of each other (a tie the two paths may break
        either way).  Returns the number of equal picks."""
        same = 0
        for j in range(toks.shape[1]):
            if torch.equal(toks[:, j], want_toks[:, j]):
                same += 1
                continue
            lg = want_lgs[j + 1].float()
            top = lg.topk(2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]).min().item()
            if not gap <= bf16_tol_paths(lg):
                raise AssertionError(
                    f"17d {label}: greedy pick {j} {toks[:, j].tolist()} vs "
                    f"the whole cache's {want_toks[:, j].tolist()}, whose "
                    f"two best logits lie {gap:.4f} apart")
            log(f"  17d {label}: greedy pick {j} differs at a near-tie of "
                f"the whole cache's logits ({gap:.4f} <= bf16_tol_paths)")
        return same

    rec, counts = {}, {}
    with torch.no_grad():
        st_w = state(1, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_lgs, want_toks, want_st = chain(st_w, run())
        torch.cuda.synchronize()
        rec["whole_s"] = time.perf_counter() - t0
        n = 4
        blk = S // n
        lgs, toks, sts, rec["sharded_s"] = sharded(n, want_toks, counts)
        same = picks(toks, want_lgs, "4 blocks")
        worst = ratio(lgs, want_lgs)
        wrote = np.zeros(S, bool)
        wrote[24400:24848] = True
        wrote[32320:] = True

        def cache_rows(sts, n, label):
            """Each rank's block against the whole run's rows there: the
            rows no step wrote bit-equal to the random cache (in both
            runs), layer 0's written rows bit-equal (both runs compute
            them from the same embeddings), and each layer's written rows'
            distance from the whole run's in x bf16_tol_paths (the larger
            of k and v)."""
            blk = S // n
            out = []
            for li in range(L):
                r = 0.0
                for w, name in enumerate(("k", "v")):
                    init = seq_cache_layer(torch, cfg, li, w, S, dev)[0]
                    whole = getattr(want_st.cache, name)[li, 0]
                    for i in range(n):
                        mine = getattr(sts[i].cache, name)[li, 0]
                        lo = i * blk
                        rows = torch.from_numpy(wrote[lo:lo + blk]).to(dev)
                        part = whole[lo:lo + blk]
                        if not torch.equal(mine[~rows], init[lo:lo + blk][~rows]) \
                                or not torch.equal(part[~rows],
                                                   init[lo:lo + blk][~rows]):
                            raise AssertionError(f"17d {label} layer {li} "
                                                 f"{name} rank {i}: an "
                                                 "unwritten row moved")
                        if not rows.any():
                            continue
                        if li == 0 and not torch.equal(mine[rows],
                                                       part[rows]):
                            raise AssertionError(f"17d {label} rank {i}: "
                                                 "layer 0's written rows "
                                                 "differ from the whole "
                                                 "run's")
                        r = max(r, max_err(mine[rows], part[rows])
                                / bf16_tol_paths(part[rows]))
                out.append(r)
            return out
        cache4 = cache_rows(sts, n, "4 blocks")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del sts
        gc.collect()
        torch.cuda.empty_cache()
        # the witness: the same chain over 2 blocks
        lg2, tok2, sts2, _ = sharded(2, want_toks)
        w_ratio = ratio(lg2, want_lgs)
        w_pair = ratio(lgs, lg2)
        same2 = picks(tok2, want_lgs, "2 blocks")
        cache2 = cache_rows(sts2, 2, "2 blocks")
        del sts2, st_w, want_st
        gc.collect()
        torch.cuda.empty_cache()
    cache_worst, cache_wit = max(cache4), max(cache2)
    log(f"  17d logits by step (x bf16_tol: 2 prefills, 8 decode steps), 4 "
        f"blocks vs the whole cache: "
        f"{[round(x, 3) for x in ratios(lgs, want_lgs)]}; 2 blocks: "
        f"{[round(x, 3) for x in ratios(lg2, want_lgs)]}")
    log(f"  17d written cache rows by layer (x bf16_tol_paths, the larger of "
        f"k and v), 4 blocks: {[round(x, 3) for x in cache4]}; 2 blocks: "
        f"{[round(x, 3) for x in cache2]}")
    log(f"  17d witness (x bf16_tol, the worst of 10 logit rows): 4 blocks "
        f"vs the whole cache {worst:.3f} / 2 blocks vs the whole cache "
        f"{w_ratio:.3f} / 4 blocks vs 2 blocks {w_pair:.3f}; greedy picks "
        f"equal to the whole cache's: {same} of 8 (4 blocks), {same2} of 8 "
        "(2 blocks)")
    # bf16_tol_paths, or, where the cell's two bf16 paths lie farther
    # apart (the witness: another split of the same cache), within 2 x
    # the witness's distance, as 11d holds a bf16 session to its witness
    bound = max(2.0, 2.0 * w_ratio)
    if worst > bound:
        raise AssertionError(f"17d: the sharded run's logits lie {worst:.3f}"
                             f" x bf16_tol from the whole cache's (bound "
                             f"{bound:.3f}: bf16_tol_paths, or 2 x the "
                             "2-block witness)")
    if cache_worst > max(1.0, 2.0 * cache_wit):
        raise AssertionError(f"17d: written cache rows at {cache_worst:.3f} "
                             f"x bf16_tol_paths (2-block witness "
                             f"{cache_wit:.3f})")
    log(f"  17d: 4 data ranks over a {S}-token cache: logits "
        f"{worst:.3f} x bf16_tol from the whole cache's (bound "
        f"{bound:.3f}), {same} of 8 greedy "
        f"picks equal (every run decodes the whole cache's), written "
        f"cache rows within {cache_worst:.3f} x bf16_tol_paths (2 blocks "
        f"{cache_wit:.3f}; layer 0 bit-equal), every other row bit-equal; "
        f"the whole run {rec['whole_s']:.2f} s, the 4 ranks in turn "
        f"{rec['sharded_s']:.2f} s (host clock); peak {peak:.1f} GiB "
        f"[{card}]")
    rec.update(worst=worst, bound=bound, witness_2_blocks=w_ratio,
               witness_4_vs_2=w_pair,
               picks_equal=same, picks_equal_2_blocks=same2,
               cache_worst=cache_worst, cache_witness=cache_wit,
               peak_gib=peak)
    return counts, rec


# 17e: the batch split over the data axes as well as the cache's sequence,
# on LLaMA-7B: B4 over an 8192-token cache (17.2 GB at 32 layers), cut in
# 2 and in 4 blocks; the chain's lengths (an ingest over 3000 cached
# tokens, a 448-token prefill at 3900, which crosses 4096, an edge of both
# cuts, then 4 decode steps)
P17E_BATCH, P17E_CACHE, P17E_BLOCKS = 4, 8192, (2, 4)


def seq_rows_loop(torch, m, params, cfg, card):
    """17e: LLaMA-7B at full width and depth (32 layers, bf16) under
    ``shard_cache_seq=True, batch_sharded=True``: B4 over an 8192-token
    cache of random K/V cut in 2 and in 4 sequence blocks, held by the
    data ranks of a LocalGroup in turn on the card.  Each rank holds its
    block of every lane's cache and its B/n lanes of the memory and the
    tokens; each op gathers those rows over the data axes
    (``launch.serve.DataRows``, the builders' own), runs on the whole
    batch over its block (``SeqShard``) and keeps its rows.  The chain:
    an ingest of 64 tokens, a 448-token prefill whose block crosses a
    rank edge, 4 decode steps fed the whole cache's greedy picks.  Held:
    bit-equal to the same ranks under ``batch_sharded=False`` (each rank
    the whole batch: logits, memory rows, the cache rows a step may
    write, and every other row's sum of bits), and the logits
    within bf16_tol_paths of the whole cache's, or within 2 x the other
    cut's distance where that is larger (17d's witness).  Returns the
    ``batch_sharded=True`` runs' launches and the record (host
    seconds)."""
    from repro_torch.core import inference as I
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.mesh import make_dist, make_shape_mesh
    PI, ops = m.PI, m.ops
    dev = params["embed"].device
    B, S, L = P17E_BATCH, P17E_CACHE, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(174)
    ctx = torch.randint(0, cfg.vocab_size, (B, 64), generator=gen,
                        device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, 448), generator=gen,
                           device=dev)

    def states(n, rows):
        """The n data ranks' states: each its block of the random cache
        (every lane) and, with ``rows``, its B/n lanes of the memory."""
        blk = S // n
        sts = [PI.init_online_state(cfg, B, blk, device=dev)
               for _ in range(n)]
        for li in range(L):
            for w in range(2):
                g = torch.Generator(device=dev).manual_seed(1740 + 2 * li + w)
                x = torch.randn((B, S, cfg.n_kv_heads, cfg.hd), generator=g,
                                device=dev, dtype=torch.bfloat16)
                for i, st in enumerate(sts):
                    (st.cache.k, st.cache.v)[w][li].copy_(
                        x[:, i * blk:(i + 1) * blk])
        if rows:
            b = B // n
            sts = [st._replace(mem=st.mem._replace(
                k=st.mem.k[:, i * b:(i + 1) * b].clone(),
                v=st.mem.v[:, i * b:(i + 1) * b].clone()))
                for i, st in enumerate(sts)]
        return sts

    def chain(st, seq, rows, cut, feed):
        """ingest at 3000, prefill at 3900, 4 decode steps of ``feed``
        (or the run's own greedy picks): (last-position logits, picks,
        state)."""
        def step(kind, st, x):
            def op(st, x):
                if kind == "ingest":
                    return PI.ingest_context(params, cfg, st, x,
                                             seq_shard=seq)
                if kind == "prefill":
                    return PI.prefill(params, cfg, st, x, seq_shard=seq)
                return PI.decode_step(params, cfg, st, x, seq_shard=seq)
            return op(st, x) if rows is None else rows.run(op, st, x)

        def at(st, n_):
            return st._replace(cache=st.cache._replace(length=n_))
        st = step("ingest", at(st, 3000), cut(ctx))
        lg, st = step("prefill", at(st, 3900), cut(prompt))
        lgs, toks = [lg[:, -1]], []
        for j in range(4):
            toks.append(lgs[-1].argmax(-1))
            tok = toks[-1] if feed is None else cut(feed)[:, j]
            lg, st = step("decode", st, tok[:, None])
            lgs.append(lg[:, -1])
        return lgs, torch.stack(toks, 1), st

    def digest(st, i, n):
        """What the comparison keeps of rank i's state (the states of two
        runs do not fit on the card beside the params): its memory, its
        cache rows a step may write (3900-4351) whole, and every other
        row's sum over the heads of its bits (int16 view)."""
        blk = S // n
        lo, hi = min(max(3900 - i * blk, 0), blk), min(max(4352 - i * blk,
                                                              0), blk)
        out = {"mem_k": st.mem.k, "mem_v": st.mem.v}
        for name in ("k", "v"):
            x = getattr(st.cache, name)
            out[name] = x[:, :, lo:hi].clone()
            out[name + "_sums"] = torch.stack([
                x[li].view(torch.int16).sum((-1, -2), dtype=torch.int64)
                for li in range(L)])
        return out

    def sharded(n, rows, feed, counts=None):
        """The chain on n data ranks in turn: (every rank's (logits,
        picks, `digest` of its state), host seconds)."""
        grp = TPX.LocalGroup(n)
        sts = states(n, rows)
        specs = SH.online_state_pspecs(
            cfg, make_dist(make_shape_mesh((n, 1), ("data", "model"))),
            batch_sharded=True, shard_cache_seq=True)
        b = B // n

        def rank(i):
            member = grp.member(i)
            dr = SRV.DataRows(member, i, n, specs) if rows else None
            return chain(sts[i], I.SeqShard(member, i, n), dr,
                         (lambda x: x[i * b:(i + 1) * b]) if rows
                         else (lambda x: x), feed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = counted(ops, counts, lambda: grp.run(rank)) \
            if counts is not None else grp.run(rank)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del sts
        return [(lg, tk, digest(st, i, n)) for i, (lg, tk, st)
                in enumerate(outs)], secs

    rec, counts, split = {}, {}, {}
    with torch.no_grad():
        st_w = states(1, False)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_lgs, want_toks, _ = chain(st_w, None, None, lambda x: x, None)
        torch.cuda.synchronize()
        rec["whole_s"] = time.perf_counter() - t0
        del st_w
        gc.collect()
        torch.cuda.empty_cache()
        for n in P17E_BLOCKS:
            b = B // n
            got, secs = sharded(n, True, want_toks, counts)
            rep, secs_rep = sharded(n, False, want_toks)
            bad = []
            for i, ((lg, tk, st), (lr, tr, sr)) in enumerate(zip(got, rep)):
                rows = slice(i * b, (i + 1) * b)
                if not all(torch.equal(x, y[rows]) for x, y in zip(lg, lr)):
                    bad.append(f"rank {i} logits")
                for name in ("k", "v", "k_sums", "v_sums"):
                    if not torch.equal(st[name], sr[name]):
                        bad.append(f"rank {i} cache {name}")
                for name in ("mem_k", "mem_v"):
                    if not torch.equal(st[name], sr[name][:, rows]):
                        bad.append(f"rank {i} {name}")
            if bad:
                raise AssertionError(f"17e n={n}: batch_sharded=True differs "
                                     f"from batch_sharded=False at {bad}")
            lgs = [torch.cat([o[0][j] for o in got]) for j in
                   range(len(want_lgs))]
            ratios = [max_err(a, w) / bf16_tol_paths(w)
                      for a, w in zip(lgs, want_lgs)]
            rec[n] = dict(rows_s=secs, replicated_s=secs_rep,
                          worst=max(ratios))
            split[n] = lgs
            log(f"  17e n={n}: B{B} over a {S}-token cache in {n} blocks, "
                f"the batch split over the same data ranks: bit-equal to "
                f"batch_sharded=False (logits, the cache's written rows and "
                f"every other row's bit sums, memory rows); "
                f"logits by step vs the whole cache (x bf16_tol_paths: the "
                f"prefill, 4 decode steps) {[round(x, 3) for x in ratios]}; "
                f"the {n} ranks in turn {secs:.2f} s (batch_sharded=False "
                f"{secs_rep:.2f} s), the whole cache {rec['whole_s']:.2f} s "
                f"(host clock) [{card}]")
            del got, rep
            gc.collect()
            torch.cuda.empty_cache()
    # each cut within bf16_tol_paths of the whole cache or, where the two
    # cuts lie farther from it, within 2 x the other cut's distance (17d's
    # witness rule: each block's attention is rounded to bf16 before the
    # combine, a third bf16 path beside the whole cache's)
    a, b = P17E_BLOCKS
    pair = max(max_err(x, y) / bf16_tol_paths(y)
               for x, y in zip(split[a], split[b]))
    rec["between_cuts"] = pair
    for n, other in ((a, b), (b, a)):
        bound = max(1.0, 2.0 * rec[other]["worst"])
        if rec[n]["worst"] > bound:
            raise AssertionError(f"17e n={n}: logits {rec[n]['worst']:.3f} x "
                                 f"bf16_tol_paths from the whole cache's "
                                 f"(bound {bound:.3f}: 1, or 2 x the "
                                 f"{other}-block cut's)")
    log(f"  17e witness (x bf16_tol_paths, the worst of 5 logit rows): "
        f"{a} blocks vs the whole cache {rec[a]['worst']:.3f}, {b} blocks "
        f"{rec[b]['worst']:.3f}, {a} vs {b} blocks {pair:.3f}; each held "
        "within 1, or 2 x the other cut's distance")
    return counts, rec


def phase17(torch, m, params, cfg, card):
    """Phase 17 on LLaMA-7B's weights: 17a the mma.sync route's lse, 17b
    the blocks against the whole cache at the kernel, 17c the builders
    in an NCCL world of one, 17d the data ranks in turn at full width."""
    t0 = time.perf_counter()
    log("  17a: the mma.sync route's log-sum-exp")
    rec = {"17a": mma_lse_check(torch, m.dattn, m.PI.quantize_kv, card)}
    log("  17b: prefill and ingest blocks over a cache cut in 4, combined")
    rec["17b"] = seq_blocks_check(torch, m.dattn, card)
    log("  17c: the sequence-sharded builders in an NCCL world of one rank, "
        "(1, 1) mesh")
    counts = seq_world_of_one(torch, m, params, cfg, card)
    log("  17d: 4 data ranks in turn (LocalGroup) over a 32768-token cache")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop_counts, rec["17d"] = seq_rank_loop(torch, m, params, cfg, card)
    add_counts(counts, loop_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("  17e: the batch split too (batch_sharded=True): B4 over an "
        "8192-token cache, 2 and 4 data ranks in turn")
    rows_counts, rec["17e"] = seq_rows_loop(torch, m, params, cfg, card)
    add_counts(counts, rows_counts)
    log(f"  17e beside 17d (host clock): 17d's 4 ranks in turn "
        f"{rec['17d']['sharded_s']:.2f} s (B1, 32768 keys, 11 ops); 17e's "
        + ", ".join(f"{n} ranks {rec['17e'][n]['rows_s']:.2f} s"
                    for n in P17E_BLOCKS) + " (B4, 8192 keys, 6 ops)")
    gc.collect()
    torch.cuda.empty_cache()
    for k in ("segmented_attention_mma_lse", "segmented_attention_splitk",
              "cond_lora_wgmma"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"phase 17: no launch of {k} ({counts})")
    rec["seconds"] = time.perf_counter() - t0
    log(f"  phase 17 launches: {({k: v for k, v in counts.items() if v})}; "
        f"took {rec['seconds']:.1f} s [{card}]")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 18: the dry run's cells (launch/specs.py, launch/dryrun.py) on the card
# ---------------------------------------------------------------------------

P18_SHAPES = ("prefill_32k", "decode_32k", "long_500k", "train_4k")
# 18a's depth cuts (never width): phase 12's (FAM_DEPTH: one card's memory
# and the script's time) and the hybrid cut to its whole attention sites
# (6 sites of 6 layers: its last 2 Mamba2 layers dropped)
P18_DEPTH = dict(FAM_DEPTH, **{"zamba2-1.2b": 36})
# the VLM's train and prefill cells hold its 1024 patch positions and 512
# text tokens: the smoke shape's 512 tokens cannot hold the patches (nor
# can the reference's step)
P18_VLM_SEQ = 1024 + 512
# the routes phase 18 must launch
P18_KERNELS = ("segmented_attention_splitk", "segmented_attention_mma",
               "cond_lora_wgmma", "ccm_attention_mma",
               "ccm_attention_backward_mma", "kv_cummean",
               "kv_cummean_backward")


def p18_cell(m, cfg, shape: str, dist=None):
    """The cell of ``shape`` at phase 18's scale: ``build_cell(smoke=True)``
    (seq 512; batch 4 for train, 2 otherwise), the VLM's train and
    prefill cells at ``P18_VLM_SEQ``."""
    SP = m.specs
    if cfg.family != "vlm" or shape not in ("train_4k", "prefill_32k"):
        return SP.build_cell(cfg, shape, dist, smoke=True)
    spec = dataclasses.replace(SP._scaled_shape(SP.SHAPES[shape], True),
                               seq=P18_VLM_SEQ)
    build = SP.build_train_cell if spec.kind == "train" \
        else SP.build_prefill_cell
    cell = build(cfg, spec, dist)
    cell.name = f"{cfg.name}:{shape}"
    return cell


def card_args(torch, m, cfg, cell, params, dev, seed: int, draw_on=None):
    """The cell's ``meta`` arguments made on ``dev``: the weights are
    ``params``'s leaves at the same key paths (a partition keeps its None
    leaves), the moments zeros, token ids drawn in [0, vocab), the loss
    mask ones, int8 K/V in [-127, 127], every other float leaf (frames,
    patches, the state's K/V, memory, SSM states and int8 scales) from
    N(0, 0.5^2) in its dtype; host counters as the cell set them.  The
    draws come from ``seed`` on ``draw_on`` (default ``dev``)."""
    PP = m.PP
    src = dev if draw_on is None else torch.device(draw_on)
    gen = torch.Generator(device=src).manual_seed(seed)

    def weight(path, x):
        if x is None:
            return None
        w = params
        for k in path:
            w = w[k]
        if w.shape != x.shape or w.dtype != x.dtype:
            raise AssertionError(f"{cell.name} {'/'.join(path)}: weights "
                                 f"{tuple(w.shape)} {w.dtype}, cell "
                                 f"{tuple(x.shape)} {x.dtype}")
        return w

    def draw(x, name=""):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype == torch.int8:
            y = torch.randint(-127, 128, x.shape, generator=gen, device=src,
                              dtype=torch.int8)
        elif not x.dtype.is_floating_point:
            y = torch.randint(0, cfg.vocab_size, x.shape, generator=gen,
                              device=src, dtype=x.dtype)
        elif name == "loss_mask":
            y = torch.ones(x.shape, dtype=x.dtype, device=src)
        else:
            y = (torch.randn(x.shape, generator=gen, device=src)
                 * 0.5).to(x.dtype)
        return y.to(dev)

    a = cell.args
    if isinstance(a[2], m.PA.AdamWState):
        def zeros(_, x):
            return None if x is None else torch.zeros(x.shape, dtype=x.dtype,
                                                      device=dev)
        return (PP.tree_map(weight, a[0]), PP.tree_map(weight, a[1]),
                a[2]._replace(mu=PP.tree_map(zeros, a[2].mu),
                              nu=PP.tree_map(zeros, a[2].nu)),
                {k: draw(v, k) for k, v in a[3].items()}, None)
    return (PP.tree_map(weight, a[0]),
            m.TPX.map_by_spec(lambda x, _: draw(x), a[1], None)) \
        + tuple(draw(x) for x in a[2:])


def p18_run(torch, m, cfg, cell, args, counts, card):
    """Run a cell on the card (launches counted into ``counts``): (its
    result, host ms synchronised, whether every float leaf is finite)."""
    grad = isinstance(args[2], m.PA.AdamWState)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.nullcontext() if grad else torch.no_grad():
        out = counted(m.ops, counts, lambda: cell.fn(*args))
    ms = (time.perf_counter() - t0) * 1e3
    finite = all(bool(torch.isfinite(x).all()) for x in m.dryrun._tensors(out)
                 if x.is_floating_point())
    return out, ms, finite


def p18_cells(torch, m, card, llama):
    """18a and 18d: every registry arch x the four shapes at full width
    (``P18_DEPTH``'s cuts), ``dist=None``, on the card from random weights
    of seed 0 (LLaMA-7B: phase 3's, at its 32 layers), then LLaMA-7B's
    train cell with the ``merge`` variant and its decode with ``int8kv``.
    Each cell runs twice on its arguments (the first call's launches
    counted): host ms of each, finite outputs; its dry-run record at the
    same scale (the meta device): argument bytes equal to the card args'
    bytes, its peak bytes beside the card's (the args' bytes and the most
    ``max_memory_allocated`` rose above them), FLOPs over the second
    call's ms."""
    from repro_torch.configs.registry import ASSIGNED
    counts, rows = {}, []
    archs = ("llama-7b",) + tuple(ASSIGNED)
    for arch in archs:
        cfg = m.get_config(arch)
        if arch in P18_DEPTH:
            cfg = cfg.replace(n_layers=P18_DEPTH[arch])
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "llama-7b":
            params = llama
        else:
            params = m.init_lm(cfg, seed=0)
            if cfg.family != "ssm":             # mamba2 has no LoRA
                randomize_lora_b(torch, params, seed=100)
        dev = params["embed"].device
        cells = [(cfg, s, "") for s in P18_SHAPES]
        if arch == "llama-7b":
            cells[1:1] = [(cfg.replace(kv_cache_dtype="int8"), "decode_32k",
                           "int8kv")]
            cells.append((cfg.replace(ccm=dataclasses.replace(
                cfg.ccm, mode="merge")), "train_4k", "merge"))
        for c, shape, variant in cells:
            cell = p18_cell(m, c, shape)
            rec = m.dryrun.measure(cell)
            args = card_args(torch, m, c, cell, params, dev, seed=180)
            held = m.dryrun._storage_bytes(m.dryrun._tensors(args))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = {}
            _, ms, finite = p18_run(torch, m, c, cell, args, got, card)
            add_counts(counts, got)
            # the card's peak as the record counts it: the args and the
            # most the step held at once beside them
            peak = held + torch.cuda.max_memory_allocated() - before
            _, ms2, finite2 = p18_run(torch, m, c, cell, args, {}, card)
            mem, flops = rec["memory"], rec["cost"]["flops"]
            name = cell.name + (f" ({variant})" if variant else "")
            row = dict(cell=name, layers=c.n_layers, ms=ms, ms_again=ms2,
                       finite=finite and finite2,
                       arg_bytes=mem["argument_bytes"], card_arg_bytes=held,
                       peak_bytes=mem["peak_bytes"], card_peak_bytes=peak,
                       peak_ratio=mem["peak_bytes"] / peak, flops=flops,
                       tflops=flops / ms2 / 1e9,
                       launches={k: v for k, v in got.items() if v})
            rows.append(row)
            finite = row["finite"]
            log(f"  18a {name} ({c.n_layers} L): {ms:.1f} ms, again "
                f"{ms2:.1f} ms, finite {finite}; 18d args "
                f"{mem['argument_bytes']} B (card {held}), peak meta "
                f"{mem['peak_bytes'] / 2 ** 30:.3f} / card "
                f"{peak / 2 ** 30:.3f} GiB = {row['peak_ratio']:.3f}, "
                f"{flops:.4g} FLOPs over the 2nd call = {row['tflops']:.2f} "
                f"TFLOP/s [{card}]; launches {row['launches']}")
            if not finite:
                raise AssertionError(f"18a {name}: non-finite outputs")
            if held != mem["argument_bytes"]:
                raise AssertionError(f"18d {name}: argument_bytes "
                                     f"{mem['argument_bytes']} != the card "
                                     f"args' {held}")
            del args
        del params
    return counts, rows


def p18_xcheck(torch, m, llama, cfg):
    """18b: each kind's cell at LLaMA-7B's first 2 layers, full width,
    float32, on the card (kernels) against the CPU (plain versions) from
    the same arguments (drawn on the CPU): the loss, the gradients' norm
    and every gradient (train: each device's first moment after one step
    over its own clip factor, ``mu / (0.1 min(1, clip / norm))``), the
    logits and every state leaf (the others), each within 1e-3 x
    max|CPU|.  Returns the worst ratio per kind."""
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32")
    clip = m.PA.AdamWConfig().clip_norm
    base = fp32_layers(torch, llama, "cpu")
    worst = {}
    for shape in P18_SHAPES:
        outs = {}
        for dev in ("cuda", "cpu"):
            # a copy each: the train step updates its weights in place
            pp = m.PP.tree_map(lambda _, x: x.clone().to(dev), base)
            cell = p18_cell(m, c2, shape)
            args = card_args(torch, m, c2, cell, pp, torch.device(dev),
                             seed=181, draw_on="cpu")
            grad = isinstance(args[2], m.PA.AdamWState)
            with contextlib.nullcontext() if grad else torch.no_grad():
                out = cell.fn(*args)
            if grad:
                met = out[2]
                norm = met["grad_norm"].detach().cpu()
                f = 0.1 * min(1.0, clip / max(norm.item(), 1e-9))
                named = {"loss": met["loss"], "grad_norm": norm,
                         **{"grad " + "/".join(k): v / f
                            for k, v in m.PP.leaves(out[1].mu)}}
            else:
                named = {"logits": out[0], **{
                    f"state {i}": x for i, x in enumerate(
                        m.dryrun._tensors(out[1])) if x.is_floating_point()}}
            outs[dev] = {k: v.detach().cpu() for k, v in named.items()}
            del pp, args, out
        ratios = {}
        for k, b in outs["cpu"].items():
            lim = 1e-3 * b.abs().max().item()
            err = max_err(outs["cuda"][k], b)
            ratios[k] = err / lim if lim else (0.0 if err == 0 else math.inf)
        top = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
        worst[shape] = top[0][1]
        log(f"  18b {shape}: {len(ratios)} leaves, worst max|d| / "
            f"(1e-3 max|CPU|): " + ", ".join(f"{k} {r:.3f}" for k, r in top))
        if worst[shape] > 1:
            raise AssertionError(f"18b {shape}: {top}")
    return worst


def p18_world_of_one(torch, m, llama, cfg, card, n_layers: int = 4):
    """18c: each kind's ``dist`` cell on a (1, 1) mesh in an NCCL world
    of one rank, bit-equal to its ``dist=None`` cell (LLaMA-7B's first
    ``n_layers`` layers, bf16; train under deterministic algorithms):
    the loss, leaves and moments, the logits and every state leaf.
    Returns the dist runs' launches."""
    import torch.distributed as tdist
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    c4 = cfg.replace(n_layers=n_layers)
    dev = init_world(0, 1, free_port(), llama["embed"].device)   # NCCL
    counts = {}
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        for shape in P18_SHAPES:
            outs = []
            for d in (dist, None):
                pp = m.PP.tree_map(lambda _, x: x.detach().clone(),
                                   first_layers(llama, n_layers))
                cell = p18_cell(m, c4, shape, d)
                args = card_args(torch, m, c4, cell, pp, dev, seed=182)
                with deterministic(torch):
                    out, _, _ = p18_run(torch, m, c4, cell, args,
                                        counts if d is not None else {},
                                        card)
                outs.append(m.dryrun._tensors(out))
                del pp, args
            diff = [i for i, (a, b) in enumerate(zip(*outs))
                    if not torch.equal(a, b)]
            if diff or len(outs[0]) != len(outs[1]):
                raise AssertionError(f"18c {shape}: leaves {diff} differ")
            log(f"  18c {shape}: the dist cell on a (1, 1) mesh bit-equal to "
                f"dist=None ({len(outs[0])} leaves)")
    finally:
        tdist.destroy_process_group()
    return counts


def phase18(torch, m, card):
    """Phase 18: the cells of ``launch/specs.py`` and the dry run of
    ``launch/dryrun.py`` on the card (18a-e)."""
    import tempfile
    t0 = time.perf_counter()
    cfg = m.get_config("llama-7b")
    llama = m.init_lm(cfg, seed=0)          # phase 3's weights
    randomize_lora_b(torch, llama, seed=100)
    log("  18a/18d: every registry arch x 4 shapes, dist=None, at full "
        "width, against its dry-run record")
    counts, rows = p18_cells(torch, m, card, llama)
    log("  18b: 2 layers at full width in float32, card vs CPU")
    worst = p18_xcheck(torch, m, llama, cfg)
    log("  18c: the dist cells in an NCCL world of one rank, (1, 1) mesh")
    add_counts(counts, p18_world_of_one(torch, m, llama, cfg, card))
    del llama
    gc.collect()
    torch.cuda.empty_cache()
    log("  18e: the dry run of LLaMA-7B's four shapes on the 16 x 16 mesh "
        "(the host, the meta device)")
    dry = {}
    with tempfile.TemporaryDirectory() as out:
        for shape in m.specs.SHAPES:
            r = m.dryrun.run_cell("llama-7b", shape, "single", out,
                                  force=True)
            dry[shape] = dict(s=r["lower_s"] + r["compile_s"],
                              flops=r["cost"]["flops"],
                              peak_bytes=r["memory"]["peak_bytes"],
                              collective_total=r["collective_total"])
            log(f"  18e llama-7b {shape} single: {dry[shape]['s']:.2f} s, "
                f"{r['cost']['flops']:.4g} FLOPs, peak "
                f"{r['memory']['peak_bytes'] / 2 ** 30:.2f} GiB, collectives "
                f"{r['collective_total'] / 2 ** 20:.1f} MiB a device")
    for k in P18_KERNELS:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"phase 18: no launch of {k} ({counts})")
    rec = dict(cells=rows, xcheck=worst, dryrun=dry,
               seconds=time.perf_counter() - t0)
    log(f"  phase 18 launches: {({k: v for k, v in counts.items() if v})}; "
        f"took {rec['seconds']:.1f} s [{card}]")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 19: ZeRO-3 (sharding_strategy="fsdp")
# ---------------------------------------------------------------------------

# 19b's blocks: LLaMA-7B at n = 2, 4, 8, as 14b's
FSDP_BLOCKS = (("llama-7b", 2), ("llama-7b", 4), ("llama-7b", 8))
# the kernels phase 19 launches (19a trains, serves and streams; 19b's
# rank loops run forward only)
FSDP_KERNELS = ("cond_lora_wgmma", "segmented_attention_splitk",
                "segmented_attention_mma", "ccm_attention_mma",
                "ccm_attention_backward_mma", "kv_merge_update",
                "kv_cummean", "kv_cummean_backward")


def fsdp_world_of_one(torch, m, params, cfg, card):
    """19a and 19c in an NCCL world of one rank on a (1, 1) mesh, under
    ``sharding_strategy="fsdp"`` (every stored block a whole leaf; the
    gathers, reduce-scatters and all-reduces go through NCCL groups of
    one rank).  19a, against ``dist=None``, bit-equal (the train steps
    under deterministic algorithms): ``jit_train_step``'s placed step at
    phase 5's cell (B4, S1216, LoRA), one concat and one merge AdamW step;
    ``TrainLoop`` for 2 steps; the three ``dist=`` builders and
    ``generate`` (14a's cell) and ``make_stream_step`` (4 layers).  19c:
    the dry run's fsdp cells of the four shapes (phase 18's scale) built on
    the meta device over a (1, 1) shape mesh, then on the card: their
    argument bytes against the card's, the peak against
    ``max_memory_allocated``.  Returns the dist runs' launches and 19c's
    rows."""
    import torch.distributed as tdist
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch.mesh import (make_debug_mesh, make_dist,
                                         make_shape_mesh)
    TR, PD, PA, PP, ops = m.TR, m.PD, m.PA, m.PP, m.ops
    dev = init_world(0, 1, free_port(), params["embed"].device)   # NCCL
    fcfg = cfg.replace(sharding_strategy="fsdp")
    counts, rows = {}, []
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        layout = m.segment_layout(*ZOO_LAYOUT)
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 4)
                                   .key_for(0), layout, 4, device=dev)
        tp0, fp0 = PP.partition(params, TR.trainable_mask_for(cfg, params))
        ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)

        def clone(t):
            return PP.tree_map(lambda _, x: None if x is None
                               else x.detach().clone(), t)
        for mode in ("concat", "merge"):
            c = cfg.replace(ccm=dataclasses.replace(cfg.ccm, mode=mode))
            fc = c.replace(sharding_strategy="fsdp")
            with deterministic(torch):
                step = TR.jit_train_step(
                    TR.make_train_step(fc, layout, ocfg, dist), fc, dist,
                    None, None, batch, None)
                tp, fp, opt = step.place(clone(tp0), fp0,
                                         PA.init_adamw(tp0))
                tp, opt, mt, _ = counted(ops, counts, lambda: step(
                    tp, fp, opt, batch))
                tq, oq, mq, _ = TR.make_train_step(c, layout, ocfg)(
                    clone(tp0), fp0, PA.init_adamw(tp0), batch)
            diff = same_tree(torch, PP, tp, tq) \
                + same_tree(torch, PP, opt.mu, oq.mu) \
                + same_tree(torch, PP, opt.nu, oq.nu)
            if mt["loss"].item() != mq["loss"].item() or diff:
                raise AssertionError(f"19a fsdp train {mode}: loss "
                                     f"{mt['loss'].item()} vs "
                                     f"{mq['loss'].item()}, differ {diff}")
            log(f"  19a jit_train_step(dist=) under fsdp, {mode}: one AdamW "
                f"step bit-equal to dist=None (loss {mt['loss'].item():.4f},"
                " leaves, moments)")
            del tp, tq, opt, oq

        def loop_run(c, d):
            lp = TR.TrainLoop(c, layout, ocfg, 4, dist=d, device=dev)
            hist = lp.run(2, log_every=0)
            return [h["loss"] for h in hist], lp.tp
        with deterministic(torch):
            ha, ta = counted(ops, counts, lambda: loop_run(fcfg, dist))
            gc.collect()
            torch.cuda.empty_cache()
            hb, tb = loop_run(cfg, None)
        if ha != hb or same_tree(torch, PP, ta, tb):
            raise AssertionError(f"19a TrainLoop under fsdp: {ha} vs {hb}")
        log(f"  19a TrainLoop(dist=) under fsdp: 2 steps bit-equal to "
            f"dist=None (losses {ha}, trainable leaves)")
        del ta, tb
        gc.collect()
        torch.cuda.empty_cache()

        online_builders_check(torch, m, params, fcfg, dist, counts, "19a")
        stream_builder_check(torch, m, params, fcfg, dist, counts, "19a")

        shape = make_shape_mesh((1, 1), ("data", "model"))
        for name in P18_SHAPES:
            rec = m.dryrun.measure(p18_cell(m, fcfg, name, make_dist(shape)),
                                   shape.counts)
            cell = p18_cell(m, fcfg, name, dist)
            args = card_args(torch, m, fcfg, cell, params, dev, seed=190)
            held = m.dryrun._storage_bytes(m.dryrun._tensors(args))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, ms, finite = p18_run(torch, m, fcfg, cell, args, counts,
                                    card)
            peak = held + torch.cuda.max_memory_allocated() - before
            mem = rec["memory"]
            row = dict(cell=cell.name + " (fsdp)", ms=ms, finite=finite,
                       arg_bytes=mem["argument_bytes"], card_arg_bytes=held,
                       peak_bytes=mem["peak_bytes"], card_peak_bytes=peak,
                       peak_ratio=mem["peak_bytes"] / peak)
            rows.append(row)
            log(f"  19c {row['cell']} ({fcfg.n_layers} L): {ms:.1f} ms, "
                f"finite {finite}; args {mem['argument_bytes']} B (card "
                f"{held}), peak meta {mem['peak_bytes'] / 2 ** 30:.3f} / "
                f"card {peak / 2 ** 30:.3f} GiB = {row['peak_ratio']:.3f} "
                f"[{card}]")
            if not finite:
                raise AssertionError(f"19c {cell.name}: non-finite outputs")
            if held != mem["argument_bytes"]:
                raise AssertionError(f"19c {cell.name}: argument_bytes "
                                     f"{mem['argument_bytes']} != the card "
                                     f"args' {held}")
            del args
    finally:
        tdist.destroy_process_group()
    return counts, rows


def zero3_block(torch, m, card):
    """19b's checks on one 14b block (`tp_rank_loop`'s ``zero3``): (i)
    the ranks of a ``LocalGroup`` in turn on their ZeRO-3 blocks, each
    layer gathered and cut as the serve path does, bit-equal to the
    tensor-parallel loop's outputs on the same block (the same local
    weights, the same kernels); the one-layer gather's device ms (the
    group's concat of the blocks on the card) and the loop's time; (ii)
    in concat mode, the ZeRO-3 training forward: each rank its own rows
    of a B8 batch, the layer whole, the loss's parts summed, against the
    unsharded loss within bf16_tol."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import tensor_parallel as TPX
    TR, PD, PP, ops = m.TR, m.PD, m.PP, m.ops
    layout = m.segment_layout(*ZOO_LAYOUT)

    def run(cfg, params, train, online, st0, outs, n, here):
        fcfg = cfg.replace(sharding_strategy="fsdp")
        stored = [FS.shard_fsdp(params, fcfg,
                                TPX.TensorParallel(fcfg, n, r, None))
                  for r in range(n)]

        def zloop():
            grp = TPX.LocalGroup(n)
            ranks = TPX.local_ranks(fcfg, grp)
            sts = [rank_state(torch, st0, tp) for tp in ranks]
            return grp.run(lambda i: (train(stored[i], ranks[i]),
                                      online(stored[i], sts[i], ranks[i])))
        leaves = []
        for path, _ in PP.leaves(params["layers"]):
            d = FS.gather_dim(("layers",) + path, fcfg, n)
            if d is not None:
                blocks = []
                for st in stored:
                    x = st["layers"]
                    for k in path:
                        x = x[k]
                    blocks.append(x[0])
                leaves.append((d, blocks))
        nbytes = sum(b[0].numel() * b[0].element_size() * n
                     for _, b in leaves)
        with torch.no_grad():
            zouts = counted(ops, here, zloop)
            t_loop = time_ms(torch, lambda i: zloop(), iters=3, warmup=1)
            t_gather = time_ms(torch, lambda i: [torch.cat(b, d)
                                                 for d, b in leaves])
        flat = [x for o in outs for pair in o for x in pair]
        zflat = [x for o in zouts for pair in o for x in pair]
        bad = [i for i, (a, b) in enumerate(zip(zflat, flat))
               if not torch.equal(a, b)]
        if bad or len(flat) != len(zflat):
            raise AssertionError(f"19b n={n} {cfg.ccm.mode}: the ZeRO-3 "
                                 f"blocks' outputs {bad} differ from the "
                                 "tensor-parallel loop's")
        r = dict(loop_ms=t_loop, per_rank_ms=t_loop / n, gather_ms=t_gather,
                 gather_bytes=nbytes)
        log(f"  19b(i) LLaMA-7B n={n} {cfg.ccm.mode}: the ZeRO-3 blocks "
            "gathered and cut per layer, bit-equal to the tensor-parallel "
            f"loop (training forward + loss, ingest, prefill, decode; every "
            f"rank); the {n} ranks in turn {t_loop:.2f} ms ({t_loop / n:.2f}"
            f" ms a rank); one layer's all-gather (the group's concat of "
            f"{nbytes / 2 ** 20:.1f} MiB on the card) {t_gather:.3f} ms "
            f"[{card}]")
        if cfg.ccm.mode != "concat":
            return r
        dev = params["embed"].device
        b8 = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 8).key_for(0),
                                layout, 8, device=dev)
        mask = TR.trainable_mask_for(cfg, params)
        count = b8["loss_mask"].float().sum()

        def rows(i):
            k = 8 // n
            return {name: v[i * k:(i + 1) * k] for name, v in b8.items()}

        def zfwd():
            grp = TPX.LocalGroup(n)
            return grp.run(lambda i: TR._loss_fn(
                *PP.partition(stored[i], mask), fcfg, layout, rows(i),
                dist=FS.Fsdp(fcfg, n, i, grp.member(i)), count=count))
        with torch.no_grad():
            want = TR._loss_fn(*PP.partition(params, mask), cfg, layout, b8)
            parts = counted(ops, here, zfwd)
            t_fwd = time_ms(torch, lambda i: zfwd(), iters=3, warmup=1)
        loss = functools.reduce(torch.add, parts)
        check(f"19b(ii) LLaMA-7B n={n}: the ZeRO-3 training forward, each "
              "rank its own rows (B8 S1216), the loss's parts summed, vs the "
              "unsharded loss", max_err(loss, want), bf16_tol(want))
        r.update(train_forward_ms=t_fwd, loss=loss.item(),
                 loss_whole=want.item())
        log(f"  19b(ii) LLaMA-7B n={n}: loss {loss.item():.6f} vs "
            f"{want.item():.6f}; the {n} ranks in turn {t_fwd:.2f} ms "
            f"({t_fwd / n:.2f} ms a rank, {8 // n} rows each) [{card}]")
        return r
    return run


# 19d: moe_impl="ep" under ZeRO-3 on phi3.5-moe: the model-axis sizes of
# the block's rank loops (mesh (1, n)); the world of one at phase 12's
# depth (4 of 32 layers)
FSDP_EP_SIZES = (2, 4)


def fsdp_ep_world_of_one(torch, m, card):
    """19d(i): phi3.5-moe at full width, phase 12's 4 of its 32 layers,
    bf16 (seed 15, LoRA b drawn), ``moe_impl="ep"`` under ``fsdp`` in an
    NCCL world of one rank on a (1, 1) mesh: ``jit_train_step``'s placed
    step at phase 5's cell (B4, S1216, LoRA, concat), ``TrainLoop`` for 2
    steps, the three ``dist=`` builders with ``generate``
    (`online_builders_check`) and ``make_stream_step``
    (`stream_builder_check`), each bit-equal to ``dist=None`` (the train
    steps under deterministic algorithms).  Returns the dist runs'
    launches."""
    import torch.distributed as tdist
    from repro_torch.distributed.context import free_port, init_world
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    TR, PD, PA, PP, ops = m.TR, m.PD, m.PA, m.PP, m.ops
    dev = init_world(0, 1, free_port(), "cuda")                 # NCCL
    counts = {}
    try:
        dist = make_dist(make_debug_mesh(1, 1, device=dev))
        cfg = m.get_config(MOE_TP_ARCH).replace(n_layers=4, moe_impl="ep")
        fcfg = cfg.replace(sharding_strategy="fsdp")
        params = m.init_lm(cfg, seed=15)
        randomize_lora_b(torch, params, seed=115)
        layout = m.segment_layout(*ZOO_LAYOUT)
        batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 4)
                                   .key_for(0), layout, 4, device=dev)
        tp0, fp0 = PP.partition(params, TR.trainable_mask_for(cfg, params))
        ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)

        def clone(t):
            return PP.tree_map(lambda _, x: None if x is None
                               else x.detach().clone(), t)
        with deterministic(torch):
            step = TR.jit_train_step(TR.make_train_step(fcfg, layout, ocfg,
                                                        dist), fcfg, dist,
                                     None, None, batch, None)
            tp, fp, opt = step.place(clone(tp0), fp0, PA.init_adamw(tp0))
            tp, opt, mt, _ = counted(ops, counts, lambda: step(tp, fp, opt,
                                                               batch))
            tq, oq, mq, _ = TR.make_train_step(cfg, layout, ocfg)(
                clone(tp0), fp0, PA.init_adamw(tp0), batch)
        diff = same_tree(torch, PP, tp, tq) + same_tree(
            torch, PP, opt.mu, oq.mu) + same_tree(torch, PP, opt.nu, oq.nu)
        if mt["loss"].item() != mq["loss"].item() or diff:
            raise AssertionError(f"19d fsdp+ep train: loss {mt['loss'].item()}"
                                 f" vs {mq['loss'].item()}, differ {diff}")
        log(f"  19d jit_train_step(dist=) under fsdp+ep: one AdamW step "
            f"bit-equal to dist=None (loss {mt['loss'].item():.4f}, leaves, "
            "moments)")
        del tp, tq, opt, oq

        def loop_run(c, d):
            lp = TR.TrainLoop(c, layout, ocfg, 4, dist=d, device=dev)
            hist = lp.run(2, log_every=0)
            return [h["loss"] for h in hist], lp.tp
        with deterministic(torch):
            ha, ta = counted(ops, counts, lambda: loop_run(fcfg, dist))
            gc.collect()
            torch.cuda.empty_cache()
            hb, tb = loop_run(cfg, None)
        if ha != hb or same_tree(torch, PP, ta, tb):
            raise AssertionError(f"19d TrainLoop under fsdp+ep: {ha} vs {hb}")
        log(f"  19d TrainLoop(dist=) under fsdp+ep: 2 steps bit-equal to "
            f"dist=None (losses {ha}, trainable leaves)")
        del ta, tb
        gc.collect()
        torch.cuda.empty_cache()
        online_builders_check(torch, m, params, fcfg, dist, counts, "19d")
        stream_builder_check(torch, m, params, fcfg, dist, counts, "19d")
    finally:
        tdist.destroy_process_group()
    return counts


def fsdp_ep_block(torch, m, card):
    """19d(ii): one full-width block of phi3.5-moe (``n_layers=1``, random
    weights of seed 15, LoRA b drawn, bf16) under ``moe_impl="ep"`` and
    ``fsdp`` at n = 2 and 4 (mesh (1, n)), the ranks of a LocalGroup in
    turn on the card.  Training (full, remat off): each rank stores its
    ZeRO-3 blocks, gathers the layer whole, runs its own rows of a B8
    batch (S1216) and reckons ep's drops over the whole block from the
    expert ids gathered over the model axis (``models.moe.
    _moe_ep_rows``); the loss's parts summed and every gathered leaf's
    gradient summed over the ranks (taken to the gathered leaves: the
    gathers' own backward, a reduce-scatter, would need the ranks' turns,
    which autograd's device thread cannot take) within bf16_tol of the
    unsharded block under ``moe_ep_unsharded(..., n, blocks=1)``, the
    expert ids pinned to the unsharded block's; its drops equal to those
    of phase 15's tensor-parallel ``ep`` rank loop on the same forward.
    Serving: the ZeRO-3 blocks gathered and cut along E per layer
    (ingest, prefill and decode, B4), bit-equal to the tensor-parallel
    ``ep`` loop.  Prints a rank's share of the training forward in ms
    beside the tensor-parallel ep rank's, and the ids gather in ms.
    Returns the launches and the record."""
    import threading
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.models import moe as MOE
    PI, TR, PD, PP, ops = m.PI, m.TR, m.PD, m.PP, m.ops

    @dataclasses.dataclass(frozen=True)
    class Seen(FS.Fsdp):
        """A ZeRO-3 training rank that keeps each leaf it gathers."""
        seen: list = None

        def leaf(self, path, x):
            y = super().leaf(path, x)
            self.seen.append((tuple(path), y))
            return y

    base = m.get_config(MOE_TP_ARCH).replace(n_layers=1, moe_impl="ep",
                                              train_mode="full", remat=False)
    fcfg = base.replace(sharding_strategy="fsdp")
    params = m.init_lm(base, seed=15)
    randomize_lora_b(torch, params, seed=115)
    dev = params["embed"].device
    layout = m.segment_layout(*ZOO_LAYOUT)
    b8 = PD.sample_kv_batch(PD.ShardableIndexIterator(0, 8).key_for(0),
                            layout, 8, device=dev)
    count = b8["loss_mask"].float().sum()
    mask = TR.trainable_mask_for(base, params)
    gen = torch.Generator(device=dev).manual_seed(191)
    ctx = torch.randint(0, base.vocab_size, (4, 64), generator=gen,
                        device=dev)
    prompt = torch.randint(0, base.vocab_size, (4, 64), generator=gen,
                           device=dev)
    st0 = PI.init_online_state(base, 4, 256, device=dev)
    tls = threading.local()
    counts, rec = {}, {}

    def online(p, c, st, tp):
        st = PI.ingest_context(p, c, st, ctx, dist=tp)
        lp, st = PI.prefill(p, c, st, prompt, dist=tp)
        ld, st = PI.decode_step(p, c, st, prompt[:, :1], dist=tp)
        return PI.gather_vocab(lp, c, tp), PI.gather_vocab(ld, c, tp)

    for n in FSDP_EP_SIZES:
        here, k = {}, 8 // n
        with torch.no_grad():
            stored = [FS.shard_fsdp(params, fcfg,
                                    TPX.TensorParallel(fcfg, n, r, None))
                      for r in range(n)]
            shards = [TPX.shard_params(params, base,
                                       TPX.TensorParallel(base, n, r, None))
                      for r in range(n)]

        def rows(i):
            return {name: v[i * k:(i + 1) * k] for name, v in b8.items()}

        def zloss(i, fs):
            return TR._loss_fn(*PP.partition(stored[i], mask), fcfg, layout,
                               rows(i), dist=fs, count=count)

        def tloss(ranks, i):
            return TR._loss_fn(*PP.partition(shards[i], mask), base, layout,
                               b8, dist=ranks[i], count=count)

        # the unsharded block under ep's drops at n, its routes recorded
        whole = PP.tree_map(lambda _, x: x.detach().clone()
                            .requires_grad_(True), params)
        calls = []
        with torch.enable_grad(), ep_unsharded(n), \
                moe_routes(recorded_routes(calls)):
            want = TR._loss_fn(*PP.partition(whole, mask), base, layout, b8,
                               count=count)
            wg = torch.autograd.grad(want, [x for _, x in PP.leaves(whole)],
                                     allow_unused=True)
        want_g = {p: g for (p, _), g in zip(PP.leaves(whole), wg)}
        del whole, wg

        def pick_rows(flips):
            """Each ZeRO-3 rank (``tls.rank``) takes its rows of the
            unsharded block's ids."""
            picks = {}

            def pick(cfg, w, xf, route):
                i = tls.rank
                if i not in picks:
                    ids = calls[0]
                    N = ids.shape[0] // n
                    picks[i] = pinned_routes(torch, [ids[i * N:(i + 1) * N]],
                                             flips)
                return picks[i](cfg, w, xf, route)
            return pick

        # training: the ZeRO-3 ranks' forward in turn, then each rank's
        # backward to its gathered leaves
        for st in stored:
            for _, x in PP.leaves(st):
                x.requires_grad_(True)
        grp = TPX.LocalGroup(n)
        seen = [[] for _ in range(n)]
        flips = []

        def zfwd(i):
            tls.rank = i
            with torch.enable_grad():
                return zloss(i, Seen(fcfg, n, i, grp.member(i),
                                     seen=seen[i]))
        MOE.EP_DROPS.update(assignments=0, dropped=0)
        with moe_routes(pick_rows(flips)):
            parts = counted(ops, here, lambda: grp.run(zfwd))
        drops = dict(MOE.EP_DROPS)
        total = {}

        def backward():
            for i in range(n):
                gs = torch.autograd.grad(parts[i], [y for _, y in seen[i]],
                                         allow_unused=True)
                for (p, _), g in zip(seen[i], gs):
                    if g is not None:
                        total[p] = total.get(p, 0) + g.float()
        counted(ops, here, backward)
        for st in stored:
            for _, x in PP.leaves(st):
                x.requires_grad_(False)
        loss = functools.reduce(torch.add, [x.detach() for x in parts])
        del parts, seen
        check(f"19d phi3.5-moe ep n={n}: the ZeRO-3 training loss (each rank "
              "its rows of B8 S1216, ids pinned) vs the unsharded block under "
              "ep's drops", max_err(loss, want.detach()), bf16_tol(want))
        worst, where = 0.0, None
        for p, g in want_g.items():
            got = total.get(p)
            if g is None or got is None:
                if (g is None) != (got is None):
                    raise AssertionError(f"19d n={n} {'/'.join(p)}: a "
                                         "gradient on one side only")
                continue
            g = g[0] if p[0] == "layers" else g
            err, tol = max_err(got, g), bf16_tol(g)
            r = err / tol if tol else (0.0 if err == 0 else math.inf)
            if r > worst:
                worst, where = r, "/".join(p)
        check(f"19d phi3.5-moe ep n={n}: every gradient, summed over the "
              f"ranks, vs the unsharded block's (x bf16_tol of the leaf; "
              f"worst {where})", worst, 1.0)
        del total, want_g

        # the tensor-parallel ep rank loop on the same forward and ids
        tflips = []
        tgrp = TPX.LocalGroup(n)
        tranks = TPX.local_ranks(base, tgrp)
        MOE.EP_DROPS.update(assignments=0, dropped=0)
        with torch.no_grad(), moe_routes(rank_routes(torch, calls, tflips)):
            tgrp.run(lambda i: tloss(tranks, i))
        tp_drops = dict(MOE.EP_DROPS)
        if drops != tp_drops:
            raise AssertionError(f"19d n={n}: ZeRO-3 drops {drops} vs the "
                                 f"tensor-parallel ep loop's {tp_drops}")

        # serving: the ZeRO-3 blocks gathered and cut along E, bit-equal to
        # the tensor-parallel ep loop
        def serve_loop(c, trees):
            grp = TPX.LocalGroup(n)
            ranks = TPX.local_ranks(c, grp)
            sts = [rank_state(torch, st0, tp) for tp in ranks]
            return grp.run(lambda i: online(trees[i], c, sts[i], ranks[i]))
        with torch.no_grad():
            zs = counted(ops, here, lambda: serve_loop(fcfg, stored))
            ts = serve_loop(base, shards)
        bad = [(i, j) for i, (a, b) in enumerate(zip(zs, ts))
               for j in range(2) if not torch.equal(a[j], b[j])]
        if bad:
            raise AssertionError(f"19d n={n}: ZeRO-3 serving differs from "
                                 f"the tensor-parallel ep loop at {bad}")

        # a rank's share of the training forward (the port's own routes),
        # and the ids gather (the group's concat on the card)
        def zloop(_):
            g = TPX.LocalGroup(n)
            return g.run(lambda i: zloss(i, FS.Fsdp(fcfg, n, i,
                                                    g.member(i))))

        def tloop(_):
            g = TPX.LocalGroup(n)
            rk = TPX.local_ranks(base, g)
            return g.run(lambda i: tloss(rk, i))
        ids = [torch.randint(0, base.n_experts, (k * layout.seq_len,
                                                 base.top_k), device=dev)
               for _ in range(n)]
        with torch.no_grad():
            t_z = time_ms(torch, zloop, iters=3, warmup=1)
            t_t = time_ms(torch, tloop, iters=3, warmup=1)
            t_ids = time_ms(torch, lambda i: torch.cat(ids))
        rec[n] = dict(zero3_rank_ms=t_z / n, tp_ep_rank_ms=t_t / n,
                      ids_gather_ms=t_ids, loss=loss.item(),
                      loss_whole=want.item(), grad_worst=worst,
                      dropped=drops["dropped"],
                      assignments=drops["assignments"],
                      route_flips=sum(flips))
        log(f"  19d phi3.5-moe ep n={n}: ZeRO-3 training loss "
            f"{loss.item():.6f} vs {want.item():.6f}, gradients within "
            f"{worst:.3f} x bf16_tol; ep dropped {drops['dropped']} of "
            f"{drops['assignments']} assignments, as the tensor-parallel "
            f"ep loop; {sum(flips)} rows whose own top-k differs from the "
            f"pinned; serving (ingest, prefill, decode) bit-equal to the "
            f"tensor-parallel ep loop; the training forward a rank "
            f"{t_z / n:.2f} ms (its {k} rows, the layer gathered whole) vs "
            f"a tensor-parallel ep rank {t_t / n:.2f} ms (all 8 rows, "
            f"{base.n_experts // n} experts); the ids gather "
            f"({n} x {k * layout.seq_len} x {base.top_k} int64) "
            f"{t_ids:.4f} ms [{card}]")
        add_counts(counts, here)
        del stored, shards
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def phase19(torch, m, card):
    """Phase 19: ZeRO-3 on LLaMA-7B: 19a and 19c in an NCCL world of one
    rank (`fsdp_world_of_one`), 19b the full-width block's rank loops
    (`tp_rank_loop` with `zero3_block`); 19d ``ep`` under ZeRO-3 on
    phi3.5-moe (`fsdp_ep_world_of_one`, `fsdp_ep_block`)."""
    t0 = time.perf_counter()
    cfg = m.get_config("llama-7b")
    llama = m.init_lm(cfg, seed=0)          # phase 3's weights
    randomize_lora_b(torch, llama, seed=100)
    log("  19a/19c: the fsdp dist= entry points and cells in an NCCL world "
        "of one rank, (1, 1) mesh (LLaMA-7B, 32 layers, bf16)")
    counts, cells = fsdp_world_of_one(torch, m, llama, cfg, card)
    del llama
    gc.collect()
    torch.cuda.empty_cache()
    log("  19b: one full-width LLaMA-7B block, the ZeRO-3 blocks of a "
        "LocalGroup's ranks in turn on the card")
    rec = {}
    loop_counts, rec["19b"] = tp_rank_loop(torch, m, card, FSDP_BLOCKS,
                                           zero3_block(torch, m, card))
    add_counts(counts, loop_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("  19d: moe_impl='ep' under ZeRO-3 on phi3.5-moe: the fsdp+ep "
        "dist= entry points in an NCCL world of one rank, (1, 1) mesh (4 "
        "layers, bf16)")
    add_counts(counts, fsdp_ep_world_of_one(torch, m, card))
    gc.collect()
    torch.cuda.empty_cache()
    log("  19d: one full-width phi3.5-moe block, the ZeRO-3 ranks of a "
        "LocalGroup in turn (training forward and backward, serving)")
    ep_counts, rec["19d"] = fsdp_ep_block(torch, m, card)
    add_counts(counts, ep_counts)
    missing = [k for k in FSDP_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 19: no launch of {missing} ({counts})")
    rec.update(cells=cells, seconds=time.perf_counter() - t0)
    log(f"  phase 19 launches: {({k: v for k, v in counts.items() if v})}; "
        f"took {rec['seconds']:.1f} s [{card}]")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 20: the paper's learn-and-answer loop and the example CLIs
# ---------------------------------------------------------------------------

P20_STEPS = 800          # tests/test_system.py's recipe: 800 + 800 steps
P20_LR = 3e-3
P20_FULL_STEPS = 4       # 20b: LLaMA-7B's adapter steps
# the example CLIs at 20 training steps, each with a line its run prints
P20_CLIS = (
    ("quickstart_torch", ["--steps", "20"], "query accuracy FROM MEMORY"),
    ("serve_online_torch", ["--steps", "20"], "accuracy from memory"),
    ("streaming_demo_torch", ["--steps", "20", "--tokens", "512"],
     "StreamingLLM (drop)"),
    ("serve_many_users_torch", ["--steps", "20"],
     "accuracy from compressed memory"),
    ("train_online_torch", ["--ablate-lora", "--steps", "20"],
     "default     LoRA acc@t4"))
# the kernels phase 20 must launch: the float32 routes (20a, 20c), the
# tensor-core routes of LLaMA-7B's bf16 (20b), the engine's rows (20c)
P20_KERNELS = ("segmented_attention", "cond_lora", "cond_lora_wgmma",
               "ccm_attention", "ccm_attention_backward",
               "ccm_attention_mma", "ccm_attention_backward_mma",
               "session_gather", "session_scatter")


def synced_s(torch, t0: float) -> float:
    """Host seconds since ``t0`` once the card has finished its work."""
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def paper_recipe(torch, m, card):
    """20a: ``tests/test_system.py``'s fixture (``pretrain_base(800)``,
    then ``train_compression(800)``, lr 3e-3, the port's seeds 0 and 1)
    and its four claims, at its thresholds."""
    PL = m.PL
    rec = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = PL.pretrain_base(P20_STEPS, seed=0, lr=P20_LR)
    rec["pretrain_s"] = synced_s(torch, t0)
    cfg = PL.bench_cfg()
    t0 = time.perf_counter()
    params = PL.train_compression(base, cfg, P20_STEPS, seed=1, lr=P20_LR)
    rec["compression_s"] = synced_s(torch, t0)
    rec["pretrain_ms_per_step"] = rec["pretrain_s"] / P20_STEPS * 1e3
    rec["compression_ms_per_step"] = rec["compression_s"] / P20_STEPS * 1e3
    log(f"  20a: pretrain_base {P20_STEPS} steps in {rec['pretrain_s']:.1f} "
        f"s ({rec['pretrain_ms_per_step']:.2f} ms a step), "
        f"train_compression {P20_STEPS} steps in "
        f"{rec['compression_s']:.1f} s ({rec['compression_ms_per_step']:.2f} "
        f"ms a step; host clock around the synchronized loop, B32 x S "
        f"{PL.layout_for(PL.T_MAX).seq_len}) [{card}]")

    t0 = time.perf_counter()
    rec.update(PL.claims(base, params, cfg))
    acc, acc0 = rec["acc4"], rec["acc0"]
    log(f"  20a hold 1: accuracy at t = 4 from memory {acc:.4f}, the base "
        f"with no context {acc0:.4f}: margin {acc - acc0:.4f} (needs > 0.08)")
    if not acc > acc0 + 0.08:
        raise AssertionError(f"20a: memory {acc} does not beat no context "
                             f"{acc0} by 0.08")
    acc1, acc4 = rec["acc1_all"], rec["acc4_all"]
    seeds = PL.EVAL_SEEDS
    log(f"  20a hold 2: over the whole key space, eval seeds "
        f"{seeds[0]}-{seeds[-1]}: acc(t=1) {acc1:.4f}, acc(t=4) {acc4:.4f}: "
        f"margin {acc4 - acc1:.4f} (needs >= 0.02); per seed "
        f"{rec['per_seed']}")
    if not acc4 >= acc1 + 0.02:
        raise AssertionError(f"20a: acc(t=4) {acc4} < acc(t=1) {acc1} + 0.02")
    check("20a hold 3: online (4 ingests, prefill) = train_forward, last "
          "row, B8", rec["online_err"], 5e-3)
    t, mm = PL.T_MAX, cfg.ccm.comp_len
    mem, cached = rec["memory_tokens"], rec["cache_length"]
    log(f"  20a hold 4: memory {mem} KV tokens after {t} ingests of "
        f"{PL.CHUNK} (t*m = {t * mm}), cache length {cached}")
    if mem != t * mm or cached != 0:
        raise AssertionError(f"20a: memory {mem} != {t * mm} or cache "
                             f"{cached} != 0")
    rec["eval_s"] = synced_s(torch, t0)
    log(f"  20a: the holds' evaluations took {rec['eval_s']:.1f} s")
    # where a step goes: the device's busy share over 3 steps of each loop
    # (its init included)
    for label, fn in (("pretrain_base", lambda: PL.pretrain_base(
            3, seed=0, lr=P20_LR)), ("train_compression", lambda:
            PL.train_compression(base, cfg, 3, seed=1, lr=P20_LR))):
        rec[f"{label}_profile"] = {}
        profile_window(torch, fn, f"20a {label}, 3 steps", card,
                       stats=rec[f"{label}_profile"])
    return rec


def paper_full_width(torch, m, card):
    """20b: ``train_compression`` on LLaMA-7B at full width (phase 3's
    weights), then ``eval_at_timesteps`` and ``eval_no_context``.  Its
    base is random, so nothing is learnt: the loss is finite, every
    adapter leaf moved off ``train_compression``'s own init (drawn again
    from its seed) and the accuracies lie in [0, 1]."""
    PL = m.PL
    cfg = m.get_config("llama-7b")
    base = m.init_lm(cfg, seed=0)
    randomize_lora_b(torch, base, seed=100)
    layout = PL.layout_for(cfg.ccm.max_steps, cfg.ccm.comp_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = PL.train_compression(base, cfg, P20_FULL_STEPS, seed=1,
                                  lr=P20_LR)
    rec = dict(train_s=synced_s(torch, t0),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    rec["ms_per_step"] = rec["train_s"] / P20_FULL_STEPS * 1e3
    log(f"  20b: train_compression {P20_FULL_STEPS} steps at B32 x S "
        f"{layout.seq_len} in {rec['train_s']:.2f} s ({rec['ms_per_step']:.1f} "
        f"ms a step, its init included), peak {rec['peak_gib']:.2f} GiB "
        f"[{card}]")
    fresh = m.init_lm(cfg, seed=1)
    init = {p: x for p, x in m.PP.leaves(fresh)
            if "lora" in p or "comp_embed" in p}
    del fresh
    stuck = [p for p, x in m.PP.leaves(params)
             if p in init and torch.equal(x, init[p])]
    log(f"  20b: {len(init)} adapter leaves, {len(init) - len(stuck)} moved")
    if stuck or not init:
        raise AssertionError(f"20b: adapter leaves that did not move: {stuck}")
    del init
    with torch.no_grad():
        batch = m.PD.sample_kv_batch(m.PD.generator(3, 0), layout, 32,
                                     PL.TASK)
        logits = m.PT.train_forward(params, cfg, batch["tokens"], layout)
        tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
        rec["loss"] = float(m.losses.next_token_loss(logits, tail,
                                                     batch["loss_mask"]))
    t0 = time.perf_counter()
    rec["accs"] = PL.eval_at_timesteps(params, cfg, ts=(1, 4), n_batches=1)
    rec["acc_no_context"] = PL.eval_no_context(base, cfg, ts=(1, 4),
                                               n_batches=1)
    rec["eval_s"] = synced_s(torch, t0)
    log(f"  20b: loss on the first training batch after training "
        f"{rec['loss']:.4f}; accuracy {rec['accs']}, with no context "
        f"{rec['acc_no_context']} (1 batch of 16 each; {rec['eval_s']:.2f} s)")
    values = list(rec["accs"].values()) + list(rec["acc_no_context"].values())
    if not math.isfinite(rec["loss"]) or \
            not all(0.0 <= a <= 1.0 for a in values):
        raise AssertionError(f"20b: loss {rec['loss']}, accuracies {values}")
    return rec


def example_clis(torch, card):
    """20c: each ``examples/*_torch.py`` CLI's ``main`` on the card at 20
    training steps, its printed lines logged."""
    import importlib.util
    import io
    rec = {}
    for name, argv, want in P20_CLIS:
        path = ROOT / "examples" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        rec[name] = dict(rc=rc, seconds=synced_s(torch, t0))
        for line in out.getvalue().splitlines():
            if line.strip():
                log(f"    {name}: {line}")
        log(f"  20c: {name} {' '.join(argv)}: exit {rc} in "
            f"{rec[name]['seconds']:.1f} s [{card}]")
        if rc != 0 or want not in out.getvalue():
            raise AssertionError(f"20c: {name} exited {rc} or printed no "
                                 f"{want!r}")
    return rec


def phase20(torch, m, card):
    """Phase 20: the paper's learn-and-answer loop on the card (20a the
    reference recipe and ``tests/test_system.py``'s claims, 20b LLaMA-7B
    at full width) and the example CLIs (20c); each part's launches
    counted on its own."""
    t0 = time.perf_counter()
    counts, by_part, rec = {}, {}, {}
    for part, fn in (("20a", lambda: paper_recipe(torch, m, card)),
                     ("20b", lambda: paper_full_width(torch, m, card)),
                     ("20c", lambda: example_clis(torch, card))):
        by_part[part] = {}
        rec[part] = counted(m.ops, by_part[part], fn)
        add_counts(counts, by_part[part])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {part} launches: "
            f"{({k: v for k, v in by_part[part].items() if v})}")
    need = {"20a": ("segmented_attention", "cond_lora", "ccm_attention",
                    "ccm_attention_backward"),
            "20b": ("cond_lora_wgmma", "ccm_attention_mma",
                    "ccm_attention_backward_mma"),
            "20c": ("segmented_attention", "cond_lora", "ccm_attention",
                    "session_gather", "session_scatter")}
    missing = [(p, k) for p, ks in need.items() for k in ks
               if by_part[p].get(k, 0) <= 0]
    missing += [k for k in P20_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 20: no launch of {missing} ({by_part})")
    rec["seconds"] = time.perf_counter() - t0
    log(f"  phase 20 launches: {({k: v for k, v in counts.items() if v})}; "
        f"took {rec['seconds']:.1f} s [{card}]")
    return counts, rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.configs import llama_7b_paper
    from repro_torch.configs.registry import get_config
    from repro_torch.core import inference as PI
    from repro_torch.core import streaming as STR
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cond_lora as clora
    from repro_torch.kernels import decode_attention as dattn
    from repro_torch.kernels import kv_merge as kvm
    from repro_torch.kernels import ccm_attention as ca
    from repro_torch.kernels import session_gather as sg
    from repro_torch.core.masks import segment_layout
    from repro_torch.data import synthetic as PD
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as PT
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import grad_compress as PG
    from repro_torch.optim import partition as PP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    card = smi
    log("phase 1: card and build")
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"  {nvcc[-1]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"  built {sorted(libs)} in {build_s:.1f} s")
    for stem in sorted(libs):
        for line in _build.build_log(stem).splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "arning", "wall time")):
                log(f"    {stem}: {line.strip()}")

    if "--phase12" in sys.argv[1:]:
        archs = [a for a in sys.argv[1:] if a in FAMILIES] or FAMILIES
        log(f"phase 12 alone (--phase12): {', '.join(archs)}")
        family_phase(torch, types.SimpleNamespace(
            get_config=get_config, init_lm=init_lm, PI=PI, STR=STR, ops=ops,
            clora=clora, TR=TR, PT=PT, PD=PD, PA=PA, PP=PP,
            segment_layout=segment_layout), card, archs)
        log(f"  --phase12: done ({time.perf_counter() - t_start:.1f} s)")
        return 0

    if "--phase13" in sys.argv[1:]:
        log("phase 13 alone (--phase13): LLaMA-7B (32 layers, bf16, seed 0)")
        cfg = llama_7b_paper.config()
        params = init_lm(cfg, seed=0)
        randomize_lora_b(torch, params, seed=100)
        phase13(torch, ops, PI, TR, PD, PA, PP, PG, segment_layout, params,
                cfg, card)
        log(f"  --phase13: done ({time.perf_counter() - t_start:.1f} s)")
        return 0

    m14 = types.SimpleNamespace(
        get_config=get_config, init_lm=init_lm, PI=PI, STR=STR, ops=ops,
        TR=TR, PT=PT, PD=PD, PA=PA, PP=PP, dattn=dattn,
        segment_layout=segment_layout)
    if "--phase14" in sys.argv[1:]:
        log("phase 14 alone (--phase14): LLaMA-7B (32 layers, bf16, seed 0)")
        cfg = llama_7b_paper.config()
        params = init_lm(cfg, seed=0)
        randomize_lora_b(torch, params, seed=100)
        phase14(torch, m14, params, cfg, card)
        log(f"  --phase14: done ({time.perf_counter() - t_start:.1f} s)")
        return 0
    if "--phase15" in sys.argv[1:]:
        log("phase 15 alone (--phase15): phi3.5-moe and llama4-maverick")
        phase15(torch, m14, card)
        log(f"  --phase15: done ({time.perf_counter() - t_start:.1f} s)")
        return 0
    if "--phase16" in sys.argv[1:]:
        log("phase 16 alone (--phase16): mamba2-370m, zamba2-1.2b, "
            "whisper-tiny and pixtral-12b")
        phase16(torch, m14, card)
        log(f"  --phase16: done ({time.perf_counter() - t_start:.1f} s)")
        return 0
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.launch import dryrun, specs
    m18 = types.SimpleNamespace(**vars(m14), specs=specs, dryrun=dryrun,
                                TPX=TPX)
    if "--phase18" in sys.argv[1:]:
        log("phase 18 alone (--phase18): the dry run's cells on the card")
        phase18(torch, m18, card)
        log(f"  --phase18: done ({time.perf_counter() - t_start:.1f} s)")
        return 0
    if "--phase19" in sys.argv[1:]:
        log("phase 19 alone (--phase19): ZeRO-3 on LLaMA-7B")
        phase19(torch, m18, card)
        log(f"  --phase19: done ({time.perf_counter() - t_start:.1f} s)")
        return 0
    from repro_torch.launch import paper_loop
    from repro_torch.optim import losses
    m20 = types.SimpleNamespace(**vars(m14), PL=paper_loop, losses=losses)
    if "--phase20" in sys.argv[1:]:
        log("phase 20 alone (--phase20): the paper's learn-and-answer loop "
            "and the example CLIs")
        phase20(torch, m20, card)
        log(f"  --phase20: done ({time.perf_counter() - t_start:.1f} s)")
        return 0
    if "--phase17" in sys.argv[1:]:
        log("phase 17 alone (--phase17): LLaMA-7B (32 layers, bf16, seed 0)")
        cfg = llama_7b_paper.config()
        params = init_lm(cfg, seed=0)
        randomize_lora_b(torch, params, seed=100)
        phase17(torch, m14, params, cfg, card)
        log(f"  --phase17: done ({time.perf_counter() - t_start:.1f} s)")
        return 0

    log("phase 2: kernels against their plain versions on the card")
    seg = check_segmented(torch, F, dattn, PI.quantize_kv, card)
    lora = check_cond_lora(torch, clora, card)
    merge = check_kv_merge(torch, kvm, card)
    check_cond_lora_grad(torch, clora, card)
    ccm_fwd, ccm_bwd = check_ccm_attention(torch, F, ca, segment_layout, card)
    cummean, cummean_bwd = check_kv_cummean(torch, kvm, card)
    gather, scatter = check_session_gather(torch, sg, card)
    if "--phase2" in sys.argv[1:]:
        log(f"  --phase2: stopping after phase 2 ({time.perf_counter() - t_start:.1f} s)")
        return 0

    log("phase 3: LLaMA-7B main path (32 layers, d 4096, bf16, seed 0)")
    cfg = llama_7b_paper.config()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0)
    randomize_lora_b(torch, params, seed=100)
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    totals = {}
    for mode, cdt in (("concat", "bfloat16"), ("concat", "int8"),
                      ("merge", "bfloat16")):
        counts = main_path(torch, PI, ops, params, cfg, mode, cdt, card,
                           profile=(mode, cdt) == ("concat", "bfloat16"))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 4: cross-check, 2 layers full width fp32, CUDA vs CPU")
    cross_check(torch, PI, params, cfg)

    log("phase 5: LLaMA-7B training, 3 concat + 2 merge AdamW steps "
        "(B4, S1216)")
    train_counts = train_phase(torch, ops, clora, TR, PT, PD, PA, PP,
                               segment_layout, params, cfg, card)
    log(f"  launches over the 5 steps: {train_counts}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 6: training cross-check, 2 layers full width fp32, CUDA vs "
        "CPU, and parallel = online on the card")
    train_cross_check(torch, PI, TR, PT, PD, PP, segment_layout, params, cfg)

    log("phase 7: the multi-tenant serve engine, LLaMA-7B (32 layers, bf16, "
        "concat): 12 sessions on 8 slots, 3 tenants")
    rec7 = {}
    serve_counts = serve_phase(torch, ops, PI, params, cfg, card,
                               label="32L concat+bf16", n_sessions=12,
                               n_slots=8, seed=21, detail=True, record=rec7)
    log("  then 4 layers at full width: merge + bf16 (per-lane a_t, async "
        "offload) and concat + int8 cache (pressure recompress)")
    p4 = first_layers(params, 4)
    merge_counts = serve_phase(torch, ops, PI, p4, cfg.replace(
        n_layers=4, ccm=dataclasses.replace(cfg.ccm, mode="merge")), card,
        label="4L merge+bf16", n_sessions=6, n_slots=4, seed=22,
        async_offload=True, stagger=True)
    serve_phase(torch, ops, PI, p4, cfg.replace(n_layers=4,
                                                kv_cache_dtype="int8"),
                card, label="4L concat+int8", n_sessions=6, n_slots=4,
                seed=23, recompress=True)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 13: multi-device, part 1: session-sharded serving, the "
        "session mesh and data-parallel training (run after phase 7, on the "
        "weights phase 7 served)")
    p13_counts, _ = phase13(torch, ops, PI, TR, PD, PA, PP, PG,
                            segment_layout, params, cfg, card, rec7)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 14: tensor parallelism, part 1 (the dense family): the "
        "dist= entry points, the rank loop at full width, the sequence-"
        "sharded decode")
    p14_counts, rec14 = phase14(torch, m14, params, cfg, card)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 17: the sequence-sharded prefill and ingest: the mma.sync "
        "route's lse, the blocks at the kernel, the builders in an NCCL "
        "world of one, 4 data ranks at full width")
    gc.collect()
    torch.cuda.empty_cache()
    p17_counts, rec17 = phase17(torch, m14, params, cfg, card)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 8: CCM streaming (sink + sliding window + compressed memory)")
    log("  8a: LLaMA-7B (32 layers, bf16, concat), the default stream "
        "config (W 4096, sink 4, chunk 64, 64 groups), B=2")
    stream_counts, _, n_evict = stream_full_width(torch, STR, ops, params,
                                                  cfg, card)
    L = cfg.n_layers
    want = dict(segmented_attention=L * (72 + 16 + n_evict),
                segmented_attention_mma=L * (72 + n_evict),
                segmented_attention_splitk=L * 16,
                cond_lora=4 * L * n_evict, cond_lora_wgmma=4 * L * n_evict)
    got = {k: stream_counts[k] for k in want}
    if got != want or stream_counts["kv_merge_update"]:
        raise AssertionError(f"8a: launches {stream_counts} != {want}")
    log("  8b: 4 layers at full width, W 512, chunk 64, 4 memory groups")
    add_counts(stream_counts, stream_modes(torch, STR, ops, p4, cfg.replace(
        n_layers=4), card))
    log("  8c: cross-check, 2 layers full width fp32, CUDA vs CPU")
    stream_cross_check(torch, STR, params, cfg)
    log("  8d: the serve engine's stream sessions, LLaMA-7B (32 layers, "
        "bf16, concat, W 512)")
    stream_serve = stream_serve_phase(torch, STR, ops, params, cfg, card)
    add_counts(stream_counts, stream_serve)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 10: the paper's baselines in training, the gradient codecs "
        "and the serve-metrics demo (run before phase 9, on the LLaMA-7B "
        "weights phases 3-8 hold)")
    del p4
    gc.collect()
    torch.cuda.empty_cache()
    log("  10a: LLaMA-7B (32 layers, bf16, LoRA), 2 AdamW steps of "
        "Gisting-online and 2 of the Compressive Transformer (B4, S1216)")
    m10 = types.SimpleNamespace(ops=ops, clora=clora, TR=TR, PD=PD, PA=PA,
                                PP=PP, segment_layout=segment_layout)
    base_counts, _ = baselines_train(torch, m10, params, cfg, card)
    log("  10b: cross-check, 2 layers full width fp32, CUDA vs CPU")
    train_cross_check(torch, PI, TR, PT, PD, PP, segment_layout, params, cfg,
                      cases=BASELINE_CASES)
    log("  10c: the gradient codecs, card vs CPU, on LLaMA-7B's LoRA leaves")
    codec_check(torch, PG, PP, PP.partition(
        params, TR.trainable_mask_for(cfg, params))[0], card)
    log("  10d: the serve-metrics demo (scripts/serve_metrics_torch.py), "
        "card vs CPU")
    add_counts(base_counts, serve_metrics_check(torch, ops, card))
    log(f"  phase 10 launches: {base_counts}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    del params
    gc.collect()             # phase 3-10 closures may hold LLaMA-7B's state
    torch.cuda.empty_cache()

    log("phase 9: the dense model zoo at full width, from the port's "
        f"registry: {', '.join(ZOO)}")
    torch.cuda.reset_peak_memory_stats()
    zoo_counts, _ = zoo_phase(torch, types.SimpleNamespace(
        get_config=get_config, init_lm=init_lm, PI=PI, STR=STR, ops=ops,
        clora=clora, TR=TR, PT=PT, PD=PD, PA=PA, PP=PP,
        segment_layout=segment_layout), card)
    log(f"  phase 9 launches: {zoo_counts}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("phase 11: the recurrent families at full width, from the port's "
        f"registry: {', '.join(RECURRENT)}")
    torch.cuda.reset_peak_memory_stats()
    t11 = time.perf_counter()
    rec_counts, _, _ = recurrent_phase(torch, types.SimpleNamespace(
        get_config=get_config, init_lm=init_lm, PI=PI, ops=ops, clora=clora,
        TR=TR, PT=PT, PD=PD, PA=PA, PP=PP, segment_layout=segment_layout),
        card)
    log(f"  phase 11 launches: {({k: v for k, v in rec_counts.items() if v})}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; phase 11 took {time.perf_counter() - t11:.1f} s")

    log("phase 12: the encoder-decoder, the VLM and MoE at full width, from "
        f"the port's registry: {', '.join(FAMILIES)}")
    t12 = time.perf_counter()
    fam_counts, fam_rec = family_phase(torch, types.SimpleNamespace(
        get_config=get_config, init_lm=init_lm, PI=PI, STR=STR, ops=ops,
        clora=clora, TR=TR, PT=PT, PD=PD, PA=PA, PP=PP,
        segment_layout=segment_layout), card)
    enc = fam_rec["whisper-tiny"]["encoder_ccm_launches"]
    log(f"  phase 12 launches: {({k: v for k, v in fam_counts.items() if v})}"
        f"; of the CCM kernel's, whisper's encoder {enc}")
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    log("phase 15: tensor parallelism, part 2 (the MoE family): the dist= "
        "entry points under each moe_impl, the MoE rank loop at full width")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p15_counts, rec15 = phase15(torch, m14, card)

    log("phase 16: tensor parallelism, part 3 (the recurrent, encoder-"
        "decoder and VLM families): the dist= entry points, the rank loops "
        "at full width")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p16_counts, _ = phase16(torch, m14, card)

    log("phase 18: the dry run's cells (launch/specs.py) on the card: every "
        "registry arch x 4 shapes, 2 float32 layers card vs CPU, the dist "
        "cells in an NCCL world of one, the dry run's counts")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p18_counts, rec18 = phase18(torch, m18, card)

    log("phase 19: ZeRO-3 (sharding_strategy='fsdp'): the dist= entry "
        "points and the dry run's cells in an NCCL world of one, the "
        "full-width block's ZeRO-3 ranks in turn")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p19_counts, rec19 = phase19(torch, m18, card)

    log("phase 20: the paper's learn-and-answer loop (launch/paper_loop.py): "
        "20a the reference recipe and tests/test_system.py's claims, 20b "
        "LLaMA-7B's adapter at full width, 20c the example CLIs")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p20_counts, rec20 = phase20(torch, m20, card)

    # the tensor-core routes' launches in each main-path phase (3: online,
    # 5: training, 7: the 32-layer serve engine, 8: streaming, 9: the zoo,
    # 10: the baselines' training and the serve-metrics demo, 11: the
    # recurrent families, 12: the encoder-decoder, the VLM and MoE, 13: the
    # sharded engines and the data-parallel step, 14, 15 and 16: the dist=
    # entry points and the tensor-parallel rank loops: dense, MoE, and the
    # recurrent, encoder-decoder and VLM families; 17: the sequence-
    # sharded builders and the data ranks over a cut cache; 18: the dry
    # run's cells; 19: ZeRO-3; 20: the paper's loop at LLaMA-7B's bf16)
    by_phase = {k: {"3": totals[k], "5": train_counts.get(k, 0),
                    "7": serve_counts[k], "8": stream_counts[k],
                    "9": zoo_counts[k], "10": base_counts.get(k, 0),
                    "11": rec_counts[k], "12": fam_counts[k],
                    "13": p13_counts.get(k, 0),
                    "14": p14_counts.get(k, 0),
                    "15": p15_counts.get(k, 0),
                    "16": p16_counts.get(k, 0),
                    "17": p17_counts.get(k, 0),
                    "18": p18_counts.get(k, 0),
                    "19": p19_counts.get(k, 0),
                    "20": p20_counts.get(k, 0)}
                for k in ("segmented_attention_splitk",
                          "segmented_attention_mma", "cond_lora_wgmma",
                          "ccm_attention_mma", "ccm_attention_backward_mma")}
    for k, need in (("segmented_attention_splitk", ("3", "8", "9", "11",
                                                    "12", "14", "15", "16",
                                                    "17", "18", "19")),
                    ("segmented_attention_mma", ("3", "7", "8", "9", "11",
                                                 "12", "13", "14", "15",
                                                 "16", "17", "18", "19")),
                    ("cond_lora_wgmma", ("3", "5", "7", "8", "9", "10",
                                         "11", "12", "13", "14", "15",
                                         "16", "17", "18", "19", "20")),
                    ("ccm_attention_mma", ("5", "9", "11", "12", "13",
                                           "14", "15", "16", "18", "19",
                                           "20")),
                    ("ccm_attention_backward_mma", ("5", "9", "11", "12",
                                                    "13", "14", "15",
                                                    "16", "18", "19",
                                                    "20"))):
        if any(by_phase[k][ph] <= 0 for ph in need):
            raise AssertionError(f"{k}: launches by phase {by_phase[k]}")
    for k in ("kv_merge_update", "session_gather", "session_scatter"):
        if stream_counts[k] <= 0 or zoo_counts[k] <= 0 or rec_counts[k] <= 0 \
                or fam_counts[k] <= 0:
            raise AssertionError(f"{k}: no launch in phase 8, 9, 11 or 12")
    for k in ("session_gather", "session_scatter", "kv_cummean",
              "kv_cummean_backward"):
        if p13_counts.get(k, 0) <= 0:
            raise AssertionError(f"{k}: no launch in phase 13")
    for k in ("kv_cummean", "kv_cummean_backward"):
        if train_counts[k] <= 0 or rec_counts[k] <= 0 or fam_counts[k] <= 0:
            raise AssertionError(f"{k}: no launch in phase 5, 11 or 12")
    for k in ("kv_merge_update", "kv_cummean", "kv_cummean_backward"):
        if p14_counts.get(k, 0) <= 0 or p15_counts.get(k, 0) <= 0 \
                or p16_counts.get(k, 0) <= 0:
            raise AssertionError(f"{k}: no launch in phase 14, 15 or 16")
    log(f"  tensor-core route launches by phase: {by_phase}")

    def p20_all(k):
        """Phase 20's launches of kernel ``k`` on every route (20a and 20c
        run the float32 routes)."""
        return {"launches_phase20_all_routes": p20_counts.get(k, 0)}
    rows = [
        dict(name="segmented_attention", route="cuda",
             source="src/repro_torch/csrc/segmented_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:160",
             launches=sum(by_phase["segmented_attention_splitk"].values()),
             launches_by_phase=by_phase["segmented_attention_splitk"],
             kernel_route="split-K decode (bf16, Sq <= 2)", **seg["decode"],
             **p20_all("segmented_attention"),
             shapes=shape_rows(seg),
             lse=dict(rec14["14c"], launches_phase15=rec15["lse_launches"])),
        dict(name="segmented_attention_mma", route="cuda",
             source="src/repro_torch/csrc/segmented_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:160",
             launches=sum(by_phase["segmented_attention_mma"].values()),
             launches_by_phase=by_phase["segmented_attention_mma"],
             kernel_route="mma.sync (bf16, Sq > 2)", **seg["prefill"]),
        dict(name="segmented_attention_mma_lse", route="cuda",
             source="src/repro_torch/csrc/segmented_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:160",
             launches=p17_counts["segmented_attention_mma_lse"],
             launches_by_phase={"17": p17_counts[
                 "segmented_attention_mma_lse"]},
             kernel_route="mma.sync with the log-sum-exp (bf16, Sq > 2; "
             "the sequence-sharded prefill and ingest)",
             **{k: rec17["17a"]["row"][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "no_lse_ms", "lse_err")},
             blocks=rec17["17b"]),
        dict(name="cond_lora", route="cuda",
             source="src/repro_torch/csrc/cond_lora.cu",
             replaces="src/repro/kernels/cond_lora.py:48",
             launches=sum(by_phase["cond_lora_wgmma"].values()),
             launches_by_phase=by_phase["cond_lora_wgmma"],
             kernel_route="TMA + wgmma (bf16)", **lora[288],
             **p20_all("cond_lora"),
             shapes=shape_rows(lora)),
        dict(name="kv_merge_update", route="cuda",
             source="src/repro_torch/csrc/kv_merge.cu",
             replaces="src/repro/kernels/kv_merge.py:27",
             launches=totals["kv_merge_update"]
             + merge_counts["kv_merge_update"]
             + stream_counts["kv_merge_update"]
             + zoo_counts["kv_merge_update"]
             + rec_counts["kv_merge_update"]
             + fam_counts["kv_merge_update"]
             + p13_counts.get("kv_merge_update", 0)
             + p14_counts["kv_merge_update"]
             + p15_counts["kv_merge_update"]
             + p16_counts["kv_merge_update"]
             + p19_counts["kv_merge_update"]
             + p20_counts.get("kv_merge_update", 0),
             launches_by_phase={"3": totals["kv_merge_update"],
                                "7": merge_counts["kv_merge_update"],
                                "8": stream_counts["kv_merge_update"],
                                "9": zoo_counts["kv_merge_update"],
                                "11": rec_counts["kv_merge_update"],
                                "12": fam_counts["kv_merge_update"],
                                "13": p13_counts.get("kv_merge_update", 0),
                                "14": p14_counts["kv_merge_update"],
                                "15": p15_counts["kv_merge_update"],
                                "16": p16_counts["kv_merge_update"],
                                "19": p19_counts["kv_merge_update"],
                                "20": p20_counts.get("kv_merge_update", 0)},
             **merge),
        dict(name="ccm_attention", route="cuda",
             source="src/repro_torch/csrc/ccm_attention.cu",
             replaces="src/repro/kernels/ccm_attention.py:86",
             launches=sum(by_phase["ccm_attention_mma"].values()),
             launches_by_phase=by_phase["ccm_attention_mma"],
             encoder_launches_phase12=enc["forward"],
             kernel_route="mma.sync, two tile streams (bf16)", **ccm_fwd,
             **p20_all("ccm_attention")),
        dict(name="ccm_attention_backward", route="cuda",
             source="src/repro_torch/csrc/ccm_attention.cu",
             replaces="src/repro/kernels/ccm_attention.py:86",
             launches=sum(by_phase["ccm_attention_backward_mma"].values()),
             launches_by_phase=by_phase["ccm_attention_backward_mma"],
             encoder_launches_phase12=enc["backward"],
             kernel_route="mma.sync, two tile streams (bf16)", **ccm_bwd,
             **p20_all("ccm_attention_backward")),
        dict(name="kv_cummean", route="cuda",
             source="src/repro_torch/csrc/kv_cummean.cu",
             replaces="src/repro/kernels/kv_merge.py:65",
             launches=train_counts["kv_cummean"]
             + rec_counts["kv_cummean"] + fam_counts["kv_cummean"]
             + p13_counts["kv_cummean"] + p14_counts["kv_cummean"]
             + p15_counts["kv_cummean"] + p16_counts["kv_cummean"]
             + p18_counts["kv_cummean"] + p19_counts["kv_cummean"]
             + p20_counts.get("kv_cummean", 0),
             launches_by_phase={"5": train_counts["kv_cummean"],
                                "11": rec_counts["kv_cummean"],
                                "12": fam_counts["kv_cummean"],
                                "13": p13_counts["kv_cummean"],
                                "14": p14_counts["kv_cummean"],
                                "15": p15_counts["kv_cummean"],
                                "16": p16_counts["kv_cummean"],
                                "18": p18_counts["kv_cummean"],
                                "19": p19_counts["kv_cummean"],
                                "20": p20_counts.get("kv_cummean", 0)},
             **cummean),
        dict(name="kv_cummean_backward", route="cuda",
             source="src/repro_torch/csrc/kv_cummean.cu",
             replaces="src/repro/kernels/kv_merge.py:65",
             launches=train_counts["kv_cummean_backward"]
             + rec_counts["kv_cummean_backward"]
             + fam_counts["kv_cummean_backward"]
             + p13_counts["kv_cummean_backward"]
             + p14_counts["kv_cummean_backward"]
             + p15_counts["kv_cummean_backward"]
             + p16_counts["kv_cummean_backward"]
             + p18_counts["kv_cummean_backward"]
             + p19_counts["kv_cummean_backward"]
             + p20_counts.get("kv_cummean_backward", 0),
             launches_by_phase={"5": train_counts["kv_cummean_backward"],
                                "11": rec_counts["kv_cummean_backward"],
                                "12": fam_counts["kv_cummean_backward"],
                                "13": p13_counts["kv_cummean_backward"],
                                "14": p14_counts["kv_cummean_backward"],
                                "15": p15_counts["kv_cummean_backward"],
                                "16": p16_counts["kv_cummean_backward"],
                                "18": p18_counts["kv_cummean_backward"],
                                "19": p19_counts["kv_cummean_backward"],
                                "20": p20_counts.get("kv_cummean_backward", 0)},
             **cummean_bwd),
        dict(name="session_gather", route="cuda",
             source="src/repro_torch/csrc/session_gather.cu",
             replaces="src/repro/kernels/session_gather.py:30",
             launches=serve_counts["session_gather"]
             + stream_counts["session_gather"] + zoo_counts["session_gather"]
             + base_counts["session_gather"] + rec_counts["session_gather"]
             + fam_counts["session_gather"]
             + p13_counts["session_gather"] + p20_counts["session_gather"],
             launches_by_phase={"7": serve_counts["session_gather"],
                                "8": stream_counts["session_gather"],
                                "9": zoo_counts["session_gather"],
                                "10": base_counts["session_gather"],
                                "11": rec_counts["session_gather"],
                                "12": fam_counts["session_gather"],
                                "13": p13_counts["session_gather"],
                                "20": p20_counts["session_gather"]},
             **gather),
        dict(name="session_scatter", route="cuda",
             source="src/repro_torch/csrc/session_gather.cu",
             replaces="src/repro/kernels/session_gather.py:56",
             launches=serve_counts["session_scatter"]
             + stream_counts["session_scatter"]
             + zoo_counts["session_scatter"] + base_counts["session_scatter"]
             + rec_counts["session_scatter"]
             + fam_counts["session_scatter"]
             + p13_counts["session_scatter"] + p20_counts["session_scatter"],
             launches_by_phase={"7": serve_counts["session_scatter"],
                                "8": stream_counts["session_scatter"],
                                "9": zoo_counts["session_scatter"],
                                "10": base_counts["session_scatter"],
                                "11": rec_counts["session_scatter"],
                                "12": fam_counts["session_scatter"],
                                "13": p13_counts["session_scatter"],
                                "20": p20_counts["session_scatter"]},
             **scatter),
    ]
    for r in rows:
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never launched on the main path")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(f"  device times taken with CUDA events for want of profiler "
        f"events: {len(EVENT_TIMED)} ({', '.join(EVENT_TIMED) or 'none'})")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
