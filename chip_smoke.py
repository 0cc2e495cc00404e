#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the build of the
     hand-written kernels from ``src/repro_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (and, for segmented attention, GQA / int8 /
     layer- and lane-major / per-lane lengths / empty memory / a fully
     masked row), with its time, the plain version's, one library call's
     and the least time the card could take (the bound);
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
     pressure recompression);
then one ``{"kernels": [...]}`` line, then the result line.  Phase 2 also
holds the training kernels (CCM flash attention forward and backward,
kv_cummean forward and reverse, cond_lora's autograd) and the arena's
session gather/scatter against their plain versions.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES = 3.35e12            # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12              # H100 SXM dense bf16 tensor-core FLOP/s


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


def device_ms(torch, fn, iters: int = 20, only: str = None) -> float:
    """Mean DEVICE time per call of ``fn``: the summed durations of the
    device events that ``torch.profiler`` records over ``iters`` calls
    after a warm-up (with ``only``, just the kernels whose name contains
    it).  Host launch overhead is excluded.  A window in which the
    profiler delivered no device event at all is measured again (up to
    three windows); it never stands in for a time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        evs = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and (only is None or only in e.name())]
        if evs:
            break
        log("  (the profiler delivered no device events; measuring again)")
    if not evs:
        raise RuntimeError(f"the profiler recorded no device events"
                           f"{'' if only is None else ' named ' + only}")
    return sum(e.duration_ns() for e in evs) / 1e6 / iters


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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_tol(want) -> float:
    """Two bf16 ulps of the largest value: both versions compute in
    float32 and round once to bf16, so float32 sums taken in another
    order can land them one ulp apart (an ulp of x is <= 2**-7 |x|)."""
    return 2.0 ** -6 * want.float().abs().max().item()


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
    #    an empty memory lane and a fully masked row (float32: tight);
    #    head dims 72 (not a multiple of 32) and 256 (the largest taken)
    B, Hq, Hkv, L, S = 3, 14, 2, 3, 100
    for D, Sq in ((64, 5), (64, 1), (72, 5), (72, 1), (256, 5), (256, 1)):
        q = rn(B, Sq, Hq, D)
        mk, mv = rn(B, 16, Hkv, D), rn(B, 16, Hkv, D)
        ck8, cks = quantize_kv(rn(L, B, S, Hkv, D))
        cv8, cvs = quantize_kv(rn(L, B, S, Hkv, D))
        sk, sv = rn(B, Sq, Hkv, D), rn(B, Sq, Hkv, D)
        ar = torch.arange(Sq, device=dev, dtype=torch.int32)
        qi = ar.clone()
        if Sq > 1:
            qi[2] = -5                       # row 2 sees no key at all
        self_seg = seg_dict(sk, sv, idx=ar, seg=torch.ones_like(ar),
                            comp=torch.zeros_like(ar, dtype=torch.bool),
                            valid=ar < Sq - 1 if Sq > 1 else None)
        mem_len = torch.tensor([0, 5, 16], device=dev, dtype=torch.int32)
        lens = torch.tensor([37, 0, 100], device=dev, dtype=torch.int32)
        layouts = {
            "layer-major": seg_dict(ck8, cv8, k_scale=cks, v_scale=cvs,
                                    length=lens, layer=1),
            "lane-major": seg_dict(
                ck8.transpose(0, 1).contiguous(), cv8.transpose(0, 1).contiguous(),
                k_scale=cks.transpose(0, 1).contiguous(),
                v_scale=cvs.transpose(0, 1).contiguous(), length=lens,
                layer=torch.tensor([1, 0, 2], device=dev, dtype=torch.int32),
                lane_major=True),
        }
        for name, cache_seg in layouts.items():
            segs = [seg_dict(mk, mv, length=mem_len), cache_seg, self_seg]
            one = torch.ones_like(qi)
            out = dattn.segmented_flash_attention(q, segs, qi, one, D ** -0.5)
            want = dattn.plain(q, segs, qi, one, D ** -0.5)
            torch.cuda.synchronize()
            check(f"segmented GQA 14/2 hd{D} int8 {name} Sq={Sq}",
                  max_err(out, want), 1e-4)
            if Sq > 1 and not bool((out[:, 2] == 0).all()):
                raise AssertionError("fully masked row is not exactly 0")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError("non-finite attention output")

    # -- main-path shapes (LLaMA-7B, bf16): decode, ingest, prefill
    B, H, D, L = 4, 32, 128, 32
    mem_k, mem_v = rn(B, 128, H, D, dtype=torch.bfloat16), \
        rn(B, 128, H, D, dtype=torch.bfloat16)
    ck, cv = rn(L, B, 512, H, D, dtype=torch.bfloat16), \
        rn(L, B, 512, H, D, dtype=torch.bfloat16)
    ck8, cks = quantize_kv(ck)
    cv8, cvs = quantize_kv(cv)
    scale = D ** -0.5
    results = {}

    def shapes(Sq, cache_len, decode):
        q = rn(B, Sq, H, D, dtype=torch.bfloat16)
        sk, sv = rn(B, Sq, H, D, dtype=torch.bfloat16), \
            rn(B, Sq, H, D, dtype=torch.bfloat16)
        ar = torch.arange(Sq, device=dev, dtype=torch.int32)
        idx = ar + 2 ** 30 if decode else ar
        comp = torch.zeros(Sq, device=dev, dtype=torch.bool)
        if not decode and Sq == 72:          # ingest: <COMP> rows last
            comp[64:] = True
        self_seg = seg_dict(sk, sv, idx=idx, seg=torch.ones_like(ar), comp=comp)
        return q, self_seg, idx

    for label, Sq, clen, decode, int8 in (
            ("decode", 1, 480, True, False), ("decode int8", 1, 480, True, True),
            ("ingest", 72, 0, False, False), ("prefill", 448, 0, False, False)):
        q, self_seg, idx = shapes(Sq, clen, decode)
        one = torch.ones_like(idx)

        def segs_at(layer):
            cache = seg_dict(ck8, cv8, k_scale=cks, v_scale=cvs, length=clen,
                             layer=layer) if int8 else \
                seg_dict(ck, cv, length=clen, layer=layer)
            return [seg_dict(mem_k, mem_v, length=32), cache, self_seg]

        out = dattn.segmented_flash_attention(q, segs_at(5), idx, one, scale)
        want = dattn.plain(q, segs_at(5), idx, one, scale)
        torch.cuda.synchronize()
        err = max_err(out, want)
        check(f"segmented {label} B4 Sq{Sq} H32 hd128 cache {clen}", err,
              bf16_tol(want))
        # rotate over 4 layers so the timed reads exceed the 50 MB L2
        segs4 = [segs_at(li) for li in range(4)]
        # library yardstick: SDPA over the explicit concatenation of the
        # valid keys with the CCM mask (built outside the timing; decode
        # sees every valid key, so it needs no mask)
        cats = []
        for li in range(4):
            kk = ck[li] if not int8 else \
                (ck8[li].float() * cks[li][..., None]).bfloat16()
            vv = cv[li] if not int8 else \
                (cv8[li].float() * cvs[li][..., None]).bfloat16()
            kc = torch.cat([mem_k[:, :32], kk[:, :clen], self_seg["k"]], 1)
            vc = torch.cat([mem_v[:, :32], vv[:, :clen], self_seg["v"]], 1)
            cats.append((kc.transpose(1, 2).contiguous(),
                         vc.transpose(1, 2).contiguous()))
        qt = q.transpose(1, 2).contiguous()
        mask = None
        if not decode:
            kidx = torch.cat([torch.full((32 + clen,), -1, device=dev,
                                         dtype=torch.int32), idx])
            kcomp = torch.cat([torch.ones(32 + clen, device=dev,
                                          dtype=torch.bool), self_seg["comp"]])
            kseg = torch.cat([torch.zeros(32 + clen, device=dev,
                                          dtype=torch.int32), one])
            mask = (kidx[None] <= idx[:, None]) & \
                ((kseg[None] == one[:, None]) | kcomp[None])
        t = timings(
            torch,
            lambda i: dattn.segmented_flash_attention(q, segs4[i % 4], idx,
                                                      one, scale),
            "segmented_attention_kernel",
            lambda i: dattn.plain(q, segs4[i % 4], idx, one, scale),
            lambda i: F.scaled_dot_product_attention(
                qt, cats[i % 4][0], cats[i % 4][1], attn_mask=mask))
        nkeys = 32 + clen + Sq
        kv_bytes = B * nkeys * H * D * 2 * (1 if int8 else 2)
        if int8:
            kv_bytes += B * clen * H * 4 * 2 + B * (32 + Sq) * H * D * 2
        nbytes = kv_bytes + 2 * q.numel() * 2
        ops_ = 4.0 * B * H * Sq * nkeys * D
        bms, by = bound(nbytes, ops_, PEAK_BF16)
        report(f"segmented {label} (library: SDPA)", t, bms, by, card)
        results[label] = dict(max_abs_err=err, ms=t["ms"],
                              plain_ms=t["plain_ms"],
                              library_ms=t["library_ms"], bound_ms=bms,
                              bound_by=by)
    return results


def check_cond_lora(torch, clora, card):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    M, K, N, r = 4 * (64 + 8), 4096, 4096, 8
    bf = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf)

    x = rn(M, K)
    ws = [rn(K, N, std=K ** -0.5) for _ in range(4)]   # 4 x 33.5 MB > L2
    a, b = rn(r, K, std=K ** -0.5), rn(r, N, std=0.05)
    gate = ((torch.arange(M, device=dev) % 72) >= 64).float()
    for gname, gt in (("gated", gate), ("gate all zero", torch.zeros_like(gate))):
        out = clora.cond_lora_matmul(x, ws[0], a, b, gt, 2.0)
        want = clora.plain(x, ws[0], a, b, gt, 2.0)
        torch.cuda.synchronize()
        err = max_err(out, want)
        check(f"cond_lora {gname} M{M} K{K} N{N} r{r}", err, bf16_tol(want))
        if gname == "gated":
            main_err = err
    bias = rn(N)
    want = clora.plain(x, ws[1], a, b, gate, 2.0, bias=bias)
    check("cond_lora with bias", max_err(
        clora.cond_lora_matmul(x, ws[1], a, b, gate, 2.0, bias=bias), want),
        bf16_tol(want))
    g2 = gate.to(bf)[:, None]
    t = timings(
        torch,
        lambda i: clora.cond_lora_matmul(x, ws[i % 4], a, b, gate, 2.0),
        "cond_lora_kernel",
        lambda i: clora.plain(x, ws[i % 4], a, b, gate, 2.0),
        lambda i: x @ ws[i % 4] + g2 * ((x @ a.T) @ b) * 2.0)
    nbytes = 2 * (M * K + K * N + r * K + r * N + M * N) + 4 * M
    ops_ = 2.0 * M * K * N + 2.0 * M * K * r + 2.0 * M * r * N
    bms, by = bound(nbytes, ops_, PEAK_BF16)
    report("cond_lora (library: x@W + gate*(x@A^T@B)*s)", t, bms, by, card)
    return dict(max_abs_err=main_err, ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=bms, bound_by=by)


def check_kv_merge(torch, kvm, card):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (32, 4, 8, 32, 128)
    mems = [torch.randn(shape, generator=g, device=dev).bfloat16()
            for _ in range(4)]
    hs = [torch.randn(shape, generator=g, device=dev).bfloat16()
          for _ in range(4)]
    errs = []
    for a in (1.0, 1.0 / 3, 0.3):
        want = kvm.plain(mems[0], hs[0], a)
        got = kvm.kv_merge_update_(mems[0].clone(), hs[0], a)
        torch.cuda.synchronize()
        errs.append(max_err(got, want))
        check(f"kv_merge a={a:.4f} {shape}", errs[-1], bf16_tol(want))
    t = timings(
        torch,
        lambda i: kvm.kv_merge_update_(mems[i % 4], hs[i % 4], 1.0 / 3),
        "merge_kernel",
        lambda i: mems[i % 4].copy_(kvm.plain(mems[i % 4], hs[i % 4], 1.0 / 3)),
        lambda i: torch.lerp(mems[i % 4], hs[i % 4], 1.0 / 3))
    n = mems[0].numel()
    bms, by = bound(3 * 2 * n, 3.0 * n, PEAK_BF16)
    report("kv_merge (library: torch.lerp)", t, bms, by, card)
    return dict(max_abs_err=max(errs), ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=bms, bound_by=by)


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

    # -- GQA 14/2 and 32/32, head dims 64/72/128/256, S not a multiple of
    #    the tiles, padded keys, a fully masked row; float32 and bf16.
    #    float32: 1e-4 x max|plain| (float32 sums over up to 1216 keys in
    #    another order); bf16: 2 ulps of the largest output for the forward
    #    and 4 for gradients (the backward rounds O, dQ, dK, dV to bf16 and
    #    recomputes P from the float32 log-sum-exp).
    lay = segment_layout(3, 29, 4, 11)                   # S = 110
    cases = [(2, 14, 2, 64, torch.float32), (2, 14, 2, 72, torch.float32),
             (1, 4, 4, 256, torch.float32), (2, 14, 2, 128, torch.bfloat16),
             (1, 6, 2, 256, torch.bfloat16)]
    for B, Hq, Hkv, D, dt in cases:
        S = lay.seq_len
        idx, seg, comp = ccm_meta(torch, lay, dev)
        qi = idx.clone()
        qi[5] = -7                                       # sees no key
        valid = torch.ones(S, dtype=torch.bool, device=dev)
        valid[-3:] = False                               # padded keys
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
                  f"{str(dt)[6:]}", max_err(a, b), tol)
        if not bool((got[0][:, :, 5] == 0).all()):
            raise AssertionError("fully masked row is not exactly 0")

    # -- the training shape: LLaMA-7B heads, concat layout, bf16
    lay = segment_layout(16, 64, 8, 64)                  # S = 1216
    B, H, S, D = 4, 32, lay.seq_len, 128
    idx, seg, comp = ccm_meta(torch, lay, dev)
    meta = (idx, seg, idx, seg, comp, None)
    scale = D ** -0.5
    sets = [tuple(rn(B, H, S, D, dtype=torch.bfloat16) for _ in range(4))
            for _ in range(4)]                           # 4 x 160 MB > L2
    q, k, v, do = sets[0]
    got = grads(lambda a, b, c: ca.ccm_attention(a, b, c, *meta, scale),
                q, k, v, do)
    want = grads(lambda a, b, c: ca.plain(a, b, c, *meta, scale), q, k, v, do)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("fwd", "dq", "dk", "dv"), got, want):
        errs[name] = max_err(a, b)
        top = b.float().abs().max().item()
        check(f"ccm_attention {name} B4 H32 S{S} hd128 bf16 (training shape)",
              errs[name], 2.0 ** (-6 if name == "fwd" else -5) * top)
    del got, want
    # the (q, k) pairs the CCM mask lets through: the work this data needs
    mask = (idx[None, :] <= idx[:, None]) \
        & ((seg[None, :] == seg[:, None]) | comp[None, :])
    pairs = int(mask.sum().item()) * B * H
    nq, nk = -(-S // 16), -(-S // 32)      # the kernel's 16 x 32 tiles
    padded = torch.zeros(nq * 16, nk * 32, dtype=torch.bool, device=dev)
    padded[:S, :S] = mask
    kept = int(padded.reshape(nq, 16, nk, 32).any(3).any(1).sum().item())
    log(f"  ccm_attention training shape: {pairs / (B * H * S * S):.4f} of "
        f"the S x S pairs visible; the tile skip keeps {kept} of "
        f"{nq * nk} 16 x 32 tiles")

    def fwd_k(i):
        return ca.ccm_attention_fwd(*sets[i % 4][:3], *meta, scale)

    def fwd_p(i):
        return ca.plain(*sets[i % 4][:3], *meta, scale)

    def fwd_l(i):
        return F.scaled_dot_product_attention(*sets[i % 4][:3],
                                              attn_mask=mask, scale=scale)
    t_f = timings(torch, fwd_k, "ccm_attention_fwd_kernel", fwd_p, fwd_l)
    nb = 2 * (4 * B * H * S * D) + 4 * B * H * S      # q, k, v, o + lse
    bms, by = bound(nb, 4.0 * D * pairs, PEAK_BF16)
    report("ccm_attention forward (library: SDPA with the CCM mask)", t_f,
           bms, by, card)
    fwd_row = dict(max_abs_err=errs["fwd"], ms=t_f["ms"],
                   plain_ms=t_f["plain_ms"], library_ms=t_f["library_ms"],
                   bound_ms=bms, bound_by=by)

    # backward only: the graphs are built once, outside the timing
    saved = []
    for qq, kk, vv, dd in sets:
        o, lse = ca.ccm_attention_fwd(qq, kk, vv, *meta, scale)
        saved.append((qq, kk, vv, o, lse, dd))

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
        a, b, c, attn_mask=mask, scale=scale))

    def bwd_l(i):
        o, xs, dd = lib_g[i % 4]
        return torch.autograd.grad(o, xs, dd, retain_graph=True)
    t_b = dict(ms=device_ms(torch, bwd_k, 20, only="ccm_attention_bwd"),
               call_ms=time_ms(torch, bwd_k, 20),
               library_ms=device_ms(torch, bwd_l, 20), **t_pb)
    del lib_g
    nb = 2 * (8 * B * H * S * D) + 8 * B * H * S     # q k v o dO -> dq dk dv
    bms, by = bound(nb, 10.0 * D * pairs, PEAK_BF16)
    report("ccm_attention backward (library: SDPA backward)", t_b, bms, by,
           card)
    bwd_row = dict(max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                   ms=t_b["ms"], plain_ms=t_b["plain_ms"],
                   library_ms=t_b["library_ms"], bound_ms=bms, bound_by=by)
    del sets, saved
    torch.cuda.empty_cache()
    return fwd_row, bwd_row


def check_kv_cummean(torch, kvm, card):
    """Kernel 5 at the merge shape: T = 16 steps of R = B*m*H*D columns,
    forward and reverse, contiguous and read in place from (B, S, H, D)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    T, B, m, H, D, lc = 16, 4, 8, 32, 128, 64
    R = B * m * H * D
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        h = torch.randn(T, R, generator=g, device=dev).to(dt)
        gr = torch.randn(T, R, generator=g, device=dev).to(dt)
        hh = h.detach().requires_grad_(True)
        out = kvm.kv_cummean(hh[None])[0]
        (dh,) = torch.autograd.grad(out, (hh,), gr)
        hp = h.detach().requires_grad_(True)
        want = kvm.plain_cummean(hp, 0)
        (dwant,) = torch.autograd.grad(want, (hp,), gr)
        torch.cuda.synchronize()
        tol = (lambda w: 1e-6 * w.abs().max().item()) if dt == torch.float32 \
            else bf16_tol
        errs.append(max_err(out, want))
        check(f"kv_cummean forward (T{T}, R{R}) {str(dt)[6:]}", errs[-1],
              tol(want))
        check(f"kv_cummean reverse (T{T}, R{R}) {str(dt)[6:]}",
              max_err(dh, dwant), tol(dwant))
    # in place: the <COMP> groups of a (B, S, H, D) activation, strided
    x = torch.randn(B, T * (lc + m) + 64, H, D, generator=g,
                    device=dev).bfloat16()
    grp = x[:, :T * (lc + m)].reshape(B, T, lc + m, H * D)[:, :, lc:].flatten(2)
    got = kvm.kv_cummean(grp)
    want = kvm.plain_cummean(grp, 1)
    check("kv_cummean on the strided <COMP> groups of (B, S, H, D)",
          max_err(got, want), bf16_tol(want))
    hs = [torch.randn(T, R, generator=g, device=dev).bfloat16()
          for _ in range(4)]
    ar = torch.arange(1, T + 1, device=dev, dtype=torch.float32)[:, None]
    t = timings(
        torch, lambda i: kvm.kv_cummean(hs[i % 4][None]), "cummean_kernel",
        lambda i: kvm.plain_cummean(hs[i % 4], 0),
        lambda i: torch.cumsum(hs[i % 4].float(), 0) / ar)
    bms, by = bound(2 * 2 * T * R, 2.0 * T * R, PEAK_BF16)
    report("kv_cummean (library: torch.cumsum(h.float(), 0) / arange)", t,
           bms, by, card)
    tr = device_ms(torch, lambda i: kvm.kv_cummean_launch(hs[i % 4][None],
                                                          reverse=True),
                   20, only="cummean_kernel")
    log(f"  kv_cummean reverse: kernel {tr:.4f} ms (device) [{card}]")
    return dict(max_abs_err=max(errs), ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=bms, bound_by=by)


def check_cond_lora_grad(torch, clora, card):
    """cond_lora under autograd (kernel forward, matmul backward) against
    autograd through the plain version: dx, dA, dB and dbias."""
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
            xs = [t.detach().requires_grad_(True) for t in (x, a, b, bias)]
            y = fn(xs[0], w, xs[1], xs[2], gate, 2.0, xs[3])
            res.append(torch.autograd.grad(y, xs, dy))
        torch.cuda.synchronize()
        for name, got, want in zip(("dx", "dA", "dB", "dbias"), *res):
            top = want.float().abs().max().item()
            # bf16: the base product dy @ W^T is rounded to bf16 before the
            # LoRA term is added, then the sum is rounded again (4 ulps)
            tol = 1e-4 * top if dt == torch.float32 else 2.0 ** -5 * top
            check(f"cond_lora autograd {name} M{M} K{K} N{N} {str(dt)[6:]}",
                  max_err(got, want), tol)


# ---------------------------------------------------------------------------
# phase 3: the main path at full width and depth
# ---------------------------------------------------------------------------

def profile_window(torch, fn, label: str, card: str, warmup: bool = True):
    """Device busy time, span and top kernels of one call of ``fn`` under
    ``torch.profiler`` (after one warm-up call unless ``warmup`` is
    False); returns {kernel name: device ms} (None when the profiler
    recorded no device event).  The profiler's own host overhead
    stretches the span, so the idle share is an upper bound."""
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
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    return by_name

def randomize_lora_b(torch, params, seed: int, std: float = 0.05):
    """The reference initialises LoRA b = 0, which would leave the gate
    unexercised: draw it at random (comp_embed is random already)."""
    lora = params["layers"]["attn"]["lora"]
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


def main_path(torch, PI, ops, params, cfg, mode, cache_dtype, card,
              profile: bool = False):
    B, T, LC, PROMPT, CACHE, NEW = 4, 4, 64, 448, 512, 32
    ccm = dataclasses.replace(cfg.ccm, mode=mode)
    rcfg = cfg.replace(kv_cache_dtype=cache_dtype, ccm=ccm)
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(11)
    chunks = [torch.randint(0, cfg.vocab_size, (B, LC), generator=gen,
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

    name = f"{mode}+{cache_dtype}"
    if not finite:
        raise AssertionError(f"{name}: non-finite logits")
    if not torch.equal(gen_toks, manual):
        raise AssertionError(f"{name}: generate tokens differ from the "
                             "prefill + decode_step loop")
    L, m = cfg.n_layers, cfg.ccm.comp_len
    # one attend per layer per pass: T ingests, then prefill + NEW - 1
    # decode steps twice (the explicit loop and generate)
    want_counts = {k: 0 for k in counts}
    want_counts.update({"segmented_attention": L * (T + 2 * NEW),
                        "cond_lora": 4 * L * T,
                        "kv_merge_update": 2 * T if mode == "merge" else 0})
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
    if profile:         # after the counts: these launches are not counted
        def decode3():
            nonlocal st
            for _ in range(3):
                _, st = PI.decode_step(params, rcfg, st, toks[-1][:, None])

        def ingest1():
            nonlocal st
            st = PI.ingest_context(params, rcfg, st, chunks[0])
        profile_window(torch, decode3, f"{name} 3 decode steps", card)
        profile_window(torch, ingest1, f"{name} 1 ingest", card)
    return counts


# ---------------------------------------------------------------------------
# phase 4: the whole path, CUDA kernels vs CPU plain versions
# ---------------------------------------------------------------------------

def cross_check(torch, PI, params_bf16, cfg, devices=("cuda", "cpu")):
    B, T, LC, PROMPT, CACHE = 2, 17, 32, 64, 66
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32")

    def to(t, dev, layers=False):
        """float32 copy on ``dev``; under ``layers`` the first 2 layers."""
        if isinstance(t, dict):
            return {k: to(v, dev, layers or k == "layers")
                    for k, v in t.items()}
        t = t[:2] if layers else t
        return t.to(device=dev, dtype=torch.float32).contiguous()

    runs = {}
    gen = torch.Generator().manual_seed(5)
    chunks = [torch.randint(0, c2.vocab_size, (B, LC), generator=gen)
              for _ in range(T)]
    prompt = torch.randint(0, c2.vocab_size, (B, PROMPT), generator=gen)
    forced = [torch.randint(0, c2.vocab_size, (B, 1), generator=gen)
              for _ in range(4)]
    for dev in devices:
        t0 = time.perf_counter()
        pp = to(params_bf16, dev)
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

def train_phase(torch, ops, clora, TR, T, PD, PA, PP, segment_layout,
                params, cfg, card):
    """3 concat + 2 merge AdamW steps of LLaMA-7B through
    ``make_train_step`` (B=4, S=1216), then one gradient-free
    ``train_forward``; returns the launch counts of the 5 steps."""
    import dataclasses as dc
    dev = params["embed"].device
    layout = segment_layout(16, 64, 8, 64)
    B = 4
    batch = PD.sample_kv_batch(PD.ShardableIndexIterator(0, B).key_for(0),
                               layout, B, device=dev)
    tp, fp = PP.partition(params, TR.trainable_mask_for(cfg, params))
    opt = PA.init_adamw(tp)
    # lr 1e-3 from step 1: an update of ~lr moves every bf16 comp_embed
    # value (|x| ~ 0.02, one bf16 ulp ~ 1.2e-4)
    ocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    train0 = {"/".join(p): x.detach().clone() for p, x in PP.leaves(tp)}
    frozen0 = {"/".join(p): x.clone() for p, x in PP.leaves(fp)}
    merge_cfg = cfg.replace(ccm=dc.replace(cfg.ccm, mode="merge",
                                           merge_alpha=None))
    steps = [("concat", cfg)] * 3 + [("merge", merge_cfg)] * 2
    fns = {m: TR.make_train_step(c, layout, ocfg) for m, c in steps}
    L = cfg.n_layers
    want_step = {
        "concat": {"ccm_attention": 2 * L, "ccm_attention_backward": L,
                   "cond_lora": 4 * 2 * L},
        "merge": {"kv_cummean": 2 * 2 * L, "kv_cummean_backward": 2 * L,
                  "cond_lora": 4 * 2 * L}}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    clora.backward_calls = 0
    totals = {}
    losses = []
    for i, (mode, _) in enumerate(steps):
        before = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tp, opt, metrics, _ = fns[mode](tp, fp, opt, batch, None)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        after = ops.launch_counts()
        step_counts = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
        losses.append(loss)
        log(f"  train step {i + 1} ({mode}): loss {loss:.4f}, grad norm "
            f"{metrics['grad_norm'].item():.4f}, {dt:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches {step_counts} [{card}]")
        if step_counts != want_step[mode]:
            raise AssertionError(f"step {i + 1} launches {step_counts} != "
                                 f"{want_step[mode]}")
    totals = ops.launch_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if clora.backward_calls != 5 * 4 * L:
        raise AssertionError(f"cond_lora autograd backward ran "
                             f"{clora.backward_calls} times, want {20 * L}")
    for k, x in PP.leaves(tp):
        if torch.equal(x.detach(), train0["/".join(k)]):
            raise AssertionError(f"trainable leaf {'/'.join(k)} unchanged")
    for k, x in PP.leaves(fp):
        if not torch.equal(x, frozen0["/".join(k)]):
            raise AssertionError(f"frozen leaf {'/'.join(k)} changed")
    log(f"  {len(train0)} trainable leaves all changed, {len(frozen0)} "
        f"frozen leaves bitwise unchanged; opt step {opt.step}")
    del frozen0, train0
    for mode, c in (("concat", cfg), ("merge", merge_cfg)):
        with torch.no_grad():
            T.train_forward(params, c, batch["tokens"], layout)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = T.train_forward(params, c, batch["tokens"], layout)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(lg).all()) \
                or lg.shape != (B, 64, cfg.vocab_size):
            raise AssertionError(f"train_forward {mode}: bad logits")
        log(f"  train_forward {mode} (no grad, B4 S1216, tail logits): "
            f"{ms:.1f} ms [{card}]")
    # one profiled step of each mode (after the counts: not counted)
    for mode in ("concat", "merge"):
        profile_window(torch, lambda: fns[mode](tp, fp, opt, batch, None),
                       f"1 {mode} train step", card)
    return totals


# ---------------------------------------------------------------------------
# phase 6: training cross-check (CUDA vs CPU) and parallel = online
# ---------------------------------------------------------------------------

def train_cross_check(torch, PI, TR, PT, PD, PP, segment_layout, params_bf16,
                      cfg, devices=("cuda", "cpu")):
    """2 layers at full width in float32: (a) loss, tail logits and every
    trainable gradient leaf on CUDA (kernels) against the CPU (plain
    versions), concat and merge; (b) on the card, the parallel forward's
    tail logits against t ingests + prefill (the online kernels).
    Tolerance 1e-3 x max|.| per tensor (float32 sums in other orders)."""
    import dataclasses as dc
    c2 = cfg.replace(n_layers=2, compute_dtype="float32",
                     param_dtype="float32")
    layout = segment_layout(4, 32, 8, 32)                 # S = 192
    B = 2
    batch = PD.sample_kv_batch(PD.ShardableIndexIterator(3, B).key_for(0),
                               layout, B, device="cpu")

    def to(t, dev, layers=False):
        if isinstance(t, dict):
            return {k: to(v, dev, layers or k == "layers")
                    for k, v in t.items()}
        t = t[:2] if layers else t
        return t.detach().to(device=dev, dtype=torch.float32).contiguous()

    def close(name, a, b):
        lim = 1e-3 * b.abs().max().item()
        err = max_err(a.cpu(), b)
        if not err <= lim:
            raise AssertionError(f"{name}: {err} > {lim}")
        return err / lim

    for mode in ("concat", "merge"):
        cm = c2.replace(ccm=dc.replace(c2.ccm, mode=mode))
        res = {}
        for dev in devices:
            t0 = time.perf_counter()
            pp = to(params_bf16, dev)
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
        for k in grp:
            if not grp[k].abs().max().item() > 0:
                raise AssertionError(f"{mode} gradient {k} is all zero")
            worst = max(worst, close(f"{mode} grad {k}", grc[k], grp[k]))
        log(f"  train cross-check {mode}: loss {lc.item():.6f} vs "
            f"{lp.item():.6f}, logits + {len(grp)} gradient leaves, worst "
            f"max|d| / limit {worst:.3f}; cuda {tc:.1f} s, cpu {tpu:.1f} s")

        # (b) parallel = online on the card
        pp = to(params_bf16, devices[0])
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


def serve_phase(torch, ops, PI, params, cfg, card, *, label: str,
                n_sessions: int, n_slots: int, seed: int,
                async_offload: bool = False, recompress: bool = False,
                stagger: bool = False, detail: bool = False):
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
    back bit-equal.  Returns the kernel launches of the engine's run."""
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
                      device=dev)
    mgr = eng._mgr["online"]

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
            by_name = profile_window(torch, eng.run, f"{label} ingest drain",
                                     card, warmup=False)
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
    for k in ("session_gather", "session_scatter", "segmented_attention",
              "cond_lora"):
        if counts[k] <= 0:
            raise AssertionError(f"{label}: {k} never launched")
    log(f"  {label}: offloads {moved['offload']}, restores "
        f"{moved['restore']}, prefix hits {hits}, COW breaks {cow}, "
        f"launches {counts}")

    # every query against the session run alone (B=1) on the card
    worst = 0.0
    for sid, req in reqs.items():
        if not req.done or req.result is None:
            raise AssertionError(f"{label}: query of {sid} not delivered")
        src = parent if sid == "fork" else sid
        st = PI.init_online_state(cfg, 1, 256, device=dev)
        for c in ctx[src]:
            st = PI.ingest_context(params, cfg, st,
                                   torch.as_tensor(c, device=dev)[None])
        if src == recompressed:
            st = st._replace(mem=recompress_memory(
                cfg, st.mem, eng.pressure.policy.recompress_group))
        want, _ = PI.prefill(params, cfg, st,
                             torch.as_tensor(qry[sid], device=dev)[None],
                             full_logits=True)
        want = want[0].float().cpu()
        got = torch.from_numpy(req.result)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: {sid} logits {got.shape}")
        err, tol = max_err(got, want), bf16_tol(want)
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"{label}: {sid} logits differ from the "
                                 f"single-session run: {err} > {tol}")
    log(f"  {label}: {len(reqs)} queries match their single-session runs: "
        f"worst max_abs_err / bf16_tol = {worst:.3f}")

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
    del eng
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.configs import llama_7b_paper
    from repro_torch.core import inference as PI
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
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"  built {sorted(libs)} in {build_s:.1f} s")
    for stem in sorted(libs):
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {stem}: {line.strip()}")

    log("phase 2: kernels against their plain versions on the card")
    seg = check_segmented(torch, F, dattn, PI.quantize_kv, card)
    lora = check_cond_lora(torch, clora, card)
    merge = check_kv_merge(torch, kvm, card)
    check_cond_lora_grad(torch, clora, card)
    ccm_fwd, ccm_bwd = check_ccm_attention(torch, F, ca, segment_layout, card)
    cummean = check_kv_cummean(torch, kvm, card)
    gather, scatter = check_session_gather(torch, sg, card)

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
    serve_counts = serve_phase(torch, ops, PI, params, cfg, card,
                               label="32L concat+bf16", n_sessions=12,
                               n_slots=8, seed=21, detail=True)
    log("  then 4 layers at full width: merge + bf16 (per-lane a_t, async "
        "offload) and concat + int8 cache (pressure recompress)")
    p4 = first_layers(params, 4)
    serve_phase(torch, ops, PI, p4, cfg.replace(
        n_layers=4, ccm=dataclasses.replace(cfg.ccm, mode="merge")), card,
        label="4L merge+bf16", n_sessions=6, n_slots=4, seed=22,
        async_offload=True, stagger=True)
    serve_phase(torch, ops, PI, p4, cfg.replace(n_layers=4,
                                                kv_cache_dtype="int8"),
                card, label="4L concat+int8", n_sessions=6, n_slots=4,
                seed=23, recompress=True)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del params, p4

    rows = [
        dict(name="segmented_attention", route="cuda",
             source="src/repro_torch/csrc/segmented_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:160",
             launches=totals["segmented_attention"], **seg["decode"]),
        dict(name="cond_lora", route="cuda",
             source="src/repro_torch/csrc/cond_lora.cu",
             replaces="src/repro/kernels/cond_lora.py:48",
             launches=totals["cond_lora"], **lora),
        dict(name="kv_merge_update", route="triton",
             source="src/repro_torch/kernels/kv_merge.py",
             replaces="src/repro/kernels/kv_merge.py:27",
             launches=totals["kv_merge_update"], **merge),
        dict(name="ccm_attention", route="cuda",
             source="src/repro_torch/csrc/ccm_attention.cu",
             replaces="src/repro/kernels/ccm_attention.py:86",
             launches=train_counts["ccm_attention"], **ccm_fwd),
        dict(name="ccm_attention_backward", route="cuda",
             source="src/repro_torch/csrc/ccm_attention.cu",
             replaces="src/repro/kernels/ccm_attention.py:86",
             launches=train_counts["ccm_attention_backward"], **ccm_bwd),
        dict(name="kv_cummean", route="triton",
             source="src/repro_torch/kernels/kv_merge.py",
             replaces="src/repro/kernels/kv_merge.py:65",
             launches=train_counts["kv_cummean"], **cummean),
        dict(name="session_gather", route="cuda",
             source="src/repro_torch/csrc/session_gather.cu",
             replaces="src/repro/kernels/session_gather.py:30",
             launches=serve_counts["session_gather"], **gather),
        dict(name="session_scatter", route="cuda",
             source="src/repro_torch/csrc/session_gather.cu",
             replaces="src/repro/kernels/session_gather.py:56",
             launches=serve_counts["session_scatter"], **scatter),
    ]
    for r in rows:
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never launched on the main path")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
