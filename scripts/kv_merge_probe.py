#!/usr/bin/env python3
"""Where the merge kernels (``csrc/kv_merge.cu``, the online update, and
``csrc/kv_cummean.cu``, the training running mean) spend their time, on
one CUDA GPU.

    python3 scripts/kv_merge_probe.py              # both kernels
    python3 scripts/kv_merge_probe.py --merge      # the update only
    python3 scripts/kv_merge_probe.py --cummean    # the running mean only

The update:
1. Variants of the kernel built from patched copies of the source (block
   size, accesses in flight per thread, a grid capped at a few blocks per
   SM, no cache-streaming hints, a 256-byte L2 prefetch hint on the loads,
   launch bounds that force 8 blocks per SM), each timed in turns, two
   rounds, with the library pair (two ``lerp_``) in each round: device ms
   of the k + v
   pair with a shared weight at the online shape (LLaMA-7B merge memory,
   (32, 4, 8, 32, 128) bf16, 8 MiB a tensor), of the lane-major pair with
   per-lane weights and a transposed h, and of the 4-layer serve engine's
   pair ((4, 4, 8, 32, 128), 1 MiB a tensor).
2. Host time per back-to-back call on a tiny pair, where the device time
   is negligible: the wrapper with a shared weight and with per-lane
   weights, the C launcher called with a ready parameter struct, and the
   two ``lerp_`` calls.

The running mean:
3. Variants of its kernel (block size, steps in flight per thread, T
   split across 2 or 4 threads with a shared-memory carry, 8-byte
   vectors, cache-streaming loads, a grid capped at a few blocks per SM
   that loops), each timed in turns, two rounds, with the library pair
   (two ``torch.cumsum``) in each round: device ms of the k + v forward
   and reverse at the LLaMA-7B training shape ((4, 16, 32768) bf16,
   4 MiB a tensor), of the forward reading the strided <COMP> groups of
   two (4, 1216, 32, 128) activations in place, and of the single
   (1, 16, 131072) tensor; each variant's results are first held against
   the plain version.
4. Host time per back-to-back call on a tiny pair: the wrapper, the
   autograd op, the wrapper's parts (two output allocations, the
   parameter struct, the C launcher with a ready struct), and two
   ``torch.cumsum``.

Builds into ``build/kv_merge_probe/`` at the checkout root.  Needs the
card, nvcc and nothing else; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def define(name: str, value: int):
    def patch(src: str) -> str:
        old = next(ln for ln in src.splitlines()
                   if ln.startswith(f"#define {name} "))
        return src.replace(old, f"#define {name} {value}", 1)
    return patch


def cap(n: int):
    """A grid of at most ``n`` blocks per SM; its blocks loop over the
    chunks."""
    def patch(src: str) -> str:
        old = "  if (chunks > 0x7fffffffLL) chunks = 0x7fffffffLL;"
        if old not in src:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        return src.replace(old, f"""  {{
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long per_row = ((long long)sms * {n} + rows * p.n_tensors
                               - 1) / (rows * p.n_tensors);
    if (chunks > per_row) chunks = per_row;
  }}
""" + old)
    return patch


def no_hints(src: str) -> str:
    for old, new in (
            ("return __ldcs(reinterpret_cast<const uint4*>(p));",
             "return *reinterpret_cast<const uint4*>(p);"),
            ("__stcs(reinterpret_cast<uint4*>(p), v);",
             "*reinterpret_cast<uint4*>(p) = v;")):
        if old not in src:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def prefetch_256(src: str) -> str:
    """Loads with a 256-byte L2 prefetch-size hint (cache-streaming kept)."""
    old = "return __ldcs(reinterpret_cast<const uint4*>(p));"
    if old not in src:
        raise RuntimeError(f"probe patch does not apply: {old!r}")
    return src.replace(old, """uint4 v;
  asm volatile("ld.global.cs.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;""")


def min_blocks(n: int):
    def patch(src: str) -> str:
        old = "__global__ void __launch_bounds__(NTHREADS)"
        if old not in src:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        return src.replace(old, f"__global__ void __launch_bounds__("
                                f"NTHREADS, {n})")
    return patch


def both(*patches):
    def patch(src: str) -> str:
        for p in patches:
            src = p(src)
        return src
    return patch


def cummean_cap(n: int):
    """The running mean's grid capped at ``n`` blocks per SM; its blocks
    loop over the column blocks."""
    def patch(src: str) -> str:
        old = "  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;"
        if old not in src:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        return src.replace(old, f"""  {{
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long per_row = ((long long)sms * {n} + rows * p.n_tensors
                               - 1) / (rows * p.n_tensors);
    if (blocks > per_row) blocks = per_row;
  }}
""" + old)
    return patch


def streaming_loads(src: str) -> str:
    """The running mean's loads with the cache-streaming hint."""
    old = "raw[c] = *reinterpret_cast<const R_t*>(src + t * s_t);"
    if old not in src:
        raise RuntimeError(f"probe patch does not apply: {old!r}")
    return src.replace(old, "raw[c] = __ldcs(reinterpret_cast<const R_t*>"
                            "(src + t * s_t));")


VARIANTS = {
    "kernel as is": lambda s: s,
    "no cache-streaming hints": no_hints,
    "UNROLL 2": define("UNROLL", 2),
    "UNROLL 8": define("UNROLL", 8),
    "128 threads": define("NTHREADS", 128),
    "512 threads": define("NTHREADS", 512),
    "grid capped at 4 blocks per SM": cap(4),
    "grid capped at 8 blocks per SM": cap(8),
    "grid capped at 16 blocks per SM": cap(16),
    "UNROLL 8, capped at 4 blocks per SM": both(define("UNROLL", 8),
                                                cap(4)),
    "L2 prefetch 256 B on loads": prefetch_256,
    "launch bounds: 8 blocks of 256 per SM": min_blocks(8),
    "128 threads, L2 prefetch 256 B": both(define("NTHREADS", 128),
                                           prefetch_256),
    "L2 prefetch 256 B, 8 blocks per SM": both(prefetch_256, min_blocks(8)),
}

CUMMEAN_VARIANTS = {
    "kernel as is": lambda s: s,
    "64 threads": define("NTHREADS", 64),
    "256 threads": define("NTHREADS", 256),
    "512 threads": define("NTHREADS", 512),
    "CHUNK 8": define("CHUNK", 8),
    "CHUNK 4": define("CHUNK", 4),
    "T split over 2 threads, CHUNK 8": both(define("TSPLIT", 2),
                                            define("CHUNK", 8)),
    "T split over 2 threads, CHUNK 8, 256 threads": both(
        define("TSPLIT", 2), define("CHUNK", 8), define("NTHREADS", 256)),
    "T split over 4 threads, CHUNK 4, 256 threads": both(
        define("TSPLIT", 4), define("CHUNK", 4), define("NTHREADS", 256)),
    "8-byte vectors": define("VEC_BYTES", 8),
    "8-byte vectors, 256 threads": both(define("VEC_BYTES", 8),
                                        define("NTHREADS", 256)),
    "cache-streaming loads": streaming_loads,
    "grid capped at 1 block per SM": cummean_cap(1),
    "grid capped at 2 blocks per SM": cummean_cap(2),
}


def build(_build, out: Path, stem: str, variants) -> dict:
    """{variant: loaded library} of patched copies of csrc/<stem>.cu,
    compiled in parallel; prints the unpatched copy's registers."""
    src = (_build.CSRC / f"{stem}.cu").read_text()
    procs = {}
    for i, (name, patch) in enumerate(variants.items()):
        cu = out / f"{stem}_v{i}.cu"
        cu.write_text(patch(src))
        so, log = cu.with_suffix(".so"), cu.with_suffix(".log")
        procs[name] = (so, log, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=open(log, "w"), stderr=subprocess.STDOUT))
    for name, (_, log, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {stem} variant "
                               f"{name!r}:\n{log.read_text()[-3000:]}")
    for line in procs["kernel as is"][1].read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  {stem} as is: {line.strip()}", flush=True)
    return {name: ctypes.CDLL(str(so)) for name, (so, _, _) in procs.items()}


def merge_probe(torch, cs, kvm, _build, libs, card) -> None:
    def use(name):
        _build._libs["kv_merge"] = libs[name]
        kvm._fns.pop("kv_merge", None)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)

    def rn(shp):
        return torch.randn(shp, generator=g, device=dev).bfloat16()

    def tr(shp):
        return rn((shp[1], shp[0]) + tuple(shp[2:])).transpose(0, 1)

    online = (32, 4, 8, 32, 128)
    lanes = (4, 32, 8, 32, 128)
    serve = (4, 4, 8, 32, 128)
    w4 = [1.0, 0.5, 1.0 / 3, 0.3]
    # four sets of (mem_k, mem_v, h_k, h_v) a case, > 50 MB of L2 at the
    # online shapes
    cases = {
        f"k+v {online}, shared a": (
            [(rn(online), rn(online), rn(online), rn(online))
             for _ in range(4)], 1.0 / 3, 1),
        f"k+v lane-major {lanes}, per-lane a, h transposed": (
            [(rn(lanes), rn(lanes), tr(lanes), tr(lanes)) for _ in range(4)],
            w4, 0),
        f"k+v serve 4L lane-major {serve}, per-lane a, h transposed": (
            [(rn(serve), rn(serve), tr(serve), tr(serve)) for _ in range(4)],
            w4, 0)}

    def run(sets, a, axis):
        def fn(i):
            mk, mv, hk, hv = sets[i % 4]
            kvm.kv_merge_update_lanes_((mk, mv), (hk, hv), a, axis)
        return fn

    def lerp(sets):
        def fn(i):
            mk, mv, hk, hv = sets[i % 4]
            mk.lerp_(hk, 1.0 / 3)
            mv.lerp_(hv, 1.0 / 3)
        return fn

    n = 1
    for d in online:
        n *= d
    bms = 2 * 3 * n * 2 / cs.PEAK_BYTES * 1e3
    print(f"bytes bound of the online pair: {bms:.4f} ms", flush=True)
    for rnd in range(2):
        lib_ms = cs.device_ms(torch, lerp(cases[next(iter(cases))][0]), 20)
        print(f"round {rnd + 1}: library pair (two lerp_) at {online}: "
              f"{lib_ms:.4f} ms [{card}]", flush=True)
        for name in libs:
            use(name)
            got = [cs.device_ms(torch, run(*c), 20, only="kv_merge_kernel")
                   for c in cases.values()]
            print(f"round {rnd + 1}, {name}: "
                  + ", ".join(f"{k}: {t:.4f} ms" for k, t in
                              zip(("online", "lane-major", "serve 4L"), got))
                  + f" ({bms / got[0]:.3f} of the bound) [{card}]",
                  flush=True)
    del cases

    use("kernel as is")
    tiny = [rn((2, 2, 8)) for _ in range(4)]
    mk, mv, hk, hv = tiny
    fn, ready = kvm._launcher(), []

    def keep(params, index, stream):        # the struct the wrapper built
        ready.append(kvm._MergeParams.from_buffer_copy(params._obj))
        return fn(params, index, stream)
    kvm._fns["kv_merge"] = keep
    kvm.kv_merge_update_lanes_((mk, mv), (hk, hv), 0.5, 1)
    kvm._fns["kv_merge"] = fn
    p = ready[0]
    stream = torch.cuda.current_stream().cuda_stream
    host = {
        "wrapper, shared a": lambda i: kvm.kv_merge_update_lanes_(
            (mk, mv), (hk, hv), 0.5, 1),
        "wrapper, per-lane a": lambda i: kvm.kv_merge_update_lanes_(
            (mk, mv), (hk, hv), [0.5, 0.25], 1),
        "C launcher, ready struct": lambda i: fn(ctypes.byref(p), 0, stream),
        "two lerp_": lambda i: (mk.lerp_(hk, 0.5), mv.lerp_(hv, 0.5)),
    }
    for rnd in range(2):
        for name, f in host.items():
            t = cs.time_ms(torch, f, iters=2000, warmup=100)
            print(f"host, round {rnd + 1}: {name}: {t * 1e3:.2f} us per "
                  f"back-to-back call on (2, 2, 8) bf16 [{card}]", flush=True)


def cummean_probe(torch, cs, kvm, _build, libs, card) -> None:
    def use(name):
        _build._libs["kv_cummean"] = libs[name]
        kvm._fns.pop("kv_cummean", None)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    T, B, m, H, D, lc = 16, 4, 8, 32, 128, 64
    R, S = m * H * D, T * (lc + m) + 64

    def rn(*shp):
        return torch.randn(shp, generator=g, device=dev).bfloat16()

    # 8 pairs of 4 MiB a case, > 50 MB of L2
    pairs = [(rn(B, T, R), rn(B, T, R)) for _ in range(8)]
    acts = [rn(B, S, H, D) for _ in range(2)]        # 2 x 40 MiB
    groups = [x[:, :T * (lc + m)].reshape(B, T, lc + m, H * D)[
        :, :, lc:].flatten(2) for x in acts]
    singles = [x.view(1, T, B * R) for pr in pairs for x in pr]
    cases = {
        "k+v fwd": lambda i: kvm.kv_cummean_launch(pairs[i % 8]),
        "k+v rev": lambda i: kvm.kv_cummean_launch(pairs[i % 8],
                                                   reverse=True),
        "k+v fwd <COMP> groups in place": lambda i: kvm.kv_cummean_launch(
            groups),
        "single fwd": lambda i: kvm.kv_cummean_launch([singles[i % 16]]),
    }
    ar = torch.arange(1, T + 1, device=dev, dtype=torch.float32)[:, None]

    def lib(i):
        return [torch.cumsum(x.float(), 1) / ar for x in pairs[i % 8]]

    def check(name):
        """The variant's k + v forward and reverse on the groups against
        the plain versions (bf16_tol)."""
        for rev, plain in ((False, kvm.plain_cummean),
                           (True, kvm.plain_reverse)):
            outs = kvm.kv_cummean_launch(groups, reverse=rev)
            for o, x in zip(outs, groups):
                want = plain(x, 1)
                err = cs.max_err(o, want)
                if not err <= cs.bf16_tol(want):
                    raise AssertionError(f"cummean variant {name!r} "
                                         f"(reverse {rev}): {err}")

    pair_b = 2 * 2 * B * T * R * 2 / cs.PEAK_BYTES * 1e3
    print(f"bytes bound of the k+v pair {(B, T, R)} bf16: {pair_b:.4f} ms, "
          f"of the single (1, {T}, {B * R}): {pair_b / 2:.4f} ms", flush=True)
    for name in libs:
        use(name)
        check(name)
    for rnd in range(2):
        print(f"round {rnd + 1}: library pair (two torch.cumsum(h.float(), "
              f"1) / arange): {cs.device_ms(torch, lib, 20):.4f} ms "
              f"[{card}]", flush=True)
        for name in libs:
            use(name)
            got = [cs.device_ms(torch, fn, 20, only="kv_cummean_kernel")
                   for fn in cases.values()]
            print(f"round {rnd + 1}, cummean {name}: "
                  + ", ".join(f"{k}: {t:.4f} ms" for k, t in
                              zip(cases, got))
                  + f" ({pair_b / got[0]:.3f} / {pair_b / got[1]:.3f} of "
                  f"the pair's bound) [{card}]", flush=True)
    del pairs, acts, groups, singles

    use("kernel as is")
    tiny = [rn(2, 4, 8) for _ in range(2)]
    outs = kvm.kv_cummean_launch(tiny)
    p = kvm._cummean_params(tiny, outs, False)
    fn = kvm._launcher("kv_cummean")
    stream = torch.cuda.current_stream().cuda_stream
    host = {
        "wrapper, k+v": lambda i: kvm.kv_cummean_launch(tiny),
        "autograd op, k+v": lambda i: kvm.kv_cummean(*tiny),
        "its parts: two torch.empty": lambda i: [
            torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for x in tiny],
        "its parts: the struct": lambda i: kvm._cummean_params(tiny, outs,
                                                               False),
        "its parts: C launcher, ready struct": lambda i: fn(
            ctypes.byref(p), 0, stream),
        "two torch.cumsum": lambda i: [torch.cumsum(x, 1) for x in tiny],
    }
    for rnd in range(2):
        for name, f in host.items():
            t = cs.time_ms(torch, f, iters=2000, warmup=100)
            print(f"host, round {rnd + 1}: cummean {name}: {t * 1e3:.2f} us "
                  f"per back-to-back call on (2, 4, 8) bf16 [{card}]",
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kv_merge_probe: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import kv_merge as kvm

    args = sys.argv[1:]
    parts = [a[2:] for a in args if a in ("--merge", "--cummean")] \
        or ["merge", "cummean"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = ROOT / "build" / "kv_merge_probe"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(2) as pool:     # every nvcc started together
        built = {part: pool.submit(build, _build, out, stem, variants)
                 for part, stem, variants in (
                     ("merge", "kv_merge", VARIANTS),
                     ("cummean", "kv_cummean", CUMMEAN_VARIANTS))
                 if part in parts}
        built = {k: f.result() for k, f in built.items()}
    if "merge" in built:
        merge_probe(torch, cs, kvm, _build, built["merge"], card)
    if "cummean" in built:
        cummean_probe(torch, cs, kvm, _build, built["cummean"], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
