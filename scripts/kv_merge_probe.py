#!/usr/bin/env python3
"""Where the merge-update kernel (``csrc/kv_merge.cu``) spends its time,
on one CUDA GPU.

    python3 scripts/kv_merge_probe.py

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

Builds into ``build/kv_merge_probe/`` at the checkout root.  Needs the
card, nvcc and nothing else; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kv_merge_probe: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import kv_merge as kvm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = ROOT / "build" / "kv_merge_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "kv_merge.cu").read_text()
    procs = {}
    for i, (name, patch) in enumerate(VARIANTS.items()):
        (out / f"v{i}.cu").write_text(patch(src))
        procs[name] = (out / f"v{i}.so", out / f"v{i}.log", subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"v{i}.so"), str(out / f"v{i}.cu")],
            stdout=open(out / f"v{i}.log", "w"), stderr=subprocess.STDOUT))
    for name, (_, log, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for the variant {name!r}:\n"
                               f"{log.read_text()[-3000:]}")
    libs = {name: ctypes.CDLL(str(so)) for name, (so, _, _) in procs.items()}
    for line in procs["kernel as is"][1].read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  as is: {line.strip()}", flush=True)

    def use(name):
        _build._libs["kv_merge"] = libs[name]
        kvm._fn = None

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
        for name in VARIANTS:
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
    kvm._fn = keep
    kvm.kv_merge_update_lanes_((mk, mv), (hk, hv), 0.5, 1)
    kvm._fn = fn
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
