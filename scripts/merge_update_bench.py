#!/usr/bin/env python3
"""Time one merge-mode g_update (``core/memory.update_memory``) of
LLaMA-7B's compressed memory on one CUDA GPU, host issue included.

    python3 scripts/merge_update_bench.py [--src DIR]

``--src`` imports ``repro_torch`` from DIR (default: this checkout's
``src``), so two versions of the port can be compared in one run on one
card, in turns.  Cases (bf16, m 8, 32 KV heads of 128, B = 4 lanes):

  online     layer-major (32, 4, 8, 32, 128), every lane at the same t
             (``ingest_context`` of the online path);
  serve-32L  lane-major (4, 32, 8, 32, 128), lanes at t = 2, 3, 2, 3
             (the serve engine's staggered ingest batch at full depth);
  serve-4L   lane-major (4, 4, 8, 32, 128), lanes at t = 2, 3, 2, 3
             (the 4-layer merge engine of ``chip_smoke.py`` phase 7);
  layer-per-lane  layer-major with lanes at t = 2, 3, 2, 3.

Each case: 10 warm-up calls, then 3 windows of 50 back-to-back calls
between two CUDA events (the time per call is the larger of the host's
issue time and the device's), and the kernel launches per call.  A
version that refuses a case prints so.  Exits non-zero without a card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    src = ROOT / "src"
    if "--src" in sys.argv:
        src = Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
    sys.path.insert(0, str(src))
    import dataclasses
    import subprocess

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("merge_update_bench: no CUDA device; nothing run",
              file=sys.stderr)
        return 2
    from repro_torch.configs import llama_7b_paper
    from repro_torch.core import memory as M
    from repro_torch.kernels import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = llama_7b_paper.config()
    cfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, mode="merge"))
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    B, m, H, hd = 4, cfg.ccm.comp_len, cfg.n_kv_heads, cfg.hd
    stagger = np.array([1, 2, 1, 2], np.int64)          # t = 2, 3, 2, 3

    def state(L, lane_major, steps):
        shp = (B, L, m, H, hd) if lane_major else (L, B, m, H, hd)
        k, v = (torch.randn(shp, generator=g, device=dev).bfloat16()
                for _ in range(2))
        return M.MemState(k=k, v=v, slots=steps * 0 + 1, steps=steps,
                          stream_pos=steps * 72, lane_major=lane_major)

    cases = {"online": (32, False, 1), "serve-32L": (32, True, stagger),
             "serve-4L": (4, True, stagger),
             "layer-per-lane": (32, False, stagger)}
    print(f"repro_torch from {src} [{card}]", flush=True)
    for name, (L, lane_major, steps) in cases.items():
        mem = state(L, lane_major, steps)
        hk, hv = (torch.randn((L, B, m, H, hd), generator=g,
                              device=dev).bfloat16() for _ in range(2))

        def call():
            M.update_memory(cfg, mem, hk, hv, 72)
        try:
            call()
        except ValueError as e:
            print(f"  {name}: refused ({e})", flush=True)
            continue
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        launches = ops.launch_counts()["kv_merge_update"]
        per = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            per.append(start.elapsed_time(end) / 50)
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in per)} ms per "
              f"update_memory call, {launches} kv_merge launches a call "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
