#!/usr/bin/env python3
"""How far apart two bf16 runs of the port's streaming path land at the
full width and depth of LLaMA-7B, on one CUDA card.

    python3 scripts/stream_precision_probe.py

``chip_smoke.py`` phase 8 holds bf16 logits through 32 layers against
another run of the same step: the dense oracle (``impl="concat"``), or
the same session run alone where the serve engine ran it in a batch.
This script measures the gap of each pair in units of ``bf16_tol`` (two
bf16 ulps of the largest logit), beside the gap between the dense oracle
and the same oracle with its attention computed in float32:

  1. one eviction step (a 64-token chunk, and a single token) of a
     window of 512 and of 4096 tokens, B=2: the segmented kernels
     against ``impl="concat"`` and against ``impl="concat"`` with a
     float32 attention, for the logits and the newest compressed group;
  2. ``ServeEngine`` stream sessions (window 512, 6 sessions on 4 slots,
     12 requests of 33-64 tokens each, the traffic of phase 8d) against
     each session run alone, unpadded and padded to the engine's 64-token
     bucket, request by request.

Random bf16 weights from seed 0 (LoRA ``b`` drawn at random, as in
``chip_smoke.py``).  Exits non-zero without a card.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def held_step(torch, CS, STR, A, params, cfg, W: int, n_chunks: int,
              width: int):
    """Gaps of one eviction step after ``n_chunks`` chunks of 64."""
    rc = cfg.replace(ccm=dataclasses.replace(cfg.ccm, stream_window=W))
    gen = torch.Generator(device="cuda").manual_seed(5)
    st = STR.init_stream_state(rc, 2, device="cuda")
    for _ in range(n_chunks):
        t = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                          device="cuda")
        _, st = STR.stream_step(params, rc, st, t)
    t = torch.randint(0, cfg.vocab_size, (2, width), generator=gen,
                      device="cuda")
    if not STR.eviction_pending(rc, st, width):
        raise AssertionError("the held step would not evict")
    dense = A.attend_dense

    def dense32(q, k, v, mask, scale):
        return dense(q.float(), k.float(), v.float(), mask, scale).to(q.dtype)

    runs = {}
    for name, impl, attend in (("kernels", None, dense),
                               ("concat", "concat", dense),
                               ("concat-fp32", "concat", dense32)):
        A.attend_dense = attend
        try:
            lg, s2 = STR.stream_step(params, rc, CS.clone_state(torch, st),
                                     t, impl=impl)
        finally:
            A.attend_dense = dense
        e, m = s2.mem.slots, rc.ccm.comp_len
        runs[name] = (lg, s2.mem.k[:, :, (e - 1) * m:e * m])
    label = f"W {W}, {'chunk' if width > 1 else 'single token'}"
    for a, b in (("kernels", "concat"), ("kernels", "concat-fp32"),
                 ("concat", "concat-fp32")):
        gaps = [CS.max_err(x, y) / CS.bf16_tol(y)
                for x, y in zip(runs[a], runs[b])]
        print(f"  {label}: {a} vs {b}: logits {gaps[0]:.3f}, group "
              f"{gaps[1]:.3f} x bf16_tol", flush=True)
    torch.cuda.empty_cache()


def engine_vs_alone(torch, np, CS, STR, params, cfg):
    from repro_torch.serve import ServeEngine
    scfg = cfg.replace(ccm=dataclasses.replace(cfg.ccm, stream_window=512))
    rs = np.random.default_rng(41)
    sids = [f"s{i}" for i in range(6)]
    chunks = {sid: [rs.integers(0, cfg.vocab_size, int(rs.integers(33, 65))
                                ).astype(np.int32) for _ in range(12)]
              for sid in sids}
    eng = ServeEngine(params, scfg, n_slots=1, cache_len=64, stream_slots=4,
                      device="cuda")
    for sid in sids:
        eng.create_session(sid, kind="stream")
    reqs = {sid: [] for sid in sids}
    for r in range(12):
        for sid in sids[r % 6:] + sids[:r % 6]:
            reqs[sid].append(eng.stream(sid, chunks[sid][r]).request)
        eng.run()
    torch.cuda.synchronize()
    for padded in (False, True):
        worst = 0.0
        for sid in sids:
            st = STR.init_stream_state(scfg, 1, device="cuda")
            gaps = []
            for t, req in zip(chunks[sid], reqs[sid]):
                n = len(t)
                buf = np.zeros((1, 64 if padded else n), np.int32)
                buf[0, :n] = t
                want, st = STR.stream_step(
                    params, scfg, st, torch.as_tensor(buf, device="cuda"),
                    valid_len=np.array([n]) if padded else None)
                want = want[0, :n].float().cpu()
                gaps.append(CS.max_err(torch.from_numpy(req.result), want)
                            / CS.bf16_tol(want))
            worst = max(worst, max(gaps))
            print(f"  engine vs alone{' (padded)' if padded else ''} {sid}:"
                  f" {[round(g, 3) for g in gaps]} x bf16_tol", flush=True)
        print(f"  engine vs alone{' (padded)' if padded else ''}: worst "
              f"{worst:.3f} x bf16_tol", flush=True)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stream_precision_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.configs import llama_7b_paper
    from repro_torch.core import streaming as STR
    from repro_torch.kernels import _build
    from repro_torch.models import attention as A
    from repro_torch.models.transformer import init_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    cfg = llama_7b_paper.config()
    params = init_lm(cfg, seed=0)
    CS.randomize_lora_b(torch, params, seed=100)
    for W, n, width in ((512, 9, 64), (512, 9, 1), (4096, 65, 64)):
        held_step(torch, CS, STR, A, params, cfg, W, n, width)
    engine_vs_alone(torch, np, CS, STR, params, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
