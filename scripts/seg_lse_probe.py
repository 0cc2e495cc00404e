#!/usr/bin/env python3
"""The segmented kernel's mma.sync route (bf16 q, Sq > 2) of two checkouts
output for output, at ``chip_smoke.py`` phase 17a's shapes, on one CUDA
GPU.

    python3 scripts/seg_lse_probe.py --save OUT.pt [--src DIR]
    python3 scripts/seg_lse_probe.py --against OUT.pt

``--save`` builds the kernel of the ``repro_torch`` under DIR (default:
this checkout's ``src``), runs it without the log-sum-exp at each of
phase 17a's cases (inputs from their seeds) and writes the outputs to
OUT.pt.  ``--against`` runs this checkout's kernel at the same cases,
without and with the log-sum-exp, and holds each output bit-equal to the
saved one: the route's arithmetic does not change with the lse.  Exits
non-zero on a difference, and without a card.
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
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("seg_lse_probe: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from repro_torch.core.inference import quantize_kv
    from repro_torch.kernels import decode_attention as dattn
    sys.path.insert(1, str(ROOT))
    from chip_smoke import MMA_LSE_CASES, mma_lse_inputs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"repro_torch from {Path(dattn.__file__).parents[2]} [{card}]",
          flush=True)
    outs = {}
    for case in MMA_LSE_CASES:
        q, segs, qi, qs, scale, _ = mma_lse_inputs(torch, quantize_kv,
                                                   **case)
        outs[case["label"]] = dattn.segmented_flash_attention(
            q, segs, qi, qs, scale).cpu()
        if "--against" in sys.argv:
            with_lse, _ = dattn.segmented_flash_attention(q, segs, qi, qs,
                                                          scale, lse=True)
            outs[case["label"] + " (lse)"] = with_lse.cpu()
    if "--save" in sys.argv:
        torch.save(outs, sys.argv[sys.argv.index("--save") + 1])
        print(f"saved {len(outs)} outputs", flush=True)
        return 0
    saved = torch.load(sys.argv[sys.argv.index("--against") + 1])
    bad = []
    for name, out in outs.items():
        same = torch.equal(out, saved[name.replace(" (lse)", "")])
        print(f"  {name}: {tuple(out.shape)} "
              f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
        if not same:
            bad.append(name)
    if bad:
        print(f"seg_lse_probe: {bad} differ from the saved outputs",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
