#!/usr/bin/env python
"""Serve-metrics CLI on the PyTorch/CUDA port: drive a seeded engine
workload and print (or re-render) its metrics snapshot, the counterpart
of ``scripts/serve_metrics.py``.

Two modes:

  default          - build a tiny `repro_torch.serve.ServeEngine` (model
                     weights from seed 0, seeded traffic with offload
                     churn and a backpressured tenant) on one device, run
                     it, and emit the metrics snapshot
  --from-json SNAP - skip the engine: re-render a previously saved
                     ``metrics_snapshot()`` (or its bare ``["metrics"]``
                     registry) JSON file through
                     `repro_torch.obs.metrics.render_prometheus`

The demo runs at ``n_shards=1``: sharded serving (and so the reference
demo's per-shard labels, at ``n_shards=2``) comes with the multi-device
slice of the port.  It runs on the CUDA card unless given ``--device
cpu``.

Output formats (``--format``): ``json`` (the full snapshot, including
the derived ratios block) or ``prometheus`` (text exposition of the
registry).  ``--out FILE`` writes instead of printing.

    python scripts/serve_metrics_torch.py --format prometheus
    python scripts/serve_metrics_torch.py --device cpu --out snap.json
    python scripts/serve_metrics_torch.py --from-json snap.json \\
        --format prometheus

See docs/OBSERVABILITY.md for the metric catalog.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def demo_engine(device=None):
    """Small seeded workload exercising every instrumented path of one
    device: batching, padding waste, offload/restore churn, admission
    backpressure + pump and request tracing (``n_shards=1``)."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.models.config import CCMConfig, ModelConfig
    from repro_torch.obs import Observability
    from repro_torch.serve import ServeEngine, TenantQuota

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                      ccm=CCMConfig(comp_len=2, max_steps=4))
    params = T.init_lm(cfg, seed=0, device=device)
    eng = ServeEngine(
        params, cfg, n_slots=4, max_resident=3, cache_len=64,
        n_shards=1, batch_buckets=(1, 2, 4), admission_policy="block",
        max_queued_tokens=64,
        tenant_quotas={"small": TenantQuota(max_queued_tokens=16)},
        obs=Observability.tracing(), device=device)
    rng = np.random.RandomState(0)
    for s in range(6):
        eng.create_session(f"u{s}", tenant="small" if s >= 4 else "default")
    for rnd in range(6):
        for s in range(6):
            ln = (3, 5, 8)[rng.randint(3)]
            toks = rng.randint(0, cfg.vocab_size, size=ln).astype(np.int32)
            eng.ingest(f"u{s}", toks, priority=int(rng.randint(2)))
        eng.run(max_batches=2)
    for s in range(6):
        eng.query(f"u{s}", np.arange(4, dtype=np.int32))
    eng.run()
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The demo engine runs at n_shards=1 (sharded serving comes "
               "with the multi-device slice of the port).")
    ap.add_argument("--format", choices=("json", "prometheus"),
                    default="json")
    ap.add_argument("--out", default=None,
                    help="write to a file instead of stdout")
    ap.add_argument("--from-json", default=None, metavar="SNAP",
                    help="re-render a saved snapshot JSON instead of "
                         "running the demo engine")
    ap.add_argument("--device", default=None,
                    help="torch device of the demo engine (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)

    if args.from_json:
        with open(args.from_json) as f:
            snap = json.load(f)
        metrics = snap.get("metrics", snap)   # accept bare registry dicts
        if args.format == "prometheus":
            from repro_torch.obs.metrics import render_prometheus
            text = render_prometheus(metrics)
        else:
            text = json.dumps(snap, indent=1)
    else:
        eng = demo_engine(args.device)
        if args.format == "prometheus":
            text = eng.metrics_prometheus()
        else:
            text = json.dumps(eng.metrics_snapshot(), indent=1)

    if args.out:
        with open(args.out, "w") as f:
            f.write(text if text.endswith("\n") else text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
