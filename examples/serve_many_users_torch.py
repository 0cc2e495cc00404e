"""Multi-tenant serving demo on the PyTorch/CUDA port (the counterpart of
``examples/serve_many_users.py``): many users, interleaved arrivals,
bounded device state.  It runs on the CUDA card unless given
``--device cpu``.

Users arrive a few per round, each ingesting their context turn by turn
(compressed into CCM memory — never cached raw) and finally querying.
The serve engine continuously batches whatever mix of ops is pending
each round, packs the active sessions' arena rows into one step, and
LRU-offloads cold sessions to host when the arena is smaller than the
user population — total users exceed device slots with no semantic
effect (offload->restore is bit-exact).  At the end one user's session
is forked into an agent tree: branches share the parent's compressed
memory copy-on-write and diverge with private turns.

    python examples/serve_many_users_torch.py
    python examples/serve_many_users_torch.py --device cpu --steps 100
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.data.synthetic import generator, sample_kv_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.obs.clock import perf_counter  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--users", type=int, default=12)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--slots", type=int, default=6,
                    help="arena slots (< users: forces LRU offload)")
    ap.add_argument("--arrivals", type=int, default=3,
                    help="new users per round")
    ap.add_argument("--metrics", action="store_true",
                    help="print the engine's Prometheus metrics export "
                         "at the end (docs/OBSERVABILITY.md)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("training serving model + compression adapter...")
    base = C.pretrain_base(args.steps, device=dev)
    cfg = C.bench_cfg()
    params = C.train_compression(base, cfg, args.steps, device=dev)

    layout = C.layout_for(args.turns)
    batch = sample_kv_batch(generator(3), layout, args.users, C.TASK,
                            device="cpu")
    toks = batch["tokens"].numpy()
    sl = layout.chunk_len + layout.comp_len

    eng = ServeEngine(params, cfg, n_slots=args.slots, cache_len=64,
                      device=dev)
    progress = {}          # user -> turns ingested so far
    queries = {}           # user -> pending query Request
    arrived = 0
    rnd = 0
    t0 = perf_counter()
    while len(queries) < args.users:
        rnd += 1
        for u in range(arrived, min(arrived + args.arrivals, args.users)):
            eng.create_session(f"u{u}")
            progress[u] = 0
        arrived = max(arrived, min(arrived + args.arrivals, args.users))
        for u, t in list(progress.items()):
            if t < args.turns:
                chunk = toks[u, t * sl:(t + 1) * sl - layout.comp_len]
                eng.ingest(f"u{u}", chunk)
                progress[u] = t + 1
            elif u not in queries:
                queries[u] = eng.query(
                    f"u{u}", toks[u, args.turns * sl:]).request
        eng.run()
        mgr = eng._mgr["online"]
        offloads = sum(s.n_offloads for s in mgr.sessions.values())
        print(f"round {rnd:2d}: {arrived:2d}/{args.users} users arrived, "
              f"{mgr.n_resident}/{args.slots} resident, "
              f"occupancy {eng.occupancy()['online']:.2f}, "
              f"{offloads} offloads so far")
    wall = perf_counter() - t0

    # forked agent tree: branch the first user's finished session
    # copy-on-write.  Both branches attach to u0's arena row for free
    # (refcount, no clone); each branch's first ingest breaks the share
    # with one clone, so divergence costs exactly one row and the parent
    # never observes the branches' private turns.
    eng.fork_session("u0", "u0/a")
    eng.fork_session("u0", "u0/b")
    branches = {}
    for i, b in enumerate(("u0/a", "u0/b")):
        extra = toks[(i + 1) % args.users, :sl - layout.comp_len]
        eng.ingest(b, extra)                    # diverge: private turn
        branches[b] = eng.query(b, toks[0, args.turns * sl:]).request
    eng.run()
    parent = np.asarray(queries[0].result)
    diverged = [b for b, r in branches.items()
                if not np.allclose(np.asarray(r.result), parent)]
    print(f"\nforked u0 -> {sorted(branches)}: "
          f"{len(diverged)}/2 branches diverged from the parent "
          "(copy-on-write; u0's own state untouched)")

    lm = batch["loss_mask"].numpy()
    hits = tot = 0.0
    for u, req in queries.items():
        q = toks[u, args.turns * sl:]
        pred = np.argmax(np.asarray(req.result)[:-1], axis=-1)
        hits += ((pred == q[1:]) * lm[u]).sum()
        tot += lm[u].sum()
    toks_done = sum(s["tokens"] for s in eng.stats.values())
    print(f"\nserved {args.users} users over {rnd} rounds in "
          f"{wall:.2f} s ({toks_done} tokens, "
          f"{toks_done / wall:.0f} tok/s incl. compile)")
    print(f"compiled programs: {eng.compile_stats()} "
          f"({eng.compiled_programs()} total)")
    occ = eng.batch_occupancy()
    print(f"batch occupancy: ingest {occ['ingest']:.2f}, "
          f"query {occ['query']:.2f} "
          "(ragged token buckets pad mixed-length requests into shared "
          "batches; pad lanes are masked)")
    print(f"accuracy from compressed memory: {hits / tot:.3f}")
    if args.metrics:
        print("\n--- metrics (Prometheus text exposition) ---")
        print(eng.metrics_prometheus())
    return 0


if __name__ == "__main__":
    sys.exit(main())
