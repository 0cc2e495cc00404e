"""Online serving demo on the PyTorch/CUDA port (the paper's
conversation/personalization scenario; the counterpart of
``examples/serve_online.py``): user context arrives turn by turn, each
turn is compressed into memory; queries are served from [Mem, I(t)] with
bounded KV.  It runs on the CUDA card unless given ``--device cpu``.

    python examples/serve_online_torch.py
    python examples/serve_online_torch.py --device cpu --steps 100
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import inference as I  # noqa: E402
from repro_torch.data.synthetic import generator, sample_kv_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.obs.clock import perf_counter  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    turns, users = args.turns, args.users

    print("training serving model + compression adapter...")
    base = C.pretrain_base(args.steps, device=dev)
    cfg = C.bench_cfg()
    params = C.train_compression(base, cfg, args.steps, device=dev)

    layout = C.layout_for(turns)
    batch = sample_kv_batch(generator(3), layout, users, C.TASK,
                            device=dev)
    toks = batch["tokens"]
    sl = layout.chunk_len + layout.comp_len

    with torch.no_grad():
        state = I.init_online_state(cfg, users, max_cache_len=64, device=dev)
        t_comp = 0.0
        for j in range(turns):
            chunk = toks[:, j * sl:(j + 1) * sl - layout.comp_len]
            _sync(dev)
            t0 = perf_counter()
            state = I.ingest_context(params, cfg, state, chunk)
            _sync(dev)
            t_comp += perf_counter() - t0
            raw_kv = C.kv_bytes(cfg, (j + 1) * layout.chunk_len) / 1024
            mem_kv = C.kv_bytes(cfg, int(state.mem.slots)
                                * cfg.ccm.comp_len) / 1024
            print(f"turn {j+1}: full-context KV would be {raw_kv:7.1f} KiB; "
                  f"compressed memory is {mem_kv:5.1f} KiB")

        query = toks[:, turns * sl:]
        t0 = perf_counter()
        logits, _ = I.prefill(params, cfg, state, query, full_logits=True)
        _sync(dev)
        t_q = perf_counter() - t0
    pred = torch.argmax(logits[:, :-1], dim=-1)
    lm = batch["loss_mask"]
    acc = float(((pred == query[:, 1:]) * lm).sum() / lm.sum())
    print(f"\nserved {users} users: compress {t_comp*1e3:.0f} ms total, "
          f"query {t_q*1e3:.0f} ms, accuracy from memory {acc:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
