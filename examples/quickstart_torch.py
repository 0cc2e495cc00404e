"""Quickstart on the PyTorch/CUDA port: train a compressed-context-memory
adapter on a tiny model and watch it answer queries whose evidence lives
ONLY in compressed memory (the counterpart of ``examples/quickstart.py``).
It runs on the CUDA card unless given ``--device cpu``.

    python examples/quickstart_torch.py
    python examples/quickstart_torch.py --device cpu --steps 100

Steps: (1) fine-tune a tiny decoder full-context on the synthetic online
KV task, (2) train the conditional-LoRA compression adapter (paper Alg. 1),
(3) run ONLINE inference — contexts arrive chunk by chunk, are compressed
into <COMP> KV memory (raw KV discarded), then queries are answered from
memory alone. Compare against no-context accuracy.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import inference as I  # noqa: E402
from repro_torch.core import masks as M  # noqa: E402
from repro_torch.data.synthetic import generator, sample_kv_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import CCMConfig  # noqa: E402


def _accuracy(logits, tail, lm) -> float:
    pred = torch.argmax(logits[:, :-1], dim=-1)
    return float(((pred == tail[:, 1:]) * lm).sum() / lm.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("1) fine-tuning base model (full context)...")
    base = C.pretrain_base(args.steps, device=dev)
    cfg = C.bench_cfg()
    print("2) training CCM-concat compression adapter...")
    params = C.train_compression(base, cfg, args.steps, device=dev)

    print("3) online inference with compressed context memory")
    layout = C.layout_for(C.T_MAX)
    batch = sample_kv_batch(generator(7), layout, 4, C.TASK, device=dev)
    toks = batch["tokens"]
    with torch.no_grad():
        state = I.init_online_state(cfg, 4, max_cache_len=32, device=dev)
        step = layout.chunk_len + layout.comp_len
        for j in range(layout.t_steps):
            chunk = toks[:, j * step:(j + 1) * step - layout.comp_len]
            state = I.ingest_context(params, cfg, state, chunk)
            raw = (j + 1) * layout.chunk_len
            comp = int(state.mem.slots) * cfg.ccm.comp_len
            print(f"   step {j+1}: context {raw:3d} tokens -> memory "
                  f"{comp:2d} KV slots (compression {raw/comp:.1f}x)")
        tail = toks[:, layout.t_steps * step:]
        logits, _ = I.prefill(params, cfg, state, tail, full_logits=True)
        lm = batch["loss_mask"]
        print(f"   query accuracy FROM MEMORY ONLY: "
              f"{_accuracy(logits, tail, lm):.3f}")

        # no-context control
        lo0 = M.segment_layout(0, C.CHUNK, C.COMP, C.TAIL)
        plain = cfg.replace(ccm=CCMConfig(enabled=False))
        lg0 = T.train_forward(base, plain, tail, lo0)
        print(f"   query accuracy WITHOUT context:  "
              f"{_accuracy(lg0, tail, lm):.3f}")
    print("done — compressed memory carries the task information.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
