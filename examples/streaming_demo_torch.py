"""Unbounded-stream demo on the PyTorch/CUDA port (paper Fig. 8/9; the
counterpart of ``examples/streaming_demo.py``): process an arbitrarily
long token stream with a FIXED KV budget — sliding window + attention
sink, evicted blocks compressed into CCM memory instead of dropped.  It
runs on the CUDA card unless given ``--device cpu``.

    python examples/streaming_demo_torch.py --tokens 2048
    python examples/streaming_demo_torch.py --device cpu --steps 100
"""
import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import streaming as ST  # noqa: E402
from repro_torch.data.synthetic import generator, lm_stream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.models.config import CCMConfig  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ccm = CCMConfig(comp_len=2, max_steps=4, stream_window=64,
                    stream_sink=4, stream_chunk=16, stream_mem_slots=8)
    cfg = C.bench_cfg().replace(ccm=ccm)
    print("training model + compression adapter...")
    base = C.pretrain_base(args.steps, device=dev)
    params = C.train_compression(base, cfg, args.steps, device=dev)

    toks = lm_stream(generator(5), 4, args.tokens, cfg.vocab_size,
                     device=dev)
    for name, ccm_on in (("CCM streaming", True),
                         ("StreamingLLM (drop)", False)):
        st = ST.init_stream_state(cfg, 4, device=dev)
        nll = torch.zeros((), dtype=torch.float64, device=dev)
        cnt = 0
        with torch.no_grad():
            for i in range(0, args.tokens - 16, 16):
                lg, st = ST.stream_step(params, cfg, st, toks[:, i:i + 16],
                                        ccm_on=ccm_on)
                lp = torch.log_softmax(lg.float()[:, :-1], -1)
                tgt = toks[:, i + 1:i + 16].long()
                nll += -torch.gather(lp, -1, tgt[..., None]).sum().double()
                cnt += tgt.numel()
        kv_now = int(st.win_len) + int(st.mem.slots) * cfg.ccm.comp_len
        print(f"{name:22s}: {args.tokens} tokens streamed, "
              f"KV in use {kv_now} (budget "
              f"{ccm.stream_window + ccm.stream_mem_slots*ccm.comp_len}), "
              f"ppl {math.exp(float(nll) / cnt):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
