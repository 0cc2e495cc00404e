"""End-to-end training script on the PyTorch/CUDA port: CCM compression
training with the full loop (checkpoint/restart, watchdog, deterministic
data, optional gradient codec), the counterpart of
``examples/train_online.py``.  It runs on the CUDA card unless given
``--device cpu``.

    # CPU-sized default (~20M params, a few hundred steps):
    python examples/train_online_torch.py --steps 200

    # ~100M-param configuration:
    python examples/train_online_torch.py --preset 100m --steps 300

    # any registry architecture at smoke scale (the dense ones train):
    python examples/train_online_torch.py --arch qwen2-0.5b --smoke

    # on the CPU; run again with more --steps to resume:
    python examples/train_online_torch.py --device cpu --steps 100 \\
        --ckpt ckpt_dir

A ``--grad-codec`` acts on the data-parallel reduce, so on one device it
trains exactly as "none" (as the reference does without a mesh).

    # conditional-LoRA ablation (paper Table 5) on the paper's tiny task:
    python examples/train_online_torch.py --ablate-lora
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import masks as M  # noqa: E402
from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.launch.train import TrainLoop  # noqa: E402
from repro_torch.models.config import CCMConfig, ModelConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

CKPT_EVERY = 50

PRESETS = {
    # ~20M params
    "cpu": ModelConfig(
        name="ccm-20m", family="dense", n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=2, d_ff=1024, vocab_size=8192, train_mode="lora",
        ccm=CCMConfig(comp_len=2, max_steps=4)),
    # ~100M params
    "100m": ModelConfig(
        name="ccm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=16384,
        train_mode="lora", ccm=CCMConfig(comp_len=4, max_steps=8)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="cpu", choices=list(PRESETS))
    ap.add_argument("--arch", default=None, help="registry arch id")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ccm_ckpt_torch"))
    ap.add_argument("--grad-codec", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ablate-lora", action="store_true",
                    help="compare conditional vs default LoRA")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke) if args.arch \
        else PRESETS[args.preset]
    print(f"model: {cfg.name}  params~{cfg.param_count() / 1e6:.1f}M  "
          f"train_mode={cfg.train_mode}")
    t, m = cfg.ccm.max_steps, max(cfg.ccm.comp_len, 1)
    layout = M.segment_layout(t, 12, m, 16)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps)

    if args.ablate_lora:
        base = C.pretrain_base(args.steps, device=args.device)
        for cond in (True, False):
            p = C.train_compression(base, C.bench_cfg(), args.steps,
                                    unconditional=not cond,
                                    device=args.device)
            acc = C.eval_at_timesteps(p, C.bench_cfg(), ts=(4,),
                                      unconditional=not cond,
                                      device=args.device)[4]
            print(f"{'conditional' if cond else 'default    '} LoRA "
                  f"acc@t4 = {acc:.3f}")
        return 0

    loop = TrainLoop(cfg, layout, opt, batch_size=args.batch,
                     ckpt_dir=args.ckpt, ckpt_every=CKPT_EVERY,
                     grad_codec=args.grad_codec, device=args.device)
    start = loop.maybe_restore()
    if start:
        print(f"resumed from checkpoint at step {start}")
    hist = loop.run(args.steps, start_step=start, log_every=20)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} "
              f"(start {hist[0]['loss']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
