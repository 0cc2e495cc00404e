#!/usr/bin/env python3
"""Where a float32 training step on the card departs from the CPU: the
CCM attention kernel alone, then LLaMA-7B's first 2 layers through the
train cell of ``launch/specs.py``.

    python3 scripts/ccm_train_probe.py

(1) The CCM attention op (``kernels/ops.ccm_attention``: the CUDA kernels
on the card) against its plain version in float64 on the CPU, forward
and backward, B4, 32 x 128 heads, over the CCM mask of two training
layouts: ``segment_layout(4, 32, 8, 32)`` (S 192) and the train cell's
at seq 512, ``train_layout`` = (16, 16, 8, 128); float32 and bf16.  Per
tensor (o, dq, dk, dv): max|d| / max|plain|.
(1b) The cond_lora op at M = 384 and 2048 likewise.
(2) The train cell (B4 and B1 at seq 512) at LLaMA-7B's
width, 2 layers, float32, random weights (LoRA b drawn too) and inputs
from seed 0: each trainable leaf's gradient
(the first moment over its clip factor) on the card with the kernels,
on the card with ``attn_impl="concat"`` (the dense masked attention in
plain PyTorch), each against the CPU: max|d| / (1e-3 max|CPU|).
Needs one CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rel(a, b) -> float:
    b = b.double()
    return ((a.double().cpu() - b.cpu()).abs().max()
            / b.abs().max().clamp_min(1e-300)).item()


def kernel_level(torch, ops, A, M):
    for lay in ((4, 32, 8, 32), (16, 16, 8, 128)):
        layout = M.segment_layout(*lay)
        S = layout.seq_len
        g = torch.Generator().manual_seed(1)
        B, H, D = 4, 32, 128
        q, k, v, do = (torch.randn(B, S, H, D, generator=g)
                       for _ in range(4))
        for dt in (torch.float32, torch.bfloat16):
            outs = {}
            for dev, t in (("cuda", dt), ("cpu", torch.float64)):
                info = A.KeyInfo(idx=torch.arange(S, dtype=torch.int32,
                                                  device=dev),
                                 seg=layout.seg_ids.to(dev),
                                 comp=layout.comp_mask.to(dev))
                x = [y.to(dev, t).requires_grad_(True) for y in (q, k, v)]
                o = ops.ccm_attention(*x, info, info, D ** -0.5)
                gr = torch.autograd.grad(o, x, do.to(dev, t))
                outs[dev] = (o.detach(),) + gr
            errs = [rel(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
            print(f"(1) layout {lay} S {S} {dt}: o {errs[0]:.3e} dq "
                  f"{errs[1]:.3e} dk {errs[2]:.3e} dv {errs[3]:.3e} "
                  "(max|d| / max|plain float64|)", flush=True)


def lora_level(torch, ops):
    """The cond_lora op (its CUDA kernel forward, its matmul backward)
    against the plain version in float64, float32, K = N = 4096, rank 8,
    the gate on 1 row in 3, at M = 384 and 2048 (B x S of phase 6's
    cross-check and of the train cell at seq 512)."""
    for M in (384, 2048):
        g = torch.Generator().manual_seed(3)
        K = N = 4096
        x, w = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g)
        a = torch.randn(8, K, generator=g) / 64
        b = torch.randn(8, N, generator=g) * 0.05
        gate = (torch.arange(M) % 3 == 0).float()
        dy = torch.randn(M, N, generator=g)
        outs = {}
        for dev, t in (("cuda", torch.float32), ("cpu", torch.float64)):
            xs = [y.to(dev, t).requires_grad_(True) for y in (x, w, a, b)]
            y = ops.cond_lora(*xs, gate.to(dev, t), 2.0)
            outs[dev] = (y.detach(),) + torch.autograd.grad(
                y, xs, dy.to(dev, t))
        errs = [rel(p, q) for p, q in zip(outs["cuda"], outs["cpu"])]
        print(f"(1b) cond_lora M {M}: y {errs[0]:.3e} dx {errs[1]:.3e} dw "
              f"{errs[2]:.3e} da {errs[3]:.3e} db {errs[4]:.3e} "
              "(max|d| / max|plain float64|)", flush=True)


def step_level(torch, get_config, specs, PP, PA, init_lm, seq=512, B=4):
    cfg = get_config("llama-7b").replace(n_layers=2, compute_dtype="float32",
                                         param_dtype="float32")
    params = init_lm(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(100)
    for name in ("q", "k", "v", "o"):    # LoRA b = 0 would hide the gate
        lb = params["layers"]["attn"]["lora"][name]["b"]
        lb.copy_(torch.randn(lb.shape, generator=gen) * 0.05)
    clip = PA.AdamWConfig().clip_norm
    spec = specs.ShapeSpec("train", seq, B)
    g = torch.Generator().manual_seed(2)
    batch = None
    grads = {}
    for label, c, dev in (("cuda kernels", cfg, "cuda"),
                          ("cuda concat", cfg.replace(attn_impl="concat"),
                           "cuda"),
                          ("cpu", cfg, "cpu")):
        cell = specs.build_train_cell(c, spec, None)
        if batch is None:
            batch = {k: (torch.randint(0, cfg.vocab_size, v.shape,
                                       generator=g, dtype=v.dtype)
                         if not v.dtype.is_floating_point else
                         torch.ones(v.shape)) for k, v in cell.args[3].items()}
        pp = PP.tree_map(lambda _, x: x.detach().clone().to(dev), params)
        tp, fp = PP.partition(pp, PP.tree_map(
            lambda _, x: x is not None, cell.args[0]))
        opt = PA.init_adamw(tp)
        out = cell.fn(tp, fp, opt, {k: v.to(dev) for k, v in batch.items()},
                      None)
        norm = out[2]["grad_norm"].item()
        f = 0.1 * min(1.0, clip / max(norm, 1e-9))
        grads[label] = {"/".join(p): (x / f).cpu()
                        for p, x in PP.leaves(out[1].mu)}
        grads[label]["loss"] = out[2]["loss"].detach().cpu()
        print(f"(2) seq {seq} B {B} {label}: loss "
              f"{out[2]['loss'].item():.6f} grad norm "
              f"{norm:.6f}", flush=True)
    for label in ("cuda kernels", "cuda concat"):
        r = {k: rel(grads[label][k], grads["cpu"][k]) * 1e3
             for k in grads["cpu"]}
        top = sorted(r.items(), key=lambda kv: -kv[1])
        print(f"(2) seq {seq} B {B} {label} vs cpu, "
              "max|d| / (1e-3 max|CPU|): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ccm_train_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.core import masks as M
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import attention as A
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP
    kernel_level(torch, ops, A, M)
    lora_level(torch, ops)
    for seq, B in ((512, 4), (512, 1)):
        step_level(torch, get_config, specs, PP, PA, init_lm, seq, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
