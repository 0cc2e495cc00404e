#!/usr/bin/env python3
"""Where the float32 cross-check of the recurrent families
(``chip_smoke.py`` phase 11b) stands as depth grows, on one CUDA card.

    python3 scripts/recurrent_xcheck_probe.py

Phase 11b runs the first layers of mamba2-370m and zamba2-1.2b at their
published widths in float32 on the card (the kernels) and on the CPU
(their plain versions), and holds the online path's logits and state
and ``train_forward``'s loss, logits and gradients to 1e-3 x max|.|.
For each depth cut below this script prints the worst ratio of each
kind for five pairs of runs, the last run of each pair the yardstick:

  cuda / cpu        the comparison 11b holds;
  cpu nudged / cpu  the CPU on weights moved by one float32 ulp each
                    (``nudge``): how strongly the model amplifies a
                    rounding-sized change of its weights at that depth;
  cuda / cpu64      the card against the CPU in float64 (compute and
                    weights; every plain version and the SSD widen to
                    float64 there, ``kernels/ref.widen``);
  cpu / cpu64       the CPU's float32 against its float64;
  cuda concat / cpu64  the card with ``attn_impl="concat"`` (dense
                    attention instead of the CCM and segmented kernels).

cuda / cpu64 and cpu / cpu64 are each float32 run's own error.  The
nudge moves only the weights, once, in one random direction.  Then
``layerwise`` follows zamba2's training forward at 13 layers step by
step: the error of the residual stream after each step (propagated) and
the error each step adds when fed float64's input (local), card and CPU
each against float64: a card whose steps are each as precise as the
CPU's but whose stream ends farther off is amplifying rounding, not
computing less precisely.  Seed-0 float32 weights (LoRA ``b`` drawn at
random, as in ``chip_smoke.py``), CCM concat.  Exits non-zero without a
card.
"""
from __future__ import annotations

import math
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (config, depth cuts): the hybrid's cuts keep at least 2 groups; 38 is
# its full depth
CUTS = (("mamba2-370m", (dict(n_layers=13),)),
        ("zamba2-1.2b", (dict(n_layers=5, attn_every=2),
                         dict(n_layers=9, attn_every=4),
                         dict(n_layers=13), dict(n_layers=38))))
# the cut whose training forward is followed step by step
LAYERWISE = ("zamba2-1.2b", dict(n_layers=13))


def nudge(torch, tree, seed: int):
    """A copy of a float32 parameter tree with every element moved one
    float32 ulp up or down at random (seeded): a rounding-sized change of
    the weights."""
    gen = torch.Generator().manual_seed(seed)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        up = torch.rand(x.shape, generator=gen) < 0.5
        to = torch.where(up, torch.tensor(math.inf), torch.tensor(-math.inf))
        return torch.nextafter(x, to.to(x.device))
    return one(tree)


def layerwise(torch, cs, m, params, cfg, cut, card):
    """``train_forward`` (no gradients) at one depth cut, followed step by
    step through ``transformer.layer_plan``.  Propagated: the residual
    stream after each step in float32 on the card and on the CPU against
    float64 on the CPU.  Local: each step alone, fed float64's input
    rounded to float32, against float64's output of that step: the error
    the step itself adds.  Each printed as max|d| / max|float64|,
    card/cpu."""
    PT = m.PT
    inp = cs.xcheck_inputs(torch, m, cfg, cut)
    c32 = inp.cfg
    c64 = c32.replace(compute_dtype="float64", param_dtype="float64")
    steps = {"mamba": PT._mamba_block, "site": PT._attn_mlp_block}
    out, calls = {}, []

    def conv(x, dev):
        """x on ``dev`` in float32 (``c32`` for a config)."""
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32) if x.is_floating_point() \
                else x.to(dev)
        if isinstance(x, tuple):
            ys = [conv(v, dev) for v in x]
            return type(x)(*ys) if hasattr(x, "_fields") else tuple(ys)
        if isinstance(x, dict):
            return {k: conv(v, dev) for k, v in x.items()}
        return c32 if x is c64 else x

    def first(kind, y):
        return (y[0] if kind == "mamba" else y).detach().double().cpu()

    def run(c, dev):
        rec = out.setdefault((c.compute_dtype, dev), [])

        def wrap(kind, fn):
            def f(*a, **k):
                y = fn(*a, **k)
                rec.append((kind, first(kind, y)))
                if c is c64:
                    calls.append((kind, a, k))
                return y
            return f
        pp = m.PP.tree_map(lambda _, x: x.to(c.pdtype), cs.fp32_layers(
            torch, params, dev, c.n_layers))
        PT._mamba_block = wrap("mamba", steps["mamba"])
        PT._attn_mlp_block = wrap("site", steps["site"])
        try:
            with torch.no_grad():
                lg = PT.train_forward(pp, c, inp.batch["tokens"].to(dev),
                                      inp.layout)
        finally:
            PT._mamba_block, PT._attn_mlp_block = steps["mamba"], steps["site"]
        rec.append(("logits", lg.double().cpu()))
    run(c64, "cpu")
    run(c32, "cpu")
    run(c32, "cuda")
    ref = out[("float64", "cpu")]
    rows, local = [], []
    for i, (kind, h) in enumerate(ref):
        scale = h.abs().max().item()
        e = [(out[k][i][1] - h).abs().max().item() / scale
             for k in (("float32", "cuda"), ("float32", "cpu"))]
        rows.append(f"{i}:{kind} {e[0]:.2e}/{e[1]:.2e}")
        if i < len(calls):
            _, a, k = calls[i]
            with torch.no_grad():
                e = [(first(kind, steps[kind](*conv(a, d), **conv(k, d)))
                      - h).abs().max().item() / scale for d in ("cuda", "cpu")]
            local.append(f"{i}:{kind} {e[0]:.2e}/{e[1]:.2e}")
    cs.log(f"  layerwise {cfg.name} {cut} train_forward, max|d| / max|f64| "
           "after each step, card/cpu: propagated " + ", ".join(rows)
           + "; local " + ", ".join(local) + f" [{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("recurrent_xcheck_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.core import inference as PI
    from repro_torch.core.masks import segment_layout
    from repro_torch.data import synthetic as PD
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as PT
    from repro_torch.optim import partition as PP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    m = types.SimpleNamespace(PI=PI, TR=TR, PT=PT, PD=PD, PP=PP,
                              segment_layout=segment_layout)
    for arch, cuts in CUTS:
        cfg = get_config(arch)
        params = PT.init_lm(cfg, seed=0)
        if cfg.ccm.enabled:
            cs.randomize_lora_b(torch, params, seed=100)
        for cut in cuts:
            inp = cs.xcheck_inputs(torch, m, cfg, cut)
            n = inp.cfg.n_layers
            nudged = nudge(torch, cs.fp32_layers(torch, params, "cpu", n), 1)

            def variant(**over):
                return types.SimpleNamespace(
                    **{**vars(inp), "cfg": inp.cfg.replace(**over)})
            runs = {"cuda": cs.xcheck_run(torch, m, params, inp, "concat",
                                          "cuda"),
                    "cuda concat": cs.xcheck_run(
                        torch, m, params, variant(attn_impl="concat"),
                        "concat", "cuda"),
                    "cpu": cs.xcheck_run(torch, m, params, inp, "concat",
                                         "cpu"),
                    "cpu nudged": cs.xcheck_run(torch, m, nudged, inp,
                                                "concat", "cpu"),
                    "cpu64": cs.xcheck_run(
                        torch, m, params, variant(compute_dtype="float64",
                                                  param_dtype="float64"),
                        "concat", "cpu")}
            for a, b in (("cuda", "cpu"), ("cpu nudged", "cpu"),
                         ("cuda", "cpu64"), ("cpu", "cpu64"),
                         ("cuda concat", "cpu64")):
                worst, over = {}, []
                cs.xcheck_compare(runs[a], runs[b], "concat", worst, over)
                cs.log(f"  {arch} {cut} {a} / {b}: worst max|d| / (1e-3 "
                       "max|.|): " + ", ".join(
                           f"{k} {v:.3f}" for k, v in sorted(worst.items()))
                       + f"; {len(over)} tensors past 1.0 [{card}]")
        if arch == LAYERWISE[0]:
            layerwise(torch, cs, m, params, cfg, LAYERWISE[1], card)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
