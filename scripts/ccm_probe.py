#!/usr/bin/env python3
"""Where the bf16 CCM attention kernels spend their time, on one CUDA GPU.

    python3 scripts/ccm_probe.py

1. Device ms of the three kernels (forward, backward dQ pass, backward
   dK/dV pass) at the training shape (B 4, H 32, hd 128, the layout of
   16 steps of 64 + 8 <COMP> tokens and a 64-token tail, S 1216) and at
   a one-segment causal layout of the same S (more key tiles per q
   tile), with the microseconds per tile and block slot (2 blocks per
   SM), the blocks per SM and SDPA's causal forward beside them.
2. The forward and the dK/dV pass built from patched copies of
   ``csrc/ccm_attention.cu``, each with one part taken out or undone
   (the mask, the dK/dV pass's register copy of each chunk's q-row
   metadata, Q K^T, P V, the exponentials, the K/V loads), timed in
   turns at the training shape.  An ablated variant computes garbage;
   only its time is read.

Builds into ``build/ccm_probe/`` at the checkout root.  Needs the card,
nvcc and nothing else; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OCCUPANCY = '''
extern "C" int probe_blocks_per_sm(int D, int nts, int nq, int which) {
  int n = -1;
  const int big = 227 * 1024;
  if (which == 0) {
    cudaFuncSetAttribute(ccm_attention_fwd_mma_kernel<128, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize, big);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ccm_attention_fwd_mma_kernel<128, 64>, 128, QLayout(D, nts, false).total);
  } else if (which == 1) {
    cudaFuncSetAttribute(ccm_attention_bwd_dq_mma_kernel<128, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize, big);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ccm_attention_bwd_dq_mma_kernel<128, 64>, 128, QLayout(D, nts, true).total);
  } else {
    cudaFuncSetAttribute(ccm_attention_bwd_dkdv_mma_kernel<128, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, big);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ccm_attention_bwd_dkdv_mma_kernel<128, 1>, 128, KLayout(D, nq).total);
  }
  return n;
}
'''


def in_forward(src: str, old: str, new: str) -> str:
    """Replace the first ``old`` inside the forward kernel's body."""
    start = src.index("ccm_attention_fwd_mma_kernel(const")
    end = src.index("// backward pass 1: dQ and Delta = rowsum")
    body = src[start:end]
    if old not in body:
        raise RuntimeError(f"probe patch does not apply: {old!r}")
    return src[:start] + body.replace(old, new, 1) + src[end:]


def everywhere(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"probe patch does not apply: {old!r}")
    return src.replace(old, new)


def dkdv_per_element(src: str) -> str:
    col = "qc + j * 8 + 2 * tq + u"
    for old, new in (
            ("shows(km[e >> 1], rq[j][u], rg[j][u])",
             f"shows(km[e >> 1], qi[{col}], qs[{col}])"),
            ("sT[j][e] * sl2 - rl[j][u]", f"sT[j][e] * sl2 - ls[{col}] * LOG2E"),
            ("(dpT[j][e] - rd[j][u])", f"(dpT[j][e] - ds[{col}])")):
        src = everywhere(src, old, new)
    return src


VARIANTS = {
    "kernel as is": lambda s: s,
    "no mask": lambda s: in_forward(
        s, "const bool vis = shows(km[c0 + n * 8 + 2 * tq + (e & 1)], "
        "qi[hh], qg[hh]);", "const bool vis = true;"),
    "dK/dV: q-row metadata from shared memory per element":
        lambda s: dkdv_per_element(s),
    "no Q K^T": lambda s: in_forward(
        s, "qk_tile<NKS, NKT>(s, qw, kst + c0 * rse, rse, nks, lane);", ""),
    "no P V": lambda s: in_forward(
        s, "pv_tile<NKT, NDT>(o, s, vst + c0 * rse, rse, 0, ndt, lane);", ""),
    "no exponentials": lambda s: in_forward(
        s, "s[n][e] = exp2f(s[n][e] - mu[e >> 1]);",
        "s[n][e] = s[n][e] - mu[e >> 1];"),
    "no K/V loads after the first tile": lambda s: everywhere(
        s, """    key_rows_async(kst, kst + TB * B.rse, B.rse, B.meta + ((i + 1) % 3) * TB,
                   B.k, p.k_s, B.v, p.v_s, p.D, 128);""", ""),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ccm_probe: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.core.masks import segment_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels import ccm_attention as ca

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = ROOT / "build" / "ccm_probe"
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    src = (_build.CSRC / "ccm_attention.cu").read_text()
    procs = {}
    for i, (name, patch) in enumerate(VARIANTS.items()):
        (out / f"v{i}.cu").write_text(patch(src) + OCCUPANCY)
        procs[name] = (out / f"v{i}.so", subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"v{i}.so"),
             str(out / f"v{i}.cu")], stdout=open(out / f"v{i}.log", "w"),
            stderr=subprocess.STDOUT))
    for name, (_, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for the variant {name!r}")
    libs = {name: ctypes.CDLL(str(so)) for name, (so, _) in procs.items()}

    def use(name):
        _build._libs["ccm_attention"] = libs[name]
        ca._fns = None

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, D = 4, 32, 128
    lay = segment_layout(16, 64, 8, 64)
    S = lay.seq_len
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    zeros = torch.zeros(S, dtype=torch.int32, device=dev)
    layouts = {
        "training layout": (idx, lay.seg_ids.to(dev), idx, lay.seg_ids.to(dev),
                            lay.comp_mask.to(dev), None),
        "one-segment causal": (idx, zeros, idx, zeros, zeros.bool(), None)}
    sets = [tuple(torch.randn((B, H, S, D), generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(4)) for _ in range(4)]
    scale = D ** -0.5

    use("kernel as is")
    occ = libs["kernel as is"].probe_blocks_per_sm
    occ.restype = ctypes.c_int
    nq = -(-S // 64)
    blocks = [occ(D, 2 * nq, nq, w) for w in range(3)]
    print(f"blocks per SM at hd {D}, S {S}: forward {blocks[0]}, dQ pass "
          f"{blocks[1]}, dK/dV pass {blocks[2]}", flush=True)
    slots = blocks[0] * 132
    for name, meta in layouts.items():
        tiles = int(ca.plan(*meta, B, S, S, dev).q_count.sum())
        f = cs.device_ms(torch, lambda i: ca.ccm_attention_fwd(
            *sets[i % 4][:3], *meta, scale), 20, only="ccm_attention_fwd")
        saved = []
        for q, k, v, do in sets:
            o, lse = ca.ccm_attention_fwd(q, k, v, *meta, scale)
            saved.append((q, k, v, o, lse, do))

        def bwd(i):
            return ca.ccm_attention_bwd(*saved[i % 4], *meta, scale)
        dq = cs.device_ms(torch, bwd, 20, only="bwd_dq")
        dkdv = cs.device_ms(torch, bwd, 20, only="bwd_dkdv")
        per = f * 1e3 / (tiles * B * H / slots)
        print(f"{name}: {tiles} key tiles per (lane, head); forward "
              f"{f:.4f} ms ({per:.3f} us per tile and block slot), dQ pass "
              f"{dq:.4f} ms, dK/dV pass {dkdv:.4f} ms [{card}]", flush=True)
        del saved
    sdpa = cs.device_ms(torch, lambda i: F.scaled_dot_product_attention(
        *sets[i % 4][:3], is_causal=True, scale=scale), 20)
    print(f"SDPA causal forward at the same shape: {sdpa:.4f} ms [{card}]",
          flush=True)

    meta = layouts["training layout"]
    for rnd in range(2):
        for name in VARIANTS:
            use(name)
            t = cs.device_ms(torch, lambda i: ca.ccm_attention_fwd(
                *sets[i % 4][:3], *meta, scale), 20, only="ccm_attention_fwd")
            o, lse = ca.ccm_attention_fwd(*sets[0][:3], *meta, scale)
            b = cs.device_ms(torch, lambda i: ca.ccm_attention_bwd(
                *sets[0][:3], o, lse, sets[0][3], *meta, scale), 20,
                only="bwd_dkdv")
            print(f"ablation, round {rnd + 1}, {name}: forward {t:.4f} ms, "
                  f"dK/dV pass {b:.4f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
