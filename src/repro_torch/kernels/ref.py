"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``).

Each one computes what its kernel computes, in float32 with one rounding
to the output type, as the Pallas kernels do.  The kernel ops run these
for tensors on the CPU; ``chip_smoke.py`` holds each CUDA/Triton kernel
against them on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

NEG_INF = -1e30


def _lanes(x, B: int, dtype, device) -> torch.Tensor:
    """(S,) shared or (B, S) per-lane metadata -> (B, S)."""
    x = torch.as_tensor(x, device=device).to(dtype)
    return x.expand(B, -1) if x.ndim == 1 else x


def ccm_attention_ref(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid,
                      scale: float) -> torch.Tensor:
    """Dense-mask attention oracle.

    q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D); metadata (S,) shared or (B, S)
    per lane (``k_valid`` None: every key valid).  Mask: (k_idx <= q_idx)
    & ((k_seg == q_seg) | k_comp) & k_valid.  Fully masked rows give
    exactly 0.  Computed in float32.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qi = _lanes(q_idx, B, torch.int32, dev)
    qs = _lanes(q_seg, B, torch.int32, dev)
    ki = _lanes(k_idx, B, torch.int32, dev)
    ks = _lanes(k_seg, B, torch.int32, dev)
    kc = _lanes(k_comp, B, torch.bool, dev)
    kv = torch.ones((B, Sk), dtype=torch.bool, device=dev) \
        if k_valid is None else _lanes(k_valid, B, torch.bool, dev)
    mask = (ki[:, None, :] <= qi[:, :, None]) \
        & ((ks[:, None, :] == qs[:, :, None]) | kc[:, None, :]) \
        & kv[:, None, :]                                   # (B, Sq, Sk)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    m = mask[:, None, None]
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = torch.where(mask.any(-1)[:, None, None, :, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _seg_layer_view(s: Dict[str, Any], key: str, B: int) -> Optional[torch.Tensor]:
    """The (B, S, ...) per-lane view of ``s[key]`` (k, v or a scale):
    picks the segment's layer out of a layer-major (L, B, S, ...) or
    lane-major (B, L, S, ...) stack; ``layer`` is an int or a (B,) tensor."""
    a = s.get(key)
    if a is None or s.get("layer") is None:
        return a
    layer = s["layer"]
    lane_major = bool(s.get("lane_major"))
    if isinstance(layer, torch.Tensor) and layer.ndim == 1:
        lanes = torch.arange(B, device=a.device)
        li = layer.to(a.device).long()
        return a[lanes, li] if lane_major else a[li, lanes]
    li = int(layer)
    return a[:, li] if lane_major else a[li]


def segmented_attention_ref(q, segs: Sequence[Dict[str, Any]], q_idx, q_seg,
                            scale: float) -> torch.Tensor:
    """Oracle for the segmented kernel: dense attend over the EXPLICIT
    concatenation of the segments (what the kernel never materializes).

    q (B, Sq, Hq, D).  Each seg a dict: k/v (B, S, Hkv, D), or a stack
    with ``layer`` set (layer-major (L, B, S, Hkv, D), or lane-major
    (B, L, S, Hkv, D) when ``lane_major``); int8 k/v with float32
    k_scale/v_scale of the same layout minus D; ``length`` an int, a (B,)
    tensor or None (fully valid); ``layer`` an int, a (B,) tensor or None;
    idx/seg/comp/valid (S,) or (B, S) metadata, or idx None for a
    memory-like segment (idx=-1, seg=0, comp=True).
    """
    B = q.shape[0]
    dev = q.device
    ks, vs, idxs, sgs, cps, vls = [], [], [], [], [], []
    for s in segs:
        k, v = _seg_layer_view(s, "k", B), _seg_layer_view(s, "v", B)
        ksc, vsc = _seg_layer_view(s, "k_scale", B), _seg_layer_view(s, "v_scale", B)
        k, v = k.float(), v.float()
        if ksc is not None:
            k = k * ksc[..., None].float()
            v = v * vsc[..., None].float()
        S = k.shape[1]
        ks.append(k)
        vs.append(v)
        if s.get("idx") is not None:
            idxs.append(_lanes(s["idx"], B, torch.int32, dev))
            sgs.append(_lanes(s["seg"], B, torch.int32, dev))
            cps.append(_lanes(s["comp"], B, torch.bool, dev))
            valid = torch.ones((B, S), dtype=torch.bool, device=dev) \
                if s.get("valid") is None \
                else _lanes(s["valid"], B, torch.bool, dev)
        else:
            idxs.append(torch.full((B, S), -1, dtype=torch.int32, device=dev))
            sgs.append(torch.zeros((B, S), dtype=torch.int32, device=dev))
            cps.append(torch.ones((B, S), dtype=torch.bool, device=dev))
            valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        length = s.get("length")
        if length is not None:
            L = torch.as_tensor(length, device=dev).reshape(-1, 1)
            valid = valid & (torch.arange(S, device=dev)[None, :] < L)
        vls.append(valid)
    k = torch.cat(ks, dim=1).transpose(1, 2)
    v = torch.cat(vs, dim=1).transpose(1, 2)
    out = ccm_attention_ref(
        q.transpose(1, 2), k, v, q_idx, q_seg,
        torch.cat(idxs, 1), torch.cat(sgs, 1), torch.cat(cps, 1),
        torch.cat(vls, 1), scale)
    return out.transpose(1, 2)


def cond_lora_ref(x, w, a, b, gate, scale: float,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x@w (+bias) + gate * ((x@a^T)@b) * scale, in float32, cast to
    x.dtype.  x (M, K); w (K, N); a (r, K); b (r, N); gate (M,)."""
    xf = x.float()
    y = xf @ w.float()
    if bias is not None:
        y = y + bias.float()
    d = ((xf @ a.float().T) @ b.float()) * scale
    return (y + d * gate.float()[:, None]).to(x.dtype)


def kv_merge_ref(mem, h, a: float) -> torch.Tensor:
    """Merge update (1 - a) * mem + a * h in float32, cast to mem.dtype;
    ``a`` is the runtime weight (1/t arithmetic mean, or the EMA alpha)."""
    a32 = torch.tensor(a, dtype=torch.float32, device=mem.device)
    return ((1 - a32) * mem.float() + a32 * h.float()).to(mem.dtype)


def kv_cummean_ref(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Running means of h along ``dim`` (merge-mode training), in float32
    with one rounding to h.dtype.  Under autograd its backward is the
    plain version of the kernel's reverse pass."""
    csum = torch.cumsum(h.float(), dim=dim)
    shape = [1] * h.ndim
    shape[dim] = h.shape[dim]
    denom = torch.arange(1, h.shape[dim] + 1, dtype=torch.float32,
                         device=h.device).reshape(shape)
    return (csum / denom).to(h.dtype)


def session_gather_ref(slab: torch.Tensor, ids) -> torch.Tensor:
    """Arena pack: ``slab[ids]`` (B, ...) out of (S, ...), a pure copy."""
    return slab[torch.as_tensor(ids, dtype=torch.long, device=slab.device)]


def session_scatter_ref(slab: torch.Tensor, ids,
                        rows: torch.Tensor) -> torch.Tensor:
    """Arena unpack: ``slab[ids] = rows`` in place; returns ``slab``."""
    slab[torch.as_tensor(ids, dtype=torch.long, device=slab.device)] = \
        rows.to(slab.dtype)
    return slab
