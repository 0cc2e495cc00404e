"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``).

Each one computes what its kernel computes, in float32 with one rounding
to the output type, as the Pallas kernels do (float64 inputs, which no
kernel takes, stay float64: ``widen``).  The kernel ops run these
for tensors on the CPU; ``chip_smoke.py`` holds each CUDA/Triton kernel
against them on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

NEG_INF = -1e30


def widen(x: torch.Tensor) -> torch.Tensor:
    """x in the type its arithmetic runs in: float32, or float64 for a
    float64 x (so a float64 run on the CPU is float64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
    qg = widen(q).reshape(B, Hkv, G, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(qg.dtype)) * scale
    m = mask[:, None, None]
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(qg.dtype))
    out = torch.where(mask.any(-1)[:, None, None, :, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def ccm_attention_streams_ref(q, k, v, q_idx, q_seg, plan,
                              scale: float) -> torch.Tensor:
    """The bf16 kernels' two-stream algorithm, in float32: each q tile
    runs one online softmax over the key-tile slots that ``plan`` (a
    ``kernels.ccm_attention.CcmPlan``) lists for it, in the kernel's
    order (the natural stream's tiles, then the <COMP> stream's), each
    slot's keys gathered by their key-table position and masked by their
    key-table k_idx, k_seg and flags.  Same arguments and result as
    ``ccm_attention_ref`` (the plan stands for the key metadata);
    differentiable in q, k and v."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    T = plan.tile
    dev = q.device
    qi = _lanes(q_idx, B, torch.int32, dev)
    qs = _lanes(q_seg, B, torch.int32, dev)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    kf, vf = k.float(), v.float()
    lanes = []
    for b in range(B):
        pb = b if plan.ktab.shape[0] > 1 else 0
        rows = []
        for t in range(plan.nq):
            r0, r1 = t * T, min(Sq, (t + 1) * T)
            qt = qf[b, :, :, r0:r1]                        # (Hkv, G, R, D)
            m = torch.full(qt.shape[:3], -torch.inf, device=dev)
            l = torch.zeros(qt.shape[:3], device=dev)
            acc = torch.zeros(qt.shape, device=dev)
            for slot in plan.q_tiles[pb, t, :int(plan.q_count[pb, t])].tolist():
                e = plan.ktab[pb, slot * T:(slot + 1) * T]      # (T, 4)
                pos = e[:, 0].clamp(min=0).long()
                vis = (e[None, :, 1] <= qi[b, r0:r1, None]) \
                    & (((e[None, :, 3] & 1) != 0)
                       | (e[None, :, 2] == qs[b, r0:r1, None]))  # (R, T)
                s = torch.einsum("hgrd,htd->hgrt", qt, kf[b, :, pos]) * scale
                s = torch.where(vis, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1))
                mu = torch.where(torch.isinf(m_new), 0.0, m_new)
                alpha = torch.exp(m - mu)
                p = torch.exp(s - mu[..., None])           # masked: 0
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] \
                    + torch.einsum("hgrt,htd->hgrd", p, vf[b, :, pos])
                m = m_new
            # a row that saw no key: l == 0, acc == 0 -> exactly 0
            rows.append(acc / torch.where(l > 0, l, 1.0)[..., None])
        lanes.append(torch.cat(rows, 2))
    return torch.stack(lanes).reshape(B, Hq, Sq, D).to(q.dtype)


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
        k, v = widen(k), widen(v)
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


def segmented_attention_lanes_ref(q, segs: Sequence[Dict[str, Any]], q_idx,
                                  q_seg, scale: float) -> torch.Tensor:
    """Batched oracle for lane-batched segmented attention: a plain
    Python loop over lanes, each lane attending its OWN segment slices
    through :func:`segmented_attention_ref`.

    q (N, Sq, Hq, D) with N the lane axis; each seg a dict: non-layered
    k/v (N, S, Hkv, D); layered ``lane_major`` k/v (N, L, S, Hkv, D)
    (scales (N, L, S, Hkv)) or layer-major (L, N, S, Hkv, D);
    length/layer () or (N,); idx/seg/comp/valid (S,) or (N, S).
    q_idx/q_seg (Sq,) or (N, Sq).
    """
    N, Sq = q.shape[:2]
    q_idx = _lanes(q_idx, N, torch.int32, q.device).expand(N, Sq)
    q_seg = _lanes(q_seg, N, torch.int32, q.device).expand(N, Sq)

    def lane(x, i):
        x = torch.as_tensor(x)
        return x[i] if x.ndim else x

    outs = []
    for i in range(N):
        per = []
        for s in segs:
            layered = s.get("layer") is not None
            d = {"layer": None if not layered else int(lane(s["layer"], i))}
            for key in ("k", "v", "k_scale", "v_scale"):
                a = s.get(key)
                if a is None:
                    d[key] = None
                elif layered and s.get("lane_major"):
                    d[key] = a[i][:, None]          # (L, S, ..) -> (L,1,S,..)
                elif layered:
                    d[key] = a[:, i:i + 1]
                else:
                    d[key] = a[i:i + 1]
            d["length"] = None if s.get("length") is None \
                else int(lane(s["length"], i))
            for key in ("idx", "seg", "comp", "valid"):
                a = s.get(key)
                d[key] = None if a is None \
                    else (a[i] if torch.as_tensor(a).ndim == 2 else a)
            per.append(d)
        outs.append(segmented_attention_ref(q[i:i + 1], per, q_idx[i],
                                            q_seg[i], scale))
    return torch.cat(outs, dim=0)


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The split-K decode's combine: splits' running-softmax states over
    the first axis -> the attention output.  m (n_split, ...) is a split's
    largest visible logit (-inf where it saw no key), l the sum of
    exp(logit - m), acc (..., D) the sum of exp(logit - m) * v.  Weights
    w_s = exp(m_s - max m) over the splits with l > 0; out = sum w acc /
    sum w l, and exactly 0 where no split saw a key.  (The kernel keeps
    m in base 2; the formula is the same.)"""
    live = l > 0
    top = torch.where(live, m, -torch.inf).amax(0)
    w = torch.where(live, torch.exp(m - top), torch.zeros_like(m))
    tot = (w * l).sum(0)
    out = (w[..., None] * acc).sum(0)
    return torch.where(tot[..., None] > 0, out / tot[..., None],
                       torch.zeros_like(out))


def cond_lora_ref(x, w, a, b, gate, scale: float,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x@w (+bias) + gate * ((x@a^T)@b) * scale, in float32, cast to
    x.dtype.  x (M, K); w (K, N); a (r, K); b (r, N); gate (M,)."""
    xf = widen(x)
    f = xf.dtype
    y = xf @ w.to(f)
    if bias is not None:
        y = y + bias.to(f)
    d = ((xf @ a.to(f).T) @ b.to(f)) * scale
    return (y + d * gate.to(f)[:, None]).to(x.dtype)


def kv_merge_ref(mem, h, a: float) -> torch.Tensor:
    """Merge update (1 - a) * mem + a * h in float32, cast to mem.dtype;
    ``a`` is the runtime weight (1/t arithmetic mean, or the EMA alpha)."""
    return kv_merge_lanes_ref(mem, h, a)


def kv_merge_lanes_ref(mem, h, a, lane_axis: int = 0) -> torch.Tensor:
    """Merge update with a weight per lane: (1 - a) * mem + a * h in
    float32, cast once to mem.dtype.  ``a`` is one host float, or one per
    index of ``lane_axis`` (0 or 1) of mem; ``h`` may have any strides and
    another float dtype."""
    f = torch.promote_types(widen(mem).dtype, h.dtype)
    a32 = torch.as_tensor(a, dtype=f, device=mem.device)
    if a32.ndim:
        a32 = a32.reshape((-1,) + (1,) * (mem.ndim - 1 - lane_axis))
    return ((1 - a32) * mem.to(f) + a32 * h.to(f)).to(mem.dtype)


def kv_cummean_ref(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Running means of h along ``dim`` (merge-mode training), in float32
    with one rounding to h.dtype.  Under autograd its backward is the
    plain version of the kernel's reverse pass."""
    csum = torch.cumsum(widen(h), dim=dim)
    shape = [1] * h.ndim
    shape[dim] = h.shape[dim]
    denom = torch.arange(1, h.shape[dim] + 1, dtype=csum.dtype,
                         device=h.device).reshape(shape)
    return (csum / denom).to(h.dtype)


def kv_cummean_pair_ref(hk: torch.Tensor, hv: torch.Tensor,
                        dim: int = 0):
    """The running means of the k and the v groups of a layer (what the
    kernel computes in one launch): ``kv_cummean_ref`` of each."""
    return kv_cummean_ref(hk, dim), kv_cummean_ref(hv, dim)


def kv_cummean_reverse_ref(g: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The running mean's gradient (the kernel's reverse pass):
    dh[t] = sum_{j>=t} g[j] / (j+1) along ``dim``, in float32 with one
    rounding to g.dtype."""
    shape = [1] * g.ndim
    shape[dim] = g.shape[dim]
    w = widen(g)
    denom = torch.arange(1, g.shape[dim] + 1, dtype=w.dtype,
                         device=g.device).reshape(shape)
    w = (w / denom).flip(dim)
    return torch.cumsum(w, dim=dim).flip(dim).to(g.dtype)


def session_gather_ref(slab: torch.Tensor, ids) -> torch.Tensor:
    """Arena pack: ``slab[ids]`` (B, ...) out of (S, ...), a pure copy."""
    return slab[torch.as_tensor(ids, dtype=torch.long, device=slab.device)]


def session_scatter_ref(slab: torch.Tensor, ids,
                        rows: torch.Tensor) -> torch.Tensor:
    """Arena unpack: ``slab[ids] = rows`` in place; returns ``slab``."""
    slab[torch.as_tensor(ids, dtype=torch.long, device=slab.device)] = \
        rows.to(slab.dtype)
    return slab
