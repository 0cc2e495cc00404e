"""Attention with CCM-aware masking (port of ``repro/models/attention.py``,
the parts the online and training slices run).

Conventions: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); GQA grouping is done
here (no materialized head repetition).  Softmax statistics in float32.

``attend`` is the training forward's full-sequence attention: every
``impl`` other than ``"concat"`` (the dense masked oracle) goes to the
hand-written CCM flash-attention kernel op (``kernels/ops.ccm_attention``,
differentiable).  So the default ``"dense"`` reaches the kernel here,
while in the reference it names ``attend_dense``; ``"chunked"`` also maps
to the kernel.  ``attend_chunked``, the reference's double-blocked
online-softmax attend in plain arrays, is kept as a plain torch function
that no path of the port calls.

``attend_segments`` is the decode / ingest / prefill hot path: a q block
attends an ordered list of KV segments ``[mem | cache(:length) | self]``
read in place.  ``impl="concat"`` materializes the concatenation and runs
the dense masked attend (the oracle); every other ``impl`` goes to the
hand-written segmented kernel op (``kernels/ops.segmented_attention``).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import lora as lora_lib
from repro_torch.core.masks import NEG_INF
from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import widen
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class KeyInfo(NamedTuple):
    """Per-token metadata driving the CCM mask, each (Sk,) or (Sq,).

    idx  : global position index used for causality (mem keys get -1).
    seg  : CCM segment id (mem keys 0).
    comp : True where the key is a <COMP> token / memory slot.
    valid: False at padding (keys only), or None; (B, Sk) per lane.
    """
    idx: torch.Tensor
    seg: torch.Tensor
    comp: torch.Tensor
    valid: Optional[torch.Tensor] = None


def plain_causal_info(length: int, offset: int = 0,
                      device=None) -> KeyInfo:
    """Plain causal metadata: one segment, every key a <COMP>-like key."""
    idx = torch.arange(length, dtype=torch.int32, device=device) + offset
    return KeyInfo(idx=idx, seg=torch.zeros_like(idx),
                   comp=torch.ones((length,), dtype=torch.bool, device=device))


def mem_key_info(length: int, valid: Optional[torch.Tensor] = None,
                 device=None) -> KeyInfo:
    """Memory keys: always visible (idx=-1, comp=True)."""
    return KeyInfo(idx=torch.full((length,), -1, dtype=torch.int32,
                                  device=device),
                   seg=torch.zeros((length,), dtype=torch.int32,
                                   device=device),
                   comp=torch.ones((length,), dtype=torch.bool,
                                   device=device),
                   valid=valid)


def concat_info(a: KeyInfo, b: KeyInfo) -> KeyInfo:
    def valid(x: KeyInfo):
        return x.valid if x.valid is not None \
            else torch.ones(x.idx.shape, dtype=torch.bool, device=x.idx.device)
    vs = None
    if a.valid is not None or b.valid is not None:
        vs = [valid(a), valid(b)]
        if vs[0].ndim != vs[1].ndim:        # one of them per lane
            B = max(v.shape[0] for v in vs if v.ndim == 2)
            vs = [v.expand(B, -1) if v.ndim == 1 else v for v in vs]
    return KeyInfo(idx=torch.cat([a.idx, b.idx]), seg=torch.cat([a.seg, b.seg]),
                   comp=torch.cat([a.comp, b.comp]),
                   valid=None if vs is None else torch.cat(vs, dim=-1))


def mask_from_info(q: KeyInfo, k: KeyInfo) -> torch.Tensor:
    """(Q, K) CCM mask: causal AND (same-segment OR k-is-comp) AND k-valid;
    (B, Q, K) when the key validity is per lane."""
    causal = k.idx[None, :] <= q.idx[:, None]
    allow = (k.seg[None, :] == q.seg[:, None]) | k.comp[None, :]
    m = causal & allow
    if k.valid is not None:
        m = m & k.valid[..., None, :]
    return m


def attend_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), mask (Sq,Sk) or (B,Sq,Sk) or None."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = widen(torch.einsum("bqhgd,bkhd->bhgqk", qg, k)) * scale
    if mask is not None:
        mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, D)


def _pad_to(x: torch.Tensor, mult: int, dim: int, fill=0) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_info: KeyInfo, k_info: KeyInfo, scale: float,
                   q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """Double-blocked online-softmax attention with the CCM mask,
    evaluated per (q block, k block) from the per-token metadata and never
    materialized at S x S; memory per step O(B * Hq * q_chunk * k_chunk).
    Key validity (Sk,).  Plain torch: no path of the port calls it (the
    card's flash attention is the CCM kernel)."""
    B, Sq0, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    dev = q.device
    valid = k_info.valid if k_info.valid is not None \
        else torch.ones((k.shape[1],), dtype=torch.bool, device=dev)

    q = _pad_to(q, q_chunk, 1)
    qi_idx = _pad_to(q_info.idx, q_chunk, 0, fill=-(10 ** 9))
    qi_seg = _pad_to(q_info.seg, q_chunk, 0, fill=-1)
    k, v = _pad_to(k, k_chunk, 1), _pad_to(v, k_chunk, 1)
    ki_idx = _pad_to(k_info.idx, k_chunk, 0, fill=10 ** 9)
    ki_seg = _pad_to(k_info.seg, k_chunk, 0, fill=-2)
    ki_comp = _pad_to(k_info.comp, k_chunk, 0, fill=False)
    ki_valid = _pad_to(valid, k_chunk, 0, fill=False)

    Sq, Sk = q.shape[1], k.shape[1]
    qg = q.reshape(B, Sq, Hkv, G, D)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qblk = qg[:, q0:q0 + q_chunk]
        qidx, qseg = qi_idx[q0:q0 + q_chunk], qi_seg[q0:q0 + q_chunk]
        m_i = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=torch.float32,
                         device=dev)
        l_i = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32,
                          device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Sk, k_chunk):
            sl = slice(k0, k0 + k_chunk)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                                  k[:, sl]).float() * scale
            msk = (ki_idx[None, sl] <= qidx[:, None]) \
                & ((ki_seg[None, sl] == qseg[:, None]) | ki_comp[None, sl]) \
                & ki_valid[None, sl]
            logits = torch.where(msk[None, None, None], logits,
                                 torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m_i, logits.amax(-1))
            alpha = torch.exp(m_i - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_i = l_i * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype), v[:, sl])
            m_i = m_new
        out = acc / torch.clamp(l_i[..., None], min=1e-37)
        outs.append(out.to(q.dtype))
    # (B, Hkv, G, Sq, D) -> (B, Sq, Hq, D)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out[:, :Sq0]


def attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, q_info: KeyInfo, k_info: KeyInfo,
           impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence CCM attention: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D).
    impl None -> ``cfg.attn_impl``; 'concat' -> the dense masked oracle;
    anything else -> the CCM flash-attention kernel op (CUDA kernel for
    CUDA tensors, its plain version on the CPU)."""
    scale = 1.0 / (cfg.hd ** 0.5)
    if (impl or cfg.attn_impl) != "concat":
        return kops.ccm_attention(q, k, v, q_info, k_info, scale)
    return attend_dense(q, k, v, mask_from_info(q_info, k_info), scale)


# ---------------------------------------------------------------------------
# segmented attention — the decode / ingest / prefill hot path
# ---------------------------------------------------------------------------

class KVSegment(NamedTuple):
    """One in-place KV region consumed by :func:`attend_segments`.

    k/v      : (B, S, Hkv, hd) — compute dtype, or int8 with scales.  With
               ``layer`` set, the stacked per-layer state (L, B, S, Hkv, hd)
               that the kernel reads straight out of (no layer copy).
    info     : per-token ``KeyInfo``; None marks a memory-like segment
               whose keys are always visible (idx=-1, seg=0, comp=True).
    length   : valid-prefix length (a host int); None = fully valid.
    k_scale/v_scale : (B, S, Hkv) float32 for int8 k/v ((L, B, S, Hkv)
               with ``layer``).
    layer    : host int index into the layer axis, or None.
    lane_major : the stack is (B, L, S, Hkv, hd) (the serve arena's packed
               lanes) instead of (L, B, S, Hkv, hd).
    length may also be a (B,) int32 tensor of per-lane lengths.
    """
    k: torch.Tensor
    v: torch.Tensor
    info: Optional[KeyInfo] = None
    length: Optional[int] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    layer: Optional[int] = None
    lane_major: bool = False

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def n_tokens(self) -> int:
        return self.k.shape[2 if self.layer is not None else 1]


def _dequant(x: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) * scale[..., None].to(dtype)


def _seg_layer_kv(seg: KVSegment):
    """The segment's (B, S, ...) layer view (concat oracle only)."""
    if seg.layer is None:
        return seg.k, seg.v, seg.k_scale, seg.v_scale
    li = (slice(None), seg.layer) if seg.lane_major else seg.layer
    return (seg.k[li], seg.v[li],
            None if seg.k_scale is None else seg.k_scale[li],
            None if seg.v_scale is None else seg.v_scale[li])


def segment_key_info(seg: KVSegment) -> KeyInfo:
    """Explicit KeyInfo for one segment (concat oracle only)."""
    S = seg.n_tokens
    dev = seg.k.device
    if seg.info is not None:
        info = seg.info
    else:
        info = KeyInfo(idx=torch.full((S,), -1, dtype=torch.int32, device=dev),
                       seg=torch.zeros((S,), dtype=torch.int32, device=dev),
                       comp=torch.ones((S,), dtype=torch.bool, device=dev))
    if seg.length is not None:
        ln = torch.as_tensor(seg.length, device=dev)
        lv = torch.arange(S, device=dev) < (ln[:, None] if ln.ndim else ln)
        info = info._replace(valid=lv if info.valid is None
                             else info.valid & lv)
    return info


def _raw_segment(seg: KVSegment) -> Dict:
    """KVSegment -> plain dict (the kernel layer is model-free)."""
    info = seg.info
    return {"k": seg.k, "v": seg.v, "k_scale": seg.k_scale,
            "v_scale": seg.v_scale, "length": seg.length, "layer": seg.layer,
            "lane_major": seg.lane_major,
            "idx": None if info is None else info.idx,
            "seg": None if info is None else info.seg,
            "comp": None if info is None else info.comp,
            "valid": None if info is None else info.valid}


def attend_segments(cfg: ModelConfig, q: torch.Tensor, segments,
                    q_info: KeyInfo, impl: Optional[str] = None,
                    lse: bool = False):
    """q (B, Sq, Hq, D) over ordered KV ``segments`` read in place.

    impl: None -> ``cfg.attn_impl``.  'concat' -> materialize the
    [seg|...|seg] concatenation and run the dense masked attend (the
    oracle); anything else -> the segmented kernel op, which runs the
    CUDA kernel for CUDA tensors and its plain version for CPU tensors.
    Returns (B, Sq, Hq, D) in ``q.dtype``; with ``lse``, also the rows'
    log-sum-exp (B, Hq, Sq) float32 (-inf where no key is visible), from
    the kernel op whatever ``impl`` says.
    """
    scale = 1.0 / (cfg.hd ** 0.5)
    segments = [s for s in segments if s.n_tokens]
    impl = impl or cfg.attn_impl
    if impl != "concat" or lse:
        return kops.segmented_attention(
            q, [_raw_segment(s) for s in segments], q_info.idx, q_info.seg,
            scale, lse=lse)
    ks, vs, infos = [], [], []
    for s in segments:
        k, v, ksc, vsc = _seg_layer_kv(s)
        if ksc is not None:
            k = _dequant(k, ksc, q.dtype)
            v = _dequant(v, vsc, q.dtype)
        ks.append(k.to(q.dtype))
        vs.append(v.to(q.dtype))
        infos.append(segment_key_info(s))
    info = functools.reduce(concat_info, infos)
    return attend_dense(q, torch.cat(ks, dim=1), torch.cat(vs, dim=1),
                        mask_from_info(q_info, info), scale)


def combine_blocks(out: torch.Tensor, lse: torch.Tensor,
                   coll) -> torch.Tensor:
    """Attention over keys split in blocks, one block per rank of
    ``coll``: each rank's ``out`` (B, Sq, H, D) over its block, with its
    log-sum-exp ``lse`` (B, H, Sq) (-inf for a block with no visible
    key), combine into the attention over every block: weights exp(lse -
    max lse) through a max and two sums over the ranks.  A row that no
    block sees gives 0."""
    m = coll.max(lse)
    live = torch.isfinite(lse)
    w = torch.where(live, torch.exp(lse - torch.where(live, m, 0.0)),
                    torch.zeros_like(lse)).transpose(1, 2)[..., None]
    num = coll.sum(out.float() * w)
    den = coll.sum(w)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-37),
                       torch.zeros_like(num)).to(out.dtype)


# ---------------------------------------------------------------------------
# attention block parameters & projections (with conditional LoRA)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   with_lora: bool = True) -> Dict:
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": L.dense_init(gen, d, Hq * hd, cfg.pdtype, device),
         "wk": L.dense_init(gen, d, Hkv * hd, cfg.pdtype, device),
         "wv": L.dense_init(gen, d, Hkv * hd, cfg.pdtype, device),
         "wo": L.dense_init(gen, Hq * hd, d, cfg.pdtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros(n * hd, dtype=cfg.pdtype, device=device)
    if with_lora and cfg.ccm.enabled:
        r = cfg.ccm.lora_rank
        p["lora"] = {
            "q": lora_lib.init_lora(gen, d, Hq * hd, r, device),
            "k": lora_lib.init_lora(gen, d, Hkv * hd, r, device),
            "v": lora_lib.init_lora(gen, d, Hkv * hd, r, device),
            "o": lora_lib.init_lora(gen, Hq * hd, d, r, device),
        }
    return p


def qkv_project(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                comp_gate: Optional[torch.Tensor],
                positions: Optional[torch.Tensor], tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with RoPE at
    ``positions``.  comp_gate (B,S) {0,1} gates the conditional LoRA;
    None disables the delta entirely.

    ``tp`` (`distributed.tensor_parallel.TensorParallel`): ``p`` is this
    rank's shard and the head counts are the rank's
    (``tensor_parallel.local_config``).  When the attention is split, x
    enters through ``copy_to_tp`` (its gradient is partial on each rank),
    and so do the replicated leaves used in the split: the LoRA ``a``s,
    and in the "query" regime the whole KV projection.  Query head h of
    rank r is global head ``r Hq/n + h``; its KV head is the reference's
    ``h // G`` of that global head: the rank's own KV block ("kv"), or
    the one ``tp.kv_view`` picks ("query")."""
    B, S, _ = x.shape
    lc = cfg if tp is None else tp.local
    split = tp is not None and tp.attn_split
    if split:
        x = TPX.copy_to_tp(x, tp)
    lora = p.get("lora")
    sc = lora_lib.lora_scale(cfg.ccm.lora_rank, cfg.ccm.lora_alpha)

    def proj(name, bias_name):
        lw = lora.get(name) if (lora is not None and comp_gate is not None) \
            else None
        w, b = p["w" + name], p.get(bias_name)
        if split:
            whole = name != "q" and tp.attn == "query"
            lw = TPX.copy_leaves(lw, tp, ("a", "b") if whole else ("a",))
            if whole:
                w, b = TPX.copy_to_tp(w, tp), TPX.copy_to_tp(b, tp)
        return lora_lib.cond_linear(x, w, lw, comp_gate, sc, bias=b)

    q = proj("q", "bq").reshape(B, S, lc.n_heads, cfg.hd)
    k = proj("k", "bk").reshape(B, S, lc.n_kv_heads, cfg.hd)
    v = proj("v", "bv").reshape(B, S, lc.n_kv_heads, cfg.hd)
    if positions is not None:
        cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    return q, k, v


def out_project(cfg: ModelConfig, p: Dict, o: torch.Tensor,
                comp_gate: Optional[torch.Tensor], tp=None) -> torch.Tensor:
    """o (B, S, Hq, hd) -> (B, S, d).  With ``tp`` splitting the
    attention, ``wo`` is row-parallel: this rank's rows, the matching
    columns of the LoRA ``a`` and ``b`` whole (through ``copy_to_tp``),
    completed by the model-axis reduce."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    lora = p.get("lora")
    lw = lora.get("o") if (lora is not None and comp_gate is not None) else None
    sc = lora_lib.lora_scale(cfg.ccm.lora_rank, cfg.ccm.lora_alpha)
    if tp is not None and tp.attn_split:
        return lora_lib.cond_linear(
            o, p["wo"], TPX.copy_leaves(lw, tp, ("b",)), comp_gate, sc,
            reduce=lambda y: TPX.reduce_from_tp(y, tp))
    return lora_lib.cond_linear(o, p["wo"], lw, comp_gate, sc)
