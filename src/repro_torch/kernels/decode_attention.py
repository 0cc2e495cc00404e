"""Fused segmented attention on the H100 (port of
``repro/kernels/decode_attention.py``).

Replaces the Pallas TPU kernel ``segmented_flash_attention`` (body
``_kernel``) in ``repro/kernels/decode_attention.py``.  The kernel is CUDA
C++ in ``csrc/segmented_attention.cu``; its header says what bounds it on
the card and what its design does about that.  This module checks the
arguments, describes each segment to the kernel by pointers and element
strides (so (B,S,H,D), layer-major (L,B,S,H,D) and lane-major
(B,L,S,H,D) segments need no copy) and launches it on PyTorch's current
stream.  The plain version is ``ref.segmented_attention_ref``.

The kernel has three routes (see the CUDA file's header): float32 q on
the CUDA cores; bf16 q with Sq <= 2 as a split-K decode
(``plan_splits`` picks the number of splits from the segments'
capacities, ``split_bounds`` is the kernel's cut of each lane's keys and
``ref.merge_partials`` its combine); bf16 q with Sq > 2 on ``mma.sync``.
bf16 q needs bf16 or int8 K/V; any other call raises ``ValueError``
before a launch, and nothing falls back.

Segment dicts follow ``repro``'s schema: k/v, k_scale/v_scale (int8
only), length (int, (B,) int32 tensor or None), layer (int, (B,) tensor
or None), lane_major, idx/seg/comp/valid ((S,) or (B, S), or idx None
for always-visible memory keys).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segmented_attention_ref as plain

MAX_SEGS = 4
MAX_D = 256
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

MAX_SPLITS = 32     # split-K blocks per (lane, kv head), at most
SPLIT_ROWS = 16     # q rows (heads x Sq) per split-K block, at most
SM_COUNT = 132      # H100 SXM streaming multiprocessors

launches = 0         # kernel launches (the count chip_smoke reads)
splitk_launches = 0  # of them: the bf16 split-K decode route (Sq <= 2)
mma_launches = 0     # of them: the bf16 mma.sync route (Sq > 2)
mma_lse_launches = 0  # of those: with the log-sum-exp

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


class _SegDesc(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("k", "v", "k_scale", "v_scale", "len_ptr",
                                   "layer_ptr", "idx", "seg", "comp", "valid")]
                + [(n, _L) for n in ("k_lane", "k_layer", "k_tok", "k_head",
                                     "v_lane", "v_layer", "v_tok", "v_head",
                                     "s_lane", "s_layer", "s_tok", "s_head",
                                     "meta_lane", "valid_lane")]
                + [(n, _I) for n in ("len", "layer", "S", "kv_type")])


class _AttnParams(ctypes.Structure):
    _fields_ = ([("seg", _SegDesc * MAX_SEGS)]
                + [(n, _P) for n in ("q", "o", "q_idx", "q_seg", "lse")]
                + [(n, _L) for n in ("q_lane", "q_tok", "q_head", "o_lane",
                                     "o_tok", "o_head", "qm_lane")]
                + [(n, _I) for n in ("nseg", "B", "Sq", "Hq", "Hkv", "D")]
                + [("scale", ctypes.c_float)])


_fn = None
_split_state: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}


def plan_splits(capacity: int, blocks: int, sms: int = SM_COUNT) -> int:
    """The split-K decode's number of splits: as many as keep the grid to
    about 4 blocks per SM (one wave: 4 resident blocks of 128 threads per
    SM), each split holding >= 64 of the ``capacity`` keys a lane can
    have (the segments' capacities: known on the host, no sync)."""
    want = 4 * sms // max(blocks, 1)
    return max(1, min(want, capacity // 64, MAX_SPLITS))


def split_bounds(counts: Sequence[int],
                 n_split: int) -> List[List[Tuple[int, int, int]]]:
    """The kernel's cut of one lane's valid keys (``counts[si]`` of
    segment si, in segment order): flattened, split s covers [s*c,
    min((s+1)*c, total)) with c = ceil(total / n_split).  Returns, per
    split, the (segment, lo, hi) pieces it reads (empty for an empty
    split)."""
    total = sum(counts)
    chunk = -(-total // n_split)
    out = []
    for sp in range(n_split):
        k0 = min(sp * chunk, total)
        k1 = min(k0 + chunk, total)
        pieces, off = [], 0
        for si, n in enumerate(counts):
            lo, hi = min(max(k0 - off, 0), n), min(max(k1 - off, 0), n)
            if lo < hi:
                pieces.append((si, lo, hi))
            off += n
        out.append(pieces)
    return out


def _split_buffers(dev: torch.device, blocks: int,
                   floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K combine's buffers on ``dev``, kept across calls and
    grown on demand: per-(lane, kv head) int32 counters, zeroed once
    (each combining block resets its own), and the float32 scratch of
    the splits' partial states.  Launches on one stream reuse them in
    order; split-K launches on two streams at once would share them."""
    c, part = _split_state.get(dev, (None, None))
    if c is None or c.numel() < blocks:
        c = torch.zeros(max(blocks, 1024), dtype=torch.int32, device=dev)
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                           device=dev)
    _split_state[dev] = (c, part)
    return c, part


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.library("segmented_attention")
        lib.segmented_attention_abi_size.restype = ctypes.c_int
        lib.segmented_attention_abi_size.argtypes = []
        if lib.segmented_attention_abi_size() != ctypes.sizeof(_AttnParams):
            raise RuntimeError("segmented_attention: C and ctypes parameter "
                               "layouts differ")
        fn = lib.segmented_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_AttnParams)] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p]
        _fn = fn
    return _fn


def _meta(x, B: int, S: int, dev, keep: List[torch.Tensor], name: str):
    """(S,) or (B, S) metadata -> (pointer, lane stride) of an int32 copy."""
    t = torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
    if t.shape not in ((S,), (B, S)):
        raise ValueError(f"{name} must be ({S},) or ({B}, {S}), got "
                         f"{tuple(t.shape)}")
    keep.append(t)
    return t.data_ptr(), (S if t.ndim == 2 and B > 1 else 0)


def _per_lane(x, B: int, dev, keep: List[torch.Tensor], name: str):
    """int -> (0, value); (B,) / 0-d int tensor -> (pointer, 0)."""
    if not isinstance(x, torch.Tensor):
        return 0, int(x)
    if x.device != dev:
        raise ValueError(f"{name} lies on {x.device}, q on {dev}")
    t = x.to(torch.int32).reshape(-1).expand(B).contiguous()
    keep.append(t)
    return t.data_ptr(), 0


def _check_vec(t: torch.Tensor, name: str):
    """The kernel reads 8 consecutive elements of a row at a time."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous")
    if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides must be multiples of 8 elements "
                         "and the data 16-byte aligned")


def segmented_flash_attention(q: torch.Tensor, segs: Sequence[Dict[str, Any]],
                              q_idx, q_seg, scale: float, lse: bool = False):
    """Launch the CUDA kernel: q (B, Sq, Hq, D) float32/bf16 on a CUDA
    device over ``segs``; returns (B, Sq, Hq, D) in q.dtype.  float32 q
    takes the CUDA-core route; bf16 q (with bf16 or int8 K/V) the split-K
    decode route when Sq <= 2, else the mma.sync route.  ``lse``: also
    returns the rows' log-sum-exp (B, Hq, Sq) float32 (-inf where a row
    sees no key), written by the same launch on every route."""
    global launches, splitk_launches, mma_launches, mma_lse_launches
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 4:
        raise ValueError(f"q must be (B, Sq, Hq, D) float32/bf16, got "
                         f"{q.dtype} {tuple(q.shape)}")
    B, Sq, Hq, D = q.shape
    if D % 8 or D > MAX_D:
        raise ValueError(f"head dim {D}: must be a multiple of 8, <= {MAX_D}")
    if q.stride(-1) != 1:
        raise ValueError("q: last dim must be contiguous")
    if q.dtype == torch.bfloat16 and Sq > 2:
        _check_vec(q, "q")           # the mma.sync route copies 16-byte rows
    segs = [s for s in segs
            if s["k"].shape[2 if s.get("layer") is not None else 1]]
    if not 1 <= len(segs) <= MAX_SEGS:
        raise ValueError(f"1..{MAX_SEGS} non-empty segments, got {len(segs)}")
    dev = q.device
    keep: List[torch.Tensor] = []
    cap = 0                 # keys a lane can hold over all segments
    p = _AttnParams()
    Hkv = segs[0]["k"].shape[-2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    for si, s in enumerate(segs):
        k, v = s["k"], s["v"]
        layered = s.get("layer") is not None
        lane_major = layered and bool(s.get("lane_major"))
        nd = 5 if layered else 4
        for name, t in (("k", k), ("v", v)):
            if t.device != dev or t.ndim != nd or t.shape[-2:] != (Hkv, D):
                raise ValueError(f"segment {si} {name}: want a {nd}-d tensor "
                                 f"(..., {Hkv}, {D}) on {dev}, got "
                                 f"{tuple(t.shape)} on {t.device}")
            _check_vec(t, f"segment {si} {name}")
        if k.dtype not in _KV_TYPES or v.dtype != k.dtype:
            raise ValueError(f"segment {si}: k/v dtype {k.dtype}/{v.dtype}")
        if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
            raise ValueError(f"segment {si}: bf16 q takes bf16 or int8 "
                             "k/v, not float32")
        lane_ax = (0 if lane_major else 1) if layered else 0
        tok_ax = 2 if layered else 1
        S = k.shape[tok_ax]
        if k.shape != v.shape or k.shape[lane_ax] != B:
            raise ValueError(f"segment {si}: k {tuple(k.shape)}, "
                             f"v {tuple(v.shape)}, {B} lanes")
        d = p.seg[si]
        d.k, d.v = k.data_ptr(), v.data_ptr()

        def strides(t):
            st = t.stride()
            layer = st[1 - lane_ax] if layered else 0
            return st[lane_ax], layer, st[tok_ax], st[tok_ax + 1]

        d.k_lane, d.k_layer, d.k_tok, d.k_head = strides(k)
        d.v_lane, d.v_layer, d.v_tok, d.v_head = strides(v)
        d.kv_type = _KV_TYPES[k.dtype]
        if k.dtype == torch.int8:
            ks, vs = s.get("k_scale"), s.get("v_scale")
            if ks is None or vs is None or ks.dtype != torch.float32 \
                    or vs.dtype != torch.float32 or ks.shape != k.shape[:-1] \
                    or vs.shape != ks.shape or vs.stride() != ks.stride() \
                    or ks.device != dev or vs.device != dev:
                raise ValueError(f"segment {si}: int8 k/v need float32 "
                                 "k_scale/v_scale of shape k.shape[:-1]")
            d.k_scale, d.v_scale = ks.data_ptr(), vs.data_ptr()
            d.s_lane, d.s_layer, d.s_tok, d.s_head = strides(ks)
        length = s.get("length")
        d.len_ptr, d.len = (0, S) if length is None \
            else _per_lane(length, B, dev, keep, f"segment {si} length")
        d.layer_ptr, d.layer = (0, 0) if not layered \
            else _per_lane(s["layer"], B, dev, keep, f"segment {si} layer")
        if s.get("idx") is not None:
            d.idx, d.meta_lane = _meta(s["idx"], B, S, dev, keep, "idx")
            d.seg, seg_lane = _meta(s["seg"], B, S, dev, keep, "seg")
            d.comp, comp_lane = _meta(s["comp"], B, S, dev, keep, "comp")
            if not d.meta_lane == seg_lane == comp_lane:
                raise ValueError("idx/seg/comp must all be shared or per-lane")
            if s.get("valid") is not None:
                d.valid, d.valid_lane = _meta(s["valid"], B, S, dev, keep,
                                              "valid")
        d.S = S
        cap += S if not isinstance(length, int) else max(0, min(length, S))
    p.nseg, p.B, p.Sq, p.Hq, p.Hkv, p.D = len(segs), B, Sq, Hq, Hkv, D
    p.scale = float(scale)
    p.q_idx, qm = _meta(q_idx, B, Sq, dev, keep, "q_idx")
    p.q_seg, qm2 = _meta(q_seg, B, Sq, dev, keep, "q_seg")
    if qm != qm2:
        raise ValueError("q_idx and q_seg must both be shared or per-lane")
    p.qm_lane = qm
    if not q.is_cuda:
        raise ValueError("segmented_flash_attention needs CUDA tensors")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    p.q, p.o = q.data_ptr(), out.data_ptr()
    rows = None
    if lse:
        rows = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
        p.lse = rows.data_ptr()
    p.q_lane, p.q_tok, p.q_head = q.stride()[:3]
    p.o_lane, p.o_tok, p.o_head = out.stride()[:3]
    route = 0 if q.dtype == torch.float32 else (1 if Sq <= 2 else 2)
    n_split = hpb = hgroups = 1
    part = counters = 0
    if route == 1:
        G = Hq // Hkv
        hpb = min(G, SPLIT_ROWS // Sq)
        hgroups = -(-G // hpb)
        blocks = B * Hkv * hgroups
        n_split = plan_splits(cap, blocks)
        if n_split > 1:
            c, scratch = _split_buffers(
                dev, blocks, blocks * n_split * SPLIT_ROWS * (D + 2))
            part, counters = scratch.data_ptr(), c.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(ctypes.byref(p), route, n_split, hpb, hgroups, part,
                      counters, dev.index if dev.index is not None
                      else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"segmented_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    splitk_launches += route == 1
    mma_launches += route == 2
    mma_lse_launches += route == 2 and lse
    return (out, rows) if lse else out


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def cost(q: torch.Tensor, segs: Sequence[Dict[str, Any]],
         lse: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch on these arguments, from their shapes
    and host lengths alone (what ``ops`` charges on the meta device): 4 hd
    FLOPs for each visible (q, k) pair of each query head (QK^T and PV),
    each visible key row of every segment read once with its scales, q
    read and the output (and the lse) written once.  A segment's visible
    keys are its host length (its capacity where the length is a tensor
    or None); a segment with per-token metadata is the new rows' own
    block, causal where it holds as many keys as there are q rows."""
    B, Sq, Hq, D = q.shape
    pairs = 0
    nbytes = 2 * _nbytes(q) + (B * Hq * Sq * 4 if lse else 0)
    for s in segs:
        k = s["k"]
        S, Hkv = k.shape[-3], k.shape[-2]
        n = s.get("length")
        n = S if n is None or isinstance(n, torch.Tensor) \
            else min(max(int(n), 0), S)
        if s.get("idx") is not None:
            pairs += Sq * (Sq + 1) // 2 if S == Sq else Sq * n
        else:
            pairs += Sq * n
        rows = B * n * Hkv
        nbytes += 2 * rows * D * k.element_size()
        if s.get("k_scale") is not None:
            nbytes += 2 * rows * s["k_scale"].element_size()
    return 4.0 * D * B * Hq * pairs, float(nbytes)
