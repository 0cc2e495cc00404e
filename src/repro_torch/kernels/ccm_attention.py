"""CCM flash attention on the H100, forward and backward (port of
``repro/kernels/ccm_attention.py``).

Replaces the Pallas TPU kernel ``ccm_flash_attention`` (body ``_kernel``)
in ``repro/kernels/ccm_attention.py``.  The kernels are CUDA C++ in
``csrc/ccm_attention.cu``; its header says what bounds them on the card
and what the design does about that.  This module checks the arguments,
passes every tensor by pointer and element strides (so q in the
reference's (B, Hq, Sq, D) layout may be a transposed view of the
model's (B, Sq, Hq, D) activations: nothing is copied or padded) and
launches on PyTorch's current stream.

The route follows the dtype, with no fallback between them:
  * float32 q/k/v: the CUDA-core kernels (the float32 cross-checks);
  * bf16 q/k/v: the tensor-core kernels (mma.sync, cp.async) over two
    tile streams, the natural key tiles under D = causal & same segment
    & !comp & valid and the lane's comp & valid keys compacted into
    tiles of their own under C = causal & comp & valid (D | C is the CCM
    mask).  ``plan`` builds both streams' tile lists on the device with
    torch ops (no host synchronisation); the kernels only walk them.  A
    bf16 call that this route cannot take raises before any launch.

``ccm_attention`` is the differentiable entry: a ``torch.autograd.Function``
whose forward launches the forward kernel (saving the per-row float32
log-sum-exp) and whose backward launches the two backward kernels.  The
TPU kernel has no backward; this one computes the gradient that the
reference gets by autodiff of its dense attend.  The plain version is
``ref.ccm_attention_ref`` (its plain backward is autograd through it).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _lanes
from repro_torch.kernels.ref import ccm_attention_ref as plain

MAX_D = 256
TILE = 64               # bf16 route: q rows of a q tile = keys of a key tile
MAX_S_BF16 = 65536      # bf16 route: longest Sq / Sk (plan lists in shared memory)
KBIG = 2 ** 31 - 1      # key-table k_idx of a key its stream does not show
QNONE = -(1 << 30)      # q_idx of a padded q row (sees no key)
F_ANY, F_OWN = 1, 2     # key-table flags: every segment sees the key; the
                        # stream writes the key's dK/dV row

launches = 0       # forward kernel launches (the count chip_smoke reads)
bwd_launches = 0   # backward launches (one dQ + one dK/dV kernel each)
mma_launches = 0       # the bf16 tensor-core route's share of each
bwd_mma_launches = 0

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


class _CcmParams(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "o", "lse", "dout", "dq",
                                   "dk", "dv", "delta", "q_idx", "q_seg",
                                   "k_idx", "k_seg", "k_comp", "k_valid")]
                + [(f"{t}_{a}", _L) for t in ("q", "k", "v", "o", "do", "dq",
                                              "dk", "dv")
                   for a in ("b", "h", "s")]
                + [(n, _L) for n in ("qm_b", "km_b")]
                + [(n, _I) for n in ("B", "Hq", "Hkv", "Sq", "Sk", "D")]
                + [("scale", ctypes.c_float)]
                + [(n, _P) for n in ("ktab", "q_tiles", "q_count", "k_tiles",
                                     "k_count")]
                + [(n, _I) for n in ("plan_lanes", "nq", "nk", "nc")])


class CcmPlan(NamedTuple):
    """The bf16 route's two streams for one set of metadata (``plan``).
    P is 1 for metadata that the lanes share, else B; NT = nk + nc tile
    slots, the natural stream's nk and then the <COMP> stream's nc."""
    ktab: torch.Tensor      # (P, NT * tile, 4) int32 per key slot: position
    #                         (-1: none), k_idx (KBIG where the stream does
    #                         not show the key), k_seg, flags (F_ANY, F_OWN)
    q_tiles: torch.Tensor   # (P, nq, NT) int32: slots each q tile visits,
    #                         ascending (natural first), -1 past the count
    q_count: torch.Tensor   # (P, nq) int32
    k_tiles: torch.Tensor   # (P, NT, nq) int32: q tiles that see each slot
    k_count: torch.Tensor   # (P, NT) int32
    nq: int
    nk: int
    nc: int
    tile: int


def comp_list(k_comp: torch.Tensor, k_valid: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The <COMP> stream of each lane: (P, Sk) comp (and valid) flags ->
    ((P, Sk) int32 positions of the comp & valid keys in order, -1 past
    the count; (P,) int32 counts).  A cumsum and a scatter on the flags'
    device, with no host synchronisation."""
    ok = k_comp if k_valid is None else k_comp & k_valid
    P, Sk = ok.shape
    rank = torch.cumsum(ok.to(torch.int32), 1) - 1
    dst = torch.where(ok, rank, torch.full_like(rank, Sk))  # spare column
    pos = torch.full((P, Sk + 1), -1, dtype=torch.int32, device=ok.device)
    pos.scatter_(1, dst.long(), torch.arange(
        Sk, dtype=torch.int32, device=ok.device).expand(P, Sk).contiguous())
    return pos[:, :Sk].contiguous(), ok.sum(1, dtype=torch.int32)


def _compact(vis: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n) bool -> (the indices of the True entries ascending, -1
    after them; their counts), both int32."""
    n = vis.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=vis.device)
    ids = torch.where(vis, ar, ar + n).sort(-1).values
    return (torch.where(ids < n, ids, -1).to(torch.int32).contiguous(),
            vis.sum(-1, dtype=torch.int32))


def plan(q_idx, q_seg, k_idx, k_seg, k_comp, k_valid, B: int, Sq: int,
         Sk: int, device=None, tile: int = TILE) -> CcmPlan:
    """Plan the bf16 route's two tile streams (plain torch on ``device``).

    Metadata are (S,) shared or (B, S) per lane.  The natural stream is
    the key tiles in order under D = causal & same segment & !comp &
    valid; the <COMP> stream is ``comp_list``'s keys in tiles of their
    own under C = causal & comp & valid.  A q tile visits a slot iff some
    q row of it sees some key of it under the slot's stream (exact: the
    natural stream from the dense D mask, the <COMP> stream from the
    tile's least k_idx against the q tile's largest q_idx).  Every key
    position is owned (its dK/dV row written) by exactly one slot: a
    comp & valid key by its <COMP> slot, any other by its natural one.
    Key indices must be below KBIG and q indices above QNONE."""
    dev = torch.device(device) if device is not None else \
        torch.as_tensor(q_idx).device
    meta = (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid)
    P = B if any(x is not None and torch.as_tensor(x).ndim == 2 and B > 1
                 for x in meta) else 1
    i32 = torch.int32
    qi, qs, ki, ks = (_lanes(x, P, i32, dev)
                      for x in (q_idx, q_seg, k_idx, k_seg))
    kc = _lanes(k_comp, P, torch.bool, dev)
    kv = torch.ones(P, Sk, dtype=torch.bool, device=dev) if k_valid is None \
        else _lanes(k_valid, P, torch.bool, dev)
    nq, nk = -(-Sq // tile), -(-Sk // tile)
    nc = nk
    F = torch.nn.functional
    pad = nk * tile - Sk

    # natural stream: slot t holds keys t * tile .. (t + 1) * tile - 1
    u = torch.arange(nk * tile, dtype=i32, device=dev).expand(P, -1)
    inr = u < Sk
    kip, ksp = F.pad(ki, (0, pad)), F.pad(ks, (0, pad))
    kcp, kvp = F.pad(kc, (0, pad)), F.pad(kv, (0, pad))
    zero = torch.zeros_like(u)
    nat = torch.stack([torch.where(inr, u, -1),
                       torch.where(kvp & ~kcp, kip, KBIG),
                       ksp,
                       torch.where(inr & ~(kcp & kvp), F_OWN, zero)], -1)
    # <COMP> stream: slot nk + c holds the lane's comp keys c * tile ..
    cpos, _ = comp_list(kc, kv)
    cpos = F.pad(cpos, (0, nc * tile - Sk), value=-1)
    has = cpos >= 0
    cki = torch.gather(kip, 1, cpos.clamp(min=0).long())
    comp = torch.stack([cpos, torch.where(has, cki, KBIG), zero,
                        torch.where(has, F_ANY | F_OWN, F_ANY + zero)], -1)
    ktab = torch.cat([nat, comp], 1).to(i32).contiguous()

    qip = F.pad(qi, (0, nq * tile - Sq), value=QNONE)
    qsp = F.pad(qs, (0, nq * tile - Sq), value=-3)
    kie, kse = ktab[:, :nk * tile, 1], ktab[:, :nk * tile, 2]
    step = max(1, (1 << 25) // (P * tile * nk * tile))   # bound the dense mask
    vis_n = torch.cat([
        ((kie[:, None, :] <= qip[:, a:b, None])
         & (kse[:, None, :] == qsp[:, a:b, None]))
        .view(P, -1, tile, nk, tile).any(4).any(2)
        for a, b in ((t * tile, min(nq, t + step) * tile)
                     for t in range(0, nq, step))], 1)
    cmin = ktab[:, nk * tile:, 1].reshape(P, nc, tile).amin(2)
    qmax = qip.view(P, nq, tile).amax(2)
    vis = torch.cat([vis_n, cmin[:, None, :] <= qmax[:, :, None]], 2)
    q_tiles, q_count = _compact(vis)
    k_tiles, k_count = _compact(vis.transpose(1, 2))
    return CcmPlan(ktab, q_tiles, q_count, k_tiles, k_count, nq, nk, nc,
                   tile)


_plans: dict = {}     # (metadata identity, versions, shapes) -> (meta, plan)


def _plan_for(meta, B: int, Sq: int, Sk: int, dev) -> CcmPlan:
    """``plan`` for this metadata, built once while the same tensors hold
    the same contents (their in-place version counters unchanged): the
    layers of a step share one plan.  The cache keeps the metadata alive
    so that their ids stay theirs; it holds a few entries."""
    if not all(x is None or isinstance(x, torch.Tensor) for x in meta):
        return plan(*meta, B, Sq, Sk, dev)
    key = (B, Sq, Sk, str(dev)) + tuple(
        None if x is None else (id(x), x._version) for x in meta)
    hit = _plans.get(key)
    if hit is None:
        if len(_plans) >= 8:
            _plans.pop(next(iter(_plans)))
        hit = _plans[key] = (meta, plan(*meta, B, Sq, Sk, dev))
    return hit[1]


_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.library("ccm_attention")
        lib.ccm_attention_abi_size.restype = ctypes.c_int
        lib.ccm_attention_abi_size.argtypes = []
        if lib.ccm_attention_abi_size() != ctypes.sizeof(_CcmParams):
            raise RuntimeError("ccm_attention: C and ctypes parameter "
                               "layouts differ")
        fns = []
        for name in ("ccm_attention_fwd_launch", "ccm_attention_bwd_launch"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_CcmParams), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fns.append(fn)
        _fns = tuple(fns)
    return _fns


def _meta(x, B: int, S: int, dev, keep: List[torch.Tensor], name: str):
    """(S,) or (B, S) metadata -> (pointer, lane stride) of an int32 copy."""
    t = torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
    if t.shape not in ((S,), (B, S)):
        raise ValueError(f"{name} must be ({S},) or ({B}, {S}), got "
                         f"{tuple(t.shape)}")
    keep.append(t)
    return t.data_ptr(), (S if t.ndim == 2 and B > 1 else 0)


def _vector_ok(t: torch.Tensor) -> bool:
    """The kernels read 8 consecutive elements of a row at a time through
    (lane, head, token) strides."""
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) \
        and t.data_ptr() % 16 == 0


def _check(t: torch.Tensor, name: str, shape, dtype, dev):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != dev:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype} on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not _vector_ok(t):
        raise ValueError(f"{name}: the head dim must be contiguous, the other "
                         "strides multiples of 8 elements and the data "
                         "16-byte aligned (16-byte row pieces)")


def _check_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What both routes refuse, whatever the device: raises ValueError
    before anything is built or launched."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: float32 or bf16 only")
    if D % 8 or D > MAX_D:
        raise ValueError(f"head dim {D}: a multiple of 8, <= {MAX_D}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError(f"empty attention: B={B} Sq={Sq} Sk={Sk}")
    if q.dtype == torch.bfloat16 and max(Sq, Sk) > MAX_S_BF16:
        raise ValueError(f"bf16 route: Sq={Sq}, Sk={Sk} above {MAX_S_BF16}")
    _check(q, "q", (B, Hq, Sq, D), q.dtype, q.device)
    _check(k, "k", (B, Hkv, Sk, D), q.dtype, q.device)
    _check(v, "v", (B, Hkv, Sk, D), q.dtype, q.device)


def _params(q, k, v, meta, scale, keep) -> _CcmParams:
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    q_idx, q_seg, k_idx, k_seg, k_comp, k_valid = meta
    p = _CcmParams()
    p.q_idx, qm = _meta(q_idx, B, Sq, dev, keep, "q_idx")
    p.q_seg, qm2 = _meta(q_seg, B, Sq, dev, keep, "q_seg")
    p.k_idx, km = _meta(k_idx, B, Sk, dev, keep, "k_idx")
    p.k_seg, km2 = _meta(k_seg, B, Sk, dev, keep, "k_seg")
    p.k_comp, km3 = _meta(k_comp, B, Sk, dev, keep, "k_comp")
    lanes = {km, km2, km3}
    if k_valid is not None:
        p.k_valid, km4 = _meta(k_valid, B, Sk, dev, keep, "k_valid")
        lanes.add(km4)
    if qm != qm2 or len(lanes) != 1:
        raise ValueError("q and k metadata must each be all shared (S,) or "
                         "all per-lane (B, S)")
    p.qm_b, p.km_b = qm, km
    for name, t in (("q", q), ("k", k), ("v", v)):
        _set(p, name, t)
    p.B, p.Hq, p.Hkv, p.Sq, p.Sk, p.D = B, Hq, Hkv, Sq, Sk, D
    p.scale = float(scale)
    if q.dtype == torch.bfloat16:
        pl = _plan_for(meta, B, Sq, Sk, dev)
        keep.append(pl)
        for name in ("ktab", "q_tiles", "q_count", "k_tiles", "k_count"):
            setattr(p, name, getattr(pl, name).data_ptr())
        p.plan_lanes = pl.ktab.shape[0]
        p.nq, p.nk, p.nc = pl.nq, pl.nk, pl.nc
    return p


def _set(p: _CcmParams, name: str, t: torch.Tensor) -> None:
    """Pointer and (lane, head, token) strides of ``t`` into ``p``."""
    setattr(p, name, t.data_ptr())
    for a, s in zip("bhs", t.stride()[:3]):
        setattr(p, f"{name}_{a}", s)


def _launch(fn, p: _CcmParams, q: torch.Tensor, what: str) -> None:
    dev = q.device
    err = fn(ctypes.byref(p), int(q.dtype == torch.bfloat16),
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ccm_attention {what} launch failed: "
                           f"cudaError {err}")


def ccm_attention_fwd(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D):
    CUDA, one dtype (float32: CUDA-core route; bf16: tensor-core route),
    head dim contiguous, any other strides that are multiples of 8;
    metadata (S,) or (B, S).  Returns (o with q's strides, lse (B, Hq, Sq)
    float32, natural log)."""
    global launches, mma_launches
    _check_route(q, k, v)
    if not q.is_cuda:
        raise ValueError("ccm_attention_fwd needs CUDA tensors")
    keep: List[torch.Tensor] = []
    p = _params(q, k, v, (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid),
                scale, keep)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _set(p, "o", o)
    p.lse = lse.data_ptr()
    _launch(_launchers()[0], p, q, "forward")
    launches += 1
    mma_launches += int(q.dtype == torch.bfloat16)
    return o, lse


def ccm_attention_bwd(q, k, v, o, lse, do, q_idx, q_seg, k_idx, k_seg,
                      k_comp, k_valid, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the two backward kernels (dQ with Delta = rowsum(dO * O),
    then dK/dV).  Returns (dq, dk, dv) with the strides of q, k, v."""
    global bwd_launches, bwd_mma_launches
    _check_route(q, k, v)
    if not q.is_cuda:
        raise ValueError("ccm_attention_bwd needs CUDA tensors")
    keep: List[torch.Tensor] = []
    p = _params(q, k, v, (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid),
                scale, keep)
    if not _vector_ok(do):           # a gradient may arrive as any view
        do = do.contiguous()
    _check(o, "o", q.shape, q.dtype, q.device)
    _check(do, "dout", q.shape, q.dtype, q.device)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse: want a contiguous (B, Hq, Sq) float32 tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    for name, t in (("o", o), ("do", do), ("dq", dq), ("dk", dk), ("dv", dv)):
        _set(p, name, t)
    p.dout = do.data_ptr()
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    _launch(_launchers()[1], p, q, "backward")
    bwd_launches += 1
    bwd_mma_launches += int(q.dtype == torch.bfloat16)
    return dq, dk, dv


class _CcmAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp, k_valid,
                scale):
        o, lse = ccm_attention_fwd(q, k, v, q_idx, q_seg, k_idx, k_seg,
                                   k_comp, k_valid, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (q_idx, q_seg, k_idx, k_seg, k_comp, k_valid)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ccm_attention_bwd(q, k, v, o, lse, do, *ctx.meta,
                                       ctx.scale)
        return (dq, dk, dv) + (None,) * 7


def ccm_attention(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp,
                  k_valid: Optional[torch.Tensor], scale: float
                  ) -> torch.Tensor:
    """The kernel under autograd: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D)
    on a CUDA device; returns o with q's strides."""
    return _CcmAttention.apply(q, k, v, q_idx, q_seg, k_idx, k_seg, k_comp,
                               k_valid, float(scale))
