"""Mamba2 (SSD, state-space duality, arXiv:2405.21060; port of
``repro/models/ssm.py``).

Chunked SSD: within-chunk attention-like diagonal blocks plus an
inter-chunk linear recurrence over per-chunk states.  The reference's
``lax.scan`` over chunks is a Python loop here.  Single group
(n_groups = 1): B/C are shared across heads.

Decode state s (B, H, P, N):
    s_t = exp(dt*A) * s_{t-1} + dt * B_t (outer) x_t ;  y_t = C_t . s_t + D*x_t
the architecture's own fixed-size context memory.

The reference's rounding points are kept: the diagonal term's ``M`` and
``x*dt`` are rounded to ``x.dtype`` before their product, the chunk
states and the off-diagonal term are float32, ``y`` and the final state
come back in ``x.dtype`` (so the state is stored in the compute dtype
between calls), the conv weight is cast to ``x.dtype`` and
``A = -exp(a_log)`` is float32 (each "float32" is float64 in a float64
run, ``acc``).  SSD, the causal conv and the decode
recurrence are jnp in the reference (no Pallas kernel), so they are
plain PyTorch here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import widen
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_mamba(gen: torch.Generator, cfg: ModelConfig, d: int,
               device) -> Dict:
    di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    d_in_proj = 2 * di + 2 * N + H   # z, x, B, C, dt
    conv_dim = di + 2 * N
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(gen, d, d_in_proj, cfg.pdtype, device),
        "conv_w": L.normal(gen, (K, conv_dim), 1.0 / K ** 0.5, cfg.pdtype,
                           device),
        "conv_b": torch.zeros(conv_dim, dtype=cfg.pdtype, device=device),
        "dt_bias": torch.zeros(H, dtype=f32, device=device),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=device)),
        "d_skip": torch.ones(H, dtype=f32, device=device),
        "norm": {"scale": torch.zeros(di, dtype=cfg.pdtype, device=device)},
        "out_proj": L.dense_init(gen, di, d, cfg.pdtype, device),
    }


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` accumulated in float64 and rounded once to x's
    type: what the CPU's float32 cumsum does, while the card's scan
    accumulates in float32, in an order that depends on the tensor's
    shape.  The SSD takes differences of these sums (chunk end minus
    position), which magnify the scan's error; accumulated in float32 on
    the card, a bf16 mamba2 session's logits changed with its batch, and
    the online logits through 13 float32 zamba2 layers lay 1.8x as far
    from float64 as the CPU's (``chip_smoke.py`` 11d,
    ``scripts/recurrent_xcheck_probe.py``)."""
    return torch.cumsum(x, dim=dim, dtype=torch.float64).to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) with out[..., i, j] = sum_{j<k<=i} x[..., k],
    -inf above the diagonal (strictly causal cumulative log-decay)."""
    Q = x.shape[-1]
    cs = _cumsum(x, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B, S, C), w (K, C).  Returns y and the
    last K-1 inputs (the decode conv state)."""
    K = w.shape[0]
    S = x.shape[1]
    pad = state if state is not None else x.new_zeros(
        (x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([pad.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return y + b.to(x.dtype), new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD scan.  x (B, S, H, P); dt (B, S, H); A (H,); Bm/Cm (B, S, N).

    Returns y (B, S, H, P) and the final state (B, H, P, N), both in
    ``x.dtype``."""
    B_, S, H, Pd = x.shape
    N = Bm.shape[-1]
    acc = widen(x).dtype
    Q = chunk
    if S % Q:
        raise ValueError(f"an SSD block of {S} tokens is not divisible by "
                         f"its chunk {Q}: it must be at most ssm_chunk or a "
                         "multiple of it")
    nc = S // Q
    xc = x.reshape(B_, nc, Q, H, Pd)
    dtc = dt.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, N)
    Cc = Cm.reshape(B_, nc, Q, N)
    dA = (dtc * A[None, None, None, :]).to(acc)          # (B,nc,Q,H)

    # diagonal (within-chunk) term
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))    # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc).to(acc)
    M = scores[:, :, None] * Lmat                        # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M.to(x.dtype),
                          xdt.to(x.dtype))

    # per-chunk states: S_c = sum_k exp(sum_{j>k} dA_j) * dt_k B_k x_k^T
    dA_cum = _cumsum(dA, 2)                              # (B,nc,Q,H)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    xw = xc.to(acc) * (dtc * decay_states)[..., None]    # (B,nc,Q,H,P)
    states = torch.einsum("bckn,bckhp->bchpn", Bc.to(acc), xw)

    # inter-chunk recurrence (emits the state before each chunk)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])         # (B,nc,H)
    s = init_state.to(acc) if init_state is not None else \
        x.new_zeros((B_, H, Pd, N), dtype=acc)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # off-diagonal: y_off[q] = C_q . (exp(dA_cum_q) * S_prev)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc.to(acc), prev_states) \
        * torch.exp(dA_cum)[..., None]
    y = (y_diag.to(acc) + y_off).reshape(B_, S, H, Pd)
    return y.to(x.dtype), s.to(x.dtype)


def _recurrence(xh, dt, A, Bm, Cm, state):
    """The per-token decode recurrence over S tokens: y (B, S, H, P)
    float32 and the final state (B, H, P, N) float32."""
    B_, S, H, Pd = xh.shape
    acc = widen(xh).dtype
    s = state.to(acc) if state is not None else \
        xh.new_zeros((B_, H, Pd, Bm.shape[-1]), dtype=acc)
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * A[None])                      # (B,H)
        xdt = xh[:, t].to(acc) * dt[:, t, :, None]               # (B,H,P)
        s = s * dec[..., None, None] \
            + xdt[..., None] * Bm[:, t].to(acc)[:, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].to(acc), s))
    return torch.stack(ys, dim=1), s


def apply_mamba(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                state: Optional[Dict] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Mamba2 block.  x (B, S, d); state = {'ssm': (B, H, P, N), 'conv':
    (B, K-1, C)}.  ``decode=True`` runs the O(1)-per-token recurrence;
    otherwise the chunked SSD, whose chunk ``min(ssm_chunk, S)`` must
    divide S."""
    B_, S, d = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xr, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    conv_out = F.silu(conv_out)
    xr, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    acc = widen(x).dtype
    dt = F.softplus(widen(dt) + p["dt_bias"].to(acc)[None, None])   # (B,S,H)
    A = -torch.exp(p["a_log"].to(acc))                              # (H,)
    xh = xr.reshape(B_, S, H, Pd)
    ssm_state = state["ssm"] if state is not None else None

    if decode:
        y, final = _recurrence(xh, dt, A, Bm, Cm, ssm_state)
    else:
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, min(cfg.ssm_chunk, S),
                               ssm_state)

    y = y.to(acc) + xh.to(acc) * p["d_skip"].to(acc)[None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.rms_norm(y, p["norm"]["scale"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"ssm": final.to(x.dtype), "conv": new_conv}
