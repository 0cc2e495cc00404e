"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``: ``init_moe``,
``_route``, ``_expert_ffn``, ``_moe_local``, ``_moe_tp_shard``,
``_moe_ep_shard`` and ``apply_moe``).

Token-choice routing: a float32 router, softmax over the experts, top-k,
and combine weights renormalised to sum to 1 (the Mixtral convention).
Dropless: every (token, choice) row is sorted by its expert (a stable
sort), each expert's rows run through its SwiGLU MLP, and the rows go back
to token order to be combined.

Top-k ties (equal router probabilities, as for two identical router
columns) go to the lower expert index, as ``jax.lax.top_k`` resolves
them: the port ranks by a stable descending sort.

The reference's grouped products are ``jax.lax.ragged_dot`` (plain XLA,
not a Pallas kernel).  Here they are one ``torch.matmul`` per non-empty
expert group over the sorted rows: the group sizes are read on the host
once per layer (one synchronisation), and an empty group launches
nothing.

SPLIT OVER THE MODEL AXIS (``dist=``: a mesh with ``n_model > 1`` or a
`distributed.tensor_parallel.TensorParallel` rank; ``params`` is then the
rank's shard).  Every rank of the model axis holds the same rows
(Megatron style) and routes all of them with the whole float32 router,
whose gradient is therefore whole on every rank.  The expert branch
enters through ``copy_to_tp``.  ``cfg.moe_impl`` picks the strategy:

- ``ragged_tp`` (``_moe_tp_shard``): the rank holds its ``d_ff / n``
  columns of every expert's ``wi``/``wg`` and the matching rows of
  ``wo``, runs the dropless path on them and completes ``y`` with one
  reduce over the model axis.
- ``ep`` (``_moe_ep_shard``): the rank holds ``E / n`` whole experts.
  The reference's capacity rule, drop for drop: per block of rows (the
  block its ``shard_map`` gives a data shard), ``C = int((N k / n) *
  1.25) + 1`` with N the block's rows; an assignment's destination is
  its expert's owner and its position the exclusive running count of
  the block's earlier assignments to that owner (token-major,
  choice-minor); positions >= C are dropped and add 0 to the combine,
  with no renormalisation.  The exchange is an all-to-all over the model
  axis and back.  Since every rank holds the same assignments, rank r
  sends each owner only its share of that owner's buffer (slots
  ``[r s, (r + 1) s)``, ``s = ceil(R C / n)`` for R blocks): each kept
  assignment runs once, and one gather over the model axis gives every
  rank the whole result.  (Sending every rank's whole copy, as the
  reference's body does, would hand each owner n cotangents of one row:
  JAX scales them by 1/n, autograd would not.)

UNDER ZeRO-3 TRAINING (``dist=`` a `distributed.fsdp.Fsdp` rank with
``tp=None``): each rank runs the layer whole, its experts gathered, on
its own share of a data block's rows (the batch split over the data
axes and then the model axis, `launch.train.local_rows`).  The
reference's ``shard_map`` hands every model rank the whole data block
(``P(ba)``), so ``ep``'s capacity is reckoned over ``B S / n_data``
rows.  ``_moe_ep_rows`` routes this rank's rows, all-gathers the
integer expert ids over the model axis in rank order (the order the
rows were cut in), reckons ``ep_slots`` over the whole block and runs
the dropless path on its own rows under its slice of that keep mask.
No gradient crosses the gather (it carries ids): the router's and the
experts' come from this rank's rows, and the ZeRO-3 backward sums and
reduce-scatters them as for any other leaf.

`moe_ep_unsharded` computes on one device what ``ep`` at n computes (the
dropless path under the same keep mask); `EP_DROPS` counts the
assignments ``ep`` dropped, once per data block (model rank 0's calls).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, d: int, f: int,
             device) -> Dict[str, torch.Tensor]:
    """Router (d, E) float32 whatever ``param_dtype`` is; expert weights
    (E, d, f) / (E, f, d) ~ N(0, 1/d_in) in ``param_dtype``, drawn one
    expert at a time (no (E, ...) float32 temporary)."""
    E = cfg.n_experts

    def ei(a, b):
        out = torch.empty((E, a, b), dtype=cfg.pdtype, device=device)
        if out.is_meta:                 # shapes only: nothing to draw
            return out
        for e in range(E):
            out[e] = L.normal(gen, (a, b), 1.0 / math.sqrt(a), cfg.pdtype,
                              device)
        return out
    return {"router": L.dense_init(gen, d, E, torch.float32, device),
            "wi": ei(d, f), "wg": ei(d, f), "wo": ei(f, d)}


def _route(cfg: ModelConfig, router_w: torch.Tensor, xf: torch.Tensor):
    """xf (N, d) -> combine weights (N, k) float32, expert ids (N, k)
    int64, the heavier choice first (ties: the lower expert id)."""
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, topi


def _expert_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                xs: torch.Tensor, sizes) -> torch.Tensor:
    """Grouped expert MLP: xs (M, d) sorted by expert, ``sizes`` the E
    group sizes (host ints).  One matmul chain per non-empty group; with
    no row at all, one chain over none (the weights stay in the graph,
    their gradient 0)."""
    # one view per expert, taken once: under autograd an unbind's backward
    # stacks the experts' gradients, where each p["wg"][e] would add a
    # zero tensor the size of the whole (E, d, f) weight
    wg, wi, wo = (p[k].unbind(0) for k in ("wg", "wi", "wo"))

    def chain(e, xe):
        h = F.silu(xe @ wg[e].to(xs.dtype)) * (xe @ wi[e].to(xs.dtype))
        return h @ wo[e].to(xs.dtype)
    outs = []
    start = 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(chain(e, xs[start:start + n]))
            start += n
    return torch.cat(outs) if outs else chain(0, xs[:0])


def _spread(total: int, parts: int) -> list:
    """``total`` rows over ``parts`` groups as evenly as they go."""
    return [total // parts + (i < total % parts) for i in range(parts)]


def host_counts(ids: torch.Tensor, n: int, expect: list,
                keep: torch.Tensor = None) -> list:
    """``bincount(ids, minlength=n)`` as host ints, and after them the
    number of False in ``keep`` when given: a layer's one host read (one
    synchronisation).  A meta tensor (the dry run, `launch.dryrun`:
    shapes, no values) has no ids to count; the counts are then
    ``expect``, each group at its expected load (the one place the model
    code reads the device that the meta device cannot answer)."""
    if ids.is_meta:
        return list(expect)
    parts = [torch.bincount(ids, minlength=n)]
    if keep is not None:
        parts.append((~keep).sum().view(1))
    return torch.cat(parts).tolist()


def _moe_local(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               xf: torch.Tensor, keep=None, tp=None) -> torch.Tensor:
    """Sort-based MoE: xf (N, d) -> (N, d), dropless unless ``keep``
    masks assignments out: a (N, k) bool tensor, or a function of the
    expert ids (N, k) that gives one (the router runs once either way).
    A dropped assignment adds 0 to the combine; the others keep their
    weights (no renormalisation).  ``tp`` (``ragged_tp``): ``p`` holds
    this rank's ``d_ff`` slice of every expert, the expert branch enters
    through ``copy_to_tp`` and its partial sums leave through one reduce
    over the model axis (``_moe_tp_shard``)."""
    topw, topi = _route(cfg, p["router"], xf)
    if keep is not None:
        keep = keep(topi) if callable(keep) else keep
        topw = topw * keep
    return _combine(cfg, p, xf, topw, topi, tp)


def _combine(cfg: ModelConfig, p: Dict[str, torch.Tensor], xf: torch.Tensor,
             topw: torch.Tensor, topi: torch.Tensor, tp=None,
             block_keep=None) -> torch.Tensor:
    """`_moe_local` after its router: each row's ``k`` assignments through
    their experts, combined by ``topw``.  ``block_keep``: the keep mask
    of the whole data block, whose assignments and drops go to
    `EP_DROPS` (read with the group sizes: the layer's one host read)."""
    N, d = xf.shape
    k, E = cfg.top_k, cfg.n_experts
    eids = topi.reshape(-1)                                   # (N*k,)
    order = torch.argsort(eids, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    xr = TPX.copy_to_tp(xf, tp).repeat_interleave(k, dim=0)[order]
    expect = _spread(N * k, E) + ([] if block_keep is None else [0])
    stats = host_counts(eids, E, expect, block_keep)
    if block_keep is not None:
        EP_DROPS["assignments"] += block_keep.numel()
        EP_DROPS["dropped"] += stats[E]
    y = TPX.reduce_from_tp(_expert_ffn(cfg, p, xr, stats[:E]), tp)[inv]
    y = y.reshape(N, k, d) * topw[..., None].to(y.dtype)
    return y.sum(dim=1)


def _moe_tp_shard(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  xf: torch.Tensor, tp) -> torch.Tensor:
    """``ragged_tp`` on one rank: the dropless path over its ``d_ff``
    slice, one reduce over the model axis."""
    f = cfg.d_ff // tp.n
    if p["wi"].shape[-1] != f:
        raise ValueError(f"ragged_tp: expert weights with d_ff "
                         f"{p['wi'].shape[-1]}, not this rank's {f} of "
                         f"{cfg.d_ff} (tensor_parallel.shard_params)")
    return _moe_local(cfg, p, xf, tp=tp)


# ---------------------------------------------------------------------------
# ep: experts over the model axis, the capacity-bounded all-to-all
# ---------------------------------------------------------------------------

CAPACITY_FACTOR = 1.25
EP_DROPS = {"assignments": 0, "dropped": 0}


def ep_capacity(rows: int, k: int, n: int) -> int:
    """The reference's per-owner capacity for a block of ``rows`` rows
    (``_moe_ep_shard``), reckoned in Python floats as there."""
    return int((rows * k / n) * CAPACITY_FACTOR) + 1


def ep_slots(topi: torch.Tensor, e_local: int, n: int, blocks: int = 1,
             capacity: bool = True):
    """Where ``ep`` at ``n`` puts each assignment of the expert ids
    ``topi`` (N, k): (owner (N*k,), slot (N*k,), keep (N*k,), C).  The
    rows are ``blocks`` contiguous blocks, each with its own capacity C
    and running counts; block b's assignments take slots ``[b C, (b +
    1) C)`` of their owner's buffer.  ``capacity=False``: dropless, C the
    block's whole count of assignments."""
    N, k = topi.shape
    if N % blocks:
        raise ValueError(f"ep: {N} rows do not split into {blocks} blocks "
                         "(the reference's shard_map splits them over the "
                         "data axes)")
    nb = N // blocks
    dest = (topi // e_local).reshape(blocks, nb * k)
    onehot = F.one_hot(dest, n)                          # (R, nb*k, n)
    prior = onehot.cumsum(1) - onehot
    pos = prior.gather(2, dest[..., None])[..., 0]
    C = ep_capacity(nb, k, n) if capacity else nb * k
    slot = torch.arange(blocks, device=topi.device)[:, None] * C + pos
    return dest.reshape(-1), slot.reshape(-1), (pos < C).reshape(-1), C


def ep_keep(cfg: ModelConfig, n: int, blocks: int = 1):
    """The keep mask ``ep`` at ``n`` applies, as a function of the expert
    ids (N, k) (`_moe_local`'s ``keep``)."""
    def keep(topi):
        return ep_slots(topi, cfg.n_experts // n, n, blocks)[2] \
            .reshape(topi.shape)
    return keep


def moe_ep_unsharded(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, n: int,
                     blocks: int = 1) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) on one device, as ``ep`` over a model axis
    of ``n`` computes it: the dropless path with ``ep``'s drops."""
    B, S, d = x.shape
    return _moe_local(cfg, p, x.reshape(B * S, d),
                      keep=ep_keep(cfg, n, blocks)).reshape(B, S, d)


def _moe_ep_rows(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 xf: torch.Tensor, fs) -> torch.Tensor:
    """``ep`` on a ZeRO-3 training rank (module docstring): ``p`` the
    whole experts, ``xf`` this rank's share of a data block's rows, every
    model rank's share of equal size.  The drops are ``ep_slots``' over
    the block, from the ids gathered over the model axis."""
    N = xf.shape[0]
    topw, topi = _route(cfg, p["router"], xf)
    ids = fs.coll.gather(topi, 0)                 # the block's, in row order
    keep = ep_slots(ids, cfg.n_experts // fs.n, fs.n)[2].reshape(ids.shape)
    mine = keep[fs.rank * N:(fs.rank + 1) * N]
    return _combine(cfg, p, xf, topw * mine, topi,
                    block_keep=keep if fs.rank == 0 else None)


class _AllToAll(torch.autograd.Function):
    """x (n, ...) -> (n, ...): row j of the output is rank j's row r.  Its
    own adjoint: the backward is the reverse all-to-all."""
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return coll.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_to_all(g.contiguous()), None


def _moe_ep_shard(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  xf: torch.Tensor, tp) -> torch.Tensor:
    """``ep`` on one rank (module docstring): route, send this rank's
    share of every owner's buffer, run the local experts on what arrives,
    send it back, gather every rank's share, combine."""
    N, d = xf.shape
    n, r, k = tp.n, tp.rank, cfg.top_k
    e_local = p["wi"].shape[0]
    if e_local * n != cfg.n_experts:
        raise ValueError(f"ep: {e_local} experts a rank over a model axis "
                         f"of {n}, not {cfg.n_experts} (tensor_parallel."
                         "shard_params)")
    topw, topi = _route(cfg, p["router"], xf)
    dest, slot, keep, C = ep_slots(topi, e_local, n, tp.row_blocks,
                                   tp.ep_capacity)
    s = -(-tp.row_blocks * C // n)             # this rank's share a buffer
    lo = r * s
    mine = keep & (slot >= lo) & (slot < lo + s)
    # (owner, slot) -> the assignment that fills it; the rest point at a
    # zero row (N*k) with the no-op expert id e_local
    dev = xf.device
    fill = torch.full((n * (s + 1),), N * k, dtype=torch.long, device=dev)
    at = dest * (s + 1) + torch.where(mine, slot - lo, s)
    fill.index_copy_(0, at, torch.arange(N * k, device=dev))
    fill = fill.view(n, s + 1)[:, :s]
    xr = TPX.copy_to_tp(xf, tp).repeat_interleave(k, dim=0)
    xr = torch.cat([xr, xr.new_zeros(1, d)])
    ids = torch.cat([topi.reshape(-1) % e_local,
                     topi.new_full((1,), e_local)])
    rx = _AllToAll.apply(xr[fill], tp.coll).reshape(n * s, d)
    re = tp.coll.all_to_all(ids[fill]).reshape(n * s)
    order = torch.argsort(re, stable=True)
    kept = min(N * k // n, tp.row_blocks * C)   # the meta device's load
    stats = host_counts(re, e_local + 1, _spread(kept, e_local)
                        + [n * s - kept, N * k - n * kept], keep)
    sizes, dropped = stats[:e_local], stats[-1]
    if tp.rank == 0:
        EP_DROPS["assignments"] += N * k
        EP_DROPS["dropped"] += dropped
    m = sum(sizes)
    ys = _expert_ffn(cfg, p, rx[order[:m]], sizes)
    ys = torch.cat([ys, ys.new_zeros(n * s - m, d)])
    y = torch.empty_like(ys).index_copy(0, order, ys).view(n, s, d)
    back = _AllToAll.apply(y, tp.coll)             # my share of each owner
    whole = TPX.gather_from_tp(back, tp, dim=1)    # (n, n s, d)
    out = whole[dest, torch.where(keep, slot, 0)]
    out = out * keep[:, None].to(out.dtype)
    out = out.reshape(N, k, d) * topw[..., None].to(out.dtype)
    return out.sum(dim=1)


def apply_moe(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              dist=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) through the experts; with ``dist``
    splitting the model, through ``cfg.moe_impl``'s strategy on this
    rank's shard; on a ZeRO-3 training rank, the whole experts on its
    rows, with ``ep``'s drops over its data block (module docstring)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    tp = TPX.tp_of(cfg, dist)
    if tp is None and isinstance(dist, FS.Fsdp) and dist.n > 1 \
            and cfg.moe_impl == "ep":
        y = _moe_ep_rows(cfg, p, xf, dist)
    elif tp is None:
        y = _moe_local(cfg, p, xf)
    elif cfg.moe_impl == "ep":
        y = _moe_ep_shard(cfg, p, xf, tp)
    else:
        y = _moe_tp_shard(cfg, p, xf, tp)
    return y.reshape(B, S, d)
