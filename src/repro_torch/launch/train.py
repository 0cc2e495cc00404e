"""Training: the CCM train step and a fault-tolerant loop (port of
``repro/launch/train.py``).

``make_train_step`` builds one step: the CCM parallel forward (paper
Alg. 1), the masked tail loss, backprop restricted to the trainable
partition (LoRA-only by default, the paper's regime), the data-parallel
gradient reduce with ``dist=`` (optionally through a gradient codec) and
the AdamW update.  ``TrainLoop`` adds checkpoint/restart (atomic +
async), a step-time watchdog and a deterministic restartable data order.
Steps are timed on ``repro_torch.obs.clock``'s monotonic clock, the
port's one reader of the stdlib clock
(``scripts/check_no_stray_timers.py``); a test injects its own
``clock=``.

DATA PARALLEL (``dist=``, a `distributed.context.DistContext` over a
mesh with ``n_model == 1``): one process per rank, every rank holding
the whole model.  Each rank draws the same global batch and trains on
its contiguous block of rows (``batch_spec``: rank r of the data and
pod axes holds rows [r B/n, (r+1) B/n), as GSPMD places them).  With
``grad_codec="none"`` the ranks reproduce the reference's global
masked mean: the mask count is all-reduced before the division and the
gradients are SUM-all-reduced.  With a codec ("int8", "topk") they do
what the reference's ``shard_map`` does: per-rank means,
``compressed_psum`` (codec + error feedback, then a SUM all-reduce),
``/ n_data`` and the mean of the ranks' losses; rank r's error-feedback
residual is row r of the reference's ``(n_data,) + shape`` one.

TENSOR PARALLEL (``n_model > 1``, every family; MoE under either
``moe_impl``): the rows split over the batch axes as above (``frames``
and ``patches`` with them), and the model over the ``model`` axis
(`distributed.tensor_parallel`): each rank holds its shard of the
trainable and frozen trees and of the moments (``tensor_parallel.
shard_params``; `jit_train_step`'s ``place``), runs its share of every
block and the vocab-parallel loss, and the gradients of its local leaves
are whole for its shard.  The data-axis reduce and its codec act on the
local leaves (an error-feedback residual covers them); a leaf split
over the model axis takes its int8 scale and its top-k threshold over
the whole leaf, as the reference's automatic model axis does, and the
clipping norm sums the split leaves over the model axis.  ``TrainLoop``
writes whole leaves (``tensor_parallel.gather_params``), so a
checkpoint does not depend on the mesh.
ZERO-3 (``cfg.sharding_strategy == "fsdp"``, `distributed.fsdp`): each
rank stores its ``param_spec`` block of every leaf and of its moments
(``fsdp.shard_fsdp``; `jit_train_step`'s ``place``), takes its own block
of rows over EVERY mesh axis (data, then model, rank-major: the
reference's train cell), and runs each layer whole on them, its leaves
gathered as it runs; the gather's backward reduce-scatters the
gradient over the model axis.  An ``ep`` MoE drops what the
reference's ``shard_map`` drops over the whole data block
(`models.moe`: the expert ids are gathered over the model axis).  A
leaf stored whole (a ``P()`` spec) has a partial gradient on each model
rank, all-reduced over the model axis first.  Then the data-axis
reduce (and its codec) acts as above: a stored block takes its int8
scale and top-k threshold over the whole leaf, and the clipping norm
sums the stored blocks' squares over the model axis.  Rows that do
not split over ``n_data * n_model`` raise ValueError.  The loss's
divisor is the mask count over every axis (with a codec, the data
block's: the model axis's).
On one device ``grad_codec`` is accepted and the step trains exactly as
with "none", as the reference does with ``dist=None`` (no residual is
allocated; the reference allocates one and never reads it).  The loop
runs on the CUDA card unless ``device="cpu"``.

A batch for the encoder-decoder carries ``frames`` (B, Se, d) and one for
the VLM ``patches`` (B, P, 1024) beside ``tokens`` and ``loss_mask``, as
the reference's loss reads them.  ``sample_kv_batch`` makes neither,
in the reference as here, so ``TrainLoop``, which samples its own
batches, stops with a KeyError on these two families as the
reference's does; ``make_train_step`` trains them on batches that carry
the inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as tdist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import masks as M
from repro_torch.data.synthetic import ShardableIndexIterator, sample_kv_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.distributed.context import DistContext, divisible
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs.clock import perf_counter
from repro_torch.optim import partition as PT
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)
from repro_torch.optim.grad_compress import (EFState, compressed_psum,
                                             init_ef)
from repro_torch.optim.losses import next_token_loss


def check_mesh(cfg: ModelConfig, dist: Optional[DistContext]) -> None:
    """A mesh that splits the model (``n_model > 1``) takes every family,
    an MoE one where its experts split over it
    (`tensor_parallel.require_tp_family`), under either strategy."""
    if dist is not None and dist.n_model > 1:
        TPX.require_tp_family(cfg, dist.n_model)


def trainable_mask_for(cfg: ModelConfig, params) -> Any:
    if cfg.train_mode == "lora":
        return PT.trainable_mask(params, PT.lora_predicate)
    return PT.trainable_mask(params, lambda _: True)


def _loss_fn(tp, fp, cfg: ModelConfig, layout: M.SegmentLayout,
             batch: Dict[str, torch.Tensor], dist=None,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked tail loss; ``count`` is the divisor's mask count (see
    `next_token_loss`).  The forward runs on this rank's rows alone; with
    a mesh that splits the model (or a `TensorParallel` rank), on this
    rank's shard of it; with a `distributed.fsdp.Fsdp` rank, its ZeRO-3
    storage."""
    tpx = TPX.tp_of(cfg, dist)
    params = PT.merge(tp, fp)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patches"] = batch["patches"]
    logits = T.train_forward(params, cfg, batch["tokens"], layout, dist=dist,
                             **kw)
    tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
    return next_token_loss(logits, tail, batch["loss_mask"], count, tp=tpx)


def row_axes(cfg: ModelConfig, dist: DistContext) -> tuple:
    """The mesh axes a training batch's rows split over: the data and pod
    axes (``batch_spec``), and under ``fsdp`` the model axis after them
    (the reference's ZeRO-3 train cell)."""
    if cfg.sharding_strategy == "fsdp":
        return tuple(dist.batch_axes) + (dist.model_axis,)
    return tuple(dist.batch_axes)


def local_rows(batch: Dict[str, torch.Tensor], dist: DistContext,
               axes=None) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch: the batch dim split over
    ``axes`` (default the data and pod axes, ``batch_spec``), rank-major."""
    axes = tuple(dist.batch_axes) if axes is None else tuple(axes)
    n = TPX._size(dist, axes)
    r = dist.rank_in(axes)
    out = {}
    for k, v in batch.items():
        if not divisible(v.shape[0], n):
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {n} ranks of {axes}")
        b = v.shape[0] // n
        out[k] = v[r * b:(r + 1) * b]
    return out


def make_train_step(cfg: ModelConfig, layout: M.SegmentLayout,
                    opt_cfg: AdamWConfig, dist: Optional[DistContext] = None,
                    grad_codec: str = "none",
                    topk_frac: float = 0.01) -> Callable:
    """Returns step(train_params, frozen_params, opt_state, batch, ef)
    -> (train_params, opt_state, metrics, ef).  Train params and moments
    are updated in place.  ``grad_codec`` acts on the data-parallel
    reduce only, so on one device ``ef`` (the error-feedback state) is
    passed through unchanged; with ``dist=`` it is this rank's
    residual, returned updated.  With a mesh that splits the model, the
    trees are this rank's shards (`jit_train_step`'s ``place``).  The
    model axis's process group is taken at the first step, so building
    a step needs none."""
    check_mesh(cfg, dist)

    def step(tp, fp, opt: AdamWState, batch, ef: Optional[EFState] = None):
        fs = FS.train_rank(cfg, dist) if dist is not None \
            and cfg.sharding_strategy == "fsdp" else None
        tpx = None if fs is not None else TPX.tp_of(cfg, dist)
        leaves = [x for _, x in PT.leaves(tp)]
        for x in leaves:
            x.requires_grad_(True)
        count = None
        if dist is not None:
            group = dist.group(dist.batch_axes)
            rows = row_axes(cfg, dist)
            batch = local_rows(batch, dist, rows)
            mask = batch["loss_mask"].float().sum()
            if grad_codec == "none":
                # the global masked mean: divide by the global count
                count = dist.all_reduce(mask, rows)
            elif fs is not None:
                # the data block's mean, as the reference's codec sees it
                count = dist.all_reduce(mask, dist.model_axis)
        with torch.enable_grad():
            loss = _loss_fn(tp, fp, cfg, layout, batch, dist=fs or tpx,
                            count=count)
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        it = iter(grads)
        gtree = PT.tree_map(lambda _, x: None if x is None else next(it), tp)
        # the model-axis collectives at each leaf split over that axis
        # (tensor parallel) or stored cut over it (ZeRO-3)
        split = None
        if tpx is not None:
            split = PT.tree_map(
                lambda path, g: tpx.coll if g is not None and TPX.split_dim(
                    path, cfg, tpx.n) is not None else None, gtree)
        elif fs is not None:
            split = PT.tree_map(
                lambda path, g: fs.coll if g is not None and FS.gather_dim(
                    path, cfg, fs.n) is not None else None, gtree)
            # a leaf stored whole: each model rank's rows gave a part
            gtree = PT.tree_map(lambda _, g, c: g if g is None or c is not
                                None else fs.coll.sum(g), gtree, split)
            loss = fs.coll.sum(loss)
        if dist is not None:
            gtree, ef = compressed_psum(gtree, group, ef, grad_codec,
                                        topk_frac, split)
            loss = dist.all_reduce(loss.clone(), dist.batch_axes)
            if grad_codec != "none":
                # the reference's `/ nb` of the psum, and its pmean
                gtree = PT.tree_map(
                    lambda _, g: None if g is None else g / dist.n_data,
                    gtree)
                loss = loss / dist.n_data
        # (one model rank holds whole leaves: AdamW's own norm)
        gnorm = None if split is None or (fs or tpx).n == 1 else \
            _split_global_norm(gtree, split, (fs or tpx).coll)
        tp, opt, metrics = adamw_update(opt_cfg, tp, gtree, opt, gnorm=gnorm)
        metrics["loss"] = loss
        return tp, opt, metrics, ef

    return step


def _split_global_norm(grads, split, coll) -> torch.Tensor:
    """The whole model's gradient norm from a rank's local leaves: the
    squares of the leaves split (or stored cut) over the model axis
    summed over it, the whole leaves' counted once."""
    parts = {True: [], False: []}
    PT.tree_map(lambda _, g, c: None if g is None else
                parts[c is not None].append(torch.sum(g.float() ** 2)),
                grads, split)
    dev = next(g for _, g in PT.leaves(grads)).device
    total = torch.zeros((), device=dev)
    if parts[True]:
        total = coll.sum(torch.stack(parts[True]).sum())
    if parts[False]:
        total = total + torch.stack(parts[False]).sum()
    return torch.sqrt(total)


class PlacedStep:
    """`jit_train_step`'s step: ``step_fn`` on this rank's shards, and
    ``place(tp, fp, opt)``, which cuts the whole trees (and moments) into
    this rank's shards by the local layout (`tensor_parallel`), or under
    ``fsdp`` into its ``param_spec`` blocks (`distributed.fsdp`), the
    counterpart of the reference's in/out shardings.  The reference's jit
    re-places its arguments at every call; the port's step updates its
    shards in place, so they are placed once and passed back as they
    come out.  ``gather(tree)`` gives the whole leaves back (every rank
    calls it: it is a collective over the model axis)."""

    def __init__(self, step_fn, cfg: ModelConfig, dist: DistContext):
        self.step_fn, self.cfg, self.dist = step_fn, cfg, dist

    def __call__(self, tp, fp, opt, batch, ef=None):
        return self.step_fn(tp, fp, opt, batch, ef)

    def place(self, tp, fp, opt: Optional[AdamWState] = None):
        def cut(t):
            return FS.shard_model(t, self.cfg, self.dist)
        placed = (cut(tp), cut(fp))
        if opt is None:
            return placed
        return placed + (opt._replace(mu=cut(opt.mu), nu=cut(opt.nu)),)

    def gather(self, tree):
        return FS.gather_model(tree, self.cfg, self.dist)


def jit_train_step(step_fn, cfg: ModelConfig, dist: DistContext,
                   params_shapes, opt_shapes, batch_shapes,
                   trainable) -> PlacedStep:
    """The reference pjits the step with in/out shardings from the rules.
    The port compiles nothing: every rank runs ``step_fn`` eagerly on its
    block of the batch (`local_rows`) and on its shard of the model
    (``PlacedStep.place``: whole leaves on a data-parallel mesh, where
    every model-axis spec is one block).  This checks the mesh and the
    batch's split (under ``fsdp`` over every mesh axis: `row_axes`)."""
    del params_shapes, opt_shapes, trainable
    check_mesh(cfg, dist)
    axes = row_axes(cfg, dist)
    n = TPX._size(dist, axes)
    for k, v in batch_shapes.items():
        if not divisible(v.shape[0], n):
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {n} ranks of {axes}")
    return PlacedStep(step_fn, cfg, dist)


# ===========================================================================
# fault-tolerant loop
# ===========================================================================

@dataclasses.dataclass
class WatchdogStats:
    """Step-time watchdog: flags straggling steps (> threshold x median)."""
    times: list = dataclasses.field(default_factory=list)
    threshold: float = 3.0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < 5:
            return False
        recent = sorted(self.times[-50:])
        return dt > self.threshold * recent[len(recent) // 2]


class TrainLoop:
    """Checkpointed, restartable training loop.  With ``dist=`` every rank
    runs one loop over the same data order and checkpoint layout: rank 0
    writes the checkpoints, every rank reads them (`maybe_restore`), and
    ``run`` returns on every rank once the last one is on disk.  On a
    mesh that splits the model every rank initialises the whole model
    from ``seed`` and keeps its shard (under ``fsdp``, its ``param_spec``
    blocks); a checkpoint holds the whole leaves (gathered over the model
    axis), so it restores onto any mesh and under either strategy."""

    def __init__(self, cfg: ModelConfig, layout: M.SegmentLayout,
                 opt_cfg: AdamWConfig, batch_size: int,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 dist: Optional[DistContext] = None, ckpt_every: int = 50,
                 grad_codec: str = "none", device: DeviceLike = None,
                 clock: Optional[Callable[[], float]] = None):
        check_mesh(cfg, dist)
        self.device = resolve_device(device)
        self.cfg, self.layout, self.opt_cfg = cfg, layout, opt_cfg
        self.batch_size = batch_size
        self.dist = dist
        params = T.init_lm(cfg, seed, device=self.device)
        self.trainable = trainable_mask_for(cfg, params)
        self.split = dist is not None and dist.n_model > 1
        self.tpx = None if cfg.sharding_strategy == "fsdp" \
            else TPX.tp_of(cfg, dist)
        if self.split:
            params = FS.shard_model(params, cfg, dist)
        self.tp, self.fp = PT.partition(params, self.trainable)
        self.opt = init_adamw(self.tp)
        # this rank's error-feedback residual (one device: no reduce, so
        # no residual)
        self.ef = init_ef(self.tp) if dist is not None \
            and grad_codec != "none" else None
        self.it = ShardableIndexIterator(seed, batch_size)
        self.step_fn = make_train_step(cfg, layout, opt_cfg, dist,
                                       grad_codec=grad_codec)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self._writes = dist is None or tdist.get_rank() == 0
        self.ckpt_every = ckpt_every
        self.clock = clock if clock is not None else perf_counter
        self.watchdog = WatchdogStats()
        self.history: list = []

    # ------------------------------------------------------------------
    def maybe_restore(self) -> int:
        if self.ckpt is None:
            return 0
        latest = self.ckpt.latest()
        if latest is None:
            return 0
        restored, extra = self.ckpt.restore(latest, {"tp": self.tp,
                                                     "opt": self.opt})
        self.tp, self.opt = restored["tp"], restored["opt"]
        if self.split:                      # whole leaves -> this shard
            self.tp, self.opt = self._each(self.tp, self.opt,
                                           FS.shard_model)
        self.it.load_state_dict(extra["iterator"])
        return int(extra["step"])

    def run(self, n_steps: int, start_step: int = 0,
            log_every: int = 10) -> list:
        for s in range(start_step, n_steps):
            batch = sample_kv_batch(self.it.next_key(), self.layout,
                                    self.batch_size, device=self.device)
            t0 = self.clock() if self.clock else None
            self.tp, self.opt, metrics, self.ef = self.step_fn(
                self.tp, self.fp, self.opt, batch, self.ef)
            loss = float(metrics["loss"])          # waits for the step
            dt = self.clock() - t0 if self.clock else None
            straggle = dt is not None and self.watchdog.record(dt)
            self.history.append({"step": s, "loss": loss, "dt": dt,
                                 "straggler": straggle})
            if log_every and s % log_every == 0:
                ms = "" if dt is None else f" dt {dt * 1e3:7.1f}ms"
                print(f"step {s:5d} loss {loss:.4f}{ms}"
                      f"{'  STRAGGLER' if straggle else ''}")
            if self.ckpt and (s + 1) % self.ckpt_every == 0:
                self._save(s + 1)
        if self.ckpt:
            self.ckpt.wait()
        if self.dist is not None:
            # every rank returns once rank 0's checkpoints are on disk
            tdist.barrier()
        return self.history

    def _each(self, tp, opt, fn):
        """``fn(tree, cfg, dist)`` on the trainable tree and the moments."""
        return fn(tp, self.cfg, self.dist), opt._replace(
            mu=fn(opt.mu, self.cfg, self.dist),
            nu=fn(opt.nu, self.cfg, self.dist))

    def _save(self, step: int) -> None:
        tp, opt = self.tp, self.opt
        if self.split:                      # every rank gathers
            tp, opt = self._each(tp, opt, FS.gather_model)
        if self._writes:
            self.ckpt.save(step, {"tp": tp, "opt": opt},
                           extra={"step": step,
                                  "iterator": self.it.state_dict()})
