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
Tensor parallelism (``n_model > 1``) raises ``NotImplementedError``.
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


def _data_parallel_only(dist: Optional[DistContext]) -> None:
    if dist is not None and dist.n_model > 1:
        raise NotImplementedError(
            "tensor parallelism (a mesh with n_model > 1) comes with slice "
            "14 of the port's multi-device work; data-parallel meshes "
            "(n_model == 1) train")


def trainable_mask_for(cfg: ModelConfig, params) -> Any:
    if cfg.train_mode == "lora":
        return PT.trainable_mask(params, PT.lora_predicate)
    return PT.trainable_mask(params, lambda _: True)


def _loss_fn(tp, fp, cfg: ModelConfig, layout: M.SegmentLayout,
             batch: Dict[str, torch.Tensor], dist=None,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked tail loss; ``count`` is the divisor's mask count (see
    `next_token_loss`).  The forward runs on this rank's rows alone, so
    ``dist`` only has to be data-parallel."""
    _data_parallel_only(dist)
    params = PT.merge(tp, fp)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patches"] = batch["patches"]
    logits = T.train_forward(params, cfg, batch["tokens"], layout, **kw)
    tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
    return next_token_loss(logits, tail, batch["loss_mask"], count)


def local_rows(batch: Dict[str, torch.Tensor],
               dist: DistContext) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch (``batch_spec``: the batch dim
    split over the data and pod axes, rank-major)."""
    n = dist.n_data
    r = dist.rank_in(dist.batch_axes)
    out = {}
    for k, v in batch.items():
        if not divisible(v.shape[0], n):
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {n} data ranks")
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
    residual, returned updated."""
    _data_parallel_only(dist)

    def step(tp, fp, opt: AdamWState, batch, ef: Optional[EFState] = None):
        leaves = [x for _, x in PT.leaves(tp)]
        for x in leaves:
            x.requires_grad_(True)
        count = None
        if dist is not None:
            group = dist.group(dist.batch_axes)
            batch = local_rows(batch, dist)
            if grad_codec == "none":
                # the global masked mean: divide by the global count
                count = dist.all_reduce(batch["loss_mask"].float().sum(),
                                        dist.batch_axes)
        with torch.enable_grad():
            loss = _loss_fn(tp, fp, cfg, layout, batch, count=count)
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        it = iter(grads)
        gtree = PT.tree_map(lambda _, x: None if x is None else next(it), tp)
        if dist is not None:
            gtree, ef = compressed_psum(gtree, group, ef, grad_codec,
                                        topk_frac)
            loss = dist.all_reduce(loss.clone(), dist.batch_axes)
            if grad_codec != "none":
                # the reference's `/ nb` of the psum, and its pmean
                gtree = PT.tree_map(
                    lambda _, g: None if g is None else g / dist.n_data,
                    gtree)
                loss = loss / dist.n_data
        tp, opt, metrics = adamw_update(opt_cfg, tp, gtree, opt)
        metrics["loss"] = loss
        return tp, opt, metrics, ef

    return step


def jit_train_step(step_fn, cfg: ModelConfig, dist: DistContext,
                   params_shapes, opt_shapes, batch_shapes,
                   trainable) -> Callable:
    """The reference pjits the step with in/out shardings from the rules.
    The port compiles nothing: every rank runs ``step_fn`` eagerly on its
    block of the batch (`local_rows`), parameters and moments replicated.
    That is the rules' layout when ``n_model == 1`` — every model-axis
    spec is then one block — so this checks the mesh and the batch's
    split and returns ``step_fn``."""
    del params_shapes, opt_shapes, trainable
    _data_parallel_only(dist)
    for k, v in batch_shapes.items():
        if not divisible(v.shape[0], dist.n_data):
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {dist.n_data} data ranks")
    return step_fn


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
    ``run`` returns on every rank once the last one is on disk."""

    def __init__(self, cfg: ModelConfig, layout: M.SegmentLayout,
                 opt_cfg: AdamWConfig, batch_size: int,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 dist: Optional[DistContext] = None, ckpt_every: int = 50,
                 grad_codec: str = "none", device: DeviceLike = None,
                 clock: Optional[Callable[[], float]] = None):
        _data_parallel_only(dist)
        self.device = resolve_device(device)
        self.cfg, self.layout, self.opt_cfg = cfg, layout, opt_cfg
        self.batch_size = batch_size
        self.dist = dist
        params = T.init_lm(cfg, seed, device=self.device)
        self.trainable = trainable_mask_for(cfg, params)
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
            if self.ckpt and self._writes \
                    and (s + 1) % self.ckpt_every == 0:
                self.ckpt.save(s + 1, {"tp": self.tp, "opt": self.opt},
                               extra={"step": s + 1,
                                      "iterator": self.it.state_dict()})
        if self.ckpt:
            self.ckpt.wait()
        if self.dist is not None:
            # every rank returns once rank 0's checkpoints are on disk
            tdist.barrier(
                group=self.dist.group(self.dist.batch_axes))
        return self.history
