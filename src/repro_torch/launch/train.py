"""Training: the CCM train step and a fault-tolerant loop (port of
``repro/launch/train.py``, single device).

``make_train_step`` builds one step: the CCM parallel forward (paper
Alg. 1), the masked tail loss, backprop restricted to the trainable
partition (LoRA-only by default, the paper's regime) and the AdamW
update.  ``TrainLoop`` adds checkpoint/restart (atomic + async), a
step-time watchdog and a deterministic restartable data order.  Steps
are timed on ``repro_torch.obs.clock``'s monotonic clock, the port's one
reader of the stdlib clock (``scripts/check_no_stray_timers.py``); a
test injects its own ``clock=``.

``grad_codec`` ("int8", "topk") compresses gradients on the
data-parallel reduce only: on one device it is accepted and the step
trains exactly as with "none", as the reference does with ``dist=None``
(no error-feedback residual is allocated; the reference allocates one
and never reads it).  Not ported:
``DistContext`` meshes and ``jit_train_step`` (pjit); ``dist=`` raises.
The loop runs on the CUDA card unless ``device="cpu"``.

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

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import masks as M
from repro_torch.data.synthetic import ShardableIndexIterator, sample_kv_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs.clock import perf_counter
from repro_torch.optim import partition as PT
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)
from repro_torch.optim.losses import next_token_loss


def _single_device(dist) -> None:
    if dist is not None:
        raise NotImplementedError("DistContext (multi-device training) is "
                                  "not ported")


def trainable_mask_for(cfg: ModelConfig, params) -> Any:
    if cfg.train_mode == "lora":
        return PT.trainable_mask(params, PT.lora_predicate)
    return PT.trainable_mask(params, lambda _: True)


def _loss_fn(tp, fp, cfg: ModelConfig, layout: M.SegmentLayout,
             batch: Dict[str, torch.Tensor], dist=None) -> torch.Tensor:
    _single_device(dist)
    params = PT.merge(tp, fp)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patches"] = batch["patches"]
    logits = T.train_forward(params, cfg, batch["tokens"], layout, **kw)
    tail = batch["tokens"][:, layout.seq_len - layout.tail_len:]
    return next_token_loss(logits, tail, batch["loss_mask"])


def make_train_step(cfg: ModelConfig, layout: M.SegmentLayout,
                    opt_cfg: AdamWConfig, dist=None,
                    grad_codec: str = "none") -> Callable:
    """Returns step(train_params, frozen_params, opt_state, batch, ef)
    -> (train_params, opt_state, metrics, ef).  Train params and moments
    are updated in place.  ``grad_codec`` acts on the data-parallel
    reduce only, so on one device ``ef`` (the error-feedback state) is
    passed through unchanged."""
    _single_device(dist)

    def step(tp, fp, opt: AdamWState, batch, ef=None):
        leaves = [x for _, x in PT.leaves(tp)]
        for x in leaves:
            x.requires_grad_(True)
        with torch.enable_grad():
            loss = _loss_fn(tp, fp, cfg, layout, batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        gtree = PT.tree_map(lambda _, x: None if x is None else next(it), tp)
        tp, opt, metrics = adamw_update(opt_cfg, tp, gtree, opt)
        metrics["loss"] = loss.detach()
        return tp, opt, metrics, ef

    return step


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
    """Checkpointed, restartable training loop on one device."""

    def __init__(self, cfg: ModelConfig, layout: M.SegmentLayout,
                 opt_cfg: AdamWConfig, batch_size: int,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 dist=None, ckpt_every: int = 50, grad_codec: str = "none",
                 device: DeviceLike = None,
                 clock: Optional[Callable[[], float]] = None):
        _single_device(dist)
        self.device = resolve_device(device)
        self.cfg, self.layout, self.opt_cfg = cfg, layout, opt_cfg
        self.batch_size = batch_size
        params = T.init_lm(cfg, seed, device=self.device)
        self.trainable = trainable_mask_for(cfg, params)
        self.tp, self.fp = PT.partition(params, self.trainable)
        self.opt = init_adamw(self.tp)
        self.ef = None          # one device: no reduce, no residual
        self.it = ShardableIndexIterator(seed, batch_size)
        self.step_fn = make_train_step(cfg, layout, opt_cfg,
                                       grad_codec=grad_codec)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
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
            if self.ckpt and (s + 1) % self.ckpt_every == 0:
                self.ckpt.save(s + 1, {"tp": self.tp, "opt": self.opt},
                               extra={"step": s + 1,
                                      "iterator": self.it.state_dict()})
        if self.ckpt:
            self.ckpt.wait()
        return self.history
