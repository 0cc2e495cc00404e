"""The paper's learn-and-answer loop on a tiny decoder (port of the loops
of ``benchmarks/common.py``, lines 29-160, and of
``benchmarks/tables.py:32`` ``_eval_no_context``).

`pretrain_base` fine-tunes the decoder full-context on the synthetic
online KV task (the paper first fine-tunes LLaMA on each dataset);
`train_compression` then trains the compression adapter, the
conditional LoRA and the ``<COMP>`` embeddings, on the frozen base
(paper Alg. 1; ``unconditional=True`` fires the LoRA at every position,
the Table 5 ablation).  `eval_at_timesteps` scores value prediction at
each online time step t and `eval_no_context` without any context.  The
answers are recoverable only through compressed memory, so the gaps
between them say whether the memory carries the context.  `claims`
gathers the quantities of ``tests/test_system.py``'s four claims on a
trained pair of trees.

Batch sizes, learning rates and step counts are the reference's: 32 rows
a training step, 16 an evaluation batch.  Batches are drawn from a
``torch.Generator`` seeded by the reference's (seed, index) pair
(`data.synthetic.generator`), so the numbers differ from the
reference's ``jax.random`` draws and the distribution is the same.
Everything runs on the CUDA card unless ``device="cpu"``.

Two hooks exist so that a test can feed this module and the reference
the same initial weights and the same batches: the initial trees
(``params=`` for `pretrain_base`, ``fresh=`` for `train_compression`)
and the batch source (``sampler=``, called as ``sampler(gen, layout,
batch, query_pool)`` once per batch in the loops' order; it returns
``{"tokens", "loss_mask"}`` on the device).  By default both come from
the port's own seeds.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import inference as PI
from repro_torch.core import masks as M
from repro_torch.data.synthetic import (KVTaskConfig, generator,
                                        sample_kv_batch)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train import make_train_step, trainable_mask_for
from repro_torch.models import transformer as T
from repro_torch.models.config import CCMConfig, ModelConfig
from repro_torch.optim import partition as PT
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
from repro_torch.optim.losses import next_token_loss

TASK = KVTaskConfig(n_keys=16, n_vals=16)
T_MAX = 4
CHUNK = 8
COMP = 2
TAIL = 8
TRAIN_BATCH = 32
EVAL_BATCH = 16
EVAL_SEEDS = (99, 100, 101, 102, 103)    # the trend claim's eval seeds

Sampler = Callable[..., Dict[str, torch.Tensor]]


def bench_cfg(**kw) -> ModelConfig:
    base = dict(name="bench", family="dense", n_layers=2, d_model=128,
                n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=128,
                compute_dtype="float32", train_mode="lora",
                ccm=CCMConfig(comp_len=COMP, max_steps=T_MAX))
    base.update(kw)
    return ModelConfig(**base)


def layout_for(t: int, comp_len: int = COMP) -> M.SegmentLayout:
    return M.segment_layout(t, CHUNK, comp_len, TAIL)


def _sampler(sampler: Optional[Sampler], dev: torch.device) -> Sampler:
    if sampler is not None:
        return sampler
    return lambda gen, layout, batch, query_pool: sample_kv_batch(
        gen, layout, batch, TASK, query_pool=query_pool, device=dev)


def _frozen(tree):
    """``tree`` with no leaf requiring a gradient (the training loops set
    it on their trainable leaves)."""
    return PT.tree_map(lambda _, x: None if x is None
                       else x.requires_grad_(False), tree)


def pretrain_base(steps: int = 600, seed: int = 0, lr: float = 3e-3,
                  sampler: Optional[Sampler] = None, params=None,
                  device: DeviceLike = None) -> Dict:
    """Fine-tune the base model full-context on the task, CCM off, every
    weight trained (the full-context upper bound).  ``params`` (the
    initial tree; default ``init_lm`` at ``seed``) is not modified."""
    dev = resolve_device(device)
    cfg = bench_cfg(train_mode="full").replace(
        ccm=CCMConfig(enabled=False, comp_len=COMP, max_steps=T_MAX))
    layout = layout_for(T_MAX)
    params = T.init_lm(cfg, seed, device=dev) if params is None \
        else PT.tree_map(lambda _, x: x.detach().clone(), params)
    tp, fp = PT.partition(params, trainable_mask_for(cfg, params))
    opt = init_adamw(tp)
    step = make_train_step(cfg, layout, AdamWConfig(lr=lr,
                                                    total_steps=steps))
    draw = _sampler(sampler, dev)
    for s in range(steps):
        batch = draw(generator(seed + 1, s), layout, TRAIN_BATCH, "ctx")
        tp, opt, _, _ = step(tp, fp, opt, batch, None)
    return _frozen(PT.merge(tp, fp))


def graft_lora(params: Dict, fresh: Dict) -> Dict:
    """``params`` with copies of ``fresh``'s (zero-delta) LoRA subtrees
    and ``<COMP>`` embeddings; a base trained without CCM lacks both.
    Neither tree is modified."""
    out = dict(params)
    out["comp_embed"] = fresh["comp_embed"].detach().clone()
    layers = dict(out["layers"])
    attn = dict(layers["attn"])
    attn["lora"] = PT.tree_map(lambda _, x: x.detach().clone(),
                               fresh["layers"]["attn"]["lora"])
    layers["attn"] = attn
    out["layers"] = layers
    return out


def train_compression(base_params: Dict, cfg: ModelConfig,
                      steps: int = 600, seed: int = 1, lr: float = 3e-3,
                      unconditional: bool = False,
                      sampler: Optional[Sampler] = None, fresh=None,
                      device: DeviceLike = None) -> Dict:
    """Train the compression adapter (LoRA + comp embeddings) on a frozen
    base — paper Alg. 1.  ``fresh`` (default ``init_lm(cfg)`` at
    ``seed``) gives the adapter's initial leaves (`graft_lora`); neither
    it nor ``base_params`` is modified."""
    dev = resolve_device(device)
    layout = layout_for(cfg.ccm.max_steps, cfg.ccm.comp_len)
    if fresh is None:
        fresh = T.init_lm(cfg, seed, device=dev)
    params = graft_lora(base_params, fresh)
    del fresh
    tp, fp = PT.partition(params, trainable_mask_for(cfg, params))
    opt = init_adamw(tp)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps)
    leaves = [x.requires_grad_(True) for _, x in PT.leaves(tp)]
    tail_at = layout.seq_len - layout.tail_len
    draw = _sampler(sampler, dev)
    for s in range(steps):
        batch = draw(generator(seed + 2, s), layout, TRAIN_BATCH, "ctx")
        with torch.enable_grad():
            logits = T.train_forward(PT.merge(tp, fp), cfg, batch["tokens"],
                                     layout, unconditional_lora=unconditional)
            loss = next_token_loss(logits, batch["tokens"][:, tail_at:],
                                   batch["loss_mask"])
            grads = iter(torch.autograd.grad(loss, leaves))
        gtree = PT.tree_map(lambda _, x: None if x is None else next(grads),
                            tp)
        tp, opt, _ = adamw_update(opt_cfg, tp, gtree, opt)
    return _frozen(PT.merge(tp, fp))


def _hits(logits: torch.Tensor, tail: torch.Tensor,
          loss_mask: torch.Tensor):
    """(correct, total) of the masked next-token argmax over the tail."""
    pred = torch.argmax(logits[:, :-1], dim=-1)
    hit = (pred == tail[:, 1:].long()).float() * loss_mask
    return hit.sum(), loss_mask.sum()


@torch.no_grad()
def eval_at_timesteps(params: Dict, cfg: ModelConfig, ts=(1, 2, 4),
                      n_batches: int = 6, seed: int = 99,
                      query_pool: str = "ctx", unconditional: bool = False,
                      sampler: Optional[Sampler] = None,
                      device: DeviceLike = None) -> Dict[int, float]:
    """Accuracy of value prediction at each online time step t.

    ``query_pool="ctx"`` (default) queries only keys shown in context —
    per-retrieval fidelity.  ``query_pool="all"`` queries the whole key
    space — mapping COVERAGE, the quantity the paper's Fig. 7 trend is
    about (see `sample_kv_batch`)."""
    draw = _sampler(sampler, resolve_device(device))
    out = {}
    for t in ts:
        layout = layout_for(t, cfg.ccm.comp_len)
        tail_at = layout.seq_len - layout.tail_len
        correct = total = 0.0
        for b in range(n_batches):
            batch = draw(generator(seed, t * 100 + b), layout, EVAL_BATCH,
                         query_pool)
            logits = T.train_forward(params, cfg, batch["tokens"], layout,
                                     unconditional_lora=unconditional)
            c, n = _hits(logits, batch["tokens"][:, tail_at:],
                         batch["loss_mask"])
            correct, total = correct + c, total + n
        out[t] = float(correct) / max(float(total), 1.0)
    return out


@torch.no_grad()
def eval_no_context(params: Dict, cfg: ModelConfig, ts=(1, 2, 4),
                    n_batches: int = 6, sampler: Optional[Sampler] = None,
                    device: DeviceLike = None) -> Dict[int, float]:
    """Accuracy of the same queries (`eval_at_timesteps`'s default
    batches) with CCM off and the tail alone as input: no context."""
    draw = _sampler(sampler, resolve_device(device))
    lo0 = M.segment_layout(0, CHUNK, COMP, TAIL)
    plain = cfg.replace(ccm=CCMConfig(enabled=False))
    out = {}
    for t in ts:
        lo = layout_for(t)
        correct = total = 0.0
        for b in range(n_batches):
            batch = draw(generator(99, t * 100 + b), lo, EVAL_BATCH, "ctx")
            tail = batch["tokens"][:, lo.seq_len - lo.tail_len:]
            logits = T.train_forward(params, plain, tail, lo0)
            c, n = _hits(logits, tail, batch["loss_mask"])
            correct, total = correct + c, total + n
        out[t] = float(correct) / max(float(total), 1.0)
    return out


def kv_bytes(cfg: ModelConfig, n_tokens: int, bytes_per=2) -> int:
    """Bytes of K and V for ``n_tokens`` over every layer (the paper's
    peak KV memory)."""
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * n_tokens * bytes_per


@torch.no_grad()
def online_claims(params: Dict, cfg: ModelConfig,
                  device: DeviceLike = None) -> Dict:
    """``tests/test_system.py``'s online checks (lines 63-96) on
    ``params``: ``online_err``, the largest distance between the last-row
    logits of the online path (B8: `T_MAX` ingests, then a prefill of the
    tail) and ``train_forward``'s; ``memory_tokens`` and
    ``cache_length`` after `T_MAX` ingests of a B2 batch."""
    dev = resolve_device(device)
    t, m = T_MAX, cfg.ccm.comp_len
    layout = layout_for(t, m)
    sl = layout.chunk_len + layout.comp_len

    def ingested(batch_size, gen_seed, cache_len):
        batch = sample_kv_batch(generator(gen_seed), layout, batch_size,
                                TASK, device=dev)
        state = PI.init_online_state(cfg, batch_size,
                                     max_cache_len=cache_len, device=dev)
        for j in range(t):
            state = PI.ingest_context(
                params, cfg, state,
                batch["tokens"][:, j * sl:(j + 1) * sl - m])
        return batch["tokens"], state

    toks, state = ingested(8, 11, 32)
    online, _ = PI.prefill(params, cfg, state, toks[:, t * sl:],
                           full_logits=True)
    parallel = T.train_forward(params, cfg, toks, layout)
    out = dict(online_err=float((online[:, -1].float()
                                 - parallel[:, -1].float()).abs().max()))
    _, state = ingested(2, 1, 16)
    out.update(memory_tokens=int(state.mem.valid_len(m)),
               cache_length=int(state.cache.length))
    return out


def claims(base: Dict, params: Dict, cfg: ModelConfig,
           device: DeviceLike = None,
           eval_sampler: Optional[Callable[..., Sampler]] = None) -> Dict:
    """The quantities of ``tests/test_system.py``'s claims for the
    fine-tuned ``base`` and the compressor ``params`` trained on it:
    ``acc4`` (accuracy at t = `T_MAX` from memory) and ``acc0`` (the
    base's with no context); ``acc1_all`` and ``acc4_all``, the means
    over `EVAL_SEEDS` with ``query_pool="all"`` (``per_seed`` keeps each
    seed's); the two margins; and `online_claims`.  ``eval_sampler(ts,
    seed, query_pool)``, where given, returns the ``sampler=`` of each
    evaluation call (a test's replay of another package's batches)."""
    def ev(fn, ts, seed=99, pool="ctx", **kw):
        s = None if eval_sampler is None else eval_sampler(ts, seed, pool)
        return fn(ts=ts, sampler=s, device=device, **kw)

    out = dict(
        acc4=ev(lambda **k: eval_at_timesteps(params, cfg, **k),
                (T_MAX,))[T_MAX],
        acc0=ev(lambda **k: eval_no_context(base, cfg, **k),
                (T_MAX,))[T_MAX])
    out["per_seed"] = {seed: ev(lambda **k: eval_at_timesteps(
        params, cfg, seed=seed, query_pool="all", **k), (1, T_MAX), seed,
        "all") for seed in EVAL_SEEDS}
    for t, name in ((1, "acc1_all"), (T_MAX, "acc4_all")):
        out[name] = sum(a[t] for a in out["per_seed"].values()) \
            / len(EVAL_SEEDS)
    out["margin_no_context"] = out["acc4"] - out["acc0"]
    out["margin_t4_t1"] = out["acc4_all"] - out["acc1_all"]
    out.update(online_claims(params, cfg, device))
    return out
