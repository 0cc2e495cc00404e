"""Synthetic online-interaction data (port of ``repro/data/synthetic.py``).

Each batch element is an identity with a hidden key->value mapping.
Context chunks c(j) show (key, value) demonstration pairs; the tail
interleaves query keys with their values, so a model that compresses
context well answers queries whose evidence appeared in earlier chunks.

Token map: 0 pad | 1 <COMP> placeholder | 2 bos | 3 sep |
           keys   [4, 4+n_keys) | values [4+n_keys, 4+n_keys+n_vals)

Draws come from a ``torch.Generator`` on the CPU; the batch is then moved
to the card, or to the CPU when the caller passes ``device="cpu"``.  The numbers differ from the reference's
``jax.random`` draws; the layout, the distribution and the loss mask are
the same.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

import numpy as np
import torch

from repro_torch.core.masks import SegmentLayout
from repro_torch.device import DeviceLike, resolve_device

PAD, COMP, BOS, SEP = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class KVTaskConfig:
    n_keys: int = 32
    n_vals: int = 32

    @property
    def min_vocab(self) -> int:
        return 4 + self.n_keys + self.n_vals

    def key_id(self, k):
        return 4 + k

    def val_id(self, v):
        return 4 + self.n_keys + v


def _perms(gen: torch.Generator, lead, n: int) -> torch.Tensor:
    """Independent random permutations of range(n), shape lead + (n,)."""
    return torch.argsort(torch.rand(tuple(lead) + (n,), generator=gen), -1)


def sample_kv_batch(gen: torch.Generator, layout: SegmentLayout, batch: int,
                    task: KVTaskConfig = KVTaskConfig(),
                    query_pool: str = "ctx",
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Returns {'tokens': (B, S) int32, 'loss_mask': (B, tail-1) float32}
    on ``device`` (default: the CUDA card).

    Loss positions are the tail's even offsets (predict the value after
    each query key).  ``query_pool="ctx"`` (the training distribution)
    queries distinct positions of keys shown in the context chunks, so the
    answer is in Mem; ``"all"`` draws distinct keys from the whole key
    space (unseen keys are unanswerable: accuracy measures coverage).
    """
    t, lc, m, tail = (layout.t_steps, layout.chunk_len, layout.comp_len,
                      layout.tail_len)
    n_pairs = lc // 2
    dev = resolve_device(device)
    if query_pool not in ("ctx", "all"):
        raise ValueError(f"unknown query_pool {query_pool!r}")
    mapping = torch.randint(0, task.n_vals, (batch, task.n_keys),
                            generator=gen)
    ctx_keys = _perms(gen, (batch, t), task.n_keys)[..., :n_pairs]
    ctx_vals = torch.gather(mapping[:, None, :].expand(batch, t, task.n_keys),
                            2, ctx_keys)
    pair = torch.stack([task.key_id(ctx_keys), task.val_id(ctx_vals)], -1)
    chunk = pair.reshape(batch, t, 2 * n_pairs)
    if lc > 2 * n_pairs:
        chunk = torch.cat([chunk, torch.full((batch, t, lc - 2 * n_pairs),
                                             SEP, dtype=chunk.dtype)], -1)
    comp_toks = torch.full((batch, t, m), COMP, dtype=chunk.dtype)
    body = torch.cat([chunk, comp_toks], -1).reshape(batch, -1)
    n_q = tail // 2
    if query_pool == "all":
        q_keys = _perms(gen, (batch,), task.n_keys)[:, :n_q]
    else:
        flat_ctx = ctx_keys.reshape(batch, -1)
        reps = -(-n_q // flat_ctx.shape[1])
        pick = _perms(gen, (batch,), flat_ctx.shape[1]).repeat(1, reps)[:, :n_q]
        q_keys = torch.gather(flat_ctx, 1, pick)
    q_vals = torch.gather(mapping, 1, q_keys)
    qa = torch.stack([task.key_id(q_keys), task.val_id(q_vals)],
                     -1).reshape(batch, 2 * n_q)
    if tail > 2 * n_q:
        qa = torch.cat([qa, torch.full((batch, tail - 2 * n_q), PAD,
                                       dtype=qa.dtype)], -1)
    tokens = torch.cat([body, qa], -1).to(torch.int32)
    off = np.arange(tail - 1)
    lm = ((off % 2 == 0) & (off < 2 * n_q - 1)).astype(np.float32)
    loss_mask = torch.from_numpy(lm)[None].expand(batch, tail - 1)
    return {"tokens": tokens.to(dev), "loss_mask": loss_mask.to(dev)}


def lm_stream(gen: torch.Generator, batch: int, length: int, vocab: int,
              period: int = 97, device: DeviceLike = None) -> torch.Tensor:
    """Semi-predictable token stream (noisy periodic pattern) for streaming
    / perplexity runs: position-dependent structure a compressor can
    exploit.  (B, length) int32 on ``device`` (default: the CUDA card):
    ``arange(length) % period + 4``, with each position replaced by
    ``4 + randint(vocab // 8)`` with probability 0.2, clipped to
    ``[0, vocab)``."""
    dev = resolve_device(device)
    base = (torch.arange(length) % period)[None, :] + 4
    noise = torch.randint(0, vocab // 8, (batch, length), generator=gen)
    mix = torch.rand((batch, length), generator=gen) < 0.2
    toks = torch.where(mix, 4 + noise, base)
    return toks.clamp(0, vocab - 1).to(torch.int32).to(dev)


def _seed(*parts: int) -> int:
    h = hashlib.sha256(",".join(str(int(p)) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def generator(*parts: int) -> torch.Generator:
    """A CPU generator seeded by ``parts`` (the counterpart of the
    reference's ``fold_in`` of a ``PRNGKey``)."""
    gen = torch.Generator()
    gen.manual_seed(_seed(*parts))
    return gen


class ShardableIndexIterator:
    """Stateless-indexable data iterator: restart- and rescale-safe.

    ``state = (seed, step)`` is checkpointed; every host derives the
    generator of its shard from (seed, step, host_id) alone, so a
    restarted job resumes mid-epoch without coordination.
    """

    def __init__(self, seed: int, batch_per_host: int, n_hosts: int = 1,
                 host_id: int = 0):
        self.seed, self.bph = seed, batch_per_host
        self.n_hosts, self.host_id = n_hosts, host_id
        self.step = 0

    def key_for(self, step: int) -> torch.Generator:
        return generator(self.seed, step, self.host_id)

    def next_key(self) -> torch.Generator:
        g = self.key_for(self.step)
        self.step += 1
        return g

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st):
        self.step = int(st["step"])
        self.seed = int(st["seed"])
