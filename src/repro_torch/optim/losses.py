"""Masked next-token cross entropy (port of ``repro/optim/losses.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import tensor_parallel as TPX


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    loss_mask: torch.Tensor,
                    count: Optional[torch.Tensor] = None,
                    tp=None) -> torch.Tensor:
    """logits (B, T, V) for positions p..p+T; tokens (B, T+1) = the tokens
    at those positions plus one (targets are tokens[:, 1:]); loss_mask
    (B, T).  Float32 log-sum-exp; the masked mean.  ``count`` replaces
    this batch's mask count as the divisor: a data-parallel rank passes
    the global batch's, so that the ranks' losses sum to the global
    masked mean.

    ``tp`` (a `distributed.tensor_parallel.TensorParallel` rank splitting
    the vocabulary): ``logits`` is this rank's block of ids.  The
    vocab-parallel cross entropy all-reduces the max (no gradient: the
    log-sum-exp does not depend on it), the sum of exps and the target's
    logit over the model axis; every rank gets the whole loss and the
    gradient of its block."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :targets.shape[1]].float()
    if tp is not None and tp.vocab_split:
        m = tp.coll.max(lg.detach().amax(dim=-1))
        se = TPX.reduce_from_tp(torch.exp(lg - m[..., None]).sum(-1), tp)
        lse = m + torch.log(se)
        t = targets - tp.vocab_lo
        inside = (t >= 0) & (t < lg.shape[-1])
        tgt = torch.gather(lg, -1, t.clamp(0, lg.shape[-1] - 1)[..., None])
        tgt = TPX.reduce_from_tp(tgt[..., 0] * inside.float(), tp)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    mask = loss_mask.float()
    n = mask.sum() if count is None else count
    return ((lse - tgt) * mask).sum() / torch.clamp(n, min=1.0)
