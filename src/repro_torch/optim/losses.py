"""Masked next-token cross entropy (port of ``repro/optim/losses.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    loss_mask: torch.Tensor,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, T, V) for positions p..p+T; tokens (B, T+1) = the tokens
    at those positions plus one (targets are tokens[:, 1:]); loss_mask
    (B, T).  Float32 log-sum-exp; the masked mean.  ``count`` replaces
    this batch's mask count as the divisor: a data-parallel rank passes
    the global batch's, so that the ranks' losses sum to the global
    masked mean."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :targets.shape[1]].float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    mask = loss_mask.float()
    n = mask.sum() if count is None else count
    return ((lse - tgt) * mask).sum() / torch.clamp(n, min=1.0)
