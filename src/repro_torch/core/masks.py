"""CCM mask constants and cache writes (port of ``repro/core/masks.py``,
the part the online slice runs)."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def layer_window_write(buf: torch.Tensor, blk: torch.Tensor, layer: int,
                       at: int) -> torch.Tensor:
    """Write ``blk`` (B, s, ...) into layer ``layer`` of the stacked state
    ``buf`` (L, B, S, ...) at row ``at``, IN PLACE, and return ``buf``.

    Like the reference's ``dynamic_update_slice`` the start is clamped so
    the block fits: once ``at + s`` passes ``S`` the block lands on the
    last ``s`` rows, while the caller's length counter keeps advancing.
    """
    s, S = blk.shape[1], buf.shape[2]
    a = min(max(int(at), 0), max(S - s, 0))
    buf[layer, :, a:a + s] = blk.to(buf.dtype)
    return buf
