"""Public kernel ops (port of ``repro/kernels/ops.py``, same signatures).

Each op dispatches on the DEVICE OF ITS TENSORS: CPU tensors take the
plain PyTorch version (``kernels/ref.py``); CUDA tensors launch the
hand-written kernel, which raises on anything it does not take.  There is
no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.kernels import cond_lora as _lora
from repro_torch.kernels import decode_attention as _dattn
from repro_torch.kernels import kv_merge as _merge
from repro_torch.kernels import ref as _ref

_KERNELS = {"segmented_attention": _dattn, "cond_lora": _lora,
            "kv_merge_update": _merge}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last reset (CUDA tensors only)."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def segmented_attention(q: torch.Tensor, segs: Sequence[Dict[str, Any]],
                        q_idx, q_seg, scale: float) -> torch.Tensor:
    """q (B, Sq, Hq, D) over in-place KV segments — see
    ``decode_attention`` for the segment-dict schema."""
    if q.is_cuda:
        return _dattn.segmented_flash_attention(q, segs, q_idx, q_seg, scale)
    return _ref.segmented_attention_ref(q, segs, q_idx, q_seg, scale)


def cond_lora(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, gate: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M,K) @ w (K,N) (+bias) + gate * (x @ a.T @ b) * scale — fused."""
    if x.is_cuda:
        return _lora.cond_lora_matmul(x, w, a, b, gate.float().contiguous(),
                                      scale, bias)
    return _ref.cond_lora_ref(x, w, a, b, gate, scale, bias)


def kv_merge_update(mem: torch.Tensor, h: torch.Tensor,
                    a: float) -> torch.Tensor:
    """(1 - a) * mem + a * h in float32, written IN PLACE into ``mem``
    (returned).  ``a`` is a host float."""
    if mem.is_cuda:
        return _merge.kv_merge_update_(mem, h, a)
    return mem.copy_(_ref.kv_merge_ref(mem, h, a))
