"""Carry a parameter tree between the reference and the port.

``params_from_numpy`` takes the reference's tree as numpy arrays (for a
JAX tree, ``jax.tree.map(np.asarray, params)``) and returns the port's
tree on ``device``: every leaf in ``cfg.pdtype`` except the LoRA ``a``/``b``
factors, the Mamba2 ``a_log``/``dt_bias``/``d_skip`` vectors and the MoE
``router``, which stay float32 as the reference initialises them.  Key paths
and the stacked leading layer axis are kept as they are.
``params_to_numpy`` is the inverse: the port's tree as numpy arrays
(bf16 leaves as float32, which holds every bf16 value exactly).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


def _leaf(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # bfloat16 numpy arrays (ml_dtypes) are not accepted by torch.from_numpy
    # and arrays from JAX are read-only: go through a float32 copy, which
    # holds every bfloat16 value exactly.
    a = np.array(arr, dtype=np.float32, copy=True)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


# leaves the reference creates in float32 whatever ``param_dtype`` is
# (``repro/models/ssm.py`` ``init_mamba``; the MoE router,
# ``repro/models/moe.py`` ``init_moe``)
_F32_LEAVES = ("a_log", "dt_bias", "d_skip", "router")


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)

    def walk(t, f32: bool):
        if isinstance(t, dict):
            return {k: walk(v, f32 or k == "lora" or k in _F32_LEAVES)
                    for k, v in t.items()}
        return _leaf(t, torch.float32 if f32 else cfg.pdtype, dev)

    return walk(tree, False)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree -> numpy arrays on the host (None leaves kept)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return walk(tree)
