"""Architecture registry: ``--arch <id>`` -> ModelConfig (port of
``repro/configs/registry.py``: the same ids in the same order)."""
from __future__ import annotations

from repro_torch.configs import (codeqwen15_7b, gemma_2b, llama4_maverick,
                                 llama_7b_paper, mamba2_370m, phi35_moe,
                                 pixtral_12b, qwen2_05b, smollm_360m,
                                 whisper_tiny, zamba2_12b)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "smollm-360m": smollm_360m,
    "codeqwen1.5-7b": codeqwen15_7b,
    "qwen2-0.5b": qwen2_05b,
    "gemma-2b": gemma_2b,
    "zamba2-1.2b": zamba2_12b,
    "whisper-tiny": whisper_tiny,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "mamba2-370m": mamba2_370m,
    "pixtral-12b": pixtral_12b,
    "llama-7b": llama_7b_paper,   # the paper's own model (fidelity benches)
}

ASSIGNED = [k for k in _MODULES if k != "llama-7b"]


def get_config(arch: str, smoke: bool = False, **kw) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}'; known: {list(_MODULES)}")
    mod = _MODULES[arch]
    return mod.smoke(**kw) if smoke else mod.config(**kw)
