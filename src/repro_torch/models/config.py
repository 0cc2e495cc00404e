"""Unified model / CCM configuration (port of ``repro/models/config.py``).

The two dataclasses are copied field for field, their properties
(``param_count`` included) line for line, so a reference config and its
port describe the same model.  ``cdtype``/``pdtype`` return torch
dtypes.  ``attn_impl`` only tells ``"concat"`` (the dense masked oracle:
the materialized concatenation on the segmented path, ``attend_dense`` in
training) apart from every other value, which goes to the hand-written
kernel op; the reference's default ``"dense"`` is its jnp attend.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class CCMConfig:
    """Compressed Context Memory (the paper's technique) configuration."""

    enabled: bool = True
    comp_len: int = 2            # tokens per <COMP> group (paper: 1..8)
    mode: str = "concat"         # 'concat' | 'merge'
    method: str = "ccm"          # 'ccm' | 'gisting' | 'compressive'
    merge_alpha: Optional[float] = None  # None -> arithmetic mean a_t=1/t; else EMA
    max_steps: int = 16          # T, max online time steps
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.05   # used only in training examples
    stream_window: int = 4096    # max KV cache (local window) size
    stream_sink: int = 4         # attention-sink tokens kept forever
    stream_chunk: int = 64       # tokens compressed per compression event
    stream_mem_slots: int = 64   # max <COMP> groups kept in concat memory

    @property
    def mem_slots(self) -> int:
        """Number of <COMP>-group slots held in memory at T."""
        return self.max_steps if self.mode == "concat" else 1

    @property
    def mem_len(self) -> int:
        """Length (tokens) of the compressed memory at T."""
        return self.mem_slots * self.comp_len


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rms"            # rms | ln
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_embed: str = "rope"      # rope | learned | none
    max_pos: int = 0
    embed_scale: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "ragged_tp"
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0
    n_enc_layers: int = 0
    frontend: str = "none"
    n_frontend_tokens: int = 0
    ccm: CCMConfig = dataclasses.field(default_factory=CCMConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    train_mode: str = "lora"
    remat: bool = True
    unroll_layers: bool = False
    sharding_strategy: str = "tp"
    kv_cache_dtype: str = "bfloat16"   # bfloat16 (= compute dtype) | int8
    serve_cache_len: int = 0
    attn_impl: str = "dense"     # 'concat' = oracle; anything else = kernel
    attn_chunk: int = 1024
    attn_seg_block: int = 512
    attn_lane_batched: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_mamba(self) -> bool:
        """Whether the stack runs Mamba2 layers (ssm, hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # rough parameter counts (the reference's roofline MODEL_FLOPS = 6*N*D)
    def param_count(self, active_only: bool = False) -> int:
        d, f, hd = self.d_model, self.d_ff, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.activation in ("swiglu", "geglu"):
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.n_experts:
            e = self.top_k if active_only else self.n_experts
            ffn = ffn * max(e, 1)
        per_layer = attn + ffn
        if self.family == "ssm":
            di, ds = self.d_inner, self.ssm_state
            per_layer = d * (2 * di + 2 * ds + self.ssm_heads) + di * d \
                + self.ssm_conv * (di + 2 * ds)
        if self.family == "hybrid":
            di, ds = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * ds + self.ssm_heads) + di * d \
                + self.ssm_conv * (di + 2 * ds)
            per_layer = mamba  # shared attn counted once below
        total = emb + self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * f  # one shared block
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + ffn) + self.n_layers * attn  # cross-attn
        return int(total)


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    """The port runs every family of the registry; a config of any other
    family is refused before any model code runs."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}): unknown to the port, "
            f"which runs {', '.join(map(repr, PORTED_FAMILIES))}")
