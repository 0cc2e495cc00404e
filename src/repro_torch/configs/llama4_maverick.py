"""llama4-maverick-400b-a17b [moe] — MoE 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-*; unverified] 48L d_model=5120 40H (kv=8)
d_ff=8192 (per expert) vocab=202048. Trains conditional LoRA only (paper
regime — also the only memory-feasible mode at 400B on 256 v5e chips).
Port of ``repro/configs/llama4_maverick.py``: configuration data only; the
port's entry points raise NotImplementedError for this family
until its model code is ported (ROADMAP queue 1 item 3)."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048, activation="swiglu",
        n_experts=128, top_k=1, moe_impl="ragged_tp",
        rope_theta=500_000.0,
        train_mode="lora",
        param_dtype="bfloat16",  # frozen base; LoRA moments stay fp32
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=256, n_experts=8, top_k=1,
        ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
