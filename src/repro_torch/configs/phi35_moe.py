"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct] 32L d_model=4096 32H (kv=8)
d_ff=6400 (per expert) vocab=32064.
Port of ``repro/configs/phi35_moe.py`` (configuration data); every path of
the port runs this family."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064, activation="swiglu",
        n_experts=16, top_k=2, moe_impl="ragged_tp",
        rope_theta=10000.0,
        train_mode="lora",
        param_dtype="bfloat16",  # frozen base; LoRA moments stay fp32
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=256, n_experts=4, top_k=2,
        ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
