"""llama-7b — the paper's own evaluation model (Touvron et al., 2023).
32L d_model=4096 32H (kv=32) d_ff=11008 vocab=32000.  Port of
``repro/configs/llama_7b_paper.py``."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="llama-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab_size=32000, activation="swiglu",
        rope_theta=10000.0,
        train_mode="lora",
        param_dtype="bfloat16",  # frozen base; LoRA moments stay fp32
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
