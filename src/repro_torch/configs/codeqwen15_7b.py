"""codeqwen1.5-7b [dense] — qwen1.5 arch, QKV bias. [hf:Qwen/CodeQwen1.5-7B]
32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
Port of ``repro/configs/codeqwen15_7b.py``."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416, activation="swiglu",
        qkv_bias=True, rope_theta=1_000_000.0,
        train_mode="lora",   # paper regime: 7B trains conditional LoRA only
        param_dtype="bfloat16",  # frozen base; LoRA moments stay fp32
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
