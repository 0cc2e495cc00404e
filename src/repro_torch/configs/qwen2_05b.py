"""qwen2-0.5b [dense] — GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671] 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936.
Port of ``repro/configs/qwen2_05b.py``."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151936, activation="swiglu",
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
        train_mode="full",
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128,
        vocab_size=256, ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
