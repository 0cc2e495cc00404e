"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), scaled embeddings.
[arXiv:2403.08295] 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
Port of ``repro/configs/gemma_2b.py``."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=256000, activation="geglu",
        rope_theta=10000.0, tie_embeddings=True, embed_scale=True,
        train_mode="full",
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512,
        ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
