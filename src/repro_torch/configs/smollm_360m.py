"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
Port of ``repro/configs/smollm_360m.py``."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab_size=49152, activation="swiglu",
        rope_theta=10000.0, tie_embeddings=True,
        train_mode="full",
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128,
        vocab_size=256, ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
