"""pixtral-12b [vlm] — ViT frontend STUB + Mistral-NeMo-style decoder.
[hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072. input_specs() provides precomputed patch
embeddings (1024-dim ViT output, projected in-model).
Port of ``repro/configs/pixtral_12b.py`` (configuration data); every path of
the port runs this family."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072, activation="swiglu",
        rope_theta=1_000_000_000.0, frontend="vision",
        n_frontend_tokens=1024,
        train_mode="lora",
        param_dtype="bfloat16",  # frozen base; LoRA moments stay fp32
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256, n_frontend_tokens=8,
        ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
