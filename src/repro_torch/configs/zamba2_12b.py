"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242] 38L d_model=2048, shared attn 32H (kv=32) d_ff=8192,
vocab=32000, ssm_state=64. CCM compresses the shared attention sites' KV;
the Mamba2 state is the arch's native fixed-size memory (DESIGN §5).
Port of ``repro/configs/zamba2_12b.py``: the model code is
``models/ssm.py`` and ``models/transformer.py`` (every path but
streaming, which the reference has no version of for Mamba2 layers)."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000, activation="swiglu",
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        attn_every=6,
        train_mode="full",
        ccm=CCMConfig(comp_len=8, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        attn_every=2, ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
