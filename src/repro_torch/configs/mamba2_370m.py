"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 48L d_model=1024 vocab=50280 ssm_state=128.

CCM is INAPPLICABLE (no attention KV to compress — DESIGN
§Arch-applicability): the SSD state is the arch's own constant-size
context memory. Implemented without the technique; all shapes lower the
native train/prefill/decode programs.
Port of ``repro/configs/mamba2_370m.py``: the model code is
``models/ssm.py`` and ``models/transformer.py`` (every path but
streaming, which the reference has no version of for Mamba2 layers)."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        n_heads=1, n_kv_heads=1, d_ff=0,
        train_mode="full",
        ccm=CCMConfig(enabled=False, comp_len=2, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16,
        ccm=CCMConfig(enabled=False, comp_len=2, max_steps=4), **kw)
