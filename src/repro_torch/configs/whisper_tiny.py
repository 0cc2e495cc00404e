"""whisper-tiny [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356]
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. LayerNorm/GELU/learned pos.
CCM applies to decoder self-attention (long transcription history).
Port of ``repro/configs/whisper_tiny.py``: configuration data only; the
port's entry points raise NotImplementedError for this family
until its model code is ported (ROADMAP queue 1 item 3)."""
from repro_torch.models.config import CCMConfig, ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec",
        n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=51865, activation="gelu", norm="ln",
        pos_embed="learned", max_pos=65536, frontend="audio",
        train_mode="full",
        ccm=CCMConfig(comp_len=4, max_steps=16), **kw)


def smoke(**kw) -> ModelConfig:
    return config().replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, max_pos=2048,
        ccm=CCMConfig(comp_len=2, max_steps=4), **kw)
