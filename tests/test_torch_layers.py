"""Port parity: norms, RoPE, MLPs, embeddings, logits and cond_linear of
``repro_torch`` against ``repro`` on the same numpy inputs (float32, CPU).

Tolerance: atol 1e-5 — both sides compute in float32 on the CPU; only the
order of floating-point sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as JLoRA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro_torch.core import lora as PLoRA
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg

ATOL = 1e-5


def _cfgs(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32")
    base.update(kw)
    return (JCfg(**base, ccm=JCCM(comp_len=2, max_steps=4)),
            PCfg(**base, ccm=PCCM(comp_len=2, max_steps=4)))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=atol,
                               rtol=0)


@pytest.fixture
def rs():
    return np.random.default_rng(0)


def test_rms_norm(rs):
    x = rs.normal(size=(2, 5, 64)).astype(np.float32)
    s = rs.normal(size=(64,)).astype(np.float32)
    _close(JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5),
           PL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5))


def test_layer_norm_and_apply_norm(rs):
    x = rs.normal(size=(3, 64)).astype(np.float32)
    s, b = rs.normal(size=(2, 64)).astype(np.float32)
    _close(JL.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5),
           PL.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                         torch.from_numpy(b), 1e-5))
    jc, pc = _cfgs(norm="ln")
    _close(JL.apply_norm(jc, {"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                         jnp.asarray(x)),
           PL.apply_norm(pc, {"scale": torch.from_numpy(s),
                              "bias": torch.from_numpy(b)},
                         torch.from_numpy(x)))


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope(rs, pos_shape):
    pos = rs.integers(0, 5000, pos_shape).astype(np.int32)
    x = rs.normal(size=(2, 7, 4, 16)).astype(np.float32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    pc, ps = PL.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    _close(jc, pc)
    _close(js, ps)
    _close(JL.apply_rope(jnp.asarray(x), jc, js),
           PL.apply_rope(torch.from_numpy(x), pc, ps))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(rs, act):
    jc, pc = _cfgs(activation=act)
    p = {k: (rs.normal(size=s) / 8).astype(np.float32)
         for k, s in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    x = rs.normal(size=(2, 5, 64)).astype(np.float32)
    _close(JL.apply_mlp(jc, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)),
           PL.apply_mlp(pc, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)))


def test_embed_with_comp_embed_and_logits(rs):
    jc, pc = _cfgs()
    p = {"embed": rs.normal(size=(128, 64)).astype(np.float32),
         "comp_embed": rs.normal(size=(2, 64)).astype(np.float32),
         "lm_head": (rs.normal(size=(64, 128)) / 8).astype(np.float32),
         "final_norm": {"scale": rs.normal(size=(64,)).astype(np.float32)}}
    jp = {k: ({"scale": jnp.asarray(v["scale"])} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in p.items()}
    tp = {k: ({"scale": torch.from_numpy(v["scale"])} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in p.items()}
    tok = rs.integers(0, 128, (2, 10)).astype(np.int32)
    ar = np.arange(10)
    cm, off = ar >= 8, np.maximum(ar - 8, 0)
    je = JT.embed_tokens(jc, jp, jnp.asarray(tok), jnp.asarray(cm),
                         jnp.asarray(off))
    pe = PT.embed_tokens(pc, tp, torch.from_numpy(tok), torch.from_numpy(cm),
                         torch.from_numpy(off))
    _close(je, pe)
    _close(JT.embed_tokens(jc, jp, jnp.asarray(tok)),
           PT.embed_tokens(pc, tp, torch.from_numpy(tok)))
    _close(JT.lm_logits(jp, jc, je), PT.lm_logits(tp, pc, pe))


@pytest.mark.parametrize("lora_on,gated,bias", [
    (True, True, False), (True, True, True), (True, False, False),
    (False, False, True)])
def test_cond_linear(rs, lora_on, gated, bias):
    x = rs.normal(size=(2, 6, 64)).astype(np.float32)
    w = (rs.normal(size=(64, 32)) / 8).astype(np.float32)
    a = (rs.normal(size=(8, 64)) / 8).astype(np.float32)
    b = (rs.normal(size=(8, 32)) / 4).astype(np.float32)
    g = (rs.random((2, 6)) < 0.5).astype(np.float32)
    bi = rs.normal(size=(32,)).astype(np.float32)
    out_j = JLoRA.cond_linear(
        jnp.asarray(x), jnp.asarray(w),
        {"a": jnp.asarray(a), "b": jnp.asarray(b)} if lora_on else None,
        jnp.asarray(g) if gated else None, 2.0,
        bias=jnp.asarray(bi) if bias else None)
    out_t = PLoRA.cond_linear(
        torch.from_numpy(x), torch.from_numpy(w),
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)} if lora_on
        else None, torch.from_numpy(g) if gated else None, 2.0,
        bias=torch.from_numpy(bi) if bias else None)
    _close(out_j, out_t)


def test_lora_scale():
    assert PLoRA.lora_scale(8, 16.0) == JLoRA.lora_scale(8, 16.0) == 2.0
