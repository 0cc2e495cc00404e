"""Port parity for the model zoo's configuration data: the registry, every
config (full and smoke) with its properties, every family's model and
states built on the CPU (and the refusal of streaming for the recurrent
ones, and of a family unknown to the port), and
the embedding scale of ``embed_scale``
configs rounded as the reference rounds it.

Configs and properties must be equal (they are data and integer
arithmetic).  The embedding is compared bit for bit (atol 0) in bf16.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro_torch.configs import registry as PR
from repro_torch.core import inference as PI
from repro_torch.core import streaming as PS
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT

IDS = list(JR._MODULES)
UNPORTED = [a for a in IDS if JR.get_config(a).family != "dense"]
_PROPS = ("hd", "q_groups", "is_attention_free", "d_inner", "ssm_heads")


def test_registry_ids_and_order_match_reference():
    assert list(PR._MODULES) == IDS and len(IDS) == 11
    assert PR.ASSIGNED == JR.ASSIGNED == IDS[:-1]
    assert IDS[-1] == "llama-7b"


def test_unknown_arch_raises_with_the_known_ids():
    with pytest.raises(KeyError, match="known:.*gemma-2b"):
        PR.get_config("gemma-3b")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", IDS)
def test_config_and_properties_match_reference(arch, smoke):
    j = JR.get_config(arch, smoke=smoke)
    p = PR.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for name in _PROPS:
        assert getattr(p, name) == getattr(j, name), name
    for name in ("mem_slots", "mem_len"):
        assert getattr(p.ccm, name) == getattr(j.ccm, name), name
    for mode in ("concat", "merge"):
        pc = dataclasses.replace(p.ccm, mode=mode)
        jc = dataclasses.replace(j.ccm, mode=mode)
        assert (pc.mem_slots, pc.mem_len) == (jc.mem_slots, jc.mem_len)
    assert p.param_count() == j.param_count() > 0
    assert p.param_count(active_only=True) == j.param_count(active_only=True)
    assert (p.cdtype, p.pdtype) == (getattr(torch, j.compute_dtype),
                                    getattr(torch, j.param_dtype))
    # keyword overrides reach the config as in the reference
    kw = dict(compute_dtype="float32", kv_cache_dtype="int8")
    assert dataclasses.asdict(PR.get_config(arch, smoke=smoke, **kw)) \
        == dataclasses.asdict(JR.get_config(arch, smoke=smoke, **kw))


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_family_raises_not_implemented(arch):
    """Every family of the registry runs now (the name is kept from when
    the non-dense families were refused).  The recurrent families
    (mamba2-370m, zamba2-1.2b) run the model and the online path, and
    refuse streaming as the reference has no streaming path for Mamba2
    layers; the encoder-decoder, the VLM and the MoE configs build their
    model, run the decoder stack and start an online and a stream
    state on the CPU."""
    cfg = PR.get_config(arch, smoke=True, compute_dtype="float32")
    params = PT.init_lm(cfg, device="cpu")
    info = PA.plain_causal_info(2)
    x = PT.forward_hidden(params, cfg, torch.zeros(1, 2, cfg.d_model),
                          q_info=info, k_info=info)
    assert tuple(x.shape) == (1, 2, cfg.d_model)
    st = PI.init_online_state(cfg, 1, 8, device="cpu")
    if cfg.family in ("ssm", "hybrid"):
        assert tuple(st.ssm.ssm.shape) == (cfg.n_layers, 1, cfg.ssm_heads,
                                           cfg.ssm_head_dim, cfg.ssm_state)
        assert (st.cache is None) == (cfg.family == "ssm")
        with pytest.raises(NotImplementedError,
                           match="no streaming path in the reference"):
            PS.init_stream_state(cfg, 1, device="cpu")
        return
    assert st.ssm is None and st.cross is None
    assert tuple(st.cache.k.shape) == (cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                       cfg.hd)
    ss = PS.init_stream_state(cfg, 1, device="cpu")
    assert tuple(ss.win_k.shape) == (cfg.n_layers, 1, cfg.ccm.stream_window,
                                     cfg.n_kv_heads, cfg.hd)
    want = {"encdec": ("encoder", "pos_embed"), "vlm": ("frontend",),
            "moe": ()}[cfg.family]
    assert all(k in params for k in want)
    assert ("moe" in params["layers"]) == (cfg.family == "moe")


def test_unknown_family_still_raises_not_implemented():
    cfg = PR.get_config("llama-7b", smoke=True).replace(family="rnn")
    match = "family 'rnn'.*unknown to the port"
    with pytest.raises(NotImplementedError, match=match):
        PT.init_lm(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        PT.forward_hidden({}, cfg, torch.zeros(1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match=match):
        PI.init_online_state(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        PS.init_stream_state(cfg, 1, device="cpu")


def _embed_pair(comp: bool):
    """Gemma-2B at its full width (d 2048) in bf16, one layer and a small
    vocabulary: the reference's embed and the port's on the same
    tokens."""
    jc = JR.get_config("gemma-2b").replace(n_layers=1, vocab_size=4096)
    pc = PR.get_config("gemma-2b").replace(n_layers=1, vocab_size=4096)
    assert (pc.d_model, pc.compute_dtype, pc.embed_scale) == \
        (2048, "bfloat16", True)
    rs = np.random.default_rng(0)
    table = rs.normal(0, 1.0, (4096, 2048)).astype(np.float32)
    ce = rs.normal(0, 1.0, (jc.ccm.comp_len, 2048)).astype(np.float32)
    toks = rs.integers(0, 4096, (4, 512)).astype(np.int32)
    jp = {"embed": jnp.asarray(table), "comp_embed": jnp.asarray(ce)}
    pp = {"embed": torch.from_numpy(table),
          "comp_embed": torch.from_numpy(ce)}
    cm = off = None
    if comp:
        mask = np.zeros(512, bool)
        mask[64:72] = mask[200:208] = True
        offs = np.zeros(512, np.int32)
        offs[64:72] = offs[200:208] = np.arange(8)
        cm, off = mask, offs
    want = JT.embed_tokens(jc, jp, jnp.asarray(toks),
                           None if cm is None else jnp.asarray(cm),
                           None if off is None else jnp.asarray(off))
    got = PT.embed_tokens(pc, pp, torch.from_numpy(toks),
                          None if cm is None else torch.from_numpy(cm),
                          None if off is None else
                          torch.from_numpy(off).long())
    return np.asarray(want.astype(jnp.float32)), got


@pytest.mark.parametrize("comp", [False, True], ids=["tokens", "comp-rows"])
def test_embed_scale_is_bit_equal_to_reference_in_bf16(comp):
    """sqrt(2048) rounds to 45.25 in bf16; the reference scales by that
    rounded value, so a product by the float sqrt(2048) lands one bf16
    ulp away on a few percent of the entries."""
    want, got = _embed_pair(comp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
