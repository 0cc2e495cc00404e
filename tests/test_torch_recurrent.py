"""The recurrent families through the port's normal paths, against
``repro``: mamba2-370m (``ssm``: Mamba2 layers only, no CCM) and
zamba2-1.2b (``hybrid``: groups of Mamba2 layers, each followed by the
shared attention block, where CCM compresses), each at its registry
``smoke(compute_dtype="float32")``: 3 layers at d 64 (chunk 16), and 5
layers at d 64 with a shared-attention site after every 2 (2 sites and a
remainder of 1).

Every path runs the same weights in both packages: the reference's
``init_lm`` draws them, the shared block's LoRA ``b`` and ``comp_embed``
are then drawn at random (``b = 0`` at init would leave the gate
untested), and ``params_from_numpy`` carries them to the port.

This file holds the model (init, ``forward_hidden``, ``train_forward``)
and the online path's length rules; ``test_torch_recurrent_train.py``,
``_online.py`` and ``_serve.py`` hold training, the online path and the
serve engine, on this file's helpers.

Tolerances (float32 on the CPU): hidden states and training logits,
loss, gradients and the updated leaves and moments 1e-4 x
max|reference| per tensor (``tests/test_torch_zoo.py``); online logits
and float state leaves atol 1e-4; served answers atol 1e-4.  Counters
must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import masks as JM
from repro.data.synthetic import sample_kv_batch as jsample
from repro.models import attention as JA_
from repro.models import transformer as JT
from repro_torch.configs import registry as PR
from repro_torch.core import inference as PI
from repro_torch.core import masks as PM
from repro_torch.models import attention as PA_
from repro_torch.models import transformer as PT
from repro_torch.optim import partition as PP
from repro_torch.params import params_from_numpy

REL, ATOL = 1e-4, 1e-4
T_STEPS, LC, M, TAIL, B = 4, 8, 2, 8, 2          # S = 48: 3 SSD chunks
CASES = [("mamba2-370m", "concat"), ("zamba2-1.2b", "concat"),
         ("zamba2-1.2b", "merge")]
IDS = ["mamba2", "zamba2-concat", "zamba2-merge"]

def _cfgs(arch, mode="concat", **kw):
    out = []
    for reg in (JR, PR):
        c = reg.get_config(arch, smoke=True,
                           **{"compute_dtype": "float32", **kw})
        out.append(c.replace(ccm=dataclasses.replace(c.ccm, mode=mode)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    jc, _ = _cfgs(arch)
    p = jax.tree.map(np.asarray, jax.jit(JT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), jc))
    rs = np.random.default_rng(1)
    if "shared_attn" in p:
        for lw in p["shared_attn"]["attn"]["lora"].values():
            lw["b"] = rs.normal(0, 0.1, lw["b"].shape).astype(np.float32)
        p["comp_embed"] = rs.normal(0, 0.5, p["comp_embed"].shape
                                    ).astype(np.float32)
    mb = p["layers"]["mamba"]
    mb["dt_bias"] = rs.normal(0, 0.5, mb["dt_bias"].shape).astype(np.float32)
    mb["conv_b"] = rs.normal(0, 0.1, mb["conv_b"].shape).astype(np.float32)
    return p


def _params(arch, pc):
    p = _numpy_params(arch)
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, pc, "cpu")


def _toks(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _rel(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _flat(tree):
    return {"/".join(p): x.detach().float().numpy().copy()
            for p, x in PP.leaves(tree)}


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
            for path, x in flat}


def _layouts():
    return (JM.segment_layout(T_STEPS, LC, M, TAIL),
            PM.segment_layout(T_STEPS, LC, M, TAIL))


def _batch(seed, vocab):
    jl, _ = _layouts()
    jb = jsample(jax.random.PRNGKey(seed), jl, B)
    jb["tokens"] = jb["tokens"] % vocab
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# the model: init, forward_hidden, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_init_lm_tree_matches_reference(arch):
    """The port's random init has the reference's key paths, shapes and
    dtypes (SSM vectors float32, the rest in param_dtype), in bf16
    params too."""
    for dtype in ("float32", "bfloat16"):
        jc, pc = _cfgs(arch, param_dtype=dtype)
        want = jax.eval_shape(lambda k: JT.init_lm(k, jc),
                              jax.random.PRNGKey(0))
        want = {"/".join(str(k.key) for k in path): (x.shape, str(x.dtype))
                for path, x in jax.tree_util.tree_flatten_with_path(want)[0]}
        got = {"/".join(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
               for p, x in PP.leaves(PT.init_lm(pc, device="cpu"))}
        assert got == want


def test_bf16_params_carry_across_leaf_by_leaf():
    """A bf16-param zamba2 smoke tree from the reference's init_lm:
    every leaf keeps its dtype (a_log, dt_bias, d_skip and the LoRA
    factors float32, the rest bf16) and its values bit for bit."""
    jc, pc = _cfgs("zamba2-1.2b", param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax.jit(JT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(2), jc))
    pp = params_from_numpy(jp, pc, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(PP.leaves(pp))
    assert len(got) == len(flat)
    f32 = 0
    for path, want in flat:
        key = tuple(str(k.key) for k in path)
        t = got[key]
        assert str(t.dtype).split(".")[-1] == str(want.dtype), key
        f32 += t.dtype == torch.float32
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg=str(key))
    assert got[("layers", "mamba", "a_log")].dtype == torch.float32
    assert f32 == 3 + 8                    # SSM vectors + 4 LoRA (a, b)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_forward_hidden_matches_reference(arch):
    """The stack on embedded inputs (48 tokens, 3 SSD chunks; the
    hybrid's sites attend plainly causal)."""
    jc, pc = _cfgs(arch)
    jp, pp = _params(arch, pc)
    x = np.random.default_rng(2).normal(0, 1, (B, 48, pc.d_model)
                                        ).astype(np.float32)
    ji, pi = JA_.plain_causal_info(48), PA_.plain_causal_info(48)
    want = jax.jit(lambda p, x: JT.forward_hidden(p, jc, x, q_info=ji,
                                                  k_info=ji))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got = PT.forward_hidden(pp, pc, torch.from_numpy(x), q_info=pi,
                                k_info=pi)
    _rel(got, want, "hidden")


@pytest.mark.parametrize("arch,mode", CASES, ids=IDS)
def test_train_forward_matches_reference(arch, mode):
    """The parallel forward over the CCM layout: mamba2 without CCM, the
    hybrid's sites through the CCM attention (concat) or over the merge
    slots."""
    jc, pc = _cfgs(arch, mode)
    jp, pp = _params(arch, pc)
    jl, pl = _layouts()
    jb, pb = _batch(1, pc.vocab_size)
    want = jax.jit(lambda p, t: JT.train_forward(p, jc, t, jl))(
        jp, jb["tokens"])
    with torch.no_grad():
        got = PT.train_forward(pp, pc, pb["tokens"], pl)
    assert tuple(got.shape) == (B, TAIL, pc.vocab_size)
    _rel(got, want, "logits")


def test_chunked_ingest_then_decode_equals_one_prefill():
    """mamba2: a 16-token ingest then 16 single-token decode steps (the
    recurrence) = one 32-token prefill (two SSD chunks): every decode
    step's logits = the prefill's at that position, and the final states
    agree."""
    _, pc = _cfgs("mamba2-370m")
    _, pp = _params("mamba2-370m", pc)
    toks = torch.from_numpy(_toks(5, (B, 32), pc.vocab_size))
    one = PI.init_online_state(pc, B, 0, device="cpu")
    want, one = PI.prefill(pp, pc, one, toks, full_logits=True)
    st = PI.init_online_state(pc, B, 0, device="cpu")
    st = PI.ingest_context(pp, pc, st, toks[:, :16])
    for i in range(16, 32):
        lg, st = PI.decode_step(pp, pc, st, toks[:, i:i + 1])
        if i < 31:
            np.testing.assert_allclose(lg[:, 0].numpy(),
                                       want[:, i].numpy(), atol=ATOL)
    assert st.pos == one.pos == 32
    for a, b in ((st.ssm.ssm, one.ssm.ssm), (st.ssm.conv, one.ssm.conv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ragged_and_illegal_lengths_raise(arch):
    """``valid_len`` raises ValueError for recurrent families (as in the
    reference), and so does a block the SSD chunking cannot split (chunk
    16: 24 tokens), before any state is written."""
    _, pc = _cfgs(arch)
    _, pp = _params(arch, pc)
    st = PI.init_online_state(pc, B, 32, device="cpu")
    t8 = torch.zeros(B, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="valid_len"):
        PI.ingest_context(pp, pc, st, t8, valid_len=5)
    with pytest.raises(ValueError, match="valid_len"):
        PI.prefill(pp, pc, st, t8, full_logits=True, valid_len=5)
    with pytest.raises(ValueError, match="ssm_chunk"):
        PI.prefill(pp, pc, st, torch.zeros(B, 24, dtype=torch.int64))
    assert not st.ssm.ssm.any() and st.pos == 0
    lg, st = PI.prefill(pp, pc, st, torch.zeros(B, 32, dtype=torch.int64))
    assert st.pos == 32 and bool(torch.isfinite(lg).all())
