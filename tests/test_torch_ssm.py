"""Port parity for ``repro_torch/models/ssm.py`` (Mamba2 SSD) against
``repro/models/ssm.py``: the segment sum, the causal conv with and without
a carried state, ``ssd_chunked`` with and without an initial state,
``apply_mamba`` in its chunked and decode modes, the chunked form against
the recurrence, and the refusal of a block the SSD chunking cannot split.

Inputs come from numpy seeds; weights are the reference's ``init_mamba``
draws carried over by value.  Tolerance: float32, atol 1e-5 for the
single ops and 1e-4 for ``apply_mamba`` (float32 sums in another order
through its projections and the norm); ``_segsum`` must be equal.

In bf16 (the recurrent configs' compute dtype) the same calls hold the
reference's rounding points: ``M`` and ``x*dt`` rounded to bf16 before
their product, the conv weight cast to bf16, the state returned (and so
stored) in bf16.  The causal conv and ``ssd_chunked`` within one bf16
ulp of max|reference| (2**-7 x max) with at most 1% of the elements
unequal (each rounds the same float32 value once; rounding ``x*dt`` a
step late alone changes ~30%), ``apply_mamba`` within two (its silu and softplus are each
library's own elementwise code, which may round one ulp apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import ssm as JS
from repro_torch.configs import registry as PR
from repro_torch.models import ssm as PS
from repro_torch.params import params_from_numpy

ATOL_OP, ATOL = 1e-5, 1e-4
ULP = 2.0 ** -7                     # one bf16 ulp of a value in [1, 2)


def _cfgs():
    return tuple(reg.get_config("mamba2-370m", smoke=True,
                                compute_dtype="float32") for reg in (JR, PR))


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _close(want, got, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _close_bf16(want, got, ulps, share=1.0):
    """Both bf16, within ``ulps`` bf16 ulps of max|want|, and at most a
    ``share`` of the elements not equal."""
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    _close(w, got, ulps * ULP * float(np.abs(w).max()))
    assert np.mean(w != got.float().numpy()) <= share


def _bf(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _mamba_params(seed=3):
    jc, pc = _cfgs()
    p = jax.tree.map(np.asarray, JS.init_mamba(jax.random.PRNGKey(seed), jc,
                                               jc.d_model))
    rs = np.random.default_rng(seed)
    # non-trivial dt_bias, d_skip, conv bias and norm scale
    p["dt_bias"] = rs.normal(0, 0.5, p["dt_bias"].shape).astype(np.float32)
    p["d_skip"] = rs.normal(1, 0.2, p["d_skip"].shape).astype(np.float32)
    p["conv_b"] = rs.normal(0, 0.1, p["conv_b"].shape).astype(np.float32)
    p["norm"]["scale"] = rs.normal(0, 0.1, p["norm"]["scale"].shape
                                   ).astype(np.float32)
    return (jax.tree.map(jnp.asarray, p),
            params_from_numpy(p, pc, "cpu"))


def test_segsum_matches_reference():
    x = _rand(0, (2, 3, 16))
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    got = PS._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "carried-state"])
def test_causal_conv_matches_reference(with_state):
    x, w, b = _rand(1, (2, 7, 12)), _rand(2, (4, 12)), _rand(3, (12,))
    st = _rand(4, (2, 3, 12)) if with_state else None
    wy, ws = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    gy, gs = PS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    _close(wy, gy, ATOL_OP)
    _close(ws, gs, 0)              # the last K-1 inputs, as they are
    assert tuple(gs.shape) == (2, 3, 12)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "carried-state"])
def test_causal_conv_bf16_matches_reference(with_state):
    x, st = _bf(_rand(1, (2, 7, 12))), _bf(_rand(4, (2, 3, 12)))
    w, b = _rand(2, (4, 12)), _rand(3, (12,))      # float32 weights
    wy, ws = JS._causal_conv(x[0], jnp.asarray(w), jnp.asarray(b),
                             st[0] if with_state else None)
    gy, gs = PS._causal_conv(x[1], torch.from_numpy(w), torch.from_numpy(b),
                             st[1] if with_state else None)
    _close_bf16(wy, gy, 1, 0.01)
    _close_bf16(ws, gs, 0)          # the last K-1 inputs, as they are


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "init-state"])
def test_ssd_chunked_bf16_matches_reference(with_state):
    B, S, H, P, N, Q = 2, 48, 4, 8, 16, 16
    x, Bm, Cm = (_bf(_rand(sd, sh)) for sd, sh in
                 ((5, (B, S, H, P)), (8, (B, S, N)), (9, (B, S, N))))
    dt = np.abs(_rand(6, (B, S, H), 0.5)) + 0.01    # float32, as apply_mamba
    A = -np.exp(_rand(7, (H,), 0.3))
    s0 = _bf(_rand(10, (B, H, P, N)))
    wy, wf = JS.ssd_chunked(x[0], jnp.asarray(dt), jnp.asarray(A), Bm[0],
                            Cm[0], Q, s0[0] if with_state else None)
    gy, gf = PS.ssd_chunked(x[1], torch.from_numpy(dt), torch.from_numpy(A),
                            Bm[1], Cm[1], Q, s0[1] if with_state else None)
    _close_bf16(wy, gy, 1, 0.01)
    _close_bf16(wf, gf, 1, 0.01)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "init-state"])
def test_ssd_chunked_matches_reference(with_state):
    B, S, H, P, N, Q = 2, 48, 4, 8, 16, 16
    x = _rand(5, (B, S, H, P))
    dt = np.abs(_rand(6, (B, S, H), 0.5)) + 0.01
    A = -np.exp(_rand(7, (H,), 0.3))
    Bm, Cm = _rand(8, (B, S, N)), _rand(9, (B, S, N))
    s0 = _rand(10, (B, H, P, N)) if with_state else None
    wy, wf = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), Q,
                            None if s0 is None else jnp.asarray(s0))
    gy, gf = PS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), Q,
                            None if s0 is None else torch.from_numpy(s0))
    _close(wy, gy, ATOL_OP)
    _close(wf, gf, ATOL_OP)
    with pytest.raises(ValueError, match="divisible"):
        PS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 20)


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "decode"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state"])
def test_apply_mamba_matches_reference(decode, with_state):
    jc, pc = _cfgs()
    jp, pp = _mamba_params()
    S = 5 if decode else 32
    x = _rand(11, (2, S, jc.d_model))
    st = None
    if with_state:
        C = jc.d_inner + 2 * jc.ssm_state
        st = {"ssm": _rand(12, (2, jc.ssm_heads, jc.ssm_head_dim,
                                jc.ssm_state), 0.3),
              "conv": _rand(13, (2, jc.ssm_conv - 1, C))}
    wy, ws = JS.apply_mamba(jc, jp, jnp.asarray(x),
                            None if st is None else
                            jax.tree.map(jnp.asarray, st), decode)
    gy, gs = PS.apply_mamba(pc, pp, torch.from_numpy(x),
                            None if st is None else
                            {k: torch.from_numpy(v) for k, v in st.items()},
                            decode)
    _close(wy, gy, ATOL)
    _close(ws["ssm"], gs["ssm"], ATOL)
    _close(ws["conv"], gs["conv"], ATOL)


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "decode"])
def test_apply_mamba_bf16_matches_reference(decode):
    """bf16 activations and state, float32 weights (the recurrent
    configs' dtypes), with a carried state."""
    jc, pc = (c.replace(compute_dtype="bfloat16") for c in _cfgs())
    jp, pp = _mamba_params()
    S = 5 if decode else 32
    x = _bf(_rand(11, (2, S, jc.d_model)))
    C = jc.d_inner + 2 * jc.ssm_state
    st = {"ssm": _bf(_rand(12, (2, jc.ssm_heads, jc.ssm_head_dim,
                                 jc.ssm_state), 0.3)),
          "conv": _bf(_rand(13, (2, jc.ssm_conv - 1, C)))}
    wy, ws = JS.apply_mamba(jc, jp, x[0], {k: v[0] for k, v in st.items()},
                            decode)
    gy, gs = PS.apply_mamba(pc, pp, x[1], {k: v[1] for k, v in st.items()},
                            decode)
    _close_bf16(wy, gy, 2)
    _close_bf16(ws["ssm"], gs["ssm"], 2)
    _close_bf16(ws["conv"], gs["conv"], 0)


def test_chunked_equals_recurrence_and_state_carries():
    """One chunked call over 48 tokens = the recurrence token by token,
    and = two chunked calls (32 + 16) carrying the state (the reference's
    ``test_ssd_chunked_equals_sequential`` / ``test_ssd_state_carry``)."""
    _, pc = _cfgs()
    _, pp = _mamba_params(4)
    x = torch.from_numpy(_rand(14, (2, 48, pc.d_model)))
    y_par, st_par = PS.apply_mamba(pc, pp, x)
    y_seq, st_seq = PS.apply_mamba(pc, pp, x, decode=True)
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(), atol=ATOL)
    np.testing.assert_allclose(st_par["ssm"].numpy(), st_seq["ssm"].numpy(),
                               atol=ATOL)
    y1, st1 = PS.apply_mamba(pc, pp, x[:, :32])
    y2, st2 = PS.apply_mamba(pc, pp, x[:, 32:], st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_par.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(st2["ssm"].numpy(), st_par["ssm"].numpy(),
                               atol=ATOL)
    assert torch.equal(st2["conv"], st_par["conv"])


@pytest.mark.parametrize("S,ok", [(8, True), (16, True), (48, True),
                                  (24, False), (17, False)])
def test_block_length_must_split_into_chunks(S, ok):
    """The reference asserts S % min(ssm_chunk, S) == 0 (chunk 16 here):
    the port raises on the same lengths, and runs the others."""
    _, pc = _cfgs()
    _, pp = _mamba_params()
    x = torch.zeros(1, S, pc.d_model)
    if ok:
        assert PS.apply_mamba(pc, pp, x)[0].shape == x.shape
    else:
        with pytest.raises(ValueError, match="ssm_chunk"):
            PS.apply_mamba(pc, pp, x)
    assert PS.apply_mamba(pc, pp, x, decode=True)[0].shape == x.shape
