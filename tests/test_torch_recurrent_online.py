"""The online path of the recurrent families against ``repro``:
``ingest_context``, ``prefill``, ``decode_step`` and ``generate`` for
mamba2-370m (Mamba2 states only: no cache, no memory) and zamba2-1.2b
(Mamba2 states plus the cache and the CCM memory of its 2
shared-attention sites, concat and merge), at the registry's smoke sizes
in float32.  Logits atol 1e-4, every float state leaf atol 1e-4, counters
equal; ``generate``'s tokens equal the reference's greedy loop.
Helpers and weights are ``tests/test_torch_recurrent.py``'s.

The same path in bf16 compute (float32 weights, the recurrent configs'
dtypes): logits and every float state leaf in the reference's dtype
(the SSD and conv states stored in bf16 between calls) and within 8
bf16 ulps of max|reference| (2**-4 x max) per tensor.  Each package's
elementwise bf16 ops (silu, softplus, sigmoid) round on their own, one
ulp apart at most (``test_torch_ssm.py`` holds one Mamba2 layer within
two), and the differences cross 3-5 layers and 5 calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as JI
from repro_torch.core import inference as PI
from test_torch_recurrent import (B, CASES, IDS, _cfgs, _close, _params,
                                  _toks)

_ingest = jax.jit(JI.ingest_context, static_argnums=(1,))
_prefill = jax.jit(JI.prefill, static_argnums=(1,))
_decode = jax.jit(JI.decode_step, static_argnums=(1,))


def _clone(st):
    """A deep copy of a port state (its tensors are written in place)."""
    if isinstance(st, torch.Tensor):
        return st.clone()
    if isinstance(st, tuple) and hasattr(st, "_fields"):
        return type(st)(*[_clone(x) for x in st])
    return st


def _compare_state(js, ts):
    assert int(js.pos) == ts.pos
    _close(js.ssm.ssm, ts.ssm.ssm)
    _close(js.ssm.conv, ts.ssm.conv)
    if js.cache is None:
        assert ts.cache is None and ts.mem is None
        return
    jm, tm = js.mem, ts.mem
    _close(jm.k, tm.k)
    _close(jm.v, tm.v)
    assert (int(jm.slots), int(jm.steps), int(jm.stream_pos)) \
        == (tm.slots, tm.steps, tm.stream_pos)
    assert int(js.cache.length) == ts.cache.length
    _close(js.cache.k, ts.cache.k)
    _close(js.cache.v, ts.cache.v)


@pytest.mark.parametrize("arch,mode", CASES, ids=IDS)
def test_online_path_matches_reference(arch, mode):
    """2 ingests (6 tokens, + 2 <COMP> at the hybrid's sites), a 6-token
    prefill, 3 decode steps into a 16-token cache and a 4-token
    ``generate``: logits, tokens and every state leaf after every
    call."""
    jc, pc = _cfgs(arch, mode)
    jp, pp = _params(arch, pc)
    V = pc.vocab_size
    js = JI.init_online_state(jc, B, 16)
    ts = PI.init_online_state(pc, B, 16, device="cpu")
    for i in range(2):
        chunk = _toks(20 + i, (B, 6), V)
        js = _ingest(jp, jc, js, jnp.asarray(chunk))
        ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(chunk))
        _compare_state(js, ts)
    j0, t0 = js, _clone(ts)
    prompt = _toks(30, (B, 6), V)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt))
    tl, ts = PI.prefill(pp, pc, ts, torch.from_numpy(prompt))
    assert tuple(tl.shape) == (B, 1, V)
    _close(jl, tl)
    _compare_state(js, ts)
    for i in range(3):
        tok = _toks(40 + i, (B, 1), V)
        jl, js = _decode(jp, jc, js, jnp.asarray(tok))
        tl, ts = PI.decode_step(pp, pc, ts, torch.from_numpy(tok))
        _close(jl, tl)
        _compare_state(js, ts)
    if ts.mem is not None:
        assert ts.mem.slots == (2 if mode == "concat" else 1)
        assert ts.cache.length == 9
        assert ts.mem.k.shape[0] == ts.cache.k.shape[0] == 2     # 2 sites
    # generate: the reference's greedy loop through its (compiled) ops
    lg, js = _prefill(jp, jc, j0, jnp.asarray(prompt))
    want = [np.asarray(jnp.argmax(lg[:, -1], -1))]
    for _ in range(3):
        lg, js = _decode(jp, jc, js, jnp.asarray(want[-1][:, None]))
        want.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
    got = PI.generate(pp, pc, t0, torch.from_numpy(prompt), 4)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


def _close_bf16(j, t, ulps=8):
    assert str(j.dtype) == str(t.dtype).split(".")[-1], (j.dtype, t.dtype)
    w = np.asarray(j.astype(jnp.float32))
    _close(w, t, atol=ulps * 2.0 ** -7 * float(np.abs(w).max()))


@pytest.mark.parametrize("arch,mode", CASES, ids=IDS)
def test_online_path_bf16_matches_reference(arch, mode):
    """2 ingests, a 6-token prefill and 3 decode steps in bf16: logits
    and every float state leaf after each call."""
    jc, pc = _cfgs(arch, mode, compute_dtype="bfloat16")
    jp, pp = _params(arch, pc)
    V = pc.vocab_size

    def check(js, ts, jl=None, tl=None):
        if jl is not None:
            _close_bf16(jl, tl)
        assert int(js.pos) == ts.pos
        leaves = [(js.ssm.ssm, ts.ssm.ssm), (js.ssm.conv, ts.ssm.conv)]
        if js.cache is not None:
            leaves += [(js.mem.k, ts.mem.k), (js.mem.v, ts.mem.v),
                       (js.cache.k, ts.cache.k), (js.cache.v, ts.cache.v)]
            assert int(js.cache.length) == ts.cache.length
        for j, t in leaves:
            _close_bf16(j, t)
    js = JI.init_online_state(jc, B, 16)
    ts = PI.init_online_state(pc, B, 16, device="cpu")
    assert ts.ssm.ssm.dtype == ts.ssm.conv.dtype == torch.bfloat16
    for i in range(2):
        chunk = _toks(20 + i, (B, 6), V)
        js = _ingest(jp, jc, js, jnp.asarray(chunk))
        ts = PI.ingest_context(pp, pc, ts, torch.from_numpy(chunk))
        check(js, ts)
    prompt = _toks(30, (B, 6), V)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt))
    tl, ts = PI.prefill(pp, pc, ts, torch.from_numpy(prompt))
    check(js, ts, jl, tl)
    for i in range(3):
        tok = _toks(40 + i, (B, 1), V)
        jl, js = _decode(jp, jc, js, jnp.asarray(tok))
        tl, ts = PI.decode_step(pp, pc, ts, torch.from_numpy(tok))
        check(js, ts, jl, tl)
