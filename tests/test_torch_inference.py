"""Port parity for the online slice end to end: T ingests (g_comp +
g_update), prefill with full logits, then decode steps, on shared
weights, against ``repro`` run with ``attn_impl`` 'dense' (the jnp
segmented path) and 'pallas' (the segmented kernel in interpret mode).

Parametrised over memory mode x cache dtype x the reference's attn_impl.
T = 5 ingests exceed max_steps = 4, so the concat memory's clamped write
fires; the 8-token cache takes a 6-token prefill and 3 decode steps, so
the last cache write clamps while ``length`` keeps counting.

Tolerances (float32 on the CPU): logits and float state leaves atol 1e-4.
int8 cache values may differ by one quantum where rounding sits on a
tie, so int8 leaves are checked as |dq| <= 1, their scales to 1e-6 and
the dequantized cache to 1e-4.  Counters and greedy tokens must be equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as JI
from repro.models import transformer as JT
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro_torch.core import inference as PI
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg
from repro_torch.params import params_from_numpy

ATOL = 1e-4
B, LC, CACHE, PROMPT = 2, 8, 8, 6

_ingest = jax.jit(JI.ingest_context, static_argnums=(1,))
_prefill = jax.jit(JI.prefill, static_argnums=(1,),
                   static_argnames=("full_logits",))
_decode = jax.jit(JI.decode_step, static_argnums=(1,))
_generate = jax.jit(JI.generate, static_argnums=(1, 4))


def _cfgs(mode, cache_dtype, impl, alpha=None):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32", kv_cache_dtype=cache_dtype)
    cc = dict(comp_len=2, max_steps=4, mode=mode, merge_alpha=alpha)
    return (JCfg(**base, attn_impl=impl, ccm=JCCM(**cc)),
            PCfg(**base, ccm=PCCM(**cc)))


@functools.lru_cache(maxsize=1)
def _numpy_params():
    """JAX init (the tree is the same for every case here), then LoRA b
    and comp_embed randomized: the reference initialises b = 0, which
    would leave the gate untested."""
    jc, _ = _cfgs("concat", "bfloat16", "dense")
    init = jax.jit(JT.init_lm, static_argnums=(1,))
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jc))
    rs = np.random.default_rng(1)
    for lw in p["layers"]["attn"]["lora"].values():
        lw["b"] = rs.normal(0, 0.1, lw["b"].shape).astype(np.float32)
    p["comp_embed"] = rs.normal(0, 0.5, p["comp_embed"].shape
                                ).astype(np.float32)
    return p


def _params(pc):
    p = _numpy_params()
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, pc, "cpu")


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), atol=atol, rtol=0)


def _compare_state(js, ts):
    assert int(js.pos) == ts.pos
    jm, tm = js.mem, ts.mem
    _close(jm.k, tm.k)
    _close(jm.v, tm.v)
    assert (int(jm.slots), int(jm.steps), int(jm.stream_pos)) \
        == (tm.slots, tm.steps, tm.stream_pos)
    jcache, tcache = js.cache, ts.cache
    assert int(jcache.length) == tcache.length
    if tcache.quantized:
        for name in ("k", "v"):
            jq = np.asarray(getattr(jcache, name)).astype(np.int32)
            tq = getattr(tcache, name).numpy().astype(np.int32)
            assert np.abs(jq - tq).max() <= 1
            js_, ts_ = (getattr(jcache, name + "_scale"),
                        getattr(tcache, name + "_scale"))
            _close(js_, ts_, atol=1e-6)
            _close(JI.dequantize_kv(getattr(jcache, name), js_, jnp.float32),
                   PI.dequantize_kv(getattr(tcache, name), ts_,
                                    torch.float32))
    else:
        _close(jcache.k, tcache.k)
        _close(jcache.v, tcache.v)


def _clone(st):
    return jax.tree.map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                        else x, st)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_online_slice_matches_reference(mode, cache_dtype, impl):
    jc, pc = _cfgs(mode, cache_dtype, impl)
    jp, tp = _params(pc)
    rs = np.random.default_rng(2)
    js = JI.init_online_state(jc, B, CACHE)
    ts = PI.init_online_state(pc, B, CACHE, device="cpu")
    for _ in range(5):
        chunk = rs.integers(0, 128, (B, LC)).astype(np.int32)
        js = _ingest(jp, jc, js, jnp.asarray(chunk))
        ts = PI.ingest_context(tp, pc, ts, torch.from_numpy(chunk))
        _compare_state(js, ts)
    js_after, ts_after = js, _clone(ts)

    prompt = rs.integers(0, 128, (B, PROMPT)).astype(np.int32)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt), full_logits=True)
    tl, ts = PI.prefill(tp, pc, ts, torch.from_numpy(prompt),
                        full_logits=True)
    assert tuple(tl.shape) == (B, PROMPT, 128)
    _close(jl, tl)
    _compare_state(js, ts)
    for _ in range(3):
        tok = rs.integers(0, 128, (B, 1)).astype(np.int32)
        jl, js = _decode(jp, jc, js, jnp.asarray(tok))
        tl, ts = PI.decode_step(tp, pc, ts, torch.from_numpy(tok))
        _close(jl, tl)
        _compare_state(js, ts)
    assert ts.cache.length == PROMPT + 3 > CACHE
    # a context after an input: the ingest attends the filled cache too
    chunk = rs.integers(0, 128, (B, LC)).astype(np.int32)
    js = _ingest(jp, jc, js, jnp.asarray(chunk))
    ts = PI.ingest_context(tp, pc, ts, torch.from_numpy(chunk))
    _compare_state(js, ts)

    if impl != "dense":
        return      # generate adds no attend path beyond prefill/decode
    # greedy generate from the post-ingest state: identical tokens
    jt = _generate(jp, jc, js_after, jnp.asarray(prompt), 3)
    tt = PI.generate(tp, pc, ts_after, torch.from_numpy(prompt), 3)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def test_merge_ema_slice_matches_reference():
    jc, pc = _cfgs("merge", "bfloat16", "dense", alpha=0.3)
    jp, tp = _params(pc)
    rs = np.random.default_rng(4)
    js = JI.init_online_state(jc, B, CACHE)
    ts = PI.init_online_state(pc, B, CACHE, device="cpu")
    for _ in range(3):
        chunk = rs.integers(0, 128, (B, LC)).astype(np.int32)
        js = _ingest(jp, jc, js, jnp.asarray(chunk))
        ts = PI.ingest_context(tp, pc, ts, torch.from_numpy(chunk))
    prompt = rs.integers(0, 128, (B, PROMPT)).astype(np.int32)
    jl, js = _prefill(jp, jc, js, jnp.asarray(prompt), full_logits=False)
    tl, ts = PI.prefill(tp, pc, ts, torch.from_numpy(prompt))
    assert tuple(tl.shape) == (B, 1, 128)
    _close(jl, tl)
    _compare_state(js, ts)


def test_temperature_sampling_is_seeded():
    """Temperature sampling draws from a torch.Generator: the same seed
    gives the same tokens (the reference's jax.random bits differ)."""
    _, pc = _cfgs("concat", "bfloat16", "dense")
    from repro_torch.models.transformer import init_lm
    tp = init_lm(pc, seed=3, device="cpu")
    prompt = torch.randint(0, 128, (B, 4), generator=torch.Generator().manual_seed(0))

    def run(seed):
        st = PI.init_online_state(pc, B, 16, device="cpu")
        g = torch.Generator().manual_seed(seed)
        return PI.generate(tp, pc, st, prompt, 6, temperature=1.0,
                           generator=g)

    a, b = run(7), run(7)
    assert torch.equal(a, b) and a.shape == (B, 6) and a.dtype == torch.int32
