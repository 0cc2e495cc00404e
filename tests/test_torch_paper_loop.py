"""Port parity for the paper's learn-and-answer loop
(``repro_torch.launch.paper_loop`` against ``benchmarks/common.py`` and
``benchmarks/tables._eval_no_context``) and for ``lm_stream``.

Both packages get the same initial weights (the reference's ``init_lm``
through ``params_from_numpy``) and the same batches (the reference's
``sample_kv_batch`` draws, recorded as the reference's loop asks for
them and replayed to the port's ``sampler=``).  The loops run 3 steps
here; the reference recipe (800 + 800 steps) and the claims of
``tests/test_system.py`` on it run on the card (``chip_smoke.py``
phase 20).

Tolerances (float32 on the CPU): every trained leaf within 1e-4 x
max|reference| of the reference's; each accuracy within one hit (1 /
total) of the reference's; the online path's last-row logits within
5e-3 of the parallel forward's, as ``tests/test_system.py`` holds them.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import common as JC  # noqa: E402
from benchmarks.tables import _eval_no_context as j_eval_no_context  # noqa: E402
from repro.data.synthetic import lm_stream as j_lm_stream  # noqa: E402
from repro.data.synthetic import sample_kv_batch as jsample  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import CCMConfig as JCCM  # noqa: E402
from repro_torch.data.synthetic import lm_stream  # noqa: E402
from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.optim import partition as PP  # noqa: E402
from repro_torch.params import params_from_numpy, params_to_numpy  # noqa: E402

REL = 1e-4
STEPS = 3
EVAL_BATCHES = 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port: its small ops stall on contended
    thread pools when several test workers share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# lm_stream
# ---------------------------------------------------------------------------

def _stream_base(ref: np.ndarray, lo: int, hi: int):
    """Columns of the reference stream whose base token lies outside the
    noise range [lo, hi), with that base token: the reference's unmixed
    rows there all hold it (a mixed row lies inside the range)."""
    cols, vals = [], []
    for p in range(ref.shape[1]):
        out = ref[:, p][(ref[:, p] < lo) | (ref[:, p] >= hi)]
        if out.size:
            assert (out == out[0]).all(), p
            cols.append(p)
            vals.append(out[0])
    return np.array(cols), np.array(vals)


@pytest.mark.parametrize("case", ["dtype-range", "base-512", "base-64",
                                  "share"])
def test_lm_stream(case):
    B, L, vocab = (4, 4096, 512) if case == "share" else (4, 512, 512)
    if case == "base-64":
        vocab = 64
    gen = torch.Generator()
    gen.manual_seed(5)
    toks = lm_stream(gen, B, L, vocab, device="cpu")
    got = toks.numpy()
    lo, hi = 4, 4 + vocab // 8
    if case == "dtype-range":
        assert toks.dtype == torch.int32 and tuple(toks.shape) == (B, L)
        assert got.min() >= 0 and got.max() < vocab
        return
    ref = np.asarray(j_lm_stream(jax.random.PRNGKey(5), B, L, vocab))
    cols, base = _stream_base(ref, lo, hi)
    at = got[:, cols]
    unmixed = at == base[None]
    # every token of such a column is its base token or a noise token
    assert (unmixed | ((at >= lo) & (at < hi))).all()
    if case == "share":
        share = 1.0 - unmixed.mean()
        ref_share = 1.0 - (ref[:, cols] == base[None]).mean()
        assert abs(share - 0.2) <= 0.03, share
        assert abs(ref_share - 0.2) <= 0.03, ref_share
    else:
        assert unmixed.any(axis=0).mean() > 0.95
        if vocab == 64:        # the clip: bases past the vocabulary
            assert (base == vocab - 1).any()


# ---------------------------------------------------------------------------
# the loops, 3 steps, from the reference's init and batches
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _recorder(store, query_pool="ctx"):
    def draw(key, layout, batch):
        b = jsample(key, layout, batch, JC.TASK, query_pool=query_pool)
        store.append({k: np.array(v) for k, v in b.items()})
        return b
    return draw


def _replay(store):
    it = iter(store)

    def draw(gen, layout, batch, query_pool):
        del gen, query_pool
        b = next(it)
        assert b["tokens"].shape == (batch, layout.seq_len)
        return {k: torch.from_numpy(v) for k, v in b.items()}
    return draw


def _close_trees(got, want):
    """Every leaf of ``want`` (a numpy tree) has its twin in ``got``
    within REL x max|want|."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert flat
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w, np.float32)
        tol = REL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, atol=tol,
                                   rtol=0, err_msg=str(path))


_RUNS = {}


def _ref_pretrain():
    """The reference's `pretrain_base` for 3 steps: its init, its batches
    and its result, as numpy."""
    if "pretrain" not in _RUNS:
        cfg = JC.bench_cfg(train_mode="full").replace(
            ccm=JCCM(enabled=False, comp_len=JC.COMP, max_steps=JC.T_MAX))
        init = _np(JT.init_lm(jax.random.PRNGKey(0), cfg))
        batches = []
        out = JC.pretrain_base(STEPS, seed=0, sampler=_recorder(batches))
        _RUNS["pretrain"] = (init, batches, _np(out))
    return _RUNS["pretrain"]


def _ref_compression(unconditional: bool):
    """The reference's `train_compression` for 3 steps on the reference's
    3-step base: its fresh init, its batches and its result."""
    key = ("compression", unconditional)
    if key not in _RUNS:
        base = _ref_pretrain()[2]
        cfg = JC.bench_cfg()
        fresh = _np(JT.init_lm(jax.random.PRNGKey(1), cfg))
        batches = []
        out = JC.train_compression(jax.tree.map(jax.numpy.asarray, base),
                                   cfg, STEPS, seed=1,
                                   unconditional=unconditional,
                                   sampler=_recorder(batches))
        _RUNS[key] = (fresh, batches, _np(out))
    return _RUNS[key]


def _port(tree):
    return params_from_numpy(tree, C.bench_cfg(), device="cpu")


def test_pretrain_base_matches_reference():
    init, batches, want = _ref_pretrain()
    params = _port(init)
    got = C.pretrain_base(STEPS, seed=0, sampler=_replay(batches),
                          params=params, device="cpu")
    assert "comp_embed" not in got
    _close_trees(params_to_numpy(got), want)
    # the initial tree is left as it was
    _close_trees(params_to_numpy(params), init)


@pytest.mark.parametrize("unconditional", [False, True],
                         ids=["conditional", "unconditional"])
def test_train_compression_matches_reference(unconditional):
    fresh, batches, want = _ref_compression(unconditional)
    base = _port(_ref_pretrain()[2])
    got = C.train_compression(base, C.bench_cfg(), STEPS, seed=1,
                              unconditional=unconditional,
                              sampler=_replay(batches), fresh=_port(fresh),
                              device="cpu")
    _close_trees(params_to_numpy(got), want)
    # the adapter moved off its zero-delta init; the base did not move
    lora = params_to_numpy(got)["layers"]["attn"]["lora"]
    assert not np.allclose(lora["q"]["b"], fresh["layers"]["attn"]["lora"]
                           ["q"]["b"])
    assert not np.allclose(params_to_numpy(got)["comp_embed"],
                           fresh["comp_embed"])
    _close_trees(params_to_numpy(base), _ref_pretrain()[2])


def test_graft_lora_takes_the_adapter_from_fresh():
    base = _port(_ref_pretrain()[2])
    fresh = _port(_ref_compression(False)[0])
    out = C.graft_lora(base, fresh)
    assert torch.equal(out["comp_embed"], fresh["comp_embed"])
    assert out["comp_embed"] is not fresh["comp_embed"]
    for path, x in PP.leaves(out):
        src = fresh if "lora" in path or "comp_embed" in path else base
        y = src
        for k in path:
            y = y[k]
        assert torch.equal(x, y), path
        assert ("lora" in path or "comp_embed" in path) != (x is y), path
    assert "comp_embed" not in base and "lora" not in base["layers"]["attn"]


def _eval_batches(ts, seed, query_pool, layout_of):
    out = []
    for t in ts:
        for b in range(EVAL_BATCHES):
            bt = jsample(jax.random.fold_in(jax.random.PRNGKey(seed),
                                            t * 100 + b),
                         layout_of(t), 16, JC.TASK, query_pool=query_pool)
            out.append({k: np.array(v) for k, v in bt.items()})
    return out


@pytest.mark.parametrize("case", ["ctx", "all", "no_context"])
def test_eval_matches_reference(case):
    """Accuracy per time step (``query_pool`` "ctx" and "all") and with
    no context, on the reference's 3-step weights and batches."""
    ts = (1, 2, 4)
    trained = _ref_compression(False)[2]
    cfg = JC.bench_cfg()
    jparams = jax.tree.map(jax.numpy.asarray, trained)
    if case == "no_context":
        want = j_eval_no_context(jparams, cfg, ts=ts,
                                 n_batches=EVAL_BATCHES)
        got = C.eval_no_context(_port(trained), C.bench_cfg(), ts=ts,
                                n_batches=EVAL_BATCHES,
                                sampler=_replay(_eval_batches(
                                    ts, 99, "ctx", JC.layout_for)),
                                device="cpu")
    else:
        want = JC.eval_at_timesteps(jparams, cfg, ts=ts,
                                    n_batches=EVAL_BATCHES, seed=99,
                                    query_pool=case)
        got = C.eval_at_timesteps(_port(trained), C.bench_cfg(), ts=ts,
                                  n_batches=EVAL_BATCHES, seed=99,
                                  query_pool=case,
                                  sampler=_replay(_eval_batches(
                                      ts, 99, case, JC.layout_for)),
                                  device="cpu")
    total = EVAL_BATCHES * 16 * (C.TAIL // 2)
    assert sorted(got) == list(ts)
    for t in ts:
        assert abs(got[t] - want[t]) <= 1.0 / total + 1e-9, (t, got, want)


# ---------------------------------------------------------------------------
# tests/test_system.py's online checks on the port
# ---------------------------------------------------------------------------

def _claims():
    """``paper_loop.claims`` on the reference's 3-step base and
    compressor (the port's own eval batches)."""
    if "claims" not in _RUNS:
        _RUNS["claims"] = C.claims(_port(_ref_pretrain()[2]),
                                   _port(_ref_compression(False)[2]),
                                   C.bench_cfg(), device="cpu")
    return _RUNS["claims"]


@pytest.mark.parametrize("check", ["online-equals-parallel",
                                   "memory-size", "accuracies"])
def test_system_checks_on_the_port(check):
    got = _claims()
    if check == "online-equals-parallel":
        # the online path's last-row logits = train_forward's
        assert got["online_err"] <= 5e-3, got["online_err"]
    elif check == "memory-size":
        t, m = C.T_MAX, C.COMP
        # memory holds exactly t*m KV tokens; raw context was t*lc
        assert got["memory_tokens"] == t * m
        assert t * m < t * C.CHUNK
        assert got["cache_length"] == 0       # raw context never cached
    else:
        # the claims' accuracies are those of the eval functions
        params = _port(_ref_compression(False)[2])
        cfg = C.bench_cfg()
        assert got["acc4"] == C.eval_at_timesteps(params, cfg, ts=(4,),
                                                  device="cpu")[4]
        seed = C.EVAL_SEEDS[-1]
        assert got["per_seed"][seed] == C.eval_at_timesteps(
            params, cfg, ts=(1, 4), seed=seed, query_pool="all",
            device="cpu")
        n = len(C.EVAL_SEEDS)
        for t, name in ((1, "acc1_all"), (4, "acc4_all")):
            assert abs(got[name] - sum(a[t] for a in got["per_seed"]
                                       .values()) / n) < 1e-12
        assert got["margin_t4_t1"] == got["acc4_all"] - got["acc1_all"]
        assert got["margin_no_context"] == got["acc4"] - got["acc0"]
        assert all(0.0 <= got[k] <= 1.0 for k in ("acc4", "acc0",
                                                   "acc1_all", "acc4_all"))


# ---------------------------------------------------------------------------
# the bf16 CCM route's plan cache across the loop's layouts
# ---------------------------------------------------------------------------

def test_ccm_plan_cache_gives_each_layout_its_own_plan():
    """``kernels/ccm_attention._plan_for`` over the layouts one run of the
    loop hands the bf16 route, in its order: LLaMA-7B's training layout
    (t = 16, comp 8, B32), the eval's t = 1 and t = 4 (B16, each built
    anew), then the training layout and t = 1 again.  Each call's
    metadata (built as ``train_forward`` builds it) gets the plan that
    ``plan`` makes for it, the layers of one call share it, and an
    in-place write to the metadata gives a new plan."""
    from repro_torch.kernels import ccm_attention as ca
    dev = torch.device("cpu")
    ca._plans.clear()
    seen = []
    for t, B in ((16, 32), (1, 16), (4, 16), (16, 32), (1, 16)):
        layout = C.layout_for(t, 8)
        S = layout.seq_len
        idx = torch.arange(S, dtype=torch.int32, device=dev)
        seg, comp = layout.seg_ids.to(dev), layout.comp_mask.to(dev)
        meta = (idx, seg, idx, seg, comp, None)
        got = ca._plan_for(meta, B, S, S, dev)
        assert ca._plan_for(meta, B, S, S, dev) is got    # layer 2 on
        want = ca.plan(*meta, B, S, S, dev)
        for name in ("ktab", "q_tiles", "q_count", "k_tiles", "k_count"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (t, name)
        assert (got.nq, got.nk, got.nc) == (want.nq, want.nk, want.nc)
        assert all(got is not p for p in seen), t
        seen.append(got)
    comp = comp.clone()
    meta = (idx, seg, idx, seg, comp, None)
    before = ca._plan_for(meta, 16, S, S, dev)
    comp[-1] = True
    after = ca._plan_for(meta, 16, S, S, dev)
    assert after is not before
    assert torch.equal(after.ktab, ca.plan(*meta, 16, S, S, dev).ktab)
    assert not torch.equal(after.ktab, before.ktab)
    ca._plans.clear()
