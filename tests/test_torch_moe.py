"""The MoE family (phi3.5-moe, llama4-maverick) through the port's paths,
against ``repro``: ``models/moe.py`` alone (routing, the dropless grouped
experts with empty groups, ties, the refusal of ``dist=``) and every path
the dense family runs, with the experts in every layer.

phi3.5-moe (16 experts, top-2) and llama4-maverick (128 experts, top-1)
at their registry ``smoke`` sizes in float32 (compute and params): 4 and
8 experts, 2 layers, GQA 8/2 x 8.  Weights, inputs and tolerances as
``tests/test_torch_encdec.py`` (whose helpers this file uses): training
1e-4 x max|reference| per tensor (full training compares the expert and
router gradients), online / stream logits and state atol 1e-4, the
engine's answers atol 1e-4 against the reference's sessions alone;
``apply_moe`` alone atol 1e-5, expert ids equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as JI
from repro.models import moe as JMOE
from repro_torch.models import moe as PMOE
from repro_torch.obs import ManualClock as PClock, Observability as PObs
from repro_torch.serve import ServeEngine as PEngine
from test_torch_encdec import (ATOL, _ingest, _prefill, check_adamw_step,
                               check_generate, check_gradients,
                               check_online, check_ragged, check_stream,
                               check_train_forward, cfgs, params)
from test_torch_zoo import _toks

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]


def _top1(arch):
    return cfgs(arch)[1].top_k == 1


def _layer0(arch):
    """Layer 0's ``moe`` subtree in both packages."""
    jc, pc = cfgs(arch)
    jp, pp = params(arch, pc)
    return (jc, jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            pc, {k: v[0] for k, v in pp["layers"]["moe"].items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_with_empty_experts_matches_reference(arch):
    """The router's columns for all but two experts pushed far down: most
    groups get no token (an empty group launches nothing); outputs and
    the routing equal the reference's."""
    jc, jm, pc, pm = _layer0(arch)
    E = pc.n_experts
    bias = np.full(E, -50.0, np.float32)
    bias[[1, E - 1]] = 0.0
    rs = np.random.default_rng(2)
    x = rs.normal(0, 1, (2, 5, pc.d_model)).astype(np.float32)
    x[..., 0] = 1.0           # column 0 of the router carries the bias
    jm = dict(jm, router=jm["router"].at[0].add(jnp.asarray(bias)))
    pm = dict(pm, router=pm["router"].clone())
    pm["router"][0] += torch.from_numpy(bias)
    want = jax.jit(JMOE.apply_moe, static_argnums=(0,))(jc, jm,
                                                       jnp.asarray(x))
    got = PMOE.apply_moe(pc, pm, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _, ji = jax.jit(JMOE._route, static_argnums=(0,))(
        jc, jm["router"], jnp.asarray(x.reshape(10, -1)))
    _, pi = PMOE._route(pc, pm["router"], torch.from_numpy(x.reshape(10, -1)))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    used = set(pi.reshape(-1).tolist())
    assert used <= {1, E - 1} and len(used) < E


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_ties_go_to_the_lower_expert_as_in_the_reference(arch):
    """Equal router columns tie in float32: ``jax.lax.top_k`` picks the
    lower expert id first, and so does the port."""
    jc, jm, pc, pm = _layer0(arch)
    w = np.random.default_rng(3).normal(0, 1, (pc.d_model, pc.n_experts))
    w = w.astype(np.float32)
    w[:, 2] = w[:, 1] = w[:, :].max(axis=1) + 1.0     # 1 and 2 lead, tied
    x = np.abs(np.random.default_rng(4).normal(0, 1, (6, pc.d_model)))
    x = x.astype(np.float32)
    jw, ji = jax.jit(JMOE._route, static_argnums=(0,))(
        jc, jnp.asarray(w), jnp.asarray(x))
    pw, pi = PMOE._route(pc, torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (pi[:, 0] == 1).all()
    if pc.top_k > 1:
        assert (pi[:, 1] == 2).all()
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-6)


def test_sharded_moe_raises_for_either_impl():
    """``apply_moe(dist=)`` splits the model (``tests/test_torch_moe_tp.py``
    holds it); under either impl a split the reference's ``shard_map``
    cannot make raises, naming both numbers: ragged_tp over a model axis
    that does not divide ``d_ff``, ep over one that does not divide E."""
    from repro_torch.distributed import tensor_parallel as TPX
    _, _, pc, pm = _layer0(ARCHS[0])
    x = torch.zeros(1, 2, pc.d_model)
    for impl, n, match in (("ragged_tp", 5, f"d_ff {pc.d_ff} over 5"),
                           ("ep", 3, f"{pc.n_experts} experts over 3")):
        cfg = pc.replace(moe_impl=impl)
        with pytest.raises(ValueError, match=match):
            PMOE.apply_moe(cfg, pm, x, dist=TPX.TensorParallel(cfg, n, 0,
                                                               None))


def test_router_is_float32_under_bf16_params():
    _, pc = cfgs(ARCHS[0])
    pc = pc.replace(param_dtype="bfloat16")
    from repro_torch.models.transformer import init_lm
    p = init_lm(pc, device="cpu")["layers"]["moe"]
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("wi", "wg", "wo")} == {torch.bfloat16}
    assert tuple(p["wi"].shape) == (pc.n_layers, pc.n_experts, pc.d_model,
                                    pc.d_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_reference(arch):
    check_train_forward(arch)


@pytest.mark.parametrize("train_mode", ["lora", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, train_mode):
    """LoRA-only (the configs' ``train_mode``), then full training: the
    expert weights' and the router's gradients.  Under top-1 routing
    (llama4) the renormalised combine weight is 1 whatever the router
    says, so the router's gradient is 0, in the reference as here."""
    top1 = _top1(arch)
    got = check_gradients(arch, train_mode,
                          zero=("layers/moe/router",) if top1 else ())
    if train_mode == "full":
        for k in ("router", "wi", "wg", "wo"):
            assert f"layers/moe/{k}" in got


def test_one_adamw_step_matches_reference():
    check_adamw_step(ARCHS[0])


@pytest.mark.parametrize("mode", ["concat", "merge"])
@pytest.mark.parametrize("arch", ARCHS)
def test_online_path_matches_reference(arch, mode):
    check_online(arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_online_calls_match_reference(arch):
    check_ragged(arch)


def test_generate_matches_reference():
    check_generate(ARCHS[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_step_across_an_eviction_matches_reference(arch):
    check_stream(arch, "merge" if arch == ARCHS[0] else "concat")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_answers_match_reference_sessions_alone(arch):
    """Ragged MoE sessions in the port's engine: 5 sessions over 2
    tenants on 3 slots (LRU offload and restore), 2 contexts of 3-8
    tokens each (ragged token buckets), a fork of a resident session,
    then a query of 2-6 tokens each.  Every answer equals the reference's
    session run alone (B=1) through its online path, which is what its
    engine's vmapped arena step computes per lane; pad tokens route
    through the experts too, and no valid token's answer depends on them.

    The reference's engine itself cannot run this family under jax
    0.9.0: ``jax.lax.ragged_dot`` under its arena step's ``vmap`` raises
    NotImplementedError ("ragged_dot vmap over any dim but 0 - NYI"), so
    the lane semantics are held here through its sessions alone."""
    jc, pc = cfgs(arch)
    jp, pp = params(arch, pc)
    V = pc.vocab_size
    eng = PEngine(pp, pc, n_slots=3, cache_len=16, batch_buckets=(1, 2, 4),
                  obs=PObs(clock=PClock()), device="cpu")
    assert eng.ragged
    sids = list("abcde")
    ctx = {s: [_toks(80 + 2 * i + r, 3 + (5 * i + 3 * r) % 6, V)
               for r in range(2)] for i, s in enumerate(sids)}
    for i, s in enumerate(sids):
        eng.create_session(s, tenant=f"t{i % 2}")
    for r in range(2):
        for s in sids:
            eng.ingest(s, ctx[s][r])
        eng.run()
    mgr = eng._mgr["online"]
    parent = next(s for s in sids if mgr.sessions[s].resident)
    eng.fork_session(parent, "f")
    eng.run()
    ctx["f"] = ctx[parent]
    qry = {s: _toks(90 + i, 2 + i % 5, V) for i, s in enumerate(sids + ["f"])}
    reqs = {s: eng.query(s, qry[s]).request for s in qry}
    eng.run()
    snap = eng.metrics_snapshot()["metrics"]
    moved = {v["labels"]["dir"]: v["value"]
             for v in snap["offload_sessions_total"]["values"]}
    assert moved["offload"] > 0 and moved["restore"] > 0
    assert mgr.arena.consistency_errors() == []
    for s, req in reqs.items():
        js = JI.init_online_state(jc, 1, 16)
        for c in ctx[s]:
            js = _ingest(jp, jc, js, jnp.asarray(c)[None])
        want, _ = _prefill(jp, jc, js, jnp.asarray(qry[s])[None],
                           full_logits=True)
        assert req.done and req.result.shape == (len(qry[s]), V)
        np.testing.assert_allclose(req.result, np.asarray(want[0]),
                                   atol=ATOL, rtol=0, err_msg=s)
