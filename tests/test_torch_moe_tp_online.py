"""The MoE family split over the ``model`` axis on the online path, in
the port against the reference: the cases of
``tests/test_torch_moe_tp.py`` (``phi35_moe.smoke`` and
``llama4_maverick.smoke``, float32 params, each ``moe_impl``, meshes
(1, 2), (2, 2) and (1, 4), gloo worlds of 2 and 4 ranks against the
reference on ``make_debug_mesh``, the same `skew`-ed weights):

- the ``dist=`` serve builders: an ingest, a prefill and a decode step
  (the logits gathered over the rows and the vocabulary blocks; the
  cache and the memory gathered over the rows and the KV heads, and the
  counters);
- ``make_stream_step`` through a window eviction.  The reference's
  stream step runs its MoE without ``dist``, dropless under ``ep`` too,
  so one reference run a mesh serves both impls, and the port's ``ep``
  drops nothing there.

Tolerance (float32): 1e-4 x max|reference| per tensor.
"""
import pytest

from test_torch_moe_tp import CASES, N_STREAM, close, run_cases


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory, "online")


@pytest.mark.parametrize("case", list(CASES))
def test_moe_tp_online_builders_match_reference(results, case):
    got, want, _ = results
    g, w = got[case], want[case]
    close(g["prefill"], w["prefill"], f"{case} prefill logits")
    close(g["decode"], w["decode"], f"{case} decode logits")
    for k, v in w["state"].items():
        if isinstance(v, int):
            assert g["state"][k] == v, (case, k)
        else:
            close(g["state"][k], v, f"{case} state {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_moe_tp_stream_step_matches_reference(results, case):
    got, want, _ = results
    shape, model, _ = CASES[case]
    g, w = got[case]["stream"], want[("stream", model, shape)]
    assert len(g["logits"]) == len(w["logits"]) == N_STREAM
    for i, (a, b) in enumerate(zip(g["logits"], w["logits"])):
        close(a, b, f"{case} stream chunk {i} logits")
    for k in ("win_k", "mem_k"):
        close(g[k], w[k], f"{case} stream {k}")
    assert g["slots"] == w["slots"] > 0, case     # an eviction compressed
    assert g["drops"] == 0, case                  # dropless, as there
