"""The elastic resume in the port against the reference, as
``tests/test_distributed.py``'s: 8 steps in a ``gloo`` world of 4 ranks
with a checkpoint every 4 (rank 0 writes), then a fresh world of 2 that
reads it, resumes at step 8 and runs to 12
(``distributed.elastic.simulate_failure_and_recover``), against the
reference's recovery from mesh (4, 1) to (2, 1) (a subprocess with 4
forced host devices; its loop without ``dist=``, as its own test runs
it), both on the reference's init and batches (helpers of
``tests/test_torch_distributed_loop.py``).

Tolerance (float32): 1e-4 x max|reference| per tensor.
"""
import functools
import os

from repro_torch.distributed.elastic import simulate_failure_and_recover
from test_torch_distributed_loop import (close, finish_reference, make_loop,
                                         reference_inputs, start_reference)


def test_elastic_resume_matches_reference(tmp_path):
    out = tmp_path / "ref.pkl"
    # the reference's loop without dist=, as tests/test_distributed.py
    # runs it (its jitted single-device step; the same history)
    ref = start_reference("""
        hist, start = simulate_failure_and_recover(
            lambda d: factory(None, sys.argv[2]), make_debug_mesh(4, 1),
            make_debug_mesh(2, 1), fail_after_steps=8, total_steps=12)
        out["elastic"] = (start, [h["loss"] for h in hist])
    """, out, tmp_path / "ref_ckpt")
    try:
        params, batches = reference_inputs()
        factory = functools.partial(make_loop, params_np=params,
                                    batches=batches,
                                    ckpt_dir=str(tmp_path / "ckpt"))
        hist, start = simulate_failure_and_recover(
            factory, (4, 1), (2, 1), fail_after_steps=8, total_steps=12,
            device="cpu", timeout=600)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    want_start, want_losses = finish_reference(ref, out)["elastic"]
    assert start == want_start == 8
    assert [h["step"] for h in hist] == [8, 9, 10, 11]
    close([h["loss"] for h in hist], want_losses, "elastic losses")
    # rank 0 of the world of 4 wrote steps 4 and 8, the world of 2 step 12
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        f"step_{s:010d}" for s in (4, 8, 12)]
