"""``TrainLoop(dist=)`` in the port against the reference, on the
reference's init and the reference's batches (the port's loop draws its
own with ``torch.Generator``; here each rank's loop reads the reference's
batch of the step it is at): 3 steps in a ``gloo`` world of 4 ranks
(``distributed.elastic.launch_world``) against the reference's loop on
``make_debug_mesh(4, 1)`` (a subprocess with 4 forced host devices): the
loss history, and the trained leaves, equal on every rank.  The elastic
resume, on the same helpers, is ``tests/test_torch_distributed_elastic.py``.

The ranks are spawned processes that import this module, so the
reference's imports sit in the functions only the test process runs.

Tolerance (float32): 1e-4 x max|reference| per tensor, as
``tests/test_torch_train.py``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.core import masks as PM
from repro_torch.distributed.elastic import launch_world
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
MODEL = dict(name="d", family="dense", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=4, d_ff=64, vocab_size=128, train_mode="lora",
             compute_dtype="float32")
CCM = dict(comp_len=2, max_steps=2)
LAYOUT = (2, 6, 2, 8)
B = 8
OPT = dict(lr=1e-3, total_steps=20)

# the reference's side, run in a subprocess with 4 forced host devices;
# ``{body}`` fills ``out`` and argv[1] is where it is pickled
REF = """
import pickle, sys
import jax, numpy as np
from repro.core import masks as M
from repro.distributed.elastic import simulate_failure_and_recover
from repro.launch.mesh import make_debug_mesh, make_dist
from repro.launch.train import TrainLoop
from repro.models.config import CCMConfig, ModelConfig
from repro.optim.adamw import AdamWConfig
assert jax.device_count() == 4
cfg = ModelConfig(**{model}, ccm=CCMConfig(**{ccm}))
layout = M.segment_layout(*{layout})
flat = lambda t: {{"/".join(str(k.key) for k in p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}}

def factory(dist, ckpt=None):
    return TrainLoop(cfg, layout, AdamWConfig(**{opt}), batch_size={b},
                     ckpt_dir=ckpt, ckpt_every=4, dist=dist)

out = {{}}
{body}
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def start_reference(body: str, *args):
    """The reference's loop (``REF`` with ``body``) in a subprocess."""
    src = textwrap.dedent(REF).format(model=MODEL, ccm=CCM, layout=LAYOUT,
                                      opt=OPT, b=B,
                                      body=textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", src] + [str(a)
                                                          for a in args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_reference(proc, out, timeout=900):
    try:
        _, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    return pickle.loads(out.read_bytes())


def reference_inputs():
    """The reference loop's init (seed 0) and its batches of steps 0-11,
    as numpy."""
    import jax

    from repro.core import masks as JM
    from repro.data.synthetic import ShardableIndexIterator as JIt
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
    cfg = JCfg(**MODEL, ccm=JCCM(**CCM))
    params = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(0), cfg))
    it, layout = JIt(0, B), JM.segment_layout(*LAYOUT)
    batches = [{k: np.asarray(v) for k, v in
                jsample(it.key_for(s), layout, B).items()}
               for s in range(12)]
    return params, batches


def make_loop(dist, params_np, batches, ckpt_dir=None):
    """A port ``TrainLoop`` on ``dist`` that starts from the reference's
    init and, at step s, reads the reference's batch s."""
    from repro_torch.launch import train as TR
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import partition as PP
    from repro_torch.params import params_from_numpy

    cfg = PCfg(**MODEL, ccm=PCCM(**CCM))
    loop = TR.TrainLoop(cfg, PM.segment_layout(*LAYOUT),
                        PA.AdamWConfig(**OPT), batch_size=B,
                        ckpt_dir=ckpt_dir, ckpt_every=4, dist=dist,
                        device="cpu")
    params = params_from_numpy(params_np, cfg, device="cpu")
    loop.tp, loop.fp = PP.partition(params, loop.trainable)
    loop.opt = PA.init_adamw(loop.tp)
    # this rank's process alone: its loop reads the reference's batches
    TR.sample_kv_batch = lambda gen, layout, n, device: {
        k: torch.from_numpy(v.copy())
        for k, v in batches[loop.it.step - 1].items()}
    return loop


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= REL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _three_steps(dev, params_np, batches):
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    from repro_torch.optim import partition as PP

    loop = make_loop(make_dist(make_debug_mesh(4, 1, device=dev)),
                     params_np, batches)
    hist = loop.run(3, log_every=0)
    mine = ([h["loss"] for h in hist],
            {"/".join(p): x.detach().numpy().copy()
             for p, x in PP.leaves(loop.tp)})
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, mine)
    for loss, tp in every[1:]:                    # replicas stay equal
        assert loss == mine[0]
        assert all(np.array_equal(tp[k], x) for k, x in mine[1].items())
    return mine


def test_train_loop_matches_reference(tmp_path):
    out = tmp_path / "ref.pkl"
    ref = start_reference("""
        loop = factory(make_dist(make_debug_mesh(4, 1)))
        out["loop"] = [h["loss"] for h in loop.run(3, log_every=0)]
        out["tp"] = flat(loop.tp)
    """, out)
    try:
        params, batches = reference_inputs()
        losses, tp = launch_world(4, _three_steps, params, batches,
                                  device="cpu", timeout=600)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    want = finish_reference(ref, out)
    assert len(losses) == 3
    close(losses, want["loop"], "TrainLoop(dist=) losses")
    assert sorted(tp) == sorted(want["tp"])
    for k, v in want["tp"].items():
        close(tp[k], v, f"TrainLoop(dist=) {k}")
