"""The paper's recipe (``tests/test_system.py``'s fixture: ``pretrain_base``
800 steps, then ``train_compression`` 800, lr 3e-3) on the CPU in float32,
and the quantities of that test's claims: accuracy at t = 4 from memory
and the base's with no context, acc(t=1) and acc(t=4) over the whole key
space (mean of eval seeds 99-103), the online path's last-row distance
to ``train_forward`` (B8) and the memory after 4 ingests.  The port's
quantities come from ``repro_torch.launch.paper_loop.claims``.  A run
takes minutes.

    # the port's recipe at its own training seeds (pretrain seed 2k,
    # compression seed 2k + 1; k = 0 is the reference's 0 and 1)
    PYTHONPATH=src python scripts/paper_recipe_cpu.py --seeds 0 1 2
    # the reference's recipe, and the port's loops from the reference's
    # init and batches (both evaluated on the reference's eval batches)
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/paper_recipe_cpu.py \\
        --against-reference
    # does the port's CPU training repeat?  50 + 50 steps trained twice
    # in one process, compared leaf for leaf (one intra-op thread, and
    # torch's deterministic algorithms)
    PYTHONPATH=src python scripts/paper_recipe_cpu.py --steps 50 \\
        --repeat --threads 1 --deterministic

Each result is one JSON line.  The accuracies are CPU accuracies: they
say what the recipe learns, nothing of any device's speed.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch.launch import paper_loop as C  # noqa: E402
from repro_torch.obs.clock import perf_counter  # noqa: E402
from repro_torch.optim import partition as PT  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402

STEPS, LR = 800, 3e-3
EVAL_SEEDS = C.EVAL_SEEDS


def port_train(k: int, steps: int = STEPS):
    base = C.pretrain_base(steps, seed=2 * k, lr=LR, device="cpu")
    params = C.train_compression(base, C.bench_cfg(), steps,
                                 seed=2 * k + 1, lr=LR, device="cpu")
    return base, params


def port_recipe(k: int, steps: int = STEPS):
    t0 = perf_counter()
    base, params = port_train(k, steps)
    out = dict(run="port", training_seed=k, steps=steps,
               train_s=perf_counter() - t0)
    out.update(C.claims(base, params, C.bench_cfg(), device="cpu"))
    return out


def repeat(k: int, steps: int):
    """Train twice in this process from the same seeds and compare the
    two compressors leaf for leaf."""
    first, again = (dict(PT.leaves(port_train(k, steps)[1]))
                    for _ in range(2))
    differ = [p for p, x in first.items() if not torch.equal(x, again[p])]
    return dict(run="repeat", training_seed=k, steps=steps,
                threads=torch.get_num_threads(),
                deterministic=torch.are_deterministic_algorithms_enabled(),
                leaves=len(first), leaves_that_differ=len(differ),
                max_abs_diff=max([float((first[p] - again[p]).abs().max())
                                  for p in differ], default=0.0))


def against_reference():
    """The reference recipe with its batches recorded, then the port's
    loops from the reference's init trees and those batches; both
    evaluated on the reference's eval batches."""
    import jax

    from benchmarks import common as JC
    from benchmarks.tables import _eval_no_context
    from repro.data.synthetic import sample_kv_batch as jsample
    from repro.models import transformer as JT
    from repro.models.config import CCMConfig as JCCM

    def record(store):
        def draw(key, layout, batch):
            b = jsample(key, layout, batch, JC.TASK)
            store.append({n: np.array(v) for n, v in b.items()})
            return b
        return draw

    def replay(store):
        it = iter(store)
        return lambda gen, layout, batch, pool: {
            n: torch.from_numpy(v) for n, v in next(it).items()}

    def eval_batches(ts, seed, pool):
        return replay([{n: np.array(v) for n, v in jsample(
            jax.random.fold_in(jax.random.PRNGKey(seed), t * 100 + b),
            JC.layout_for(t), 16, JC.TASK, query_pool=pool).items()}
            for t in ts for b in range(6)])

    def to_port(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree),
                                 C.bench_cfg(), device="cpu")

    cfg = JC.bench_cfg()
    full = JC.bench_cfg(train_mode="full").replace(
        ccm=JCCM(enabled=False, comp_len=JC.COMP, max_steps=JC.T_MAX))
    init, fresh = (JT.init_lm(jax.random.PRNGKey(0), full),
                   JT.init_lm(jax.random.PRNGKey(1), cfg))
    pre, comp = [], []
    t0 = perf_counter()
    jbase = JC.pretrain_base(STEPS, lr=LR, sampler=record(pre))
    jparams = JC.train_compression(jbase, cfg, STEPS, lr=LR,
                                   sampler=record(comp))
    ref = dict(run="reference", train_s=perf_counter() - t0,
               acc4=JC.eval_at_timesteps(jparams, cfg, ts=(4,))[4],
               acc0=_eval_no_context(jbase, cfg, ts=(4,))[4])
    acc1 = acc4 = 0.0
    for seed in EVAL_SEEDS:
        accs = JC.eval_at_timesteps(jparams, cfg, ts=(1, 4), seed=seed,
                                    query_pool="all")
        acc1 += accs[1] / len(EVAL_SEEDS)
        acc4 += accs[4] / len(EVAL_SEEDS)
    ref.update(acc1_all=acc1, acc4_all=acc4,
               margin_no_context=ref["acc4"] - ref["acc0"],
               margin_t4_t1=acc4 - acc1)
    t0 = perf_counter()
    base = C.pretrain_base(STEPS, lr=LR, sampler=replay(pre),
                           params=to_port(init), device="cpu")
    params = C.train_compression(base, C.bench_cfg(), STEPS, lr=LR,
                                 sampler=replay(comp), fresh=to_port(fresh),
                                 device="cpu")
    port = dict(run="port from the reference's init and batches",
                train_s=perf_counter() - t0)
    port.update(C.claims(base, params, C.bench_cfg(), device="cpu",
                         eval_sampler=eval_batches))
    return [ref, port]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--against-reference", action="store_true")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps of each loop (the port's recipe alone)")
    ap.add_argument("--repeat", action="store_true",
                    help="train twice and compare instead of the claims")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    torch.use_deterministic_algorithms(args.deterministic)
    if args.against_reference:
        runs = against_reference()
    elif args.repeat:
        runs = (repeat(k, args.steps) for k in args.seeds)
    else:
        runs = (port_recipe(k, args.steps) for k in args.seeds)
    for r in runs:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
