"""Elastic scaling & failure recovery (port of
``repro/distributed/elastic.py``).

Recovery contract:
 1. every state that matters is in the checkpoint (params/opt/iterator),
 2. sharding specs are *functions of (cfg, mesh)*, never baked into state,
 3. the data iterator is stateless-indexable.

So recovery = a fresh launch on the surviving ranks -> a new mesh over
them -> ``CheckpointManager.restore`` -> continue at the checkpointed
step.  The reference simulates the loss of devices inside one process;
with one process per rank, "losing devices" is the coordinator's re-exec
of the launcher with the surviving slice: ``simulate_failure_and_recover``
launches a world of ``mesh_before``'s ranks, lets it train and
checkpoint, then launches a fresh, smaller world of ``mesh_after``'s
ranks that resumes from the last checkpoint.  ``launch_world`` is that
launcher: ``spawn``-ed processes that meet in one process group on
localhost (NCCL on the card, ``gloo`` with ``device="cpu"``).

Straggler mitigation: ``WatchdogStats`` (launch.train) flags slow steps;
the deterministic iterator allows skip-ahead (a lagging host jumps to
the current step index without replaying data).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import traceback
from typing import Any, Callable, Tuple

import torch
import torch.distributed as tdist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import DeviceLike
from repro_torch.distributed.context import DistContext, free_port, init_world
from repro_torch.models.config import ModelConfig


def remesh_restore(ckpt: CheckpointManager, step: int, cfg: ModelConfig,
                   new_mesh, state_template: Any,
                   trainable: Any) -> Tuple[Any, dict, DistContext]:
    """Restore a checkpoint onto a (possibly different) mesh.  A
    checkpoint holds whole leaves (`launch.train.TrainLoop` gathers them
    over the model axis), read onto the template's dtypes and device
    (its structure alone: its leaves may be whole or this rank's shards).
    Every rank of a data-parallel mesh keeps them whole; on a mesh that
    splits the model (``n_model > 1``, every family) each rank keeps its
    shard of every tree in the state that has the params' key paths
    (``fsdp.shard_model``: the tensor-parallel local layout, leaves the
    rules do not split whole; under ``sharding_strategy="fsdp"`` its
    ``param_spec`` blocks), so a checkpoint written at one ``n_model``,
    or under one strategy, restores at another."""
    del trainable
    from repro_torch.launch.mesh import make_dist
    from repro_torch.launch.train import check_mesh
    dist = make_dist(new_mesh)
    check_mesh(cfg, dist)
    state, extra = ckpt.restore(step, state_template)
    if dist.n_model > 1:
        state = _shard_state(state, cfg, dist)
    return state, extra, dist


def _shard_state(state, cfg: ModelConfig, dist: DistContext):
    """This rank's shard of a checkpointed state: its params-shaped trees
    (at any depth) and the moments of an ``AdamWState``."""
    from repro_torch.distributed.fsdp import shard_model
    from repro_torch.optim.adamw import AdamWState

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, AdamWState):
            return x._replace(mu=shard_model(x.mu, cfg, dist),
                              nu=shard_model(x.nu, cfg, dist))
        return x
    return walk(shard_model(state, cfg, dist))


def _rank_main(rank: int, world: int, port: int, device, fn, args, out):
    try:
        val = fn(init_world(rank, world, port, device), *args)
        out.put(("ok", rank, val if rank == 0 else None))
    except BaseException:              # reported to the launcher, re-raised
        out.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def launch_world(world: int, fn: Callable, *args, device: DeviceLike = None,
                 timeout: float = 600.0):
    """Run ``fn(device, *args)`` on every rank of a fresh world of
    ``world`` spawned processes joined in one process group; returns rank
    0's result.  ``fn`` and ``args`` are pickled (a module-level function,
    or a ``functools.partial`` of one).  A rank that raises, or a world
    that outlives ``timeout`` seconds, ends every rank and raises."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    dev = None if device is None else str(torch.device(device))
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, dev, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    result, errors = None, []
    try:
        for _ in range(world):
            kind, rank, val = out.get(timeout=timeout)
            if kind == "error":
                errors.append(f"rank {rank}:\n{val}")
                break
            if rank == 0:
                result = val
    except queue.Empty:
        errors.append(f"the world of {world} ranks outlived {timeout} s")
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("launch_world failed: " + "\n".join(errors))
    return result


def _train_until(dev, loop_factory, shape, n_steps: int):
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    loop = loop_factory(make_dist(make_debug_mesh(*shape, device=dev)))
    loop.run(n_steps, log_every=0)
    loop.ckpt.wait()


def _resume(dev, loop_factory, shape, total_steps: int):
    from repro_torch.launch.mesh import make_debug_mesh, make_dist
    loop = loop_factory(make_dist(make_debug_mesh(*shape, device=dev)))
    start = loop.maybe_restore()
    return loop.run(total_steps, start_step=start, log_every=0), start


def simulate_failure_and_recover(loop_factory: Callable[[DistContext], Any],
                                 mesh_before, mesh_after,
                                 fail_after_steps: int, total_steps: int,
                                 device: DeviceLike = None,
                                 timeout: float = 600.0):
    """Run ``fail_after_steps`` on a world of ``mesh_before`` = (n_data,
    n_model) ranks, 'lose' ranks, and resume on a fresh world of
    ``mesh_after`` from the last checkpoint.  Returns (the recovered
    loop's history, its start step), read on rank 0.
    ``loop_factory(dist)`` must return a ``TrainLoop`` with a checkpoint
    directory and be picklable.  The meshes are given by shape: a mesh
    cannot outlive its world's process group."""
    launch_world(mesh_before[0] * mesh_before[1], _train_until,
                 loop_factory, tuple(mesh_before), fail_after_steps,
                 device=device, timeout=timeout)
    return launch_world(mesh_after[0] * mesh_after[1], _resume,
                        loop_factory, tuple(mesh_after), total_steps,
                        device=device, timeout=timeout)
