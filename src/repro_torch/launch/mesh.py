"""Meshes (port of ``repro/launch/mesh.py``).

Defined as FUNCTIONS so that importing this module touches no device
and no process group.

Three kinds of mesh, as in the reference:

- a ``DeviceMesh`` of ranks over the axes ``data`` / ``model`` (``pod``
  first on the multi-pod mesh) for training; it needs a process group
  initialised beforehand (``distributed.context.init_world``), one
  process per rank;
- a shape-only mesh (``make_shape_mesh``: axes and sizes, no device)
  for the dry run, which runs as its rank 0;
- the serve engine's session mesh: ``make_session_mesh(n)`` is a 1-D
  tuple of devices over the axis ``"shards"``, one device per arena
  shard, all driven by one process (the reference's single-controller
  model), so it needs no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.context import (DistContext, ShapeMesh,
                                             axis_names)


def _mk(shape, axes, device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over the whole world: ``cuda`` (NCCL)
    on the card, ``cpu`` (gloo) with ``device="cpu"``.  Raises, as
    ``jax.make_mesh`` does, unless the world holds exactly that many
    ranks."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    world = tdist.get_world_size() if tdist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"a mesh of shape {tuple(shape)} needs a process group of {n} "
            f"ranks; this one has {world or 'none'}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


# the production meshes: (shape, axes) of the single pod and the two pods
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    return _mk(*PRODUCTION["multi" if multi_pod else "single"], device)


def make_shape_mesh(shape, axes) -> ShapeMesh:
    """A mesh of ``shape`` over ``axes`` with no device and no process
    group (the reference's placeholder devices): the sharding rules and
    the local layout read it, and a ``DistContext`` over it runs as its
    rank 0 with counting collectives (`context.ShapeMesh`).  The dry run
    (`launch.dryrun`) takes the production meshes so:
    ``make_shape_mesh(*PRODUCTION["single"])``."""
    return ShapeMesh(tuple(axes), tuple(int(s) for s in shape))


def make_dist(mesh) -> DistContext:
    axes = axis_names(mesh)
    return DistContext(mesh=mesh,
                       data_axes=("data",) if "data" in axes else (),
                       model_axis="model",
                       pod_axis="pod" if "pod" in axes else None)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device: DeviceLike = None):
    """A small (data, model) mesh: ``device="cpu"`` for gloo groups on
    the CPU, the card's NCCL otherwise."""
    return _mk((n_data, n_model), ("data", "model"), device)


@dataclasses.dataclass(frozen=True)
class SessionMesh:
    """A 1-D mesh over the SESSION axis for the sharded serve engine:
    ``devices[s]`` holds arena shard ``s`` (its contiguous row block, see
    `serve.arena`).  ``axis_names`` and ``shape`` read as a jax ``Mesh``'s
    do."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("shards",)

    @property
    def shape(self):
        return {"shards": len(self.devices)}


def make_session_mesh(n_shards: Optional[int] = None,
                      device: DeviceLike = None) -> SessionMesh:
    """A session mesh of ``n_shards`` shards, one device each.  On the
    card it defaults to every visible CUDA device and refuses more shards
    than devices; with ``device="cpu"`` the n shards are n CPU "devices"
    (the stand-in for the reference's forced host devices)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        n = n_shards if n_shards is not None else avail
        if n > avail:
            raise ValueError(f"a session mesh of {n} shards needs {n} CUDA "
                             f"devices; {avail} visible")
        devices = tuple(torch.device("cuda", i) for i in range(max(n, 0)))
    else:
        n = n_shards if n_shards is not None else 1
        devices = (dev,) * max(n, 0)
    if n < 1:
        raise ValueError("session mesh needs at least one device")
    return SessionMesh(devices)


def available_mesh(model_parallel: int = 1, device: DeviceLike = None):
    """Elastic: the best (data, model) mesh from the ranks of the current
    process group."""
    import torch.distributed as tdist
    n = tdist.get_world_size() if tdist.is_initialized() else 0
    if n < 1:
        raise RuntimeError("available_mesh needs an initialised process "
                           "group (distributed.context.init_world)")
    nm = model_parallel
    while n % nm:
        nm -= 1
    return _mk((n // nm, nm), ("data", "model"), device)
