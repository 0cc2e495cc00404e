"""Distribution context threaded through the training step (port of
``repro/distributed/context.py``).

The reference threads a ``jax.sharding.Mesh`` and runs its explicit
collectives under ``shard_map``.  The port is one process per rank
(``torch.distributed``): a ``DistContext`` wraps a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
``data`` / ``model`` (``pod`` before them when present), and ``group``
gives the process group of a tuple of axes, the stand-in for a
``shard_map`` collective's ``axis_name``.  The mesh can also be any
object with ``axis_names`` and a ``shape`` mapping (the reference's
``AbstractMesh`` idiom): the sharding rules need no more, and only
``group`` and ``rank_in`` need a process group.  A `ShapeMesh` (the
reference's placeholder devices: axes and sizes, no device, no process
group) runs as its rank 0: its ``group`` is a `CountingCollectives`,
whose collectives move nothing and count the bytes they would move (the
dry run, `launch.dryrun`).

The backend follows the device: NCCL for CUDA tensors, ``gloo`` for the
CPU.  A collective on a CUDA tensor never goes through a ``gloo`` group,
which would copy it to the host behind the caller's back: ``all_reduce``
raises instead.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

from repro_torch.device import DeviceLike, resolve_device

Axes = Union[str, Sequence[str]]


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's named dims (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return int(mesh.size(mesh.mesh_dim_names.index(name)))
    return int(mesh.shape[name])


def divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of named axes and their sizes that holds no device and no
    process group.  Its rank is rank 0 (``get_coordinate``); the
    collectives of its groups (`CountingCollectives`) add the bytes each
    device would receive to ``counts``, by kind."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    counts: Dict[str, int] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def get_coordinate(self) -> Tuple[int, ...]:
        return (0,) * len(self.sizes)


class CountingCollectives:
    """The collectives of a group of ``n`` ranks of a `ShapeMesh`, with
    ``tensor_parallel.GroupCollectives``' interface: nothing moves.  Each
    call returns an empty output of the collective's shape on its input's
    device (the meta device in the dry run) and adds the bytes of its
    result, what one device receives (as the reference's dry run counts
    an HLO collective's result shape), to ``counts`` under the
    reference's name of its kind.  A group of one rank counts nothing, as
    XLA emits no collective over one device."""

    def __init__(self, counts: Dict[str, int], n: int):
        self.counts, self.n = counts, n

    def _count(self, kind: str, y: torch.Tensor) -> torch.Tensor:
        if self.n > 1:
            self.counts[kind] = self.counts.get(kind, 0) \
                + y.numel() * y.element_size()
        return y

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._count("all-reduce", torch.empty_like(x))

    max = sum

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """The in-place all-reduce (`all_reduce_`): ``x`` itself."""
        return self._count("all-reduce", x)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] *= self.n
        return self._count("all-gather", x.new_empty(shape))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return self._count("all-to-all", torch.empty_like(x))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] //= self.n
        return self._count("reduce-scatter", x.new_empty(shape))


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: object                             # DeviceMesh (or shape-only)
    data_axes: Tuple[str, ...] = ("data",)   # batch sharding axes
    model_axis: str = "model"                # TP axis
    pod_axis: Optional[str] = None           # cross-pod axis (with data)
    # process groups of axis tuples, built on first use (collectively)
    _groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return ((self.pod_axis,) if self.pod_axis else ()) + tuple(self.data_axes)

    @property
    def n_model(self) -> int:
        return axis_size(self.mesh, self.model_axis)

    @property
    def n_data(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= axis_size(self.mesh, a)
        return n

    # -- process groups ------------------------------------------------
    def group(self, axes: Axes):
        """The process group spanning ``axes`` (one name, or a tuple such
        as ``("pod", "data")``: then one group over all of them).  Every
        rank must ask for the same axes in the same order, since building
        a group spanning several dims is a collective."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            mesh = self.mesh
            if isinstance(mesh, ShapeMesh):
                n = 1
                for a in axes:
                    n *= axis_size(mesh, a)
                self._groups[axes] = CountingCollectives(mesh.counts, n)
            else:
                # axes of one rank add nothing: the group of the others
                wide = tuple(a for a in axes if axis_size(mesh, a) > 1)
                self._groups[axes] = self._build(wide or axes[:1])
        return self._groups[axes]

    def _build(self, axes: Tuple[str, ...]):
        mesh = self.mesh
        if len(axes) == 1:
            return mesh.get_group(axes[0])
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(
            -1, int(torch.tensor([mesh.size(d) for d in dims]).prod()))
        mine = None
        for row in ranks.tolist():        # same order on every rank
            g = tdist.new_group(row)
            if tdist.get_rank() in row:
                mine = g
        return mine

    def rank_in(self, axes: Axes) -> int:
        """This rank's linear index over ``axes`` (row-major in the order
        given): the block of a ``batch_spec``-sharded batch it holds."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coord = self.mesh.get_coordinate()
        names = axis_names(self.mesh)
        r = 0
        for a in axes:
            r = r * axis_size(self.mesh, a) + coord[names.index(a)]
        return r

    def all_reduce(self, x: torch.Tensor, axes: Axes,
                   op=tdist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of ``x`` over ``axes``; returns ``x``."""
        return all_reduce_(x, self.group(axes), op)


def all_reduce_(x: torch.Tensor, group, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group``, a process group (its
    backend matching ``x``'s device, `check_backend`) or a `ShapeMesh`'s
    `CountingCollectives`; returns ``x``."""
    if isinstance(group, CountingCollectives):
        return group.all_reduce_(x)
    check_backend(x, group)
    tdist.all_reduce(x, op=op, group=group)
    return x


def check_backend(x: torch.Tensor, group=None) -> None:
    """Refuse a collective whose backend does not match the tensor's
    device: a CUDA tensor on a ``gloo`` group would be staged through host
    memory, a CPU tensor cannot go through NCCL."""
    backend = str(tdist.get_backend(group)).lower()
    if x.is_cuda and "nccl" not in backend:
        raise RuntimeError(
            f"a collective on a CUDA tensor needs an NCCL group, not "
            f"{backend!r} (no hidden copy to the host)")
    if not x.is_cuda and "gloo" not in backend:
        raise RuntimeError(f"a collective on a {x.device} tensor needs a "
                           f"gloo group, not {backend!r}")


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(rank: int, world: int, port: int,
               device: DeviceLike = None) -> torch.device:
    """Join a process group of ``world`` ranks that meet at
    ``tcp://localhost:<port>``: NCCL on the card (rank r on CUDA device
    r mod the visible count), ``gloo`` with ``device="cpu"``.  Returns
    this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
        # the ranks share the host's cores: a rank with every core's
        # threads oversubscribes them (8 steps of a 4-rank world on 8
        # cores: 8.15 s with the default threads, 3.13 s with 2 a rank)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                             world_size=world, rank=rank)
    return dev
