"""ZeRO-3 (``sharding_strategy="fsdp"``): the weights stored by
``param_pspecs`` and gathered layer by layer.

The reference gets ZeRO-3 from GSPMD: ``param_spec`` puts every non-LoRA
weight on ``_fsdp_spec`` (the largest dim >= 128 that divides, cut over
the model axis), and XLA gathers the weights where they are used, so the
math is the unsharded model's.  The port is one process per rank, so it
splits storage from compute.

STORAGE.  Each rank holds exactly its block of each leaf by
``sharding.param_spec`` (`shard_fsdp`): the non-LoRA leaves on
``_fsdp_spec``, a LoRA ``a`` whole and a LoRA ``b`` on its last dim where
that divides, the norms, ``comp_embed``, ``router`` and the other ``P()``
leaves whole; AdamW moments follow their leaf.  There is no departure
from the specs (`tensor_parallel` lists the local layout's), so the
per-device argument bytes are the reference's.  The stacked layer axis
is never cut (every registry config has fewer than 128 layers), so a
layer's slice of a stored leaf is that layer's block.

COMPUTE.  `view` turns stored params into a tree whose top-level leaves
(``embed``, ``lm_head``, ``pos_embed``, ``final_norm``, ``shared_attn``,
the encoder's and the frontend's) are gathered once, and whose stacks
(``layers``, ``encoder/layers``) are a `Stack`, which gathers a layer's
leaves when ``transformer.layer_params`` reads them.  The gather is an
autograd function: an all-gather along the spec's dim forward, a
reduce-scatter of the gradient along it backward.  Two modes:

- training (an `Fsdp` rank with ``tp=None``, `launch.train`): each rank
  runs every layer whole, as ``dist=None`` does, on its own block of
  rows (the batch over every mesh axis; ``ep``'s drops are the data
  block's); the gradient of a stored block is the reduce-scatter of the
  ranks' partial gradients.  Under ``cfg.remat`` the gather sits inside
  the checkpointed layer, so a layer's whole weights live only while it
  runs (two gathers a layer: the forward and the recompute);
- serving (a `tensor_parallel.TensorParallel` rank whose config is
  ``fsdp``: ``TensorParallel.stored``): each layer's gathered leaves are
  cut to the tensor-parallel local layout (``tensor_parallel.split_dim``)
  and the tensor-parallel block runs as it is, since the online and
  stream states keep the reference's specs, which split KV heads over
  the model axis whatever the strategy.

``moe_impl="ep"`` runs in both modes.  A training rank runs its experts
whole on its rows, with the drops the reference's ``shard_map`` makes
over the whole data block: the expert ids are gathered over the model
axis (``models.moe._moe_ep_rows``).  A serving rank cuts its layer
along E and runs ``ep``'s all-to-all as under ``tp``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TPX
from repro_torch.distributed.context import DistContext, ShapeMesh
from repro_torch.models.config import ModelConfig
from repro_torch.optim.partition import leaves, tree_map

STACKS = (("layers",), ("encoder", "layers"))


@functools.lru_cache(maxsize=None)
def _gather_dims(cfg: ModelConfig, n: int) -> Dict[Tuple[str, ...],
                                                   Optional[int]]:
    from repro_torch.models.transformer import init_lm
    dist = DistContext(mesh=ShapeMesh(("data", "model"), (1, n)))
    out = {}
    for path, x in leaves(init_lm(cfg, 0, device="meta")):
        spec = SH.param_spec(path, tuple(x.shape), cfg, dist)
        cut = [i for i, a in enumerate(spec) if a is not None]
        if cut and cut[0] == 0 and path[:-1] and any(
                path[:len(s)] == s for s in STACKS):
            raise NotImplementedError(f"{'/'.join(path)}: the spec cuts the "
                                      "stacked layer axis")
        out[path] = cut[0] - x.ndim if cut else None
    return out


def gather_dim(path: Tuple[str, ...], cfg: ModelConfig,
               n: int) -> Optional[int]:
    """The dim (negative) the leaf at ``path`` is stored cut on over a
    model axis of ``n`` ranks (``param_spec``'s), or None where every
    rank holds it whole.  ``path`` may lie under a prefix (a state that
    holds params-shaped trees, `elastic.remesh_restore`); a path that is
    no leaf of the params is None."""
    dims = _gather_dims(cfg, n)
    path = tuple(path)
    for i in range(len(path)):
        if path[i:] in dims:
            return dims[path[i:]]
    return None


def _n_rank(dist) -> Tuple[int, int]:
    if isinstance(dist, (Fsdp, TPX.TensorParallel)):
        return dist.n, dist.rank
    return TPX._n_rank(dist)


def shard_fsdp(tree: Any, cfg: ModelConfig, dist) -> Any:
    """This rank's stored block of every leaf of a tree with the params'
    key paths (the params, a partition of them, a moment tree), a copy
    that holds no more than the block (a leaf stored whole, or any leaf
    on a model axis of one rank, is the same tensor); None leaves stay
    None."""
    n, r = _n_rank(dist)

    def one(path, x):
        d = None if x is None else gather_dim(path, cfg, n)
        if d is None or n == 1:
            return x
        size = x.shape[d] // n
        return x.narrow(d, r * size, size).clone(
            memory_format=torch.contiguous_format)
    return tree_map(one, tree)


def gather_fsdp(tree: Any, cfg: ModelConfig, dist) -> Any:
    """The inverse of `shard_fsdp`: whole leaves on every rank (a
    collective over the model axis)."""
    n, _ = _n_rank(dist)
    coll = dist.coll if isinstance(dist, Fsdp) else TPX.collectives(dist)

    def one(path, x):
        d = None if x is None else gather_dim(path, cfg, n)
        return x if d is None else coll.gather(x, d)
    return tree_map(one, tree)


def shard_model(tree: Any, cfg: ModelConfig, dist) -> Any:
    """What a rank of a mesh that splits the model stores of a params-
    shaped tree: `shard_fsdp` under ``fsdp``, else the tensor-parallel
    local layout (``tensor_parallel.shard_params``)."""
    if cfg.sharding_strategy == "fsdp":
        TPX.require_tp_family(cfg, _n_rank(dist)[0])
        return shard_fsdp(tree, cfg, dist)
    return TPX.shard_params(tree, cfg, dist)


def gather_model(tree: Any, cfg: ModelConfig, dist) -> Any:
    """The inverse of `shard_model`: whole leaves (a collective)."""
    if cfg.sharding_strategy == "fsdp":
        return gather_fsdp(tree, cfg, dist)
    return TPX.gather_params(tree, cfg, dist)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, dim):
        ctx.coll, ctx.dim = coll, dim
        return coll.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.reduce_scatter(g, ctx.dim), None, None


@dataclasses.dataclass(frozen=True)
class Fsdp:
    """One rank of the model axis under ZeRO-3: the global ``cfg``, the
    axis size ``n``, this rank's index, the collectives the gathers go
    through, and ``tp``: the tensor-parallel rank a gathered layer is cut
    for (serving), or None (training: the layer runs whole).  The
    forward functions take one as ``dist=``."""
    cfg: ModelConfig
    n: int
    rank: int
    coll: Any
    tp: Optional[TPX.TensorParallel] = None

    def leaf(self, path: Tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
        """The leaf at ``path`` from its stored block: gathered whole,
        then cut to ``tp``'s local layout."""
        d = gather_dim(path, self.cfg, self.n)
        if d is not None:
            x = _Gather.apply(x, self.coll, d)
        if self.tp is not None:
            s = TPX.split_dim(path, self.cfg, self.tp.n)
            if s is not None:
                x = TPX._block(x, s, self.tp.n, self.tp.rank)
        return x

    def tree(self, prefix: Tuple[str, ...], tree: Any, pick=None) -> Any:
        return tree_map(lambda path, x: None if x is None else self.leaf(
            prefix + path, x if pick is None else x[pick]), tree)


def train_rank(cfg: ModelConfig, dist: DistContext) -> Fsdp:
    """The training rank of a mesh under ``fsdp`` (its model-axis
    collectives are taken here: every rank calls it)."""
    n, r = _n_rank(dist)
    return Fsdp(cfg, n, r, TPX.collectives(dist))


def of(cfg: ModelConfig, dist) -> Optional[Fsdp]:
    """The `Fsdp` rank that reads stored params under ``dist``: ``dist``
    itself, or the serving rank of a tensor-parallel view whose config is
    ``fsdp`` (``TensorParallel.stored``); None where the params are whole
    or the tensor-parallel local layout."""
    if isinstance(dist, Fsdp):
        return dist
    tp = TPX.tp_of(cfg, dist)
    if tp is None or not tp.stored:
        return None
    return Fsdp(tp.cfg, tp.n, tp.rank, tp.coll, tp)


class Stack:
    """A stored stack of layers (``params["layers"]``, the encoder's):
    ``layer(li)`` gathers layer ``li``'s leaves (``sub``: one subtree of
    them alone)."""

    def __init__(self, tree: Any, prefix: Tuple[str, ...], fs: Fsdp):
        self.stored, self.prefix, self.fs = tree, prefix, fs

    def layer(self, li: int, sub: Optional[str] = None) -> Any:
        if sub is None:
            return self.fs.tree(self.prefix, self.stored, li)
        return self.fs.tree(self.prefix + (sub,), self.stored[sub], li)


def view(params: Any, cfg: ModelConfig, dist) -> Any:
    """``params`` as a forward reads them under ``dist``: stored params
    (`of`) with their top-level leaves gathered and their stacks a
    `Stack`; ``params`` itself otherwise, or when already viewed."""
    fs = of(cfg, dist)
    if fs is None or isinstance(params.get("layers"), Stack):
        return params

    def top(prefix, tree):
        out = {}
        for k, v in tree.items():
            path = prefix + (k,)
            if path in STACKS:
                out[k] = Stack(v, path, fs)
            elif isinstance(v, dict):
                out[k] = top(path, v)
            else:
                out[k] = None if v is None else fs.leaf(path, v)
        return out
    return top((), params)
