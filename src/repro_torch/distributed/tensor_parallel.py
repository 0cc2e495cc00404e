"""Tensor parallelism for every family of the registry: one model split
over the ``model`` axis of a ``(data, model)`` mesh, Megatron style.

The reference gets tensor parallelism from GSPMD: ``param_pspecs`` lays
out the weights and XLA inserts the collectives, so its math is the
unsharded model's.  The port is one process per rank, so the split is
explicit: each rank holds its shard of the weights (`shard_params`), runs
its share of every block, and completes the block's two partial sums
(after the attention's ``wo``, after the MLP's ``wo``) with a reduce over
the model axis.  An MoE block's attention half splits as the dense
block's; its experts split by ``cfg.moe_impl`` (`models.moe`): under
``ragged_tp`` ``wi``/``wg`` by columns and ``wo`` by rows of every
expert (``d_ff`` must divide), under ``ep`` along the expert dim (``E``
must divide; a rank's ``E / n`` experts keep their whole ``d_ff``).  The
router is whole on every rank.

The other families split the blocks they share with the dense one and
keep the rest whole, as ``param_pspecs`` does: Mamba2 layers (``ssm``,
and the hybrid's backbone; ``mamba/*``) run whole on replicated
activations, and the hybrid's ``shared_attn`` site splits as a dense
block.  The encoder-decoder splits its encoder's blocks as the
decoder's, and every decoder block's cross attention (``xattn``) in the
self attention's regime, its K/V (``OnlineState.cross``) by KV heads.
The VLM's patch projection (``frontend/proj``) is whole.  A learned
position table (``pos_embed``, ``encoder/pos_embed``) splits by rows
when they divide, and its lookup is the vocab-parallel one (masked rows,
one reduce).

THE LOCAL LAYOUT.  Shards are whole heads.  Three attention regimes, by
the model-axis size ``n``:

- ``"kv"`` (``n_kv_heads % n == 0``): each rank holds ``Hkv/n`` KV heads
  and the ``Hq/n`` query heads that read them (LLaMA-7B 32/32 at n = 2,
  4, 8; Qwen2 14/2 at n = 2).
- ``"query"`` (``n_heads % n == 0`` and ``n % n_kv_heads == 0``): the
  query heads are split; the KV projection, the cache and the memory are
  replicated, as ``cache_pspecs`` / ``mem_pspecs`` say, and rank r's
  query heads, all in one GQA group, read KV head ``r Hkv / n`` (Gemma-2B
  8/1 at n = 2, 4, 8: the one KV head).
- ``"replicated"`` (anything else): every rank runs the whole attention
  and nothing is reduced after ``wo`` (SmolLM 15/5 at n = 2; Qwen2 14/2
  at n = 4).  So is a query split whose ranks would straddle GQA groups
  (``n_heads % n == 0`` with ``n % n_kv_heads != 0``): the kernels read
  one uniform group size, which such a split does not have.

``d_ff`` is split when divisible (``wi``/``wg`` by columns, ``wo`` by
rows) and the vocabulary when divisible (the rows of ``embed``, the
columns of ``lm_head``; a tied head reads the rank's ``embed`` rows).  A
column-parallel projection keeps its LoRA ``a`` whole and takes its
block of ``b``; a row-parallel one (``wo``) takes the matching columns
of ``a`` and ``b`` whole.

WHERE THE LOCAL LAYOUT DEPARTS FROM ``param_pspecs``.  The reference's
rule shards a dim whenever it divides; GSPMD can split a leaf mid-head or
on a dim an explicit split cannot use:

- ``wk``/``wv``/``bk``/``bv`` and the LoRA ``b`` of ``k``/``v`` in the
  "query" regime: the spec splits their ``Hkv * hd`` columns when they
  divide (Gemma-2B: 1 head x hd 256, split along hd); here they are
  replicated, whole heads being the unit of a split.
- ``wq``/``bq``/``wk``/... and their LoRA ``b`` in the "replicated"
  regime: the spec splits SmolLM-360M's 960 ``wq`` columns at n = 2
  (7.5 heads a rank) and Qwen2's 896 at n = 4; here the whole attention
  is replicated.
- the LoRA of ``wo``: the spec splits ``b`` on ``d_model`` and
  replicates ``a``; here ``a`` is split on its input dim (the heads) and
  ``b`` is whole, so that ``(sum_s x_s a_s^T) b`` completes in the same
  reduce as ``wo``.

These hold for every attention the model has: the encoder's, the
hybrid's ``shared_attn`` and the cross attention ``xattn`` (Whisper-tiny
6/6 at n = 4 and 8 replicates the three; the spec splits their 384
columns).  The experts, the Mamba2 layers, ``frontend/proj`` and the
position tables add none: ``split_dim`` splits them as the spec does.

``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tp_families.py`` check that these are the only
departures.

ZeRO-3 (``sharding_strategy="fsdp"``, `distributed.fsdp`) stores the
weights by ``param_pspecs`` itself, with no departure: a stored block is
only storage and may cut a leaf mid-head.  Serving under it gathers each
layer's leaves whole and cuts them to the local layout above
(`TensorParallel.stored`), so the blocks run as they do here (``ep``'s
experts cut along E, `_moe_ep_shard`'s exchange as under ``tp``).

COLLECTIVES.  ``copy_to_tp`` (identity forward, sum backward) marks the
entry of a split computation: the gradient of its replicated input, and
of a replicated leaf used inside it (a column-parallel LoRA ``a``, the
row-parallel LoRA ``b``, the "query" regime's KV projection), is partial
on each rank.  ``reduce_from_tp`` (sum forward, identity backward)
completes a partial sum.  ``gather_from_tp`` concatenates the ranks'
blocks (the vocabulary, ``ep``'s results); ``all_to_all`` hands row j of
a (n, ...) tensor to rank j (``ep``'s exchange).  A leaf used on
replicated activations (norm scales, ``comp_embed``, the MoE router)
gets its whole gradient on every rank and is never summed.  The
collectives are an object the caller supplies (`TensorParallel.coll`):
`GroupCollectives` over the mesh's model-axis process group (NCCL for
CUDA tensors, gloo for the CPU; a CUDA tensor on a gloo group raises,
`context.check_backend`), or `LocalGroup`, which runs n ranks as turns
of one process on one device (the rank loops of ``chip_smoke.py``
phases 14b, 15b and 16b; forward only on the card, where autograd's device
thread cannot take turns).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from repro_torch.distributed.context import (CountingCollectives,
                                             DistContext, axis_size,
                                             check_backend)
from repro_torch.models.config import (ModelConfig, pos_table_rows,
                                       require_ported)
from repro_torch.optim.partition import tree_map

LOCAL_TIMEOUT = 600.0       # s a LocalGroup rank waits for its turn


def require_tp_family(cfg: ModelConfig, n: int = 1) -> None:
    """Tensor parallelism runs every family of the registry (an unknown
    one raises, `require_ported`).  An MoE split over ``n`` ranks needs
    ``d_ff % n == 0`` (``ragged_tp``) or ``n_experts % n == 0``
    (``ep``), as the reference's ``shard_map`` does, under either
    ``sharding_strategy`` (under ``fsdp`` a training rank reckons ``ep``'s
    drops over its data block, ``models.moe``)."""
    require_ported(cfg)
    if cfg.family != "moe" or n == 1:
        return
    if cfg.moe_impl == "ep":
        if cfg.n_experts % n:
            raise ValueError(f"ep splits the experts over the model axis: "
                             f"{cfg.n_experts} experts over {n} ranks")
    elif cfg.d_ff % n:
        raise ValueError(f"ragged_tp splits each expert's d_ff over the "
                         f"model axis: d_ff {cfg.d_ff} over {n} ranks")


# ---------------------------------------------------------------------------
# the split rules
# ---------------------------------------------------------------------------

def attn_regime(cfg: ModelConfig, n: int) -> str:
    """``"kv"``, ``"query"`` or ``"replicated"`` (module docstring)."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    if n == 1 or Hkv % n == 0:
        return "kv"
    if Hq % n == 0 and n % Hkv == 0:
        return "query"
    return "replicated"


def _ff_split(cfg: ModelConfig, n: int) -> bool:
    """Whether ``d_ff`` splits: whenever it divides, but for ``ep``'s
    experts, which split along E and keep their whole ``d_ff``."""
    return cfg.d_ff % n == 0 and not (cfg.family == "moe"
                                      and cfg.moe_impl == "ep")


def _pos_split(cfg: ModelConfig, n: int) -> bool:
    """Whether the learned position tables split by rows."""
    return cfg.pos_embed == "learned" and pos_table_rows(cfg) % n == 0


def local_config(cfg: ModelConfig, dist) -> ModelConfig:
    """The config of one rank's shard: its query and KV head counts (the
    KV heads it holds: all of them unless the "kv" regime splits them),
    ``d_ff`` (0 stays 0: mamba2 has no MLP) and vocabulary; ``head_dim``
    pinned to the model's.
    ``n_experts`` stays E (the router spans them all); an ``ep`` rank's
    own experts are its weights' leading dim."""
    n = _n_rank(dist)[0]
    reg = attn_regime(cfg, n)
    return cfg.replace(
        n_heads=cfg.n_heads // n if reg != "replicated" else cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads // n if reg == "kv" else cfg.n_kv_heads,
        head_dim=cfg.hd,
        d_ff=cfg.d_ff // n if _ff_split(cfg, n) else cfg.d_ff,
        vocab_size=cfg.vocab_size // n if cfg.vocab_size % n == 0
        else cfg.vocab_size)


def split_dim(path: Tuple[str, ...], cfg: ModelConfig,
              n: int) -> Optional[int]:
    """The dim (negative) a params leaf at ``path`` is split on in the
    local layout, or None where every rank holds it whole."""
    if n == 1:
        return None
    reg = attn_regime(cfg, n)
    leaf = path[-1]
    q_split = reg != "replicated"
    kv_split = reg == "kv"
    if "lora" in path:
        proj = path[-2]
        if proj == "o":
            return -1 if (leaf == "a" and q_split) else None
        if leaf == "a":
            return None
        return -1 if (q_split if proj == "q" else kv_split) else None
    if leaf == "embed":
        return -2 if cfg.vocab_size % n == 0 else None
    if leaf == "lm_head":
        return -1 if cfg.vocab_size % n == 0 else None
    if leaf == "pos_embed":
        return -2 if _pos_split(cfg, n) else None
    if "attn" in path or "xattn" in path:
        if leaf in ("wq", "bq"):
            return -1 if q_split else None
        if leaf in ("wk", "wv", "bk", "bv"):
            return -1 if kv_split else None
        if leaf == "wo":
            return -2 if q_split else None
        return None
    if "moe" in path:
        if leaf == "router":
            return None
        if cfg.moe_impl == "ep":
            return -3                   # E of (..., E, d, f)
        return -1 if leaf in ("wi", "wg") else -2
    if "mlp" in path and cfg.d_ff % n == 0:
        if leaf in ("wi", "wg"):
            return -1
        if leaf == "wo":
            return -2
    return None


def _n_rank(dist) -> Tuple[int, int]:
    """(model-axis size, this rank's index on it) of a ``DistContext`` or
    a `TensorParallel`."""
    if isinstance(dist, TensorParallel):
        return dist.n, dist.rank
    n = dist.n_model
    return n, (dist.rank_in(dist.model_axis) if n > 1 else 0)


def _block(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


def shard_params(tree: Any, cfg: ModelConfig, dist) -> Any:
    """This rank's shard of a tree with the params' key paths: the full
    params (``params.params_from_numpy``, ``init_lm``), a partition of
    them, or an optimizer moment tree.  Split leaves are copied out,
    whole leaves are the same tensors (not copied); None leaves stay
    None."""
    n, r = _n_rank(dist)
    if n > 1:
        require_tp_family(cfg, n)

    def one(path, x):
        d = None if x is None else split_dim(path, cfg, n)
        return x if d is None else _block(x, d, n, r)
    return tree_map(one, tree)


def gather_params(tree: Any, cfg: ModelConfig, dist) -> Any:
    """The inverse of `shard_params`: whole leaves from every rank's
    shard, on every rank (a collective over the model axis: every rank
    calls it).  A checkpoint holds whole leaves, whatever the mesh."""
    n, _ = _n_rank(dist)
    coll = collectives(dist)

    def one(path, x):
        d = None if x is None else split_dim(path, cfg, n)
        return x if d is None else coll.gather(x, d)
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class GroupCollectives:
    """Sum, max, gather and all-to-all over a ``torch.distributed``
    process group (the mesh's model axis).  NCCL for CUDA tensors, gloo
    for the CPU."""

    def __init__(self, group, n: int):
        self.group, self.n = group, n

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.contiguous().clone()
        check_backend(y, self.group)
        tdist.all_reduce(y, op=op, group=self.group)
        return y

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, tdist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, tdist.ReduceOp.MAX)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        check_backend(x, self.group)
        parts = [torch.empty_like(x) for _ in range(self.n)]
        tdist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, ...): row j goes to rank j; row j of the result came
        from rank j."""
        x = x.contiguous()
        check_backend(x, self.group)
        out = torch.empty_like(x)
        tdist.all_to_all_single(out, x, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the ranks of ``x``, cut in n blocks along ``dim``:
        this rank's block."""
        x = x.movedim(dim, 0).contiguous()
        check_backend(x, self.group)
        out = x.new_empty((x.shape[0] // self.n,) + tuple(x.shape[1:]))
        # reduce_scatter_tensor under its newer name where torch has it
        getattr(tdist, "reduce_scatter_single",
                tdist.reduce_scatter_tensor)(out, x, group=self.group)
        return out.movedim(0, dim)


class LocalGroup:
    """n ranks in one process, on one device, run as TURNS: rank r's
    thread runs until its next collective, deposits its tensor and hands
    the turn to rank r + 1; the last rank's deposit completes the round
    and hands the turn back to rank 0, which reads every rank's tensor.
    So exactly one rank computes at any time, in rank order, and each
    collective combines the ranks' tensors on their device.

    ``run(fn)`` calls ``fn(rank)`` on every rank (each given
    ``member(rank)`` as its collectives) and returns the results in rank
    order.  Forward only with CUDA tensors: autograd runs the backward of
    CUDA tensors on one device thread, which cannot take turns."""

    def __init__(self, n: int):
        self.n = n
        self._cv = threading.Condition()
        self._turn = 0
        self._slots: List[Any] = [None] * n
        self._round: List[Any] = []
        self._error: Optional[BaseException] = None

    def member(self, rank: int) -> "_LocalMember":
        return _LocalMember(self, rank)

    def _wait_turn(self, rank: int) -> None:
        ok = self._cv.wait_for(
            lambda: self._turn == rank or self._error is not None,
            timeout=LOCAL_TIMEOUT)
        if self._error is not None:
            raise RuntimeError("another rank of the LocalGroup failed") \
                from self._error
        if not ok:
            raise RuntimeError(f"LocalGroup rank {rank} waited "
                               f"{LOCAL_TIMEOUT} s for its turn")

    def _exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        with self._cv:
            self._slots[rank] = x
            if rank == self.n - 1:
                self._round = list(self._slots)
                mine = self._round
                self._turn = 0
                self._cv.notify_all()
                if self.n > 1:
                    self._wait_turn(rank)
                return mine
            self._turn = rank + 1
            self._cv.notify_all()
            self._wait_turn(rank)
            return self._round

    def run(self, fn: Callable[[int], Any]) -> List[Any]:
        out: List[Any] = [None] * self.n

        def body(rank: int):
            try:
                with self._cv:
                    self._wait_turn(rank)
                out[rank] = fn(rank)
                with self._cv:              # the next rank's turn
                    self._turn = (rank + 1) % self.n
                    self._cv.notify_all()
            except BaseException as e:      # wakes and fails the others
                with self._cv:
                    if self._error is None:
                        self._error = e
                    self._cv.notify_all()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return out


class _LocalMember:
    def __init__(self, group: LocalGroup, rank: int):
        self.group, self.rank, self.n = group, rank, group.n

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return functools.reduce(torch.add, self.group._exchange(self.rank, x))

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return functools.reduce(torch.maximum,
                                self.group._exchange(self.rank, x))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self.group._exchange(self.rank, x), dim=dim)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([y[self.rank] for y in
                            self.group._exchange(self.rank, x)])

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _block(self.sum(x), dim, self.n, self.rank)


def collectives(dist):
    """The model-axis collectives of a ``DistContext`` (`axis_collectives`)
    or a `TensorParallel` (what it was given)."""
    if isinstance(dist, TensorParallel):
        return dist.coll
    return axis_collectives(dist, dist.model_axis)


def axis_collectives(dist: DistContext, axes):
    """The collectives over the ranks of ``axes`` of a ``DistContext``:
    `GroupCollectives` over their process group, or, on a shape-only mesh
    (`context.ShapeMesh`), its `CountingCollectives`."""
    group = dist.group(axes)
    if isinstance(group, CountingCollectives):
        return group
    return GroupCollectives(group, _size(dist, _axes(axes)))


# ---------------------------------------------------------------------------
# one rank's view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank of the model axis: the global ``cfg``, the axis size
    ``n``, this rank's index and the collectives its partial sums go
    through.  The forward functions take one as ``dist=`` (or build one
    from a ``DistContext``, `tp_of`).

    Two settings of ``ep`` (`models.moe`): ``row_blocks``, the blocks
    its capacity is reckoned over (1 where the rows are this data rank's
    block of the batch; ``n_data`` where every data rank holds the whole
    batch, `replicated_rows`); ``ep_capacity=False`` keeps every
    assignment (`dropless`)."""
    cfg: ModelConfig
    n: int
    rank: int
    coll: Any
    row_blocks: int = 1
    ep_capacity: bool = True

    @functools.cached_property
    def local(self) -> ModelConfig:
        return local_config(self.cfg, self)

    @functools.cached_property
    def attn(self) -> str:
        return attn_regime(self.cfg, self.n)

    @property
    def attn_split(self) -> bool:
        return self.attn != "replicated"

    @property
    def kv_head(self) -> Optional[int]:
        """The KV head this rank's query heads read, where it holds more
        than that one ("query" regime with Hkv > 1); else None."""
        if self.attn != "query" or self.cfg.n_kv_heads == 1:
            return None
        return self.rank * self.cfg.n_kv_heads // self.n

    @property
    def stored(self) -> bool:
        """Whether the params this rank is given are ZeRO-3 storage
        (``sharding_strategy="fsdp"``): each layer's leaves are gathered
        whole and cut to this rank's local layout as it runs
        (`distributed.fsdp.view`)."""
        return self.cfg.sharding_strategy == "fsdp"

    @property
    def ff_split(self) -> bool:
        return _ff_split(self.cfg, self.n)

    @property
    def vocab_split(self) -> bool:
        return self.cfg.vocab_size % self.n == 0

    @property
    def pos_split(self) -> bool:
        """Whether the learned position tables are this rank's rows."""
        return _pos_split(self.cfg, self.n)

    @property
    def vocab_lo(self) -> int:
        """The first vocabulary id of this rank's block."""
        return self.rank * self.local.vocab_size if self.vocab_split else 0

    def kv_view(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The KV heads this rank's query heads read, along the heads dim
        ``dim`` of a (..., Hkv, hd) tensor or its (..., Hkv) int8 scales
        (a view; the whole tensor outside the "query" regime)."""
        j = self.kv_head
        return x if j is None else x.narrow(dim, j, 1)


def tp_of(cfg: ModelConfig, dist) -> Optional[TensorParallel]:
    """The tensor-parallel view of ``dist``: None without a model split
    (``dist`` None, or a mesh with ``n_model == 1``: then every path runs
    as on one device), ``dist`` itself when it is one, else this rank's
    view over the mesh's model-axis group; a `distributed.fsdp.Fsdp`
    rank's own view (None in training, where each rank runs its layers
    whole).  A split the family cannot take raises
    (`require_tp_family`)."""
    if dist is None:
        return None
    if isinstance(dist, TensorParallel):
        require_tp_family(cfg, dist.n)
        return dist
    from repro_torch.distributed.fsdp import Fsdp
    if isinstance(dist, Fsdp):
        return dist.tp
    if dist.n_model == 1:
        return None
    require_tp_family(cfg, dist.n_model)
    n, r = _n_rank(dist)
    return TensorParallel(cfg, n, r, collectives(dist))


def replicated_rows(cfg: ModelConfig, dist):
    """``dist`` for an op whose batch every data rank holds whole (a serve
    builder's ``batch_sharded=False``): the reference's MoE ``shard_map``
    still splits the rows over the data axes, so ``ep`` reckons its
    capacity per block of ``B S / n_data`` rows.  ``dist`` itself where
    the model is not split."""
    tp = tp_of(cfg, dist)
    if tp is None or isinstance(dist, TensorParallel):
        return dist
    return dataclasses.replace(tp, row_blocks=dist.n_data)


def dropless(tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """``tp`` with ``ep`` keeping every assignment: the reference's stream
    step runs its MoE without ``dist`` (GSPMD splits the experts, the
    math stays dropless)."""
    return tp if tp is None else dataclasses.replace(tp, ep_capacity=False)


def local_ranks(cfg: ModelConfig, group: LocalGroup) -> List[TensorParallel]:
    """The ranks of a `LocalGroup`, in rank order (``group.run`` runs
    them)."""
    require_tp_family(cfg, group.n)
    return [TensorParallel(cfg, group.n, r, group.member(r))
            for r in range(group.n)]


# ---------------------------------------------------------------------------
# the collectives as autograd functions
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.sum(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        return coll.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, rank, dim):
        ctx.rank, ctx.dim, ctx.size = rank, dim, x.shape[dim]
        return coll.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, \
            None, None


def copy_to_tp(x, tp: Optional[TensorParallel]):
    """Identity forward, sum over the model axis backward (None passes)."""
    if tp is None or x is None:
        return x
    return _Copy.apply(x, tp.coll)


def reduce_from_tp(x: torch.Tensor,
                   tp: Optional[TensorParallel]) -> torch.Tensor:
    """Sum over the model axis forward, identity backward."""
    return x if tp is None else _Reduce.apply(x, tp.coll)


def gather_from_tp(x: torch.Tensor, tp: Optional[TensorParallel],
                   dim: int = -1) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order (the
    whole vocabulary of vocab-parallel logits)."""
    if tp is None:
        return x
    return _Gather.apply(x, tp.coll, tp.rank, dim % x.ndim)


def copy_leaves(tree, tp: Optional[TensorParallel], names: Sequence[str]):
    """``tree`` with the leaves ``names`` through `copy_to_tp` (replicated
    leaves used inside a split computation)."""
    if tp is None or tree is None:
        return tree
    return {k: copy_to_tp(v, tp) if k in names else v
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# placement by partition spec (states, tokens, logits)
# ---------------------------------------------------------------------------

def _axes(d) -> Tuple[str, ...]:
    if d is None:
        return ()
    return (d,) if isinstance(d, str) else tuple(d)


def _size(dist: DistContext, axes: Tuple[str, ...]) -> int:
    k = 1
    for a in axes:
        k *= axis_size(dist.mesh, a)
    return k


def shard_by_spec(x: torch.Tensor, spec, dist: DistContext) -> torch.Tensor:
    """This rank's block of a whole tensor laid out by ``spec`` (one
    entry per dim: the mesh axes it is split over, or None), copied out
    (a dim split over no rank, or a None spec, keeps ``x``)."""
    if spec is None:
        return x
    for i, d in enumerate(spec):
        axes = _axes(d)
        k = _size(dist, axes) if axes else 1
        if k > 1:
            x = _block(x, i, k, dist.rank_in(axes))
    return x


def gather_by_spec(x: torch.Tensor, spec, dist: DistContext) -> torch.Tensor:
    """The inverse of `shard_by_spec`: the whole tensor from every rank's
    block (a collective over the spec's axes: every rank calls it)."""
    if spec is None:
        return x
    for i, d in enumerate(spec):
        axes = _axes(d)
        k = _size(dist, axes) if axes else 1
        if k > 1:
            x = axis_collectives(dist, axes).gather(x, i)
    return x


def map_by_spec(fn: Callable, state: Any, specs: Any) -> Any:
    """``fn(tensor, spec)`` over the tensor leaves of a state of named
    tuples (``OnlineState``, ``StreamState``, ...) and plain tuples,
    beside the spec tree of the same structure; host counters, flags and
    None pass through."""
    if isinstance(state, torch.Tensor):
        return fn(state, specs)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[
            map_by_spec(fn, getattr(state, f),
                        getattr(specs, f, None) if specs is not None
                        else None) for f in state._fields])
    if isinstance(state, tuple):
        return tuple(map_by_spec(fn, s, sp) for s, sp in
                     zip(state, specs if specs is not None
                         else (None,) * len(state)))
    return state
