"""Logical-axis sharding rules -> partition-spec trees, per architecture
(port of ``repro/distributed/sharding.py``).

The rules are data: a spec (``P``) holds, per dim of a tensor, the mesh
axis it is split over (a name, a tuple of names, or None), as a
``jax.sharding.PartitionSpec`` does.  TP rule: shard a weight dim on the
``model`` axis iff divisible by its size — heads for attention
(gemma-2b's 8 q-heads / 1 kv-head replicate), d_ff for MLPs, vocab for
embedding/head, expert-f for MoE (``ragged_tp``) or the expert dim
(``ep``); Mamba blocks replicate.  Shapes come from a ``meta``-device
tree (``init_lm(cfg, device="meta")``), so a 400B tree is never
materialised to derive its specs.

The port applies the data-axis specs (``batch_spec``: each rank trains
on its block of batch rows, `launch.train`), the arena's
(``arena_pspecs``: one row block per session-mesh device,
`serve.arena`) and the online and stream state specs (the ``dist=``
serve builders of `launch.serve` place states by them).  The params
specs are the reference's, GSPMD's layout; the port's tensor
parallelism (`distributed.tensor_parallel`) splits whole heads, and its
docstring lists the leaves where its local layout departs from
``param_pspecs``.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.distributed.context import DistContext, divisible
from repro_torch.models.config import ModelConfig
from repro_torch.optim.partition import tree_map


class P(tuple):
    """A partition spec: one entry per dim — the mesh axis name, a tuple
    of names, or None (replicated).  ``P()`` replicates every dim.  As
    in ``PartitionSpec``, a one-name tuple is that name and an empty one
    None."""

    def __new__(cls, *dims):
        def canon(d):
            if isinstance(d, tuple) and len(d) < 2:
                return d[0] if d else None
            return d
        return super().__new__(cls, (canon(d) for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _shard_last(shape, n, axis_name, at=-1) -> P:
    """Spec sharding dim ``at`` iff divisible, else replicated."""
    dims = [None] * len(shape)
    if divisible(shape[at], n):
        dims[at] = axis_name
    return P(*dims)


def _fsdp_spec(shape, nm, ma) -> P:
    """ZeRO-3: shard the largest divisible weight dim (>= 128) over the
    model axis."""
    best = None
    for i, s in enumerate(shape):
        if divisible(s, nm) and s >= 128:
            if best is None or s >= shape[best]:
                best = i
    dims = [None] * len(shape)
    if best is not None:
        dims[best] = ma
    return P(*dims)


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, dist: DistContext) -> P:
    ma, nm = dist.model_axis, dist.n_model
    leaf = path[-1]
    joined = "/".join(path)

    # --- never shard small / norm / scalar things
    if len(shape) <= 1 or any(s in joined for s in
                              ("ln1", "ln2", "ln_x", "final_norm", "norm",
                               "dt_bias", "a_log", "d_skip", "conv",
                               "comp_embed", "frontend")):
        return P()
    if leaf == "router":
        return P()
    if cfg.sharding_strategy == "fsdp" and "lora" not in path:
        return _fsdp_spec(shape, nm, ma)
    if "lora" in path:
        # a: (..., r, d_in) replicate; b: (..., r, d_out) follow target dim
        if leaf == "a":
            return P()
        return _shard_last(shape, nm, ma)
    if leaf in ("embed", "pos_embed"):
        return _shard_last(shape, nm, ma, at=-2)   # vocab/pos rows
    if leaf == "lm_head":
        return _shard_last(shape, nm, ma)
    if "mamba" in path:
        return P()
    if "moe" in path:
        if cfg.moe_impl == "ep":
            dims = [None] * len(shape)
            if divisible(shape[-3], nm):           # E of (..., E, d, f)
                dims[-3] = ma
            return P(*dims)
        if leaf in ("wi", "wg"):
            return _shard_last(shape, nm, ma)
        if leaf == "wo":
            return _shard_last(shape, nm, ma, at=-2)
        return P()
    if leaf in ("wq", "wk", "wv", "bq", "bk", "bv"):
        return _shard_last(shape, nm, ma)
    if leaf == "wo":
        return _shard_last(shape, nm, ma, at=-2)
    if leaf in ("wi", "wg"):
        return _shard_last(shape, nm, ma)
    return P()


def param_pspecs(cfg: ModelConfig, params_shapes: Any,
                 dist: DistContext) -> Any:
    """Specs for a params tree (nested dicts; any leaf with ``.shape``,
    ``meta`` tensors included)."""
    return tree_map(lambda path, v: param_spec(tuple(path), tuple(v.shape),
                                               cfg, dist), params_shapes)


def opt_pspecs(param_specs_tree: Any, opt_state_shapes: Any) -> Any:
    """AdamW moments follow their parameter's spec; the step replicates.
    Frozen leaves (None moments) get no spec."""
    from repro_torch.optim.adamw import AdamWState

    def follow(_, spec, leaf):
        return None if leaf is None else spec

    return AdamWState(step=P(),
                      mu=tree_map(follow, param_specs_tree,
                                  opt_state_shapes.mu),
                      nu=tree_map(follow, param_specs_tree,
                                  opt_state_shapes.nu))


# ---------------------------------------------------------------------------
# activation / state specs
# ---------------------------------------------------------------------------

def batch_spec(dist: DistContext, extra_dims: int = 1) -> P:
    return P(dist.batch_axes, *([None] * extra_dims))


def _kv_axis(cfg: ModelConfig, dist: DistContext):
    return dist.model_axis if divisible(cfg.n_kv_heads, dist.n_model) \
        else None


def cache_pspecs(cfg: ModelConfig, dist: DistContext,
                 shard_seq: bool = False):
    """KVCache spec: (L, B, S, Hkv, hd). batch on data axes; kv heads on
    model iff divisible; optionally the sequence axis (SP) instead of the
    batch (long_500k, batch=1)."""
    from repro_torch.core.inference import KVCache
    ma = _kv_axis(cfg, dist)
    if shard_seq:
        kv = P(None, None, dist.batch_axes, ma, None)
        sc = P(None, None, dist.batch_axes, ma)
    else:
        kv = P(None, dist.batch_axes, None, ma, None)
        sc = P(None, dist.batch_axes, None, ma)
    if cfg.kv_cache_dtype == "int8":
        return KVCache(k=kv, v=kv, length=P(), k_scale=sc, v_scale=sc)
    return KVCache(k=kv, v=kv, length=P())


def mem_pspecs(cfg: ModelConfig, dist: DistContext, batch_sharded=True):
    from repro_torch.core.memory import MemState
    b = dist.batch_axes if batch_sharded else None
    kv = P(None, b, None, _kv_axis(cfg, dist), None)
    return MemState(k=kv, v=kv, slots=P(), steps=P(), stream_pos=P())


def ssm_pspecs(cfg: ModelConfig, dist: DistContext, batch_sharded=True):
    from repro_torch.core.inference import SSMState
    b = dist.batch_axes if batch_sharded else None
    return SSMState(ssm=P(None, b, None, None, None),
                    conv=P(None, b, None, None))


def _unbatch(cs):
    """A KVCache spec with its batch dim replicated."""
    def unb(p):
        if p is None:
            return None
        dims = list(p)
        dims[1] = None
        return P(*dims)
    return cs._replace(k=unb(cs.k), v=unb(cs.v),
                       k_scale=unb(cs.k_scale), v_scale=unb(cs.v_scale))


def online_state_pspecs(cfg: ModelConfig, dist: DistContext,
                        batch_sharded: bool = True,
                        shard_cache_seq: bool = False):
    from repro_torch.core.inference import OnlineState
    st = {"pos": P(), "cache": None, "mem": None, "ssm": None, "cross": None}
    if cfg.family in ("ssm", "hybrid"):
        st["ssm"] = ssm_pspecs(cfg, dist, batch_sharded)
    if cfg.family != "ssm":
        cs = cache_pspecs(cfg, dist, shard_seq=shard_cache_seq)
        st["cache"] = cs if batch_sharded else _unbatch(cs)
        if cfg.ccm.enabled:
            st["mem"] = mem_pspecs(cfg, dist, batch_sharded)
    if cfg.family == "encdec":
        b = dist.batch_axes if batch_sharded else None
        ma = _kv_axis(cfg, dist)
        st["cross"] = (P(None, b, None, ma, None), P(None, b, None, ma, None))
    return OnlineState(**st)


def stream_state_pspecs(cfg: ModelConfig, dist: DistContext,
                        batch_sharded: bool = True):
    from repro_torch.core.streaming import StreamState
    b = dist.batch_axes if batch_sharded else None
    win = P(None, b, None, _kv_axis(cfg, dist), None)
    return StreamState(win_k=win, win_v=win, win_len=P(),
                       mem=mem_pspecs(cfg, dist, batch_sharded), pos=P())


# ---------------------------------------------------------------------------
# serve-arena specs (session-axis sharding)
# ---------------------------------------------------------------------------

def arena_pspecs(template: Any, axis: str = "shards") -> Any:
    """Spec tree for a serve arena's slabs: every leaf is the session
    template with a leading ROW axis (`serve.arena`), split over ``axis``
    — one contiguous row block (slots + scratch row) per device; the
    other dims replicate.  Static leaves (None, flags) pass through."""
    from repro_torch.serve.arena import tree_map as state_map
    return state_map(lambda _: P(axis), template)


def arena_placement(mesh, axis: str = "shards"):
    """The arena's ``place`` hook for `arena_pspecs` (the reference's
    ``arena_sharding``): ``SessionArena(..., place=arena_placement(mesh))``
    puts shard ``s``'s row block on ``mesh.devices[s]``."""
    from repro_torch.serve.arena import ShardedSlabs
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no {axis!r} axis")
    return lambda slabs: ShardedSlabs.split(slabs, mesh.devices)
