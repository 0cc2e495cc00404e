"""The port's cells (``repro_torch.launch.specs``) against the reference's
(``repro.launch.specs``).

- ``SHAPES``, ``_scaled_shape`` and ``train_layout`` equal the
  reference's for every registry arch (full and smoke) at every shape's
  sequence, and at half of it for the encoder-decoder (its tokens).
- The argument trees equal the reference's ``ShapeDtypeStruct`` trees
  leaf for leaf (key path, shape, dtype) for every arch x shape at full
  width: ``meta`` tensors against ``jax.eval_shape``.  The port's state
  tuples carry a ``lane_major`` flag the reference has not (skipped), and
  its counters are host ints where the reference's are 0-d int32 arrays:
  an int stands for a ``()`` integer leaf.
- At a smoke config in float32, the reference's ``cell.fn`` and the
  port's agree within 1e-4 x max|reference| on the same inputs (numpy
  from a seed; the weights carried by ``params_from_numpy``; the
  reference fed the port's counter values): the dense config's four
  kinds, the hybrid's ``long`` and the VLM's ``prefill``.
- Per device on the shape-only 16 x 16 mesh, the bytes a rank holds of
  each argument leaf equal the reference's leaf bytes divided by the
  sizes of the mesh axes its partition spec names, for every arch x
  shape, but at the leaves the local layout's listed departures name
  (``distributed/tensor_parallel.py``'s docstring), which are held to
  that list's rule instead.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs.registry import get_config as jget
from repro.distributed import sharding as JSH
from repro.distributed.context import DistContext as JDist
from repro.launch import specs as JS
from repro.models import transformer as JT
from repro_torch.configs.registry import _MODULES, get_config as pget
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PS
from repro_torch.params import params_from_numpy

ARCHS = list(_MODULES)
SHAPES = list(JS.SHAPES)


@pytest.fixture(autouse=True)
def _cached_params_specs(monkeypatch):
    """One params tree per config on each side (the cells of a config
    share it; a meta tree and a ShapeDtypeStruct tree hold no data)."""
    monkeypatch.setattr(JS, "params_specs",
                        functools.lru_cache(None)(JS.params_specs))
    monkeypatch.setattr(PS, "params_specs",
                        functools.lru_cache(None)(PS.params_specs))


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def jflat(tree, spec_leaf=False):
    """{key path: leaf} of a reference tree (None kept as a leaf)."""
    leaf = (lambda x: x is None or isinstance(x, PartitionSpec)) \
        if spec_leaf else (lambda x: x is None)
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return {"/".join(_key(k) for k in path): x for path, x in flat}


def pflat(tree, path=()):
    """{key path: leaf} of a port tree: dicts by key, named tuples by
    field (``lane_major`` skipped), tuples by index."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields
                 if f != "lane_major"]
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {"/".join(path): tree}
    out = {}
    for k, v in items:
        out.update(pflat(v, path + (str(k),)))
    return out


def _desc(x):
    """(shape, dtype name) of a leaf; a host int is a () int leaf."""
    if x is None:
        return None
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return ((), "int")
    dt = str(x.dtype).replace("torch.", "")
    if dt in ("int32", "int64"):
        dt = "int" if tuple(x.shape) == () else dt
    return tuple(x.shape), dt


# ---------------------------------------------------------------------------
# shapes and layouts
# ---------------------------------------------------------------------------

def test_shapes_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in PS.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JS.SHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_equal_the_reference(arch, smoke):
    pcfg, jcfg = pget(arch, smoke=smoke), jget(arch, smoke=smoke)
    for name in SHAPES:
        ps = PS._scaled_shape(PS.SHAPES[name], smoke)
        js = JS._scaled_shape(JS.SHAPES[name], smoke)
        assert dataclasses.astuple(ps) == dataclasses.astuple(js)
        seqs = [ps.seq] + ([ps.seq // 2] if pcfg.family == "encdec" else [])
        for seq in seqs:
            pl, jl = PS.train_layout(pcfg, seq), JS.train_layout(jcfg, seq)
            assert (pl.t_steps, pl.chunk_len, pl.comp_len, pl.tail_len,
                    pl.seq_len) == (jl.t_steps, jl.chunk_len, jl.comp_len,
                                    jl.tail_len, jl.seq_len)


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_argument_trees_equal_the_reference(arch):
    pcfg, jcfg = pget(arch), jget(arch)
    for name in SHAPES:
        pc = PS.build_cell(pcfg, name, None)
        jc = JS.build_cell(jcfg, name, None)
        assert pc.name == jc.name
        p = {k: _desc(v) for k, v in pflat(pc.args).items()}
        j = {k: _desc(v) for k, v in jflat(jc.args).items()}
        assert p == j, (name, {k for k in set(p) | set(j)
                               if p.get(k) != j.get(k)})
        assert all(isinstance(x, torch.Tensor) and x.is_meta
                   for x in pflat(pc.args).values()
                   if hasattr(x, "shape"))


# ---------------------------------------------------------------------------
# the steps at a smoke config, port vs reference
# ---------------------------------------------------------------------------

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.int64: np.int64, torch.int8: np.int8}


def _weight_arg(top: str, is_train: bool) -> bool:
    """Whether the args' top-level entry ``top`` holds weights: the
    train cell's trainable and frozen trees, a serve cell's params."""
    return top in ("0", "1") if is_train else top == "0"


def _inputs(pcell, cfg, is_train, seed):
    """{path: numpy} for each tensor leaf of the port cell's args that is
    neither a weight nor a moment: token ids in [0, vocab), the loss mask
    ones, every other float from N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, x in pflat(pcell.args).items():
        top = path.split("/")[0]
        if not isinstance(x, torch.Tensor) or _weight_arg(top, is_train) \
                or (is_train and top == "2"):
            continue
        shape = tuple(x.shape)
        if not x.dtype.is_floating_point:
            out[path] = rng.integers(0, cfg.vocab_size, shape).astype(
                _NP[x.dtype])
        elif path.endswith("loss_mask"):
            out[path] = np.ones(shape, np.float32)
        else:
            out[path] = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return out


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _port_args(pcell, pp, data, is_train):
    """The port cell's args with real leaves: weights from ``pp`` ({top:
    tree}: the train cell's partitions keep their None leaves), moments
    zero, the rest from ``data``; host counters as the cell set them."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[t.lane_major if f == "lane_major"
                             else walk(getattr(t, f), path + (f,))
                             for f in t._fields])
        if isinstance(t, tuple):
            return tuple(walk(v, path + (str(i),)) for i, v in enumerate(t))
        if not isinstance(t, torch.Tensor):
            return t
        top = path[0]
        if _weight_arg(top, is_train):
            return _get(pp, "/".join(path))
        if is_train and top == "2":
            return torch.zeros(t.shape, dtype=t.dtype)
        return torch.from_numpy(data["/".join(path)].copy())
    return walk(pcell.args, ())


def _ref_args(jcell, jp, data, counters, is_train):
    """The reference cell's args with the same values: weights from
    ``jp``, moments zero, the port's data, and at each 0-d counter the
    port's host value."""
    leaves = []
    for path, x in jflat(jcell.args).items():
        top = path.split("/")[0]
        if x is None:
            leaves.append(None)
        elif _weight_arg(top, is_train):
            leaves.append(jnp.asarray(_get(jp, path), x.dtype))
        elif is_train and top == "2":
            leaves.append(jnp.zeros(x.shape, x.dtype))
        elif path in data:
            leaves.append(jnp.asarray(data[path], x.dtype))
        else:
            leaves.append(jnp.asarray(counters[path], x.dtype))
    treedef = jax.tree_util.tree_structure(jcell.args,
                                           is_leaf=lambda x: x is None)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _outputs(out, is_train, flat):
    """{path: leaf} of a cell's result: the loss and the first moments
    (0.1 x the clipped gradient after one step) of a train step, the
    logits and the state of the others."""
    if is_train:
        return {"loss": out[2]["loss"],
                **{f"mu/{k}": v for k, v in flat(out[1].mu).items()
                   if v is not None}}
    return {"logits": out[0], **{f"state/{k}": v
                                 for k, v in flat(out[1]).items()}}


CELLS = [("llama-7b", s) for s in SHAPES] + [("zamba2-1.2b", "long_500k"),
                                             ("pixtral-12b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_steps_match_the_reference(arch, shape):
    from repro.launch.train import trainable_mask_for as jmask
    from repro.optim import partition as JPT
    from repro_torch.launch.train import trainable_mask_for as pmask
    from repro_torch.optim import partition as PPT

    kw = dict(compute_dtype="float32", param_dtype="float32")
    pcfg, jcfg = pget(arch, smoke=True, **kw), jget(arch, smoke=True, **kw)
    pcell = PS.build_cell(pcfg, shape, None, smoke=True)
    jcell = JS.build_cell(jcfg, shape, None, smoke=True)
    jp = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    lora = jp.get("shared_attn", jp["layers"])["attn"]["lora"]
    for proj in lora.values():          # LoRA b = 0 would hide the gate
        proj["b"] = (rng.standard_normal(proj["b"].shape) * 0.05).astype(
            np.float32)
    pp = params_from_numpy(jp, pcfg, device="cpu")
    is_train = shape == "train_4k"
    if is_train:
        jp = dict(zip("01", JPT.partition(jp, jmask(jcfg, jp))))
        pp = dict(zip("01", PPT.partition(pp, pmask(pcfg, pp))))
    else:
        jp, pp = {"0": jp}, {"0": pp}
    data = _inputs(pcell, pcfg, is_train, 2)
    counters = {k: v for k, v in pflat(pcell.args).items()
                if isinstance(v, (int, np.integer))
                and not isinstance(v, bool)}

    pargs = _port_args(pcell, pp, data, is_train)
    jargs = _ref_args(jcell, jp, data, counters, is_train)
    with (torch.enable_grad() if is_train else torch.no_grad()):
        pout = _outputs(pcell.fn(*pargs), is_train, pflat)
    jout = _outputs(jcell.fn(*jargs), is_train, jflat)
    assert len(pout) > 1
    for k, b in jout.items():
        a = pout[k]
        if isinstance(a, (int, np.integer)) and not isinstance(a, bool):
            assert int(a) == int(b), k          # a counter
            continue
        if a is None or b is None:
            assert a is None and b is None, k
            continue
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, k
        lim = 1e-4 * max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= lim, k


# ---------------------------------------------------------------------------
# per-device bytes on the 16 x 16 mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _JMesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))


def _regime(cfg, n):
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    if Hkv % n == 0:
        return "kv"
    if Hq % n == 0 and n % Hkv == 0:
        return "query"
    return "replicated"


def _departure(parts, cfg, n):
    """Whether the port splits an attention leaf (key path ``parts``) over
    the model axis, by the local layout's listed departures: whole heads
    (the "query" regime's KV side whole, the "replicated" regime's whole
    attention), and the LoRA of ``wo`` with ``a`` split on its input and
    ``b`` whole.  None for a leaf outside the attention."""
    if not {"attn", "xattn"} & set(parts):
        return None
    reg = _regime(cfg, n)
    leaf = parts[-1]
    if reg == "replicated":
        return False
    if "lora" in parts:
        proj = parts[-2]
        if proj == "o":
            return leaf == "a"
        return leaf == "b" and (proj == "q" or reg == "kv")
    if leaf in ("wq", "bq", "wo"):
        return True
    if leaf in ("wk", "wv", "bk", "bv"):
        return reg == "kv"
    return False


def _ref_specs(jcfg, jcell, name, jdist):
    """The reference's partition specs of the cell's arguments (its jit's
    in_shardings), as a tree of the args' structure."""
    args = jcell.args
    n = jdist.n_model
    if name == "train_4k":
        from repro.launch.train import trainable_mask_for as jmask
        from repro.optim import partition as JPT
        pshapes = JS.params_specs(jcfg)
        ps = JSH.param_pspecs(jcfg, pshapes, jdist)
        tps, fps = JPT.partition(ps, jmask(jcfg, pshapes))
        return (tps, fps, JSH.opt_pspecs(tps, args[2]),
                {k: JSH.batch_spec(jdist, extra_dims=len(v.shape) - 1)
                 for k, v in args[3].items()}, None)
    ps = JSH.param_pspecs(jcfg, args[0], jdist)
    del n
    if name == "long_500k" and jcfg.family not in ("ssm", "hybrid"):
        return (ps, JSH.stream_state_pspecs(jcfg, jdist, batch_sharded=False),
                PartitionSpec(None, None))
    rows = name == "prefill_32k" or args[2].shape[0] >= jdist.n_data
    st = JSH.online_state_pspecs(jcfg, jdist, batch_sharded=rows)
    tok = PartitionSpec(jdist.batch_axes if rows else None, None)
    extra = (PartitionSpec(jdist.batch_axes, None, None),) \
        if len(args) > 3 else ()
    return (ps, st, tok) + extra


def _div(spec, sizes):
    k = 1
    for d in (spec or ()):
        for a in ((d,) if isinstance(d, str) else (d or ())):
            k *= sizes[a]
    return k


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_argument_bytes_on_the_production_mesh(arch):
    shape, axes = PM.PRODUCTION["single"]
    jdist = JDist(mesh=_JMesh(axes, shape), data_axes=("data",),
                  model_axis="model")
    sizes = dict(zip(axes, shape))
    n = sizes["model"]
    pcfg, jcfg = pget(arch), jget(arch)
    departed = 0
    for name in SHAPES:
        pdist = PM.make_dist(PM.make_shape_mesh(shape, axes))
        pc = PS.build_cell(pcfg, name, pdist)
        jc = JS.build_cell(jcfg, name, None)
        jargs = jflat(jc.args)
        jspecs = jflat(_ref_specs(jcfg, jc, name, jdist), spec_leaf=True)
        held = pflat(pc.local_args)
        for path, x in jargs.items():
            if x is None or path.endswith("lane_major"):
                continue
            got = held[path]
            if not isinstance(got, torch.Tensor):
                assert x.shape == (), path       # a host counter
                continue
            full = int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
            parts = path.split("/")
            dep = _departure(parts[1:], pcfg, n) \
                if parts[0] in ("0", "1", "2") else None
            if dep is None or name != "train_4k" and parts[0] != "0":
                want = full // _div(jspecs[path], sizes)
            else:
                want = full // n if dep else full
                departed += want != full // _div(jspecs[path], sizes)
            assert got.numel() * got.element_size() == want, (name, path)
    if _regime(pcfg, n) != "kv" or pcfg.family == "ssm":
        assert departed or pcfg.family == "ssm"
