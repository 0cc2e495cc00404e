"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``): for every config of the
registry, at smoke size and at full size (shapes only: ``jax.eval_shape``
on the reference side, the ``meta`` device on the port's), under the
meshes (data 2, model 4), (1, 1) and (pod 2, data 2, model 2), with
``sharding_strategy`` "tp" / "fsdp" and ``moe_impl`` "ragged_tp" / "ep":
the param and AdamW-moment spec trees, the state specs and the arena
specs equal the reference's ``PartitionSpec`` trees turned into tuples.
A mesh here is an object with ``axis_names`` and a ``shape`` mapping
(the reference's ``AbstractMesh`` idiom): the rules read no more, so no
device and no process group is needed."""
import dataclasses

import jax
import pytest

from repro.configs.registry import get_config as jget
from repro.distributed import sharding as JSH
from repro.distributed.context import DistContext as JDist
from repro.launch.train import trainable_mask_for as jmask
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import partition as JPT
from repro.serve.arena import online_template as j_online
from repro.serve.arena import stream_template as j_stream
from repro_torch.configs.registry import _MODULES, get_config as pget
from repro_torch.distributed import sharding as PSH
from repro_torch.distributed.context import DistContext as PDist
from repro_torch.launch.train import trainable_mask_for as pmask
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.optim import partition as PPT
from repro_torch.serve.arena import online_template as p_online
from repro_torch.serve.arena import stream_template as p_stream
from repro_torch.serve.arena import tree_leaves as p_leaves

ARCHS = list(_MODULES)


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))


MESHES = {"2x4": Mesh(("data", "model"), (2, 4)),
          "1x1": Mesh(("data", "model"), (1, 1)),
          "pod2x2x2": Mesh(("pod", "data", "model"), (2, 2, 2))}
STRATEGIES = {"tp": {}, "fsdp": dict(sharding_strategy="fsdp"),
              "ragged_tp": dict(moe_impl="ragged_tp"),
              "ep": dict(moe_impl="ep")}


def _dists(mesh):
    kw = dict(data_axes=("data",), model_axis="model",
              pod_axis="pod" if "pod" in mesh.axis_names else None)
    return JDist(mesh=mesh, **kw), PDist(mesh=mesh, **kw)


def _spec(p):
    """A spec as a plain tuple of entries (None stays None)."""
    return None if p is None else tuple(p)


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None
        or isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): _spec(x) for path, x in flat}


def _pflat(tree):
    out = {}
    PPT.tree_map(lambda path, x: out.__setitem__("/".join(path), _spec(x)),
                 tree)
    return out


def _fields(nt, prefix=""):
    """{field path: spec tuple} of a NamedTuple of specs (either
    package's), static flags and unset fields left out."""
    out = {}
    for name in nt._fields:
        x = getattr(nt, name)
        key = prefix + name
        if x is None or isinstance(x, bool):
            continue
        if hasattr(x, "_fields"):
            out.update(_fields(x, key + "/"))
        elif name == "cross":                   # a (k, v) pair of specs
            out[key] = tuple(_spec(e) for e in x)
        else:
            out[key] = _spec(x)
    return out


_SHAPES = {}


def _shapes(arch, smoke):
    """(reference shape tree, port meta tree) of the arch's params."""
    if (arch, smoke) not in _SHAPES:
        jc, pc = jget(arch, smoke=smoke), pget(arch, smoke=smoke)
        js = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jc))
        _SHAPES[(arch, smoke)] = (js, PT.init_lm(pc, 0, device="meta"))
    return _SHAPES[(arch, smoke)]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, smoke):
    js, ps = _shapes(arch, smoke)
    for mesh in MESHES.values():
        jd, pd = _dists(mesh)
        for strat in STRATEGIES.values():
            jc = jget(arch, smoke=smoke).replace(**strat)
            pc = pget(arch, smoke=smoke).replace(**strat)
            jspec = JSH.param_pspecs(jc, js, jd)
            pspec = PSH.param_pspecs(pc, ps, pd)
            want = _jflat(jspec)
            assert _pflat(pspec) == want, (arch, mesh, strat)
            # AdamW moments follow the trainable leaves' specs
            jtp_specs, _ = JPT.partition(jspec, jmask(jc, js))
            ptp_specs, _ = PPT.partition(pspec, pmask(pc, ps))
            jtp, _ = JPT.partition(js, jmask(jc, js))
            ptp, _ = PPT.partition(ps, pmask(pc, ps))
            jopt = JSH.opt_pspecs(jtp_specs, jax.eval_shape(JA.init_adamw,
                                                            jtp))
            popt = PSH.opt_pspecs(ptp_specs, PA.init_adamw(ptp))
            assert _spec(popt.step) == _spec(jopt.step)
            for m in ("mu", "nu"):
                assert _pflat(getattr(popt, m)) \
                    == _jflat(getattr(jopt, m)), (arch, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_arena_specs_match_reference(arch):
    for smoke in (True, False):
        jc, pc = jget(arch, smoke=smoke), pget(arch, smoke=smoke)
        for mesh in MESHES.values():
            jd, pd = _dists(mesh)
            assert tuple(PSH.batch_spec(pd, 3)) \
                == tuple(JSH.batch_spec(jd, 3))
            for bs in (True, False):
                for seq in (False, True):
                    want = _fields(JSH.online_state_pspecs(
                        jc, jd, batch_sharded=bs, shard_cache_seq=seq))
                    got = _fields(PSH.online_state_pspecs(
                        pc, pd, batch_sharded=bs, shard_cache_seq=seq))
                    assert got == want, (arch, mesh, bs, seq)
                assert _fields(PSH.stream_state_pspecs(pc, pd, bs)) \
                    == _fields(JSH.stream_state_pspecs(jc, jd, bs))
            assert _fields(PSH.cache_pspecs(
                pc.replace(kv_cache_dtype="int8"), pd)) == _fields(
                JSH.cache_pspecs(jc.replace(kv_cache_dtype="int8"), jd))
    # the arena: every leaf of the session template split on "shards"
    jc, pc = jget(arch, smoke=True), pget(arch, smoke=True)
    jt, pt = j_online(jc, 16), p_online(pc, 16)
    want = [_spec(x) for x in jax.tree.leaves(
        JSH.arena_pspecs(jt), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))]
    got = [_spec(x) for x in p_leaves(PSH.arena_pspecs(pt))]
    assert got == want and set(got) == {("shards",)}
    if jc.family not in ("ssm", "hybrid"):
        js_, ps_ = j_stream(jc), p_stream(pc)
        assert len(p_leaves(PSH.arena_pspecs(ps_))) == len(jax.tree.leaves(
            JSH.arena_pspecs(js_), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))
