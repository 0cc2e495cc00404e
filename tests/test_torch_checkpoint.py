"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the reference's directory format: a checkpoint written by
``repro``'s ``CheckpointManager`` is restored by the port and the
reverse (float32, bf16 and int32 leaves, NamedTuple optimizer state,
None leaves skipped); CRC corruption is detected; a partial checkpoint
is ignored; old checkpoints are collected.  Leaves must be bit-equal."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCM
from repro.optim import adamw as JA
from repro_torch.checkpoint.manager import CheckpointManager as PCM
from repro_torch.optim import adamw as PA


def _numpy_tree(rs):
    return {"a": rs.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rs.normal(size=(5,)).astype(np.float32),
                  "e": rs.normal(size=(2, 3)).astype(np.float32)},
            "n": np.arange(6, dtype=np.int32).reshape(2, 3)}


def _jax_state(host):
    tp = jax.tree.map(jnp.asarray, host)
    tp["b"]["e"] = tp["b"]["e"].astype(jnp.bfloat16)
    tp["skip"] = None
    opt = JA.init_adamw({"a": tp["a"]})
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       mu={"a": tp["a"] * 2}, nu={"a": tp["a"] * 3})
    return {"tp": tp, "opt": opt}


def _port_state(host):
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), host)
    tp["b"]["e"] = tp["b"]["e"].bfloat16()
    tp["skip"] = None
    a = tp["a"]
    return {"tp": tp, "opt": PA.AdamWState(step=7, mu={"a": a * 2},
                                           nu={"a": a * 3})}


def _template():
    z = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5),
                                       "e": torch.zeros(2, 3, dtype=torch.bfloat16)},
         "n": torch.zeros(2, 3, dtype=torch.int32), "skip": None}
    return {"tp": z, "opt": PA.AdamWState(step=0, mu={"a": torch.zeros(3, 4)},
                                          nu={"a": torch.zeros(3, 4)})}


def _assert_port_equal(got, want):
    gt, wt = got["tp"], want["tp"]
    for k in ("a", "n"):
        assert gt[k].dtype == wt[k].dtype and torch.equal(gt[k], wt[k]), k
    assert torch.equal(gt["b"]["c"], wt["b"]["c"])
    assert gt["b"]["e"].dtype == torch.bfloat16
    assert torch.equal(gt["b"]["e"], wt["b"]["e"])
    assert gt["skip"] is None
    assert got["opt"].step == 7 and isinstance(got["opt"].step, int)
    for f in ("mu", "nu"):
        assert torch.equal(getattr(got["opt"], f)["a"],
                           getattr(want["opt"], f)["a"])


def test_reference_checkpoint_restored_by_port(tmp_path):
    host = _numpy_tree(np.random.default_rng(0))
    JCM(str(tmp_path), async_save=False).save(
        3, _jax_state(host), extra={"step": 3, "iterator": {"step": 3}})
    pm = PCM(str(tmp_path), async_save=False)
    assert pm.latest() == 3
    got, extra = pm.restore(3, _template())
    assert extra == {"step": 3, "iterator": {"step": 3}}
    _assert_port_equal(got, _port_state(host))


def test_port_checkpoint_restored_by_reference(tmp_path):
    host = _numpy_tree(np.random.default_rng(1))
    pm = PCM(str(tmp_path), async_save=True)
    pm.save(5, _port_state(host), extra={"step": 5})
    pm.wait()
    jm = JCM(str(tmp_path), async_save=False)
    assert jm.latest() == 5
    # the reference's restore cannot cast a bf16 leaf (its own either:
    # numpy has no cast from the stored |V2 words to ml_dtypes.bfloat16),
    # so it restores the other leaves; the bf16 words are compared through
    # the manifests' CRCs below
    tmpl = _jax_state(host)
    del tmpl["tp"]["b"]["e"]
    got, extra = jm.restore(5, tmpl)
    assert extra == {"step": 5}
    want = _jax_state(host)
    del want["tp"]["b"]["e"]
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        assert pa == pb and a.dtype == b.dtype
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32)), pa
    # the manifests name the same leaves with the same dtypes
    d = os.path.join(str(tmp_path), "step_0000000005")
    jm.save(6, _jax_state(host))
    import json
    mp = json.load(open(os.path.join(d, "manifest.json")))["leaves"]
    mj = json.load(open(os.path.join(str(tmp_path), "step_0000000006",
                                     "manifest.json")))["leaves"]
    assert {k: (v["dtype"], v["shape"], v["crc"]) for k, v in mp.items()} == \
        {k: (v["dtype"], v["shape"], v["crc"]) for k, v in mj.items()}


def test_crc_corruption_detected(tmp_path):
    pm = PCM(str(tmp_path), async_save=False)
    pm.save(1, {"w": torch.arange(64, dtype=torch.float32)})
    f = os.path.join(str(tmp_path), "step_0000000001", "w.npy")
    raw = bytearray(open(f, "rb").read())
    raw[-5] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        pm.restore(1, {"w": torch.zeros(64)})
    got, _ = pm.restore(1, {"w": torch.zeros(64)}, verify=False)
    assert not torch.equal(got["w"], torch.arange(64, dtype=torch.float32))


def test_partial_checkpoint_ignored_and_gc(tmp_path):
    pm = PCM(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3):
        pm.save(s, {"w": torch.full((2,), float(s))})
    assert pm.all_steps() == [2, 3]
    os.makedirs(os.path.join(str(tmp_path), "step_0000000004.tmp"))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000005"))
    assert pm.latest() == 3
    got, _ = pm.restore(pm.latest(), {"w": torch.zeros(2)})
    assert torch.equal(got["w"], torch.full((2,), 3.0))


def test_async_save_snapshots_before_later_updates(tmp_path):
    """An in-place update after ``save`` must not reach the checkpoint."""
    pm = PCM(str(tmp_path), async_save=True)
    w = torch.zeros(1000)
    pm.save(1, {"w": w})
    w.add_(1.0)
    pm.wait()
    got, _ = pm.restore(1, {"w": torch.ones(1000)})
    assert torch.equal(got["w"], torch.zeros(1000))
