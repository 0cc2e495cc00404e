"""Port parity for ``core/memory.update_memory`` (g_update) against
``repro``: concat mode past the slot capacity (the reference's clamped
write: the newest group overwrites the last slot) and merge mode with
the 1/t arithmetic mean and an EMA ``merge_alpha``.

Tolerance: memory k/v atol 1e-6 — float32 on both sides; the port's merge
kernel op computes (1 - a) * mem + a * h in float32 as the reference does
for a float32 memory.  Counters must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory as JM
from repro.models.config import CCMConfig as JCCM, ModelConfig as JCfg
from repro_torch.core import memory as PM
from repro_torch.models.config import CCMConfig as PCCM, ModelConfig as PCfg


def _cfgs(mode, alpha=None, max_steps=3):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype="float32")
    cc = dict(comp_len=2, max_steps=max_steps, mode=mode, merge_alpha=alpha)
    return JCfg(**base, ccm=JCCM(**cc)), PCfg(**base, ccm=PCCM(**cc))


def _compare(jm, pm):
    np.testing.assert_allclose(np.asarray(jm.k), pm.k.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(jm.v), pm.v.numpy(), atol=1e-6,
                               rtol=0)
    assert (int(jm.slots), int(jm.steps), int(jm.stream_pos)) \
        == (pm.slots, pm.steps, pm.stream_pos)


@pytest.mark.parametrize("mode,alpha", [("concat", None), ("merge", None),
                                        ("merge", 0.25)])
def test_update_memory_matches_reference(mode, alpha):
    jc, pc = _cfgs(mode, alpha)
    B = 2
    jm = JM.init_memory(jc, B)
    pm = PM.init_memory(pc, B, device="cpu")
    assert tuple(jm.k.shape) == tuple(pm.k.shape)
    rs = np.random.default_rng(0)
    for t in range(1, 6):               # T = 5 > max_steps = 3 slots
        hk, hv = rs.normal(size=(2, 2, B, 2, 2, 16)).astype(np.float32)
        n = 10 + t
        jm = JM.update_memory(jc, jm, jnp.asarray(hk), jnp.asarray(hv),
                              jnp.asarray(n))
        pm = PM.update_memory(pc, pm, torch.from_numpy(hk),
                              torch.from_numpy(hv), n)
        _compare(jm, pm)
    if mode == "concat":
        assert pm.slots == pm.max_slots(2) == 3
        np.testing.assert_array_equal(pm.k[:, :, 4:6].numpy(), hk)


def test_memory_valid_len_and_init_shape():
    _, pc = _cfgs("merge")
    pm = PM.init_memory(pc, 3, device="cpu")
    assert tuple(pm.k.shape) == (2, 3, 2, 2, 16)
    assert pm.valid_len(2) == 0 and pm.max_slots(2) == 1
