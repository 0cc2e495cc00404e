"""``params_from_numpy`` carries the reference's parameter tree into the
port: same key paths, same shapes (stacked leading layer axis), every
leaf in ``cfg.pdtype`` except the float32 LoRA factors (and MoE
router), bfloat16 values exact — and the port's own ``init_lm`` builds
the same tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama_7b_paper as JLlama
from repro.configs import registry as JR
from repro.models import transformer as JT
from repro_torch.configs import llama_7b_paper as PLlama
from repro_torch.configs import registry as PR
from repro_torch.models.transformer import init_lm, layer_params
from repro_torch.params import params_from_numpy


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def smoke_pair():
    """The llama-7b smoke shape in bf16 params (the paper model's tree)."""
    jc, pc = JLlama.smoke(), PLlama.smoke()
    init = jax.jit(JT.init_lm, static_argnums=(1,))
    return jc, pc, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jc))


def test_key_paths_and_shapes_match_init_lm(smoke_pair):
    _, pc, jp = smoke_pair
    tp = params_from_numpy(jp, pc, device="cpu")
    own = init_lm(pc, seed=0, device="cpu")
    fj, ft, fo = _flat(jp), _flat(tp), _flat(own)
    assert set(fj) == set(ft) == set(fo)
    assert "layers/attn/lora/q/a" in fj and "comp_embed" in fj
    for k in fj:
        assert tuple(fj[k].shape) == tuple(ft[k].shape) == tuple(fo[k].shape), k
        assert ft[k].dtype == fo[k].dtype, k


def test_dtypes_and_bf16_values_exact(smoke_pair):
    _, pc, jp = smoke_pair
    tp = _flat(params_from_numpy(jp, pc, device="cpu"))
    fj = _flat(jp)
    assert fj["embed"].dtype == jnp.bfloat16      # ml_dtypes bfloat16
    for k, v in tp.items():
        want = torch.float32 if "/lora/" in k else torch.bfloat16
        assert v.dtype == want, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(fj[k], np.float32))


def test_leaves_are_writable_copies(smoke_pair):
    _, pc, jp = smoke_pair
    leaf = jp["layers"]["attn"]["lora"]["q"]["b"]
    tp = params_from_numpy(jp, pc, device="cpu")
    tp["layers"]["attn"]["lora"]["q"]["b"].add_(1.0)
    assert not np.any(np.asarray(leaf) == 1.0)


def test_layer_params_views(smoke_pair):
    _, pc, _ = smoke_pair
    own = init_lm(pc, seed=1, device="cpu")
    lp = layer_params(own, 1)
    assert torch.equal(lp["attn"]["wq"], own["layers"]["attn"]["wq"][1])
    assert lp["mlp"]["wo"].shape == (pc.d_ff, pc.d_model)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "whisper-tiny",
                                  "pixtral-12b"])
def test_family_trees_in_bf16_keep_the_reference_dtypes(arch):
    """A bf16-param smoke tree of the MoE, encoder-decoder and VLM
    families carried across, leaf by leaf against the reference's
    ``init_lm``: ``moe/router`` (and the LoRA factors) float32, every
    other leaf, ``encoder/*``, ``pos_embed`` and ``frontend/proj``
    included, bf16; values exact; the port's own ``init_lm`` builds the
    same paths, shapes and dtypes."""
    jc = JR.get_config(arch, smoke=True, param_dtype="bfloat16")
    pc = PR.get_config(arch, smoke=True, param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax.jit(JT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), jc))
    fj = _flat(jp)
    ft = _flat(params_from_numpy(jp, pc, device="cpu"))
    fo = _flat(init_lm(pc, seed=0, device="cpu"))
    assert set(fj) == set(ft) == set(fo)
    want_keys = {"phi3.5-moe-42b-a6.6b": "layers/moe/router",
                 "whisper-tiny": "encoder/pos_embed",
                 "pixtral-12b": "frontend/proj"}[arch]
    assert want_keys in fj
    for k, v in ft.items():
        f32 = "/lora/" in k or k.endswith("/router")
        want = torch.float32 if f32 else torch.bfloat16
        assert fj[k].dtype == (np.float32 if f32 else jnp.bfloat16), k
        assert v.dtype == fo[k].dtype == want, k
        assert tuple(v.shape) == tuple(fo[k].shape), k
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(fj[k], np.float32))
