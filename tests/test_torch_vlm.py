"""The VLM family (pixtral-12b) through the port's paths, against
``repro``: patch embeddings projected by ``frontend/proj`` into the first
``n_frontend_tokens`` positions of training and of a prefill.

Pixtral at its registry ``smoke`` in float32 (compute and params; the
config's params are bf16): 2 layers, GQA 8/2 x 8, 8 patch positions of
width 1024.  Weights, inputs and tolerances as
``tests/test_torch_encdec.py`` (whose helpers this file uses): training
1e-4 x max|reference| per tensor, online / stream / engine atol 1e-4.

The reference's ``prefill`` concatenates the patch rows with the block's
token rows past them, so a block shorter than the patches cannot run
there; the port refuses it with ``ValueError`` before any state is
written.  The engine serves pixtral sessions as text-only decoders (no
patches), as the reference's engine does.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import inference as PI
from test_torch_encdec import (check_adamw_step, check_engine,
                               check_generate, check_gradients,
                               check_online, check_ragged, check_stream,
                               check_train_forward, cfgs, extra_inputs,
                               params)

VLM = "pixtral-12b"


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_train_forward_with_patches_matches_reference(mode):
    check_train_forward(VLM, mode)


@pytest.mark.parametrize("train_mode", ["lora", "full"])
def test_loss_and_gradients_match_reference(train_mode):
    """LoRA-only (pixtral's ``train_mode``), then full training, which
    reaches the patch projection."""
    got = check_gradients(VLM, train_mode)
    assert ("frontend/proj" in got) == (train_mode == "full")


def test_one_adamw_step_matches_reference():
    check_adamw_step(VLM)


@pytest.mark.parametrize("mode", ["concat", "merge"])
def test_online_path_with_patches_matches_reference(mode):
    check_online(VLM, mode)


def test_ragged_online_calls_match_reference():
    check_ragged(VLM)


def test_generate_matches_reference():
    check_generate(VLM)


def test_stream_step_across_an_eviction_matches_reference():
    check_stream(VLM, "concat")


def test_engine_matches_reference():
    check_engine(VLM)


def test_patches_replace_the_first_positions_only():
    """Past the patch positions the prefill's logits do not depend on
    the token ids the patches replaced."""
    _, pc = cfgs(VLM)
    _, pp = params(VLM, pc)
    P = pc.n_frontend_tokens
    patches = torch.from_numpy(extra_inputs(pc, 3)["patches"])
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, pc.vocab_size, (2, P + 4)).astype(np.int32))
    other = toks.clone()
    other[:, :P] = (other[:, :P] + 1) % pc.vocab_size
    out = []
    for t in (toks, other):
        st = PI.init_online_state(pc, 2, 24, device="cpu")
        lg, _ = PI.prefill(pp, pc, st, t, full_logits=True, patches=patches)
        out.append(lg)
    assert torch.equal(out[0], out[1])


def test_prefill_shorter_than_the_patches_raises_before_any_write():
    _, pc = cfgs(VLM)
    _, pp = params(VLM, pc)
    P = pc.n_frontend_tokens
    patches = torch.from_numpy(extra_inputs(pc, 3)["patches"])
    st = PI.init_online_state(pc, 2, 24, device="cpu")
    before = (st.cache.k.clone(), st.cache.v.clone())
    with pytest.raises(ValueError, match="patch positions"):
        PI.prefill(pp, pc, st, torch.zeros(2, P - 1, dtype=torch.int32),
                   patches=patches)
    assert torch.equal(st.cache.k, before[0])
    assert torch.equal(st.cache.v, before[1])
    assert st.cache.length == 0 and st.pos == 0
