"""InternVL2-1B's image-prefixed decoder over the model axis of the mesh,
against the JAX package's one-device steps.

Ranks are threads of this process over gloo (``run_ranks(...,
device="cpu")``).  Reduced float32 ``internvl2_1b`` -- 4 layers, 4 query
heads over 2 KV heads of 32, 8 stub image tokens projected by the
replicated ``img_proj`` and prepended to the prompt -- on meshes:

* (1, 2): one KV head a rank for its 2 query heads (``"model"``);
* (1, 3): nothing divides 3, so the weights replicate and the prompt's
  attention is context-parallel;
* (1, 4): one query head a rank, each KV head read by two ranks
  (``Shared``);
* (2, 2): the data axis beside the model axis.

Serving: a prefill of the image and right-padded text prompts, then 4
decode steps, held as ``tests/test_torch_tp_whisper.py`` holds Whisper's
(1e-5 of max |logit|, equal greedy tokens).  Training: one train step on
B 4, 8 image + 16 text tokens -- 24 positions, which 2, 3 and 4 divide,
so the prefixed stream goes in sequence pieces on every mesh, the image
positions in rank 0's piece -- with the loss on the text positions only,
against ``jax.value_and_grad`` + ``repro.optim.adamw`` (1e-5); with
sequence parallelism off, ``remat`` off, a 511-token vocabulary, ZeRO-1
bit for bit on (2, 2) and the forward step.  Then the placements and a
planted fault: the prefixed stream's sequence piece used without its
gather (the loss reads zeros at the other ranks' positions), which must
fail.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import shardings as SH
from repro_torch.models.lm import DecoderLM
from test_torch_tp_train import TOL, _leaf_gaps, _mesh_step
from test_torch_tp_whisper import (MESHES, ODD_VOCAB, _ids, check_forward,
                                   check_placements, check_serve,
                                   check_train, check_zero1,
                                   train_reference)

torch.set_num_threads(1)

ARCH = "internvl2_1b"
S = 16                         # text tokens after the 8 image ones


@pytest.mark.parametrize("shape", MESHES, ids=_ids(MESHES))
def test_vlm_tp_serve_matches_one_device_reference(shape):
    _, calls, shapes = check_serve(ARCH, shape)
    cfg = get_config(ARCH).reduced()
    # (1, 2): one KV head a rank; (1, 4): the one of its two ranks read
    kvh = {2: 1, 3: cfg.kv_heads, 4: 1}[shape[1]]
    assert shapes["k_pool"][-2:] == (kvh, cfg.hd)
    assert calls.get("all_reduce", 0) > 0 if shape[1] != 3 else \
        set(calls) == {"all_gather"}


def test_vlm_tp_serve_with_an_undivided_vocabulary():
    _, calls, _ = check_serve(ARCH, (1, 2), vocab=ODD_VOCAB)
    assert "all_gather" not in calls


@pytest.mark.parametrize("shape", MESHES, ids=_ids(MESHES))
def test_vlm_tp_train_step_matches_one_device_reference(shape):
    calls = check_train(ARCH, S, shape)[0][4]
    # the prefixed stream in sequence pieces: gathered before the split
    # products (or the context-parallel K/V) and for the loss
    assert calls["all_gather"] > 0
    if shape[1] != 3:
        assert calls["reduce_scatter"] > 0


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=_ids([(1, 2),
                                                            (1, 4)]))
def test_vlm_tp_train_step_without_sequence_parallelism(shape):
    calls = check_train(ARCH, S, shape, rules={"seq": None})[0][4]
    assert "reduce_scatter" not in calls and calls["all_reduce"] > 0


def test_vlm_tp_train_step_without_remat():
    check_train(ARCH, S, (1, 3), remat=False)


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=_ids([(1, 2),
                                                            (1, 3)]))
def test_vlm_tp_train_step_with_an_undivided_vocabulary(shape):
    check_train(ARCH, S, shape, vocab=ODD_VOCAB)


def test_vlm_tp_forward_step_gives_the_global_loss():
    check_forward(ARCH, S, (1, 4))


def test_vlm_tp_zero1_equals_the_plain_step_bitwise():
    check_zero1(ARCH, S)


@pytest.mark.parametrize("shape", MESHES, ids=_ids(MESHES))
def test_vlm_placements_match_reference(shape):
    got, gs = check_placements(ARCH, shape)
    cfg = get_config(ARCH).reduced()
    assert got["img_proj"] == (None, None)
    kv = {2: "model", 3: None, 4: SH.Shared("model", cfg.kv_heads)}[
        shape[1]]
    assert got["layers/attn/wk"][-1] == gs["k_pool"][3] == kv


def _text_positions_without_gather(self, x, S):
    """``DecoderLM._text_positions`` with the piece's gather left out:
    the other ranks' positions of the prefixed stream read zeros."""
    I = self.cfg.num_image_tokens
    if SH.is_piece(x, I + S, dim=1):
        mesh = SH.model_mesh()
        n, r = x.shape[1], mesh.axis_index("model")
        shape = (x.shape[0],), x.shape[2:]
        x = torch.cat([x.new_zeros(shape[0] + (r * n,) + shape[1]), x,
                       x.new_zeros(shape[0] + (I + S - (r + 1) * n,)
                                   + shape[1])], dim=1)
    return x[:, I:]


def test_planted_fault_image_prefix_split_without_its_gather(monkeypatch):
    np_params, batch, loss, gnorm, want = train_reference(ARCH, S)
    monkeypatch.setattr(DecoderLM, "_text_positions",
                        _text_positions_without_gather)
    out = _mesh_step(get_config(ARCH).reduced(), np_params, batch, (1, 2))
    assert abs(out[0][0] - loss) > 100 * TOL * abs(loss)
    assert max(_leaf_gaps(out[0][2], want).values()) > 100 * TOL
