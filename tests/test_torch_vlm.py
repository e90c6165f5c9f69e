"""The port's image-prefixed decoder (InternVL2) against the JAX package's.

Reduced ``internvl2_1b`` (float32: 4 layers, d 128, 4 query heads over
2 KV heads of 32, 8 image tokens, 8-token blocks): parameters from the
JAX ``init`` go through ``convert_params``; image embeddings and tokens
are drawn with a seeded numpy generator and handed to both packages.
Logits are held at ATOL = RTOL = 1e-4 (float32 reorderings) and greedy
tokens must be identical.  Covered: ``forward`` over I + S positions,
``prefill`` with ``image_embeds`` (lengths counting the image tokens)
then ``decode_step``, ``prefill_suffix`` over text after a cached image
prefix, the image-embeddings contract, ``build_model`` for both new
families and the refusals of ``build_strategy`` and of the launchers.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.core.paged_kv import PagedKVManager as JManager
from repro.models.api import build_model as jbuild_model
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.mem import Arena
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.models.lm import DecoderLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.serve.arch import build_strategy

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B, S, S0 = 2, 24, 16


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config("internvl2_1b").reduced()
    cfg = get_config("internvl2_1b").reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(7)
    img = (0.1 * rng.normal(size=(B, cfg.num_image_tokens,
                                  cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jp, build_model(cfg), tp, cfg, img, toks


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


def _caches(jm, tm, max_seq):
    """The JAX and the port's cache over the same manager's tables."""
    jkv = jm.kv_config(max_seq=max_seq, batch=B)
    mgr = JManager(jkv)
    tables = np.stack([(mgr.admit(i, max_seq), mgr.device_table(i))[1]
                       for i in range(B)])
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tables))
    tc = PagedKVCache.create(tm.kv_config(max_seq=max_seq, batch=B), B,
                             device="cpu")
    tc.block_tables.copy_(torch.as_tensor(tables))
    return jc, tc


def test_forward_logits_match(pair):
    jm, jp, tm, tp, cfg, img, toks = pair
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                               "image_embeds": jnp.asarray(img)})
    tl = tm.forward(tp, torch.as_tensor(toks),
                    image_embeds=torch.as_tensor(img))
    assert tl.shape == (B, cfg.num_image_tokens + S, cfg.vocab_size)
    _close(tl.numpy(), jl)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))


def test_prefill_with_image_then_decode_match(pair):
    """Prefill I + S0 positions (row 1's length 3 short of it), then
    decode text: every step's logits and greedy tokens and the pools
    match the reference's."""
    jm, jp, tm, tp, cfg, img, toks = pair
    I = cfg.num_image_tokens
    jc, tc = _caches(jm, tm, I + S)
    lens = np.array([I + S0, I + S0 - 3], np.int32)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S0]),
                                "image_embeds": jnp.asarray(img)}, jc,
                           jnp.asarray(lens))
    tlast, tc = tm.prefill(tp, torch.as_tensor(toks[:, :S0]), tc,
                           torch.as_tensor(lens),
                           image_embeds=torch.as_tensor(img))
    _close(tlast.numpy(), jlast)
    for t in range(S0, S):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc)
        tl, tc = tm.decode_step(tp, torch.as_tensor(toks[:, t]), tc)
        _close(tl.numpy(), jl)
        assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))
    assert np.array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))
    _close(tc.k_pool.numpy(), jc.k_pool)
    _close(tc.v_pool.numpy(), jc.v_pool)


def test_prefill_suffix_over_text_after_image_prefix(pair):
    """The image and the first 8 text tokens are prefilled (2 blocks);
    8 more text tokens go through ``prefill_suffix`` at start 16 (row 1's
    prompt ends 3 tokens into them, so its last rows lie past kv_len):
    last logits match the reference's ``prefill_suffix`` and its full
    forward at each row's last prompt position, then a decode step
    matches the reference's."""
    jm, jp, tm, tp, cfg, img, toks = pair
    I, bt = cfg.num_image_tokens, cfg.kv_block_tokens
    P, SQ = 8, 8
    start = I + P
    assert start % bt == 0
    jc, tc = _caches(jm, tm, I + S)
    full = np.full(B, start, np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P]),
                            "image_embeds": jnp.asarray(img)}, jc,
                       jnp.asarray(full))
    _, tc = tm.prefill(tp, torch.as_tensor(toks[:, :P]), tc,
                       torch.as_tensor(full),
                       image_embeds=torch.as_tensor(img))
    lens = np.array([start + SQ, start + SQ - 3], np.int32)
    starts = full
    wt = np.array(jc.block_tables)[:, start // bt:(start + SQ) // bt]
    suffix = toks[:, P:P + SQ]
    jlast, jc = jm.prefill_suffix(jp, jnp.asarray(suffix), jc,
                                  jnp.asarray(lens), jnp.asarray(starts),
                                  jnp.asarray(wt))
    tlast, tc = tm.prefill_suffix(tp, torch.as_tensor(suffix), tc,
                                  torch.as_tensor(lens),
                                  torch.as_tensor(starts),
                                  torch.as_tensor(wt))
    _close(tlast.numpy(), jlast)
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :P + SQ]),
                               "image_embeds": jnp.asarray(img)})
    _close(tlast.numpy(), np.asarray(jl)[np.arange(B), lens - 1])
    nxt = toks[:, P + SQ]
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jc)
    td, _ = tm.decode_step(tp, torch.as_tensor(nxt), tc)
    _close(td.numpy(), jd)


def test_image_embeds_contract(pair):
    """A VLM's prompt needs its image embeddings, and a text model takes
    none; the port's ``init`` draws ``img_proj`` for the VLM only."""
    _, _, tm, tp, cfg, img, toks = pair
    with pytest.raises(ValueError, match="image_embeds"):
        tm.forward(tp, torch.as_tensor(toks))
    text = build_model(get_config("gemma_2b").reduced())
    tp_text = text.init(0, device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        text.forward(tp_text, torch.as_tensor(toks),
                     image_embeds=torch.as_tensor(img))
    assert tm.init(0, device="cpu")["img_proj"].shape == (cfg.d_model,
                                                           cfg.d_model)
    assert "img_proj" not in tp_text


@pytest.mark.parametrize("arch,cls", [("whisper_tiny", WhisperModel),
                                      ("internvl2_1b", DecoderLM)])
def test_build_model_builds_published_configs(arch, cls):
    """Both published configs build without allocating (the weights
    come from ``init``)."""
    cfg = get_config(arch)
    assert type(build_model(cfg)) is cls
    assert type(build_model(cfg, plain=True)) is cls


def test_build_strategy_refuses_the_vlm(pair):
    _, _, tm, _, _, _, _ = pair
    with pytest.raises(NotImplementedError, match="image_embeds"):
        build_strategy(tm, arena=Arena(), slots=2, max_seq=64,
                       num_blocks=16, device="cpu")


def test_launchers_refuse_the_vlm():
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    with pytest.raises(NotImplementedError, match="image_embeds"):
        serve_main(["--arch", "internvl2_1b", "--reduced", "--device", "cpu",
                    "--requests", "1"])
    with pytest.raises(NotImplementedError, match="image_embeds"):
        train_main(["--arch", "internvl2_1b", "--reduced", "--device", "cpu",
                    "--steps", "1"])
