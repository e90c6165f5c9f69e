"""The port's training losses and their gradients against the JAX package.

``chunked_lm_loss`` and every served family's ``loss`` (reduced
``gemma_2b``; ``gemma3_27b`` with qk-norm and local/global windows;
``minicpm3_4b`` with MLA; ``qwen3_moe_30b_a3b`` and
``deepseek_v2_lite_16b`` with the router's aux term; ``mamba2_370m``,
``rwkv6_7b`` and ``zamba2_2p7b``; ``internvl2_1b`` with its image prefix
and ``whisper_tiny`` with its encoder, whose batches add numpy
``image_embeds`` and ``frames``), with ``remat`` off and on, against
``jax.value_and_grad`` of the reference's (jitted: the JAX side's
compile is shorter than its eager dispatch here) on the same converted
parameters and the same numpy batch (targets partly masked with -1).
Both run float32 on the CPU: the loss agrees within 1e-5 relative and
each gradient leaf within 1e-4 of that leaf's largest magnitude
(observed gaps are float32 reorderings, ~1e-7).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.common import chunked_lm_loss as jchunked_lm_loss
from repro_torch.configs.base import get_config
from repro_torch.models.api import build_model
from repro_torch.models.common import _loss_chunk, chunked_lm_loss
from repro_torch.models.convert import convert_params
from repro_torch.models.lm import layer_params, unstack_layers
from repro_torch.tree import flatten_with_paths

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # of each leaf's max |grad|

ARCHS = ["gemma_2b", "gemma3_27b", "minicpm3_4b", "qwen3_moe_30b_a3b",
         "deepseek_v2_lite_16b", "mamba2_370m", "rwkv6_7b", "zamba2_2p7b",
         "internvl2_1b", "whisper_tiny"]


def _batch(vocab, B, S, seed, cfg=None):
    """Tokens and targets (B, S), 20% masked; for ``cfg`` with an image
    prefix or an encoder also ``image_embeds`` (B, I, d) or ``frames``
    (B, F, d), float32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((B, S)) < 0.2] = -1
    batch = {"tokens": toks[:, :-1], "targets": targets}
    if cfg is not None and cfg.num_image_tokens:
        batch["image_embeds"] = (0.1 * rng.normal(size=(
            B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg is not None and cfg.encoder is not None:
        batch["frames"] = (0.1 * rng.normal(size=(
            B, cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)
    return batch


def _grad_close(name, got, want):
    want = np.asarray(want, np.float32)
    tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def _torch_grads(fn, tensors):
    for t in tensors:
        t.requires_grad_(True)
    out = fn()
    loss = out[0] if isinstance(out, tuple) else out
    loss.backward()
    return _detached(out), [t.grad.numpy() for t in tensors]


def _detached(out):
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, dict):
        return {k: _detached(v) for k, v in out.items()}
    return tuple(_detached(o) for o in out)


# -- chunked_lm_loss -------------------------------------------------------
@pytest.mark.parametrize("S,softcap", [(16, None), (520, 30.0)])
def test_chunked_lm_loss_matches_jax(S, softcap):
    """nll, count and the gradients w.r.t. x and head_w, with masked
    targets; S = 520 runs two chunks of 260 (512 does not divide it)
    under a final softcap."""
    B, d, V = 2, 16, 40
    rng = np.random.default_rng(S)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.5).astype(np.float32)
    tg = rng.integers(0, V, (B, S)).astype(np.int32)
    tg[rng.random((B, S)) < 0.25] = -1
    assert _loss_chunk(520) == 260

    def jfn(xx, ww):
        nll, cnt = jchunked_lm_loss(xx, ww, jnp.asarray(tg),
                                    final_softcap=softcap)
        return nll, cnt
    (jn, jc), (jgx, jgw) = jax.value_and_grad(jfn, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x), torch.tensor(w)
    (tn, tc), (gx, gw) = _torch_grads(
        lambda: chunked_lm_loss(tx, tw, torch.tensor(tg),
                                final_softcap=softcap), [tx, tw])
    assert float(tc) == float(jc) == float((tg >= 0).sum())
    np.testing.assert_allclose(float(tn), float(jn), rtol=LOSS_RTOL)
    _grad_close("x", gx, jgx)
    _grad_close("head_w", gw, jgw)


# -- every family's loss ----------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    return arch, jm, jp, build_model(cfg), np_params, cfg


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(pair, remat):
    arch, jm, jp, tm, np_params, cfg = pair
    batch = _batch(cfg.vocab_size, 2, 16, seed=len(arch), cfg=cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmets), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, remat=remat), has_aux=True))(jp)
    tp = convert_params(np_params, cfg, device="cpu")
    paths, leaves, _ = flatten_with_paths(tp)
    (tl, tmets), grads = _torch_grads(
        lambda: tm.loss(tp, {k: torch.as_tensor(v)
                             for k, v in batch.items()}, remat=remat),
        leaves)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmets["nll"]), float(jmets["nll"]),
                               rtol=LOSS_RTOL)
    if "aux" in jmets:
        np.testing.assert_allclose(float(tmets["aux"]), float(jmets["aux"]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    jpaths, jleaves, _ = flatten_with_paths(jax.tree.map(np.asarray, jg))
    assert paths == jpaths
    for pth, g, jgl in zip(paths, grads, jleaves):
        _grad_close(pth, g, jgl)


def test_moe_aux_term_is_in_the_loss():
    """The MoE loss is the mean NLL plus ``router_aux_coef * aux /
    n_scan``: scaling the coefficient moves the loss by that term."""
    import dataclasses
    cfg = get_config("qwen3_moe_30b_a3b").reduced()
    m0 = build_model(cfg)
    p = m0.init(0, device="cpu")
    cfg2 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_coef=0.0))
    m2 = build_model(cfg2)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg.vocab_size, 2, 16, seed=1).items()}
    with torch.no_grad():
        l0, mets = m0.loss(p, batch)
        l2, _ = m2.loss(p, batch)
    assert float(mets["aux"]) > 0
    # |l0 - l2| ~ 1e-3 on a loss ~ 6.6: a few float32 ulps of the loss
    np.testing.assert_allclose(
        float(l0 - l2), cfg.moe.router_aux_coef * float(mets["aux"])
        / m0.n_scan, rtol=0, atol=2e-6)


def test_unstack_layers_views_match_layer_params():
    """``unstack_layers`` gives every layer the same tensors as
    ``layer_params``, and its backward pass stacks the layers' grads."""
    cfg = get_config("gemma_2b").reduced()
    p = build_model(cfg).init(0, device="cpu")
    layers = unstack_layers(p["layers"])
    assert len(layers) == cfg.num_layers
    for i, lp in enumerate(layers):
        mine = flatten_with_paths(lp)[1]
        want = flatten_with_paths(layer_params(p["layers"], i))[1]
        assert all(torch.equal(x, y) for x, y in zip(mine, want))
    w = p["layers"]["ff"]["wi"].clone().requires_grad_(True)
    parts = w.unbind(0)
    sum((i + 1) * t.sum() for i, t in enumerate(parts)).backward()
    want = torch.arange(1, cfg.num_layers + 1, dtype=w.dtype)
    assert torch.equal(w.grad, want[:, None, None].expand_as(w))
