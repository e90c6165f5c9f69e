"""The mesh's serve and prefill steps over the model axis, against the
JAX package's one-device path.

Ranks are threads of this process over gloo (``run_ranks``).  Reduced
float32 decoder LMs -- ``gemma_2b`` (MQA), ``gemma2_27b`` and
``gemma3_27b`` (GQA, local/global windows, softcaps), ``qwen3_moe_30b_a3b``
(qk-norm, MoE in both layouts), ``deepseek_v2_lite_16b`` (MLA, MoE with
shared experts and a leading dense layer, both layouts) and
``minicpm3_4b`` (MLA with q-LoRA) -- run a prefill of right-padded
prompts and 4 decode steps on meshes:

* (1, 2): heads, MLP hidden dim, vocabulary and experts split;
* (1, 3): 4 heads, a 256-wide MLP and a 512-token vocabulary do not
  divide 3, so the weights replicate, decode runs whole on every rank
  and the prompt's attention is context-parallel (pieces of 6, 6 and 4
  query rows);
* (1, 4): one query head a rank, a KV head read by two ranks;
* (2, 2): the data axis beside the model axis, over ``dp_groups=2``
  pools.

Each rank holds the pieces of the converted weights that
``param_placements`` gives it (``shard_params``) and its rows and KV
heads of the global cache (``shard_state``); ``gather_logits`` puts the
logits back together.  They must agree with the reference's one-device
``prefill``/``decode_step`` within 1e-5 of max |logit| with equal greedy
tokens (the mesh is fed the reference's tokens).  The ``ep`` layout runs
at a capacity that drops nothing (``capacity_factor`` = E), where it
computes the dropless function; its drops are held to the reference's
``_moe_ep_shardmap`` in ``tests/test_torch_moe_parallel.py``.

Then the refusals that stay, each naming its queue item, what the
refusals of items 2a-2f became, the grad-mode guard of thread ranks
on one card, and the rank's own state tensors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.models.api import build_model as jbuild_model
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.dryrun import main as dryrun_main
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.models.lm import DecoderLM
from repro_torch.optim import adamw as OPT

torch.set_num_threads(1)

B, S, STEPS_N, MAX_SEQ = 4, 16, 4, 32
NB, DP = 16, 2                 # 2 pool groups of 8 blocks, 4 rows of 4
TOL = 1e-5                     # of max |logit|

ARCHS = ["gemma_2b", "gemma2_27b", "gemma3_27b", "qwen3_moe_30b_a3b",
         "deepseek_v2_lite_16b", "minicpm3_4b"]
LAYOUTS = [(a, "tp") for a in ARCHS] + [("qwen3_moe_30b_a3b", "ep"),
                                        ("deepseek_v2_lite_16b", "ep")]
MESHES = [(1, 2), (1, 3), (1, 4), (2, 2)]
# the reduced MoE configs' 8 experts do not split over 3 ranks (ep)
CASES = [(a, mode, m) for a, mode in LAYOUTS for m in MESHES
         if not (mode == "ep" and m[1] == 3)]


def _tables():
    """Group-local tables: each group's 8 blocks dealt to its 2 rows in
    a fixed shuffled order."""
    rng = np.random.default_rng(3)
    t = np.zeros((B, MAX_SEQ // 8), np.int32)
    for g in range(DP):
        t[2 * g:2 * g + 2] = rng.permutation(NB // DP).reshape(2, -1)
    return t


def _inputs(vocab):
    rng = np.random.default_rng(11)
    toks = rng.integers(2, vocab, (B, S)).astype(np.int32)
    return toks, np.asarray([S, 11, 7, S], np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(converted float32 weights, the reference's logits of the prefill
    and each decode step (5, B, V), the tokens it fed)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks, lens = _inputs(cfg.vocab_size)
    st = dataclasses.replace(
        JCache.create(jm.kv_config(MAX_SEQ, NB, B, dp_groups=DP), B),
        block_tables=jnp.asarray(_tables()))
    last, st = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, st,
                          jnp.asarray(lens))
    out, fed = [np.asarray(last)], []
    for _ in range(STEPS_N):
        nxt = out[-1].argmax(-1).astype(np.int32)
        fed.append(nxt)
        lg, st = jm.decode_step(jp, jnp.asarray(nxt), st)
        out.append(np.asarray(lg))
    return tp, np.stack(out), fed


def _cfg(arch, mode):
    cfg = get_config(arch).reduced()
    if mode == "ep":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, parallel_mode="ep",
            capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def _global_state(model):
    st = PagedKVCache.create(model.kv_config(MAX_SEQ, NB, B, dp_groups=DP),
                             B, device="cpu")
    st.block_tables.copy_(torch.as_tensor(_tables()))
    return st


def _mesh_run(model, tp, feed, shape):
    """Every rank's gathered logits (5, B, V) and collective calls."""
    cfg = model.cfg
    toks, lens = _inputs(cfg.vocab_size)

    def fn(mesh):
        glob = _global_state(model)
        prefill = STEPS.build_prefill_step(model, mesh=mesh,
                                           state_example=glob)
        serve = STEPS.build_serve_step(model, mesh=mesh, state_example=glob)
        params = STEPS.shard_params(mesh, tp, serve.in_shardings)
        state = STEPS.shard_state(mesh, glob, cfg)
        rows = STEPS.shard_batch(mesh, {"t": toks, "l": lens})
        last, state = prefill(params, torch.as_tensor(rows["t"]), state,
                              torch.as_tensor(rows["l"]))
        out = [last]
        for f in feed:
            mine = STEPS.shard_batch(mesh, {"f": f})["f"]
            lg, state = serve(params, torch.as_tensor(mine), state)
            out.append(lg)
        got = torch.stack([STEPS.gather_logits(mesh, o, cfg.vocab_size)
                           for o in out])
        return got.numpy(), dict(mesh.stats.calls)

    return run_ranks(shape, fn, device="cpu")


@pytest.mark.parametrize("arch,mode,shape", CASES, ids=[
    f"{a}-{mode}-{m[0]}x{m[1]}" for a, mode, m in CASES])
def test_model_axis_serve_matches_one_device_reference(arch, mode, shape):
    tp, ref, fed = _reference(arch)
    model = build_model(_cfg(arch, mode))
    res = _mesh_run(model, tp, fed, shape)
    got = res[0][0]
    for r in res[1:]:
        np.testing.assert_array_equal(r[0], got)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    calls = res[0][1]
    if shape[1] == 3:
        # replicated weights: only the context-parallel prefill's
        # gathers cross the model axis
        assert "all_reduce" not in calls and calls["all_gather"] > 0
    else:
        assert calls["all_reduce"] > 0          # row-parallel sums
    if mode == "ep":
        assert calls["all_to_all"] > 0


def test_ep_refuses_experts_that_do_not_split():
    model = build_model(_cfg("qwen3_moe_30b_a3b", "ep"))
    glob = _global_state(model)
    with pytest.raises(ValueError, match="experts do not split"):
        run_ranks((1, 3), lambda m: STEPS.build_serve_step(
            model, mesh=m, state_example=glob), device="cpu")


def test_rank_state_is_its_own_and_holds_the_kv_heads_it_reads():
    """gemma2_27b reduced at tp 4: 4 query heads over 2 KV heads, so
    ranks 0, 1 read KV head 0 and ranks 2, 3 KV head 1.  Every rank's
    pools, tables and lengths are tensors of its own (contiguous
    copies), never a view another rank also writes."""
    cfg = get_config("gemma2_27b").reduced()
    model = build_model(cfg)
    glob = _global_state(model)
    glob.k_pool.copy_(torch.randn(glob.k_pool.shape, generator=torch.
                                  Generator().manual_seed(0)))

    def fn(mesh):
        local = STEPS.shard_state(mesh, glob, cfg)
        kv = mesh.rank // 2
        return (local.k_pool.is_contiguous(), local.config.kv_heads,
                torch.equal(local.k_pool, glob.k_pool[..., kv:kv + 1, :]),
                [t.data_ptr() for t in (local.k_pool, local.v_pool,
                                        local.block_tables, local.seq_lens)])

    out = run_ranks((1, 4), fn, device="cpu")
    ptrs = [p for r in out for p in r[3]]
    glob_ptrs = {t.data_ptr() for t in (glob.k_pool, glob.v_pool,
                                        glob.block_tables, glob.seq_lens)}
    assert all(r[:3] == (True, 1, True) for r in out)
    assert len(set(ptrs)) == len(ptrs) and not glob_ptrs & set(ptrs)


def test_model_axis_collectives_refuse_grad_mode():
    """Thread ranks that share a card (``Mesh.threads_share_card``, set
    by hand here: CPU thread ranks, no card) refuse a model-axis
    collective while autograd records, and a train step over their model
    axis, each naming ``spawn_ranks``; under ``no_grad`` the collective
    runs.  On CPU thread ranks the backward pass of one runs: the
    gradient of a sum over the model axis is the sum of the ranks'
    gradients (an all-reduce's adjoint)."""
    def shared(mesh):
        mesh.threads_share_card = True
        with SH.use_rules(mesh):
            with torch.no_grad():
                assert SH.model_all_reduce(torch.ones(2)).tolist() == [2, 2]
            SH.model_all_reduce(torch.ones(2))

    with pytest.raises(RuntimeError, match="spawn_ranks"):
        run_ranks((1, 2), shared, timeout=2.0, device="cpu")
    gemma = build_model(get_config("gemma_2b").reduced())

    def train(mesh):
        mesh.threads_share_card = True
        STEPS.build_train_step(gemma, OPT.AdamWConfig(), mesh=mesh)

    with pytest.raises(RuntimeError, match="spawn_ranks"):
        run_ranks((1, 2), train, timeout=2.0, device="cpu")

    def backward(mesh):
        x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
        with SH.use_rules(mesh):
            y = SH.model_all_reduce(x)
            (y * (mesh.rank + 1)).sum().backward()
        return y.tolist(), x.grad.tolist()

    # y = x_0 + x_1 = 3 on both ranks; the objective sum_r (r + 1) y_r
    # has the gradient 1 + 2 on each x_s
    assert run_ranks((1, 2), backward, timeout=5.0, device="cpu") == \
        [([3.0] * 3, [3.0] * 3)] * 2


def _refusal(what):
    gemma = build_model(get_config("gemma_2b").reduced())
    if what == "train step":
        return lambda m: STEPS.build_train_step(gemma, OPT.AdamWConfig(),
                                                mesh=m)
    if what == "forward step":
        return lambda m: STEPS.build_forward_step(gemma, mesh=m)
    if what == "seq rule":
        return lambda m: STEPS.build_serve_step(gemma, mesh=m,
                                                rules={"seq": "model"})
    if what.endswith(" train step"):
        rwkv = build_model(get_config(what.split()[0]).reduced())
        return lambda m: STEPS.build_train_step(rwkv, OPT.AdamWConfig(),
                                                mesh=m)
    return lambda m: STEPS.build_prefill_step(
        build_model(get_config(what).reduced()), mesh=m)


#: what the state families' steps split, once refused under item 2d
_STATE_SPLIT = {
    "mamba2_370m": ("layers", "mamba", "in_proj"),
    "rwkv6_7b": ("layers", "mix", "wr"),
    "rwkv6_7b train step": ("layers", "mix", "wr"),
    "zamba2_2p7b": ("mamba_layers", "mamba", "in_proj")}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("what,match", [
    ("train step", "item 2a"), ("forward step", "item 2a"),
    ("--model-parallel", "item 2a"), ("seq rule", "item 2b"),
    ("mla_latent_tp", "item 2c"), ("mamba2_370m", "item 2d"),
    ("rwkv6_7b", "item 2d"), ("zamba2_2p7b", "item 2d"),
    ("whisper_tiny", "item 2f"), ("internvl2_1b", "item 2f"),
    ("rwkv6_7b train step", "item 2d"), ("dryrun", "item 2e")])
def test_model_axis_refusals_name_their_queue_item(what, match, tmp_path):
    """Items 2a-2f, once refused here, now build: the split-latent MLA
    pool (2c: the lora stream and ``wk_b``/``wv_b`` split on their lora
    lanes and rows, every head on every rank; its numbers are held in
    ``tests/test_torch_latent_tp.py``), the dry run over placeholder
    ranks (its rows are held in ``tests/test_torch_dryrun.py``), the
    train and forward steps
    over the model axis (the heads split, sequence parallelism on by
    the default rules; their numbers are held in
    ``tests/test_torch_tp_train*.py``), the launcher's
    ``--model-parallel`` (raising only where it does not divide the
    world: a lone process), the serve step, which runs with ``seq``
    None whatever a caller's rules say, and the constant-state
    families' steps (their mixers split by heads, Mamba2's packed
    ``in_proj`` as ``shardings.Packed``; their numbers are held in
    ``tests/test_torch_tp_state.py``), and Whisper's and InternVL2's
    serve and prefill steps (their heads split, Whisper's self pool and
    cross K/V by the rank's KV heads; their numbers are held in
    ``tests/test_torch_tp_whisper.py`` and ``tests/test_torch_tp_vlm.py``)."""
    if what == "--model-parallel":
        with pytest.raises(ValueError, match="does not divide the world of "
                                             "1 process"):
            train_main(["--arch", "gemma_2b", "--reduced", "--device", "cpu",
                        "--steps", "1", "--model-parallel", "2",
                        "--ckpt-dir", str(tmp_path)])
        return
    if what == "dryrun":
        with pytest.raises(SystemExit) as e:
            dryrun_main(["--arch", "gemma_2b", "--shape", "decode_32k",
                         "--specs-only", "--out", str(tmp_path / "d.jsonl")])
        assert e.value.code == 0
        return
    if what == "mla_latent_tp":
        model = DecoderLM(dataclasses.replace(
            get_config("minicpm3_4b").reduced(), mla_latent_tp=True))
        glob = model.decode_state_specs(4, 32, num_blocks=16)

        def build(m):
            step = STEPS.build_serve_step(model, mesh=m, state_example=glob)
            return step, STEPS.state_shardings(m, glob, model.cfg)

        for step, st in run_ranks((1, 2), build, timeout=2.0, device="cpu"):
            attn = step.in_shardings["layers"]["attn"]
            assert step.rules["attn_heads"] is None
            assert attn["wk_b"] == attn["wv_b"] == (None, "model", None)
            assert attn["wq_b"] == attn["wo"] == (None, None, None)
            assert st.k_pool[3] == "model" and st.v_pool[3] is None
        return
    if match == "item 2f":
        model = build_model(get_config(what).reduced())
        glob = model.decode_state_specs(4, 32, num_blocks=16)

        def build(m):
            step = STEPS.build_prefill_step(model, mesh=m, state_example=glob)
            return step, STEPS.state_shardings(m, glob, model.cfg)

        for step, st in run_ranks((1, 2), build, timeout=2.0, device="cpu"):
            sh = step.in_shardings
            assert step.rules["seq"] is None
            if what == "whisper_tiny":
                for part in ("enc_layers", "dec_layers"):
                    assert sh[part]["attn"]["wq"] == (None, None, "model")
                assert sh["dec_layers"]["xattn"]["wk"] == (None, None,
                                                           "model")
                assert st.cross_k[3] == st.cross_v[3] == "model"
                pools = st.self_kv
            else:
                assert sh["layers"]["attn"]["wq"] == (None, None, "model")
                assert sh["img_proj"] == (None, None)
                pools = st
            assert pools.k_pool[3] == pools.v_pool[3] == "model"
        return
    if match in ("item 2a", "item 2b", "item 2d"):
        steps = run_ranks((1, 2), _refusal(what), timeout=2.0, device="cpu")
        for step in steps:
            if what in _STATE_SPLIT:
                sh = step.in_shardings
                leaf = _leaf(sh[0] if isinstance(sh, tuple) else sh,
                             _STATE_SPLIT[what])
                packed = what in ("mamba2_370m", "zamba2_2p7b")
                assert isinstance(leaf[-1], SH.Packed) if packed else \
                    leaf[-1] == "model"
                assert step.rules.get("seq", SH.DEFAULT_RULES["seq"]) == (
                    "model" if what.endswith("train step") else None)
            elif what == "seq rule":
                assert step.rules["seq"] is None
            else:
                sh = step.in_shardings
                wq = (sh[0] if isinstance(sh, tuple) else sh)["layers"][
                    "attn"]["wq"]
                assert wq == (None, None, "model")
                assert step.rules.get("seq", SH.DEFAULT_RULES["seq"]) == \
                    "model"
        return
    with pytest.raises(NotImplementedError, match=match):
        run_ranks((1, 2), _refusal(what), timeout=2.0, device="cpu")
