"""The port's cost account (``repro_torch.cost``) against the reference's.

* **FLOPs.**  The account of the port's reduced ``loss`` (B 2, S 64,
  recorded on meta tensors from ``param_specs``) against
  ``repro.cost.analyze_compiled`` on the reference's jitted reduced
  ``loss``: equal to the FLOP for the dense, MLA, state and encoder
  families; for RWKV6 short by one named contraction; for the MoE models
  off by the padded rows of the two block layouts.  The account's FLOPs
  equal ``FlopCounterMode``'s on every case.
* **The rules**, as counterparts of ``tests/test_cost_model.py``: block
  writes billed at update size, gathers at the rows gathered,
  collectives by kind, ``Cost.add``, and the pool-size independence of a
  paged decode step (plain ops, and the reduced gemma-2b ``decode_step``
  with 4x the blocks).
* **The meta route.**  Every kernel wrapper on meta returns the CUDA
  kernel's outputs (shapes and dtypes) and bills ``cost/kernels.py``'s
  formula; a reduced step's meta account equals its CPU account outside
  the kernels' lines; the peak tracker gives a known program's peak.
* **The placeholder mesh** against a real (2, 2) gloo mesh of thread
  ranks: rank 0's ``CommStats`` and its account's collectives, exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import cost as jcost
from repro.configs.base import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro_torch import cost, roofline
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.cost import accounting as A
from repro_torch.cost import kernels as KB
from repro_torch.kernels import ops
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import placeholder_mesh, run_ranks
from repro_torch.models.api import build_model
from repro_torch.models.moe import block_rows
from repro_torch.optim import adamw as OPT
from repro_torch.tree import leaves as tree_leaves

torch.set_num_threads(1)

B, S = 2, 64
EXACT = ["gemma_2b", "gemma2_27b", "gemma3_27b", "minicpm3_4b",
         "zamba2_2p7b", "mamba2_370m", "whisper_tiny", "internvl2_1b"]
MOE = ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]


# ---------------------------------------------------------------------------
# FLOPs against the reference
# ---------------------------------------------------------------------------
def _batch_shapes(cfg):
    shapes = {"tokens": ((B, S), np.int32), "targets": ((B, S), np.int32)}
    if cfg.num_image_tokens:
        shapes["image_embeds"] = ((B, cfg.num_image_tokens, cfg.d_model),
                                  np.float32)
    if cfg.encoder is not None:
        shapes["frames"] = ((B, cfg.encoder.num_frames, cfg.d_model),
                            np.float32)
    return shapes


def _reference_flops(arch):
    """``repro.cost`` on the reference's jitted reduced ``loss``."""
    jcfg = jget_config(arch).reduced()
    jm = jbuild_model(jcfg)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))[0])
    batch = {k: jax.ShapeDtypeStruct(s, d)
             for k, (s, d) in _batch_shapes(jcfg).items()}
    comp = jax.jit(lambda p, b: jm.loss(p, b)[0]).lower(params,
                                                         batch).compile()
    return jcost.analyze_compiled(comp).flops


def _port_flops(arch):
    """(the account's FLOPs, ``FlopCounterMode``'s) of the port's reduced
    ``loss`` on meta tensors."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params, _ = model.param_specs()
    batch = {k: torch.empty(s, device="meta",
                            dtype=torch.int32 if d == np.int32
                            else torch.float32)
             for k, (s, d) in _batch_shapes(cfg).items()}
    with cost.counter.flop_counter() as fc, cost.record() as rec:
        model.loss(params, batch)
    return rec.cost.flops, fc.get_total_flops()


@pytest.mark.parametrize("arch", EXACT)
def test_loss_flops_equal_the_reference(arch):
    got, raw = _port_flops(arch)
    assert got == _reference_flops(arch)
    assert got == raw


def test_rwkv6_loss_flops_short_by_the_intra_chunk_score():
    """The reference computes RWKV6's intra-chunk score
    ``M = einsum("bhtd,bhsd,bhtsd->bhts", r, k, decay)``
    (``src/repro/models/rwkv6.py:149``), which XLA lowers to a ``dot``
    over ``dk`` with (b, h, t, s) as batch dimensions: 2 B H n n dk FLOPs
    a tile of n positions.  The port forms the same sum as a product and
    a ``sum(-1)`` (``src/repro_torch/models/rwkv6.py``, ``_tile``), which
    is elementwise work and bills no FLOPs.  Over S / n tiles and L
    layers the gap is exactly ``2 B H S n dk L``."""
    cfg = get_config("rwkv6_7b").reduced()
    H = cfg.num_heads
    dk = cfg.d_model // H
    n = cfg.ssm.subchunk or cfg.ssm.chunk
    got, raw = _port_flops("rwkv6_7b")
    gap = _reference_flops("rwkv6_7b") - got
    assert gap == 2 * B * H * S * n * dk * cfg.num_layers == 2 ** 20
    assert got == raw


def _moe_rows(cfg):
    """(the port's padded rows, the reference's) of one MoE layer's
    block layout at B x S tokens."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    R = B * S * k
    m = block_rows(R, E)
    port = (-(-R // m) + E) * m
    m_ref = min(256, R)
    ref = (R + E * m_ref) // m_ref * m_ref
    return port, ref


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_flops_differ_by_the_padded_rows(arch):
    """Both packages run each MoE layer's three expert products over a
    block-padded buffer: the reference pads ``Tk + E min(256, Tk)`` rows
    (``src/repro/models/moe.py``), the port ``nb m`` at ``block_rows``
    (``src/repro_torch/models/moe.py``); every padded row costs
    ``6 d f_expert`` FLOPs a layer."""
    cfg = get_config(arch).reduced()
    got, raw = _port_flops(arch)
    port_rows, ref_rows = _moe_rows(cfg)
    L_moe = cfg.num_layers - cfg.moe.first_dense_layers
    want = 6 * cfg.d_model * cfg.moe.d_ff_expert * L_moe * (port_rows
                                                            - ref_rows)
    assert (port_rows, ref_rows) == (512, 2304)
    assert abs((got - _reference_flops(arch)) - want) <= 1e-3 * abs(want)
    assert got == raw


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------
def _bill(fn):
    with cost.record() as rec:
        fn()
    return rec.cost


@pytest.mark.parametrize("how", ["index_put_", "index_copy_", "copy_"])
def test_block_write_is_billed_at_update_size(how):
    """Writing 3 rows of 64 float32 into a 1000-row pool bills the rows
    (read and written) and the index, never the pool."""
    pool = torch.zeros(1000, 64)
    rows = torch.ones(3, 64)
    idx = torch.tensor([5, 17, 900])
    upd = rows.numel() * 4
    if how == "index_put_":
        c = _bill(lambda: pool.index_put_((idx,), rows))
        assert c.by_op == {"scatter": 2 * upd + idx.numel() * 8}
    elif how == "index_copy_":
        c = _bill(lambda: pool.index_copy_(0, idx, rows))
        assert c.by_op == {"scatter": 2 * upd + idx.numel() * 8}
    else:
        c = _bill(lambda: pool[10:13].copy_(rows))
        assert c.by_op == {"dynamic-update-slice": 2 * upd}
    assert c.bytes < pool.numel() * 4 / 100


@pytest.mark.parametrize("how", ["index", "index_select", "embedding"])
def test_gather_is_billed_at_the_rows_gathered(how):
    table = torch.randn(5000, 32)
    idx = torch.tensor([1, 2, 4000, 7])
    fn = {"index": lambda: table[idx],
          "index_select": lambda: table.index_select(0, idx),
          "embedding": lambda: torch.nn.functional.embedding(idx, table)}
    c = _bill(fn[how])
    assert c.by_op == {"gather": 2 * 4 * 32 * 4 + idx.numel() * 8}


def test_collectives_are_billed_by_kind():
    """Each collective of a placeholder mesh bills its output bytes
    under the reference's kind, with its group's ranks; size-one groups
    move nothing and bill nothing."""
    mesh = placeholder_mesh((2, 4), rank=5)
    t = torch.empty((8, 16), device="meta")
    nb = t.numel() * 4
    with cost.record() as rec:
        mesh.all_reduce(t, "model")
        mesh.all_gather(t, "data")
        mesh.reduce_scatter(t, "model")
        mesh.all_to_all(torch.empty((4, 3), device="meta"), "model")
        mesh.broadcast(t, "data")
        mesh.all_reduce(t, ())
    c = rec.cost
    assert c.coll == {"all-reduce": nb, "all-gather": 2 * nb,
                      "reduce-scatter": nb / 4, "all-to-all": 48,
                      "collective-permute": nb}
    assert c.by_op == {"collective": c.coll_total}
    assert roofline.collective_bytes(c) == dict(c.coll, total=c.coll_total)
    assert c.coll_groups[("all-reduce", ("model",), (4, 5, 6, 7))] == nb
    assert c.coll_groups[("all-gather", ("data",), (1, 5))] == 2 * nb
    assert dict(mesh.stats.calls) == {"all_reduce": 1, "all_gather": 1,
                                      "reduce_scatter": 1, "all_to_all": 1,
                                      "broadcast": 1}
    assert "placeholder" in mesh.describe()


def test_cost_add_merges_by_op_kernels_and_groups():
    a = A.Cost(flops=1.0, bytes=10.0, by_op={"gather": 10.0})
    a.coll["all-reduce"] = 4.0
    a.coll_groups[("all-reduce", ("data",), (0, 1))] = 4.0
    a._line("tree_gather")["launches"] = 1
    b = A.Cost(flops=2.0, bytes=5.0, by_op={"gather": 2.0, "matmul": 3.0})
    b.add(a, times=2)
    assert (b.flops, b.bytes) == (4.0, 25.0)
    assert b.by_op == {"gather": 22.0, "matmul": 3.0}
    assert b.coll["all-reduce"] == 8.0 and b.coll_total == 8.0
    assert b.coll_groups == {("all-reduce", ("data",), (0, 1)): 8.0}
    assert b.kernels["tree_gather"]["launches"] == 2
    assert b.dominant_op() == "gather" == A.dominant_category(b.by_op)
    assert A.dominant_category({}) == "-"


def test_paged_kv_block_write_vs_contiguous_baseline():
    """The port of the reference's pool-size test: a paged decode step
    (the token written through the table, the pages gathered through
    it) is billed for the bytes it moves, the same at a pool of 1x and
    4x the working set, with the token write billed as the contiguous
    layout's write is, and the total under 3.5x the gathered bytes."""
    Bq, H, D, BT, Sq = 4, 2, 64, 16, 128
    MB = Sq // BT
    gathered = Bq * MB * BT * H * D * 4
    rng = np.random.default_rng(0)
    lens = torch.from_numpy(rng.integers(0, Sq, Bq))
    kv = torch.randn(Bq, H, D)

    def paged(NB):
        pool = torch.zeros(NB, BT, H, D)
        tbl = torch.from_numpy(rng.permutation(NB)[: Bq * MB]
                               .reshape(Bq, MB))

        def step():
            blk = tbl.gather(1, (lens // BT)[:, None])[:, 0]
            flat = pool.view(NB * BT, H, D)
            flat.index_put_((blk * BT + lens % BT,), kv)
            return pool[tbl.clamp(min=0)].sum(dim=(1, 2))
        return _bill(step)

    def contig():
        cache = torch.zeros(Bq, Sq, H, D)

        def step():
            flat = cache.view(Bq * Sq, H, D)
            flat.index_put_((torch.arange(Bq) * Sq + lens,), kv)
            return cache.sum(dim=(1, 2))
        return _bill(step)

    cp1, cp4, cc = paged(Bq * MB), paged(4 * Bq * MB), contig()
    assert cp1.bytes == cp4.bytes and cp1.by_op == cp4.by_op
    token = Bq * H * D * 4
    assert cp1.by_op["scatter"] == 2 * token + Bq * 8 == cc.by_op["scatter"]
    assert cp1.bytes < 3.5 * gathered, cp1.by_op


def _gemma_decode(num_blocks, device="cpu"):
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    if device == "meta":
        params, _ = model.param_specs()
    else:
        params = model.init(seed=0, device=device)
    state = PagedKVCache.create(model.kv_config(S, num_blocks, B, 1), B,
                                device=device)
    tokens = torch.zeros(B, dtype=torch.int32, device=device)
    return STEPS.build_serve_step(model, device=device), params, tokens, \
        state


def test_decode_step_bill_is_independent_of_the_pool():
    """The reduced gemma-2b ``decode_step`` with 4x the blocks in its
    pools gets the same bill, on the CPU (plain versions) and on meta
    (the kernels' bills)."""
    for device in ("cpu", "meta"):
        c1, _ = cost.analyze(*_gemma_decode(2 * S // 8, device))
        c4, _ = cost.analyze(*_gemma_decode(8 * S // 8, device))
        assert c1.bytes == c4.bytes and c1.by_op == c4.by_op, device
        assert c1.kernels == c4.kernels


# ---------------------------------------------------------------------------
# the meta route
# ---------------------------------------------------------------------------
def _kernel_cases():
    """(name, make(device) -> args, call(*args), bill) of every wrapper
    at small shapes; the inputs are made outside any recording."""
    Bq, KVH, G, HD, BT, MB, NB = 2, 2, 4, 32, 8, 3, 8
    SQ, L = 5, 3
    f32, i32 = torch.float32, torch.int32
    cfg = OPT.AdamWConfig()

    def z(shape, d, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=d)

    def ids(vals, d):
        return torch.tensor(vals, dtype=i32, device=d)

    def tables(d):
        return (torch.arange(Bq * MB, dtype=i32).reshape(Bq, MB) % NB).to(d)

    def lens(d, n=5):
        return torch.full((Bq,), n, dtype=i32, device=d)

    pool = (NB, BT, KVH, HD)
    return [
        ("paged_attention",
         lambda d: (z((Bq, KVH, G, HD), d), z(pool, d), z(pool, d),
                    tables(d), lens(d)),
         ops.paged_attention,
         KB.paged_attention(Bq, KVH, G, HD, HD, MB, BT, 4, 4,
                            shared_kv=False, self_term=False)),
        ("paged_attention_append",
         lambda d: (z((Bq, KVH, G, HD), d), z((Bq, KVH, HD), d),
                    z((Bq, KVH, HD), d), z(pool, d), z(pool, d), tables(d),
                    lens(d)),
         lambda *a: ops.paged_attention_append(*a)[0],
         KB.paged_attention_append(Bq, KVH, G, HD, HD, MB, BT, 4)),
        ("paged_prefill_attention",
         lambda d: (z((Bq, SQ, KVH, G, HD), d), z(pool, d), z(pool, d),
                    tables(d), lens(d), lens(d, 0)),
         ops.paged_prefill_attention,
         KB.paged_prefill_attention(Bq, SQ, KVH, G, HD, HD, MB, BT, 4)),
        ("copy_pool_blocks", lambda d: (z((L, NB, BT, HD), d),),
         lambda p: ops.copy_pool_blocks(p, [0, 1], [2, 3]),
         KB.block_move("copy", 2, L, BT * HD * 4)),
        ("block_copy", lambda d: (z((NB, BT, HD), d),),
         lambda p: ops.block_copy(p, [0], [5]),
         KB.block_move("copy", 1, 1, BT * HD * 4)),
        ("gather_blocks", lambda d: (z((L, NB, BT, HD), d),),
         lambda p: ops.gather_blocks(p, [4, 1, 2]),
         KB.block_move("gather", 3, L, BT * HD * 4)),
        ("scatter_blocks",
         lambda d: (z((L, NB, BT, HD), d), z((L, 2, BT, HD), d)),
         lambda p, x: ops.scatter_blocks(p, [6, 2], x),
         KB.block_move("scatter", 2, L, BT * HD * 4)),
        ("tree_gather", lambda d: (z((NB, 64), d), ids([3, 1, 2], d)),
         ops.tree_gather, KB.tree_gather(3, 64, 4)),
        ("tree_block_sum", lambda d: (z((NB, 64), d), ids([3, 1], d)),
         ops.tree_block_sum, KB.tree_block_sum(2, 64, 4)),
        ("tree_gather_rows",
         lambda d: (z((NB, 4, 16), d), ids([0, 5, 9], d),
                    ids([2, 4, 6], d)),
         lambda p, r, t: ops.tree_gather_rows(p, r, t, 4),
         KB.tree_gather_rows(3, 16, 4)),
        ("adamw_update",
         lambda d: (z((6, 10), d, torch.bfloat16), z((6, 10), d),
                    z((6, 10), d), z((6, 10), d),
                    *(z((), d) for _ in range(4))),
         lambda *a: ops.adamw_update(*a, cfg),
         KB.adamw_update(60, 2, 4)),
    ]


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[0])
def test_kernel_wrapper_on_meta_returns_outputs_and_bills_its_formula(case):
    """On meta a wrapper returns what its CUDA kernel returns (shapes and
    dtypes, the plain version's on the CPU), launches and counts
    nothing, and bills exactly its formula of ``cost/kernels.py``."""
    name, make, call, bill = case
    ops.reset_launch_counts()
    args = make("meta")
    with cost.record() as rec:
        got = call(*args)
    want = call(*make("cpu"))
    if want is None:
        assert got is None
    else:
        assert got.device.type == "meta"
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape),
                                                want.dtype)
    line = rec.cost.kernels[name]
    assert line["launches"] == 1
    assert line["bytes"] == bill.bytes and line["flops"] == bill.flops
    assert line["by_op"] == bill.parts
    assert rec.cost.by_op == bill.parts and rec.cost.flops == bill.flops
    assert ops.launch_counts()[name] == 0


def test_kernel_wrapper_refuses_a_mix_of_devices():
    with pytest.raises(ValueError, match="meta"):
        ops.tree_gather(torch.zeros((4, 8), device="meta"),
                        torch.tensor([1, 2]))


def _state(model, arch, device, num_blocks=16):
    if arch == "zamba2_2p7b":
        return model.init_state(B, S, num_blocks=num_blocks, device=device)
    if hasattr(model, "kv_config"):
        return PagedKVCache.create(model.kv_config(S, num_blocks, B, 1), B,
                                   device=device)
    return model.init_state(B, device=device)


@pytest.mark.parametrize("arch", ["gemma_2b", "minicpm3_4b",
                                  "qwen3_moe_30b_a3b", "rwkv6_7b",
                                  "zamba2_2p7b"])
def test_serve_step_meta_account_equals_cpu_account_outside_kernels(arch):
    """One decode step of each reduced family, recorded on the CPU (the
    plain versions' ops, kept under the kernels' lines) and on meta (the
    kernels' bills): every category outside the kernels' lines, the
    FLOPs outside them and the kernels' launches are equal."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    tokens = torch.zeros(B, dtype=torch.int32)
    cpu, _ = cost.analyze(STEPS.build_serve_step(model, device="cpu"),
                          model.init(seed=0, device="cpu"), tokens,
                          _state(model, arch, "cpu"))
    meta, _ = cost.analyze(STEPS.build_serve_step(model, device="meta"),
                           model.param_specs()[0], tokens.to("meta"),
                           _state(model, arch, "meta"))
    assert cpu.outside_kernels() == meta.outside_kernels()
    assert {k: v["launches"] for k, v in cpu.kernels.items()} == \
        {k: v["launches"] for k, v in meta.kernels.items()}

    def flops_outside(c):
        return c.flops - sum(v["flops"] for v in c.kernels.values())
    assert flops_outside(cpu) == flops_outside(meta)


def test_train_step_meta_account_equals_cpu_account_outside_kernels():
    """The reduced gemma-2b eager train step, on the CPU and on meta:
    equal outside ``adamw_update``'s line but for the batch's upload,
    one update a leaf on each."""
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    ocfg = OPT.AdamWConfig()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, 16))
             .astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, 16))
             .astype(np.int32)}
    accounts = []
    for device in ("cpu", "meta"):
        params = (model.init(seed=0, device="cpu") if device == "cpu"
                  else model.param_specs()[0])
        step = STEPS.build_train_step(model, ocfg, device=device,
                                      graph=False)
        c, _ = cost.analyze(step, params, OPT.init_state(params), batch)
        accounts.append(c)
    cpu, meta = accounts
    # the numpy batch's upload is a copy to the step's device, which on
    # the CPU is no copy at all
    upload = 2 * sum(v.nbytes for v in batch.values())
    gap = meta.outside_kernels()
    gap["copy"] -= upload
    assert gap == cpu.outside_kernels()
    n = len(tree_leaves(model.param_specs()[0]))
    assert cpu.kernels["adamw_update"]["launches"] == n == \
        meta.kernels["adamw_update"]["launches"]


def test_peak_tracker_gives_the_analytic_peak():
    """x (4 KB) live from the start; y = x * 2 (4 KB); z = y @ w (w 1 KB,
    z 256 B): the peak holds x, w, y and z at once; y's storage goes
    when its last view does, so a later 4 KB temporary finds it freed."""
    x = torch.randn(32, 32)
    w = torch.randn(32, 8)

    def prog(x, w):
        y = x * 2
        v = y[:4]
        z = v @ w[:, :2].contiguous()
        del y
        del v
        t = x + 1
        return z, t

    _, peak = cost.analyze(prog, x, w)
    assert peak == 4096 + 1024 + 4096 + 4 * 2 * 4 + 32 * 2 * 4
    with cost.record(track_memory=True) as rec:
        rec.memory.see([x, w])
        rec.memory.start()
        out = prog(x, w)
        live = rec.memory.live
    assert live == 4096 + 1024 + 4 * 2 * 4 + 4096
    del out


# ---------------------------------------------------------------------------
# the placeholder mesh against a real one
# ---------------------------------------------------------------------------
def _mesh_inputs(mesh, model, cfg, kind, device):
    """This rank's inputs of a (2, 2) train or serve step: from seeded
    CPU weights on the real mesh, from meta specs on the placeholder."""
    rng = np.random.default_rng(1)
    if device == "meta":
        params = model.param_specs()[0]
    else:
        params = model.init(seed=0, device="cpu")
    if kind == "train":
        step = STEPS.build_train_step(model, OPT.AdamWConfig(), mesh=mesh,
                                      zero1=True)
        pshard, oshard = step.in_shardings
        p = STEPS.shard_params(mesh, params, pshard, copy=True)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16))
                 .astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (4, 16))
                 .astype(np.int32)}
        return step, (p, STEPS.init_opt_state(mesh, p, oshard),
                      STEPS.shard_batch(mesh, batch))
    dp = STEPS.dp_groups_for(mesh, 4)
    state = PagedKVCache.create(model.kv_config(S, 16, 4, dp), 4,
                                device=device)
    step = STEPS.build_serve_step(model, mesh=mesh, state_example=state)
    tokens = torch.zeros(4, dtype=torch.int32, device=device)
    return step, (STEPS.shard_params(mesh, params, step.in_shardings),
                  STEPS.shard_batch(mesh, {"t": tokens})["t"],
                  STEPS.shard_state(mesh, state, cfg))


def _rank_account(mesh, model, cfg, kind, device):
    step, args = _mesh_inputs(mesh, model, cfg, kind, device)
    mesh.stats.reset()
    with cost.record() as rec:
        step(*args)
    return (dict(mesh.stats.calls), dict(mesh.stats.bytes),
            {k: v for k, v in rec.cost.coll.items() if v})


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", ["gemma_2b", "qwen3_moe_30b_a3b"])
def test_placeholder_mesh_counts_what_a_real_rank_counts(arch, kind):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    def rank(m):
        if m.rank == 0:
            return _rank_account(m, model, cfg, kind, "cpu")
        step, args = _mesh_inputs(m, model, cfg, kind, "cpu")
        step(*args)

    real = run_ranks((2, 2), rank, device="cpu", timeout=20.0)[0]
    fake = _rank_account(placeholder_mesh((2, 2)), model, cfg, kind, "meta")
    assert real == fake
    assert sum(real[0].values()) > 0


def test_mesh_collective_kinds_cover_every_op():
    from repro_torch.launch.mesh import COLL_KIND
    assert set(COLL_KIND.values()) <= set(A.COLLECTIVE_OPS)
    assert dataclasses.is_dataclass(A.Cost)


def test_cost_model_bench_on_the_cpu(tmp_path):
    """The bench's plain-op cases on the CPU: every ratio inside the
    reference's range, the rows written to ``--out``; #1's case runs on
    the card only."""
    from repro_torch.bench import cost_model as CM
    out = tmp_path / "cm.json"
    rows = CM.run("cpu", iters=1, out=str(out))
    assert [r["name"] for r in rows] == ["paged_kv_read",
                                         "paged_kv_token_write",
                                         "tree_gather"]
    for r in rows:
        assert CM.RATIO_LO <= r["ratio_predicted_to_analytic"] \
            <= CM.RATIO_HI, r
        assert r["ms"] is None
    # the plain version of #8 runs under its kernel's line
    assert [r["kernels"] for r in rows] == [{}, {}, {"tree_gather": 1}]
    assert json.loads(out.read_text())["all_ok"]


def test_cost_model_bench_kernel_cases_hold_the_bill_to_touched_bytes():
    """On the card #1's and #8's cases hold the kernel's bill
    (``cost/kernels.py``) against the bytes this run's data makes the
    kernel touch, derived from the tensors: the two agree where the
    tables are full, #1 reads capacity over valid keys at the bench's
    lengths, and a bill of the whole pool leaves the range."""
    from repro_torch.bench import cost_model as CM
    B, H, D, BT, S, MB = CM.B, CM.H, CM.D, CM.BT, CM.S, CM.MB
    q = torch.zeros(B, H, 1, D)
    kn = torch.zeros(B, H, D)
    bill = KB.paged_attention_append(B, H, 1, D, D, MB, BT, 4).bytes
    pool = bill + 2 * (CM.POOL_FACTOR - 1) * B * MB * BT * H * D * 4
    full = torch.full((B,), S - 1, dtype=torch.int32)
    assert CM.append_touched_bytes(q, kn, kn, full, BT) == bill
    lens = torch.tensor(CM.APPEND_LENS, dtype=torch.int32)
    touched = CM.append_touched_bytes(q, kn, kn, lens, BT)
    valid = int(lens.sum()) + B
    assert bill / touched == pytest.approx(B * S / valid, rel=0.01)
    assert CM.RATIO_LO <= bill / touched <= CM.RATIO_HI
    assert pool / touched > CM.RATIO_HI
    leaves = torch.zeros(CM.NB, CM.LEAF)
    table = torch.randperm(CM.NB, generator=torch.Generator().manual_seed(0)
                           )[:CM.NL]
    touched = CM.gather_touched_bytes(leaves, table)
    bill = KB.tree_gather(CM.NL, CM.LEAF, 4).bytes
    assert bill == touched
    assert (bill + (CM.NB - CM.NL) * CM.LEAF * 4) / touched > CM.RATIO_HI
    # a table that names one leaf twice reads it once
    assert CM.gather_touched_bytes(leaves, torch.tensor([3, 3])) \
        == 3 * CM.LEAF * 4 + 2 * 4
