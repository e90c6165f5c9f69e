"""The port's paper data structures against the JAX package.

* **Placement.** ``TreeArray.from_dense`` draws the reference's leaf ids
  (numpy ``RandomState`` shuffles, allocator ids, arena radix mappings),
  so ``leaves``, ``nodes``, ``root_leaf``, ``depth`` and ``leaf_table``
  equal the reference's element for element.
* **Values.** ``to_dense``, ``get_naive`` and ``set`` equal the
  reference's exactly; ``add`` within 1e-6 (a repeated index adds its
  updates in another order); ``scan_sum_iter`` and ``scan_sum_naive``
  within 1e-5 of sum|x| of the reference's sums and of the float64 sum
  (float32 sums of the same terms in another order).
* **Helpers.** ``DeviceBlockStack`` and the deep tables
  (``pack_table``, ``deep_table``, ``resolve_deep``,
  ``apply_compaction``) give the reference's values.
* **Benches.** ``repro_torch.bench`` runs on the CPU at tiny sizes;
  every tree result there must equal the dense one (the benches check
  it themselves and raise ``ResultMismatch`` otherwise).

Inputs come from seeded numpy generators and are handed to both
packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

import repro.mem as jmem
from repro.core import block_table as JBT
from repro.core.stack import DeviceBlockStack as JDeviceBlockStack
from repro.core.treearray import TreeArray as JTreeArray
import repro_torch.mem as tmem
from repro_torch.core import block_table as TBT
from repro_torch.core import (BlockAllocator, DeviceBlockStack, TreeArray,
                              tree_depth_for)
from repro_torch.kernels import ops

torch.set_num_threads(1)

SUM_TOL = 1e-5


def _same_tree(t: TreeArray, j: JTreeArray):
    assert (t.depth, t.length, t.leaf_size, t.fanout) == \
        (j.depth, j.length, j.leaf_size, j.fanout)
    np.testing.assert_array_equal(t.leaves.numpy(), np.asarray(j.leaves))
    assert len(t.nodes) == len(j.nodes)
    for a, b in zip(t.nodes, j.nodes):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t.root_leaf) == int(j.root_leaf)
    np.testing.assert_array_equal(t.leaf_table().numpy(),
                                  np.asarray(j.leaf_table()))


@given(st.integers(1, 2000), st.sampled_from([4, 8, 16, 64]),
       st.sampled_from([2, 4, 8]), st.integers(0, 5))
@settings(max_examples=25, deadline=None)
def test_placement_matches_reference(n, leaf, fanout, seed):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    t = TreeArray.from_dense(x, leaf_size=leaf, fanout=fanout,
                             shuffle_seed=seed, device="cpu")
    _same_tree(t, JTreeArray.from_dense(x, leaf_size=leaf, fanout=fanout,
                                        shuffle_seed=seed))
    assert t.depth == tree_depth_for(n, leaf, fanout)
    np.testing.assert_array_equal(t.to_dense().numpy(), x)


def test_placement_from_an_allocator_matches_reference():
    """Raw allocator ids (after two foreign blocks), a pool larger than
    the tree (zero blocks elsewhere), then a deep table from the same
    allocator: the same ids and values as the reference's."""
    x = np.random.RandomState(4).randn(37).astype(np.float32)
    ta, ja = BlockAllocator(24), jmem.BlockAllocator(24)
    assert ta.alloc_many(2) == ja.alloc_many(2)
    t = TreeArray.from_dense(x, leaf_size=4, fanout=2, allocator=ta,
                             device="cpu")
    j = JTreeArray.from_dense(x, leaf_size=4, fanout=2, allocator=ja)
    _same_tree(t, j)
    assert t.leaves.shape == (24, 4) and t.depth == 5
    np.testing.assert_array_equal(t.to_dense().numpy(), x)
    blocks = list(range(11))
    troot, tids = TBT.deep_table(blocks, 4, ta)
    jroot, jids = JBT.deep_table(blocks, 4, ja)
    np.testing.assert_array_equal(troot, jroot)
    assert tids == jids and ta.num_free == ja.num_free


@pytest.mark.parametrize("n,leaf,fanout,seed", [
    (1, 8, 4, 0), (100, 8, 4, 2), (300, 16, 4, 1), (1000, 8, 2, 3),
    (4096, 64, 4, 5), (8192, 64, 4, 6)])
def test_values_match_reference(n, leaf, fanout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32)
    t = TreeArray.from_dense(x, leaf_size=leaf, fanout=fanout,
                             shuffle_seed=seed, device="cpu")
    j = JTreeArray.from_dense(x, leaf_size=leaf, fanout=fanout,
                              shuffle_seed=seed)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    idx = rng.randint(0, n, size=(4, 16))
    np.testing.assert_array_equal(t.get_naive(idx).numpy(),
                                  np.asarray(j.get_naive(jnp.asarray(idx))))
    np.testing.assert_array_equal(t.gather_iter(idx[0]).numpy(), x[idx[0]])
    assert t.get_naive(n - 1).shape == () and float(t.get_naive(n - 1)) \
        == x[-1]
    tol = SUM_TOL * np.abs(x).sum()
    s = float(t.scan_sum_iter())
    assert abs(s - float(j.scan_sum_iter())) <= tol
    assert abs(s - x.astype(np.float64).sum()) <= tol
    if n <= 1000:    # the reference's naive scan is a sequential loop
        assert abs(float(t.scan_sum_naive()) - float(j.scan_sum_naive())) \
            <= tol
    upd_idx = rng.randint(0, n, size=64)
    upd = rng.randn(64).astype(np.float32)
    assert t.add(upd_idx, upd) is t                 # in place
    j = j.add(jnp.asarray(upd_idx), jnp.asarray(upd))
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               rtol=1e-6, atol=1e-6)
    k = int(rng.randint(0, n))
    t.set(k, 7.0)
    j = j.set(jnp.asarray(k), jnp.asarray(7.0))
    y = t.to_dense().numpy()
    assert y[k] == 7.0
    np.testing.assert_allclose(y, np.asarray(j.to_dense()), rtol=1e-6,
                               atol=1e-6)


def test_scan_sum_iter_excludes_the_padding():
    """A partial last leaf is summed over its ``length`` elements only,
    even when the pool's padding holds garbage; a one-leaf tree with a
    partial leaf sums nothing through the block-sum kernel."""
    x = np.arange(1, 21, dtype=np.float32)           # 20 = 2 leaves + 4
    t = TreeArray.from_dense(x, leaf_size=8, fanout=4, shuffle_seed=1,
                             device="cpu")
    last = int(t.leaf_table()[-1])
    t.leaves[last, 4:] = 1000.0
    assert float(t.scan_sum_iter()) == x.sum() == float(t.scan_sum_naive())
    one = TreeArray.from_dense(x[:5], leaf_size=8, fanout=4, device="cpu")
    one.leaves[0, 5:] = -1.0
    assert float(one.scan_sum_iter()) == x[:5].sum()


def test_tree_goes_through_the_kernel_wrappers(monkeypatch):
    """``to_dense`` reaches ``ops.tree_gather`` once and
    ``scan_sum_iter`` ``ops.tree_block_sum`` once (on the card these
    launch the CUDA kernels)."""
    calls = []
    for name in ("tree_gather", "tree_block_sum"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name:
                            (calls.append(_n), _fn(*a))[1])
    x = np.random.RandomState(0).randn(70).astype(np.float32)
    t = TreeArray.from_dense(x, leaf_size=8, fanout=4, shuffle_seed=0,
                             device="cpu")
    t.to_dense()
    t.scan_sum_iter()
    assert calls == ["tree_gather", "tree_block_sum"]


def test_from_dense_takes_tensors_and_defaults_to_cuda():
    x = torch.arange(10, dtype=torch.bfloat16)
    t = TreeArray.from_dense(x, leaf_size=4, fanout=2, device="cpu")
    assert t.leaves.dtype == torch.bfloat16
    assert torch.equal(t.to_dense(), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TreeArray.from_dense(x, leaf_size=4, fanout=2)


def test_shared_arena_tenants_match_reference():
    """Many trees share one Arena through radix mappings, with the
    reference's placement, and free back to a quiescent address space."""
    arenas = {}
    for pkg, dtype in ((tmem, torch.float32), (jmem, np.float32)):
        arenas[pkg] = pkg.Arena()
        arenas[pkg].register_class("tree", num_blocks=64, block_shape=(8,),
                                   dtype=dtype)
    xs = [np.arange(i * 13 + 1, dtype=np.float32) for i in range(5)]
    ts = [TreeArray.from_dense(x, leaf_size=8, fanout=4, arena=arenas[tmem],
                               pool_class="tree", owner=f"t{i}",
                               device="cpu") for i, x in enumerate(xs)]
    js = [JTreeArray.from_dense(x, leaf_size=8, fanout=4, arena=arenas[jmem],
                                pool_class="tree", owner=f"t{i}")
          for i, x in enumerate(xs)]
    st_ = arenas[tmem].stats()["tree"]
    assert st_.mappings_by_kind == {"radix": 5}
    assert st_.num_used == sum(t.num_logical_leaves for t in ts) \
        == arenas[jmem].stats()["tree"].num_used
    for x, t, j in zip(xs, ts, js):
        _same_tree(t, j)
        np.testing.assert_array_equal(t.to_dense().numpy(), x)
    for t in ts:
        t.arena_mapping.free()
    arenas[tmem].assert_quiescent()
    with pytest.raises(KeyError):
        TreeArray.from_dense(xs[0], arena=arenas[tmem], pool_class="nope",
                             device="cpu")


def test_overhead_bytes_match_reference():
    """Paper footnote 1: indirection overhead is tiny against data."""
    n = 1 << 16
    x = np.zeros(n, np.float32)
    t = TreeArray.from_dense(x, leaf_size=1024, fanout=256, device="cpu")
    j = JTreeArray.from_dense(x, leaf_size=1024, fanout=256)
    assert t.overhead_bytes == j.overhead_bytes < 0.02 * n * 4
    assert t.num_logical_leaves == j.num_logical_leaves == 64


def test_device_block_stack_matches_reference():
    """The same pushes and pops give the same values; ``push`` writes the
    shared ``data`` in place, which an older instance sees above its own
    top."""
    t = DeviceBlockStack.full_of(np.arange(5), device="cpu")
    j = JDeviceBlockStack.full_of(jnp.arange(5))
    for op in ["pop", "push", "pop", "pop", "push", "push", "pop"]:
        if op == "pop":
            tv, t = t.pop()
            jv, j = j.pop()
            assert tv.shape == () and int(tv) == int(jv)
        else:
            v = 10 + int(t.top)
            t, j = t.push(v), j.push(jnp.asarray(v))
        assert int(t.top) == int(j.top)
        np.testing.assert_array_equal(t.data[: int(t.top)].numpy(),
                                      np.asarray(j.data)[: int(j.top)])
    old = t
    new = old.push(99)
    assert int(old.data[int(old.top)]) == 99 and int(new.top) == \
        int(old.top) + 1
    e = DeviceBlockStack.empty(3, device="cpu")
    assert e.data.tolist() == [0, 0, 0] and int(e.top) == 0
    v, _ = e.push(4).pop()
    assert int(v) == 4


def test_block_table_helpers_match_reference():
    np.testing.assert_array_equal(TBT.pack_table([3, 1, 4], 6),
                                  JBT.pack_table([3, 1, 4], 6))
    ta, ja = BlockAllocator(32), jmem.BlockAllocator(32)
    data = ta.alloc_many(20)
    assert data == ja.alloc_many(20)
    troot, tids = TBT.deep_table(data, ids_per_block=8, allocator=ta)
    jroot, jids = JBT.deep_table(data, ids_per_block=8, allocator=ja)
    np.testing.assert_array_equal(troot, jroot)
    assert tids == jids
    storage = np.full((32, 8), -1, np.int32)
    for i, tb in enumerate(tids):
        chunk = data[i * 8:(i + 1) * 8]
        storage[tb, : len(chunk)] = chunk
    logical = np.arange(20)
    got = TBT.resolve_deep(troot, storage, logical, 8)
    np.testing.assert_array_equal(got, JBT.resolve_deep(jroot, storage,
                                                        logical, 8))
    np.testing.assert_array_equal(got, np.asarray(data))
    plan = TBT.compaction_plan([0, 5, 2, 9, 1])
    assert plan == JBT.compaction_plan([0, 5, 2, 9, 1])
    tt, jt = {0: [0, 5], 1: [2, 9, 1]}, {0: [0, 5], 1: [2, 9, 1]}
    TBT.apply_compaction(tt, plan)
    JBT.apply_compaction(jt, plan)
    assert tt == jt and sorted(b for v in tt.values() for b in v) == \
        [0, 1, 2, 3, 4]


def test_core_exports_match_reference():
    import repro.core as jcore
    import repro_torch.core as tcore

    assert set(tcore.__all__) == set(jcore.__all__) - {"BlockPool"}
    from repro_torch.core.blockpool import NULL_BLOCK
    assert NULL_BLOCK == jcore.NULL_BLOCK


def test_tree_scan_bench_on_cpu(capsys):
    """Table 2 at a one-leaf and a three-leaf size (depth 1 and 2, the
    last leaf partial): every row of the reference's bench, under its
    names, and tree results equal to dense ones."""
    from repro_torch.bench import tree_scan

    rows = tree_scan.run(device="cpu",
                         sizes=[("4KB", 1 << 10), ("66KB", 2 * 8192 + 100)])
    names = [r["name"] for r in rows]
    for label in ("4KB", "66KB"):
        for kind in ("linear_scan_dense", "linear_scan_tree_iter",
                     "linear_scan_tree_naive", "strided_scan_dense",
                     "strided_scan_tree"):
            assert f"{kind}_{label}" in names
    assert all(r["err"] <= r["tol"] for r in rows if "err" in r)
    assert "linear_scan_tree_iter_66KB" in capsys.readouterr().out


def test_bench_command_line_on_cpu(capsys):
    from repro_torch.bench import common, tree_scan

    rows = common.main(tree_scan.run, tree_scan.__doc__, tree_scan.SIZES,
                       argv=["--device", "cpu", "--sizes", "4KB"])
    assert [r["name"] for r in rows][0] == "linear_scan_dense_4KB"
    assert len(rows) == 5
    with pytest.raises(SystemExit):
        common.main(tree_scan.run, tree_scan.__doc__, tree_scan.SIZES,
                    argv=["--device", "cpu", "--sizes", "3KB"])
    capsys.readouterr()


def test_gups_bench_on_cpu():
    """GUPS at two sizes, a short chase and a small paged table (bf16,
    rows not a multiple of the block): tree equal to dense."""
    from repro_torch.bench import gups

    rows = gups.run(device="cpu", sizes=[("64KB", 1 << 14), ("1MB", 1 << 18)],
                    chase_shape=(1 << 14, 32),
                    table=(1001, 64, torch.bfloat16))
    names = [r["name"] for r in rows]
    assert names == ["gups_dense_64KB", "gups_tree_64KB", "gups_dense_1MB",
                     "gups_tree_1MB", "chase_dense_64KB", "chase_tree_64KB",
                     "embedding_dense", "embedding_tree"]
    assert all(r["err"] <= r["tol"] for r in rows if "err" in r)


def test_paged_rows_setup_places_rows_by_the_table():
    from repro_torch.bench import gups

    dense, pool, table, ids = gups.paged_rows_setup(
        torch.device("cpu"), 20, 3, torch.float32)
    rpb = gups.ROWS_PER_BLOCK
    assert pool.shape == (3, rpb, 3) and ids.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(),
                                  np.random.RandomState(0).permutation(3))
    for r in range(20):
        assert torch.equal(pool[table[r // rpb], r % rpb], dense[r])


def test_stack_bench():
    from repro_torch.bench import stack

    rows = stack.run(fib_n=12, loop=300)
    assert [r["name"] for r in rows] == [
        "fib_stack_contiguous", "fib_stack_split",
        "typical_stack_contiguous", "typical_stack_split"]
