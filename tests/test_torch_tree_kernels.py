"""Plain versions of the tree kernels (#8-#10) against the JAX package.

``repro_torch.kernels.ref.tree_gather_ref``, ``tree_block_sum_ref`` and
``tree_gather_rows_ref`` -- what the wrappers in
``repro_torch.kernels.ops`` run on CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel to on the card -- against the
reference's Pallas kernels in interpret mode
(``repro.kernels.ops.tree_*(..., interpret=True)``) on the shapes of
``tests/test_kernels.py``, float32 and bfloat16.  Inputs come from
seeded numpy generators and are handed to both packages.

Tolerances: gathers are copies and must be equal.  Per-leaf sums take
their float32 terms in another order than Pallas; each is held within
1e-5 of the leaf's sum|x|, the limit chip_smoke holds the CUDA kernel
to (a float32 reordering moves a sum of these lengths by ~1e-7 of
sum|x|).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

SUM_TOL = 1e-5
_TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _both(arr, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr.astype(np.float32)).astype(dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(_TORCH[dtype])
    return j, t


def _ids(arr):
    return jnp.asarray(arr.astype(np.int32)), torch.from_numpy(
        arr.astype(np.int32))


@pytest.mark.parametrize("nblocks,leaf", [(4, 128), (16, 256), (7, 512)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_tree_gather_matches_pallas(nblocks, leaf, dtype):
    rng = np.random.default_rng(nblocks * leaf)
    jl, tl = _both(rng.standard_normal((nblocks, leaf)), dtype)
    jt, tt = _ids(rng.permutation(nblocks))
    want = np.asarray(jops.tree_gather(jl, jt, interpret=True), np.float32)
    got = ref.tree_gather_ref(tl, tt)
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(ops.tree_gather(tl, tt).float().numpy(),
                                  want)


@pytest.mark.parametrize("nblocks,leaf", [(4, 128), (9, 1024)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_tree_block_sum_matches_pallas(nblocks, leaf, dtype):
    rng = np.random.default_rng(nblocks + leaf)
    jl, tl = _both(rng.standard_normal((nblocks, leaf)), dtype)
    jt, tt = _ids(rng.permutation(nblocks)[: nblocks - 1])
    want = np.asarray(jops.tree_block_sum(jl, jt, interpret=True))
    got = ref.tree_block_sum_ref(tl, tt)
    assert got.dtype == torch.float32 and got.shape == (nblocks - 1,)
    mag = tl[tt.long()].float().abs().sum(1).numpy()
    assert np.all(np.abs(got.numpy() - want) <= SUM_TOL * mag)
    assert torch.equal(ops.tree_block_sum(tl, tt), got)


@pytest.mark.parametrize("rows_per_block,width,n",
                         [(8, 128, 17), (16, 64, 64), (1, 32, 9)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_tree_gather_rows_matches_pallas(rows_per_block, width, n, dtype):
    rng = np.random.default_rng(rows_per_block * width + n)
    nb = 6
    jp, tp = _both(rng.standard_normal((nb, rows_per_block, width)), dtype)
    jt, tt = _ids(rng.permutation(nb))
    rows = np.concatenate([rng.integers(0, nb * rows_per_block, n),
                           [0, rows_per_block - 1, nb * rows_per_block - 1]])
    jr, tr = _ids(rows)
    want = np.asarray(jops.tree_gather_rows(jp, jr, jt, rows_per_block,
                                            interpret=True), np.float32)
    got = ref.tree_gather_rows_ref(tp, tr, tt, rows_per_block)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        ops.tree_gather_rows(tp, tr.long(), tt, rows_per_block).float()
        .numpy(), want)


def test_tree_wrappers_on_cpu_launch_nothing_and_check_inputs():
    """On CPU tensors the wrappers run the plain versions (no launch is
    counted), an empty table gives an empty output, and malformed inputs
    raise before any dispatch."""
    leaves = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    empty = torch.zeros(0, dtype=torch.int32)
    ops.reset_launch_counts()
    assert ops.tree_gather(leaves, empty).shape == (0, 6)
    assert ops.tree_block_sum(leaves, empty).shape == (0,)
    assert ops.tree_gather_rows(leaves.reshape(4, 2, 3), empty,
                                torch.arange(4), 2).shape == (0, 3)
    table = torch.tensor([3, 3, 0])
    assert torch.equal(ops.tree_gather(leaves, table), leaves[[3, 3, 0]])
    assert torch.equal(ops.tree_block_sum(leaves, table),
                       leaves[[3, 3, 0]].sum(1))
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(ValueError):
        ops.tree_gather(leaves.reshape(-1), table)
    with pytest.raises(ValueError):
        ops.tree_block_sum(leaves, table.float())
    with pytest.raises(ValueError):
        ops.tree_gather_rows(leaves.reshape(4, 2, 3), table, table, 3)
