"""The CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: each test needs a GPU that runs ``sm_90a`` code and
``nvcc`` to build the kernels, and skips elsewhere (the kernels have no
CPU mode; their plain versions are held against the JAX package in
``tests/test_torch_kernels.py``).  This file imports no JAX, so it runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4, bfloat16 2e-2 (outputs round once to bf16);
pools and block copies must match exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc: the CUDA "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    rng = np.random.default_rng(12)
    B, KVH, G, HD, BT, MB = 3, 1, 8, 256, 64, 4
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    q, kn, vn = t((B, KVH, G, HD)), t((B, KVH, HD)), t((B, KVH, HD))
    kp, vp = t((NB, BT, KVH, HD)), t((NB, BT, KVH, HD))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB].reshape(B, MB)
                              .astype(np.int32)).to(cuda_device)
    lens = torch.tensor([0, 70, MB * BT], dtype=torch.int32,
                        device=cuda_device)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ro, rk, rv = ref.paged_attention_append_ref(q, kn, vn, kp.clone(),
                                                vp.clone(), tables, lens)
    o, k, v = ops.paged_attention_append(q, kn, vn, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    assert torch.equal(k, rk) and torch.equal(v, rv)
    SQ = 20
    qs = t((B, SQ, KVH, G, HD))
    kl = torch.tensor([30, 90, 256], dtype=torch.int32, device=cuda_device)
    st = torch.tensor([10, 70, 200], dtype=torch.int32, device=cuda_device)
    ro = ref.paged_prefill_attention_ref(qs, kp, vp, tables, kl, st,
                                         window=48, softcap=30.0)
    o = ops.paged_prefill_attention(qs, kp, vp, tables, kl, st, window=48,
                                    softcap=30.0)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    pool = t((2, NB, BT, KVH, HD))
    ids = np.array([3, 0, 7], np.int32)
    assert torch.equal(ops.gather_blocks(pool, ids),
                       ref.gather_blocks_ref(pool, torch.from_numpy(ids)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain_version(cuda_device, dtype):
    """``paged_attention`` in MLA latent mode at MiniCPM3-4B's widths (40
    query heads over one 288-wide latent head, V = its first 256 lanes,
    64-token blocks), with a zero-length row and NULL entries, in q's
    dtype and in float32, and in GQA mode with softcap and a window."""
    rng = np.random.default_rng(13)
    B, G, LAT, VD, BT, MB = 4, 40, 288, 256, 64, 6
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    q, pool = t((B, 1, G, LAT)), t((NB, BT, 1, LAT))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB].reshape(B, MB)
                              .astype(np.int32)).to(cuda_device)
    tables[3, 2:] = -1
    lens = torch.tensor([0, 1, MB * BT, 100], dtype=torch.int32,
                        device=cuda_device)
    ro = ref.paged_attention_ref(q, pool, pool, tables, lens, v_dim=VD)
    o = ops.paged_attention(q, pool, pool, tables, lens, v_dim=VD)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    assert not o[0].float().any()
    # float32 output (absorbed MLA un-absorbs from it): no output rounding
    ro = ref.paged_attention_ref(q, pool, pool, tables, lens, v_dim=VD,
                                 out_dtype=torch.float32)
    o = ops.paged_attention(q, pool, pool, tables, lens, v_dim=VD,
                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert torch.allclose(o, ro, atol=1e-4, rtol=1e-4)
    qg, kp, vp = t((B, 2, 4, 64)), t((NB, BT, 2, 64)), t((NB, BT, 2, 32))
    ro = ref.paged_attention_ref(qg, kp, vp, tables, lens, softcap=30.0,
                                 window=40)
    o = ops.paged_attention(qg, kp, vp, tables, lens, softcap=30.0,
                            window=40)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
