"""The host side of the block kernel (#3-#6), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here: the chunk plan (``ops.plan_block_move``), the
id packing (``ops.pack_block_ids``: the launch's parameter block up to
``ops.MAX_PARAM_IDS`` ids, a pinned upload above), the checks every
wrapper makes before it launches, and the wrappers' launch arguments,
run through a Python model of ``rt_block_move`` that moves the bytes of
CPU tensors chunk by chunk as the kernel's CTAs do.  Results must equal
the plain versions bitwise.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

#: (n blocks, L layers, block bytes) of the block kernels' recorded
#: calls in a full-width serve run: gemma-2b's COW copy and its swap
#: gather/scatter (32 KB blocks, 18 layers), MiniCPM3-4B's (36,864 B
#: latent blocks, 62 layers), and #6 on one latent layer
RECORDED = [(2, 18, 32768), (4, 18, 32768), (2, 62, 36864), (2, 1, 36864)]


def test_chunk_plan_examples():
    # gemma-2b's COW copy: 2 x 18 blocks of 32 KB in 8 KB chunks
    assert ops.plan_block_move(2, 18, 32768) == 8192
    # large plans keep whole 32 KB chunks: one 4096-token sequence of
    # gemma-2b moves 64 x 18 of them, 37.7 MB, in 1152 CTAs
    assert ops.plan_block_move(64, 18, 32768) == ops.MAX_CHUNK_BYTES
    assert ops.plan_block_move(64, 62, 36864) == ops.MAX_CHUNK_BYTES
    # a block below the smallest chunk stays whole
    assert ops.plan_block_move(3, 1, 84) == 128
    # every chunk is a power of two within the kernel's limits
    for n, L, blk in RECORDED + [(1, 1, 84), (64, 18, 320), (7, 3, 20)]:
        chunk = ops.plan_block_move(n, L, blk)
        assert chunk & (chunk - 1) == 0
        assert 16 <= chunk <= ops.MAX_CHUNK_BYTES


@pytest.mark.parametrize("layered", [True, False])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_id_packing_routes_at_the_cap(fake_card, layered, delta):
    """A gather of n ids carries n, a copy 2n: both take the parameter
    block up to the cap and the staged upload from cap + 1 on."""
    cap = ops.MAX_PARAM_IDS
    if layered:                                  # gather: ids on one side
        idx = np.arange(cap + delta, dtype=np.int32)[::-1].copy()
        ids, s_off, d_off = ops.pack_block_ids(idx, None)
        assert (s_off, d_off) == (0, -1)
        assert np.array_equal(ids, idx)
        ops.gather_blocks(torch.zeros(1, idx.size, 4), idx)
    else:                                        # copy: both sides
        n = cap // 2 + delta                     # 2n: cap - 2, cap, cap + 2
        src = np.arange(n, dtype=np.int32)
        dst = np.arange(n, 2 * n, dtype=np.int32)
        ids, s_off, d_off = ops.pack_block_ids(src, dst)
        assert (s_off, d_off) == (0, n)
        assert np.array_equal(ids[:n], src) and np.array_equal(ids[n:], dst)
        ops.copy_pool_blocks(torch.zeros(1, 2 * n, 4), src, dst)
    assert ids.dtype == np.int32 and ids.flags.c_contiguous
    assert [c["staged"] for c in fake_card.calls] == [ids.size > cap]
    ids, s_off, d_off = ops.pack_block_ids(None, np.array([4, 1]))
    assert (s_off, d_off, ids.tolist()) == (-1, 0, [4, 1])


class _FakeLaunch:
    """A Python model of ``rt_block_move`` over CPU memory.  It walks the
    kernel's grid (``n * cpb``, ``L``) and indexes it as the kernel does:
    CTA (x, l) takes block ``i = x // cpb`` and chunk ``c = x - i * cpb``,
    the bytes [c * chunk, c * chunk + min(chunk, blk - c * chunk)) of
    that block on layer l, and moves them with memmove, reading ids from
    the host list or the staged copy.  Each launch records its arguments,
    its CTA count and the (destination address, bytes) of every CTA.  It
    checks the launch's contract on the way: a power-of-two chunk of
    16 B-32 KB, at most MAX_PARAM_IDS ids in the parameter block, and
    exactly one of the two id sources."""

    def __init__(self):
        self.calls = []

    def __call__(self, src, src_layer, dst, dst_layer, n, L, blk, chunk,
                 host_ids, dev_ids, n_ids, s_off, d_off, stream):
        assert chunk & (chunk - 1) == 0 and 16 <= chunk <= 32768
        assert (host_ids is None) != (dev_ids is None)
        if host_ids is not None:
            assert n_ids <= ops.MAX_PARAM_IDS
        ptr = host_ids if host_ids is not None else dev_ids
        ids = np.ctypeslib.as_array(
            (ctypes.c_int32 * n_ids).from_address(ptr)).copy()
        cpb = (blk + chunk - 1) // chunk
        spans = []
        for l in range(L):
            for x in range(n * cpb):
                i = x // cpb
                c = x - i * cpb
                off = c * chunk
                size = min(chunk, blk - off)
                sb = int(ids[s_off + i]) if s_off >= 0 else i
                db = int(ids[d_off + i]) if d_off >= 0 else i
                d = dst + l * dst_layer + db * blk + off
                ctypes.memmove(d, src + l * src_layer + sb * blk + off, size)
                spans.append((d, size))
        self.calls.append(dict(n=n, L=L, blk=blk, chunk=chunk,
                               ctas=n * cpb * L, spans=spans,
                               staged=dev_ids is not None))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, launching the model."""
    launch = _FakeLaunch()
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops, "_fn", lambda lib, sym: launch)
    monkeypatch.setattr(ops, "_upload_ids",
                        lambda ids, device: torch.from_numpy(ids.copy()))
    ops.reset_launch_counts()
    return launch


def _gather_launch(fake_card, n, L, blk):
    """The launch record and payload of a gather of ``n`` blocks of
    ``blk`` bytes on ``L`` layers (ids reversed)."""
    pool = torch.zeros(L, n + 1, blk, dtype=torch.uint8)
    out = ops.gather_blocks(pool, np.arange(n)[::-1].copy())
    (call,) = fake_card.calls
    assert (call["n"], call["L"], call["blk"]) == (n, L, blk)
    return call, out


@pytest.mark.parametrize("blk", [84, 320, 32768, 36864])
@pytest.mark.parametrize("n,L", [(1, 1), (2, 18), (4, 62), (64, 18)])
def test_chunk_plan_covers_every_byte_once(fake_card, blk, n, L):
    """The CTAs of a gather launch, as the kernel indexes its grid, write
    every byte of the compact payload exactly once, and on blocks of a
    multiple of 16 bytes every CTA's span starts 16-byte aligned (the
    TMA route)."""
    call, out = _gather_launch(fake_card, n, L, blk)
    assert call["chunk"] == ops.plan_block_move(n, L, blk)
    base, end = out.data_ptr(), out.data_ptr() + out.numel()
    at = base
    for d, size in sorted(call["spans"]):
        assert d == at and size > 0
        if blk % 16 == 0:
            assert (d - base) % 16 == 0 and size % 16 == 0
        at += size
    assert at == end


@pytest.mark.parametrize("n,L,blk", RECORDED)
def test_chunk_plan_fills_the_card_at_recorded_plans(fake_card, n, L, blk):
    call, _ = _gather_launch(fake_card, n, L, blk)
    assert call["ctas"] == len(call["spans"]) >= ops.SM_COUNT


def _pool(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("n,blk", [
    (3, (3, 7)), (3, (64, 1, 256)), (3, (5, 2, 8)),
    (ops.MAX_PARAM_IDS // 2 + 1, (5, 2, 8)), (ops.MAX_PARAM_IDS + 1, (3, 7))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_launch_what_the_plain_versions_compute(fake_card, n, blk,
                                                         dtype):
    """All four wrappers, with 84-byte, 32 KB and 320-byte blocks: ids in
    the parameter block (n = 3), a copy of 481 blocks (962 ids: staged)
    beside a gather of 481 (parameter block), and 961 ids on every
    wrapper (staged): bitwise equal to the plain versions, one launch
    each."""
    L, NB = (2, 2 * n + 1) if n > 3 else (3, 10)
    rng = np.random.default_rng(n)
    perm = rng.permutation(NB)
    src, dst = perm[:n], perm[n:2 * n]
    pool = _pool((L, NB, *blk), dtype, 1)
    want = ref.copy_pool_blocks_ref(pool.clone(), torch.from_numpy(src),
                                    torch.from_numpy(dst))
    assert torch.equal(ops.copy_pool_blocks(pool.clone(), src, dst), want)
    assert torch.equal(ops.gather_blocks(pool, src),
                       ref.gather_blocks_ref(pool, torch.from_numpy(src)))
    payload = _pool((L, n, *blk), dtype, 2)
    want = ref.scatter_blocks_ref(pool.clone(), torch.from_numpy(dst),
                                  payload)
    assert torch.equal(ops.scatter_blocks(pool.clone(), dst, payload), want)
    flat = pool[1].clone()
    want = ref.block_copy_ref(flat.clone(), torch.from_numpy(src),
                              torch.from_numpy(dst))
    assert torch.equal(ops.block_copy(flat, src, dst), want)
    counts = ops.launch_counts()
    assert [counts[k] for k in ("copy_pool_blocks", "gather_blocks",
                                "scatter_blocks", "block_copy")] == [1] * 4
    staged = [c["staged"] for c in fake_card.calls]
    assert staged == [2 * n > ops.MAX_PARAM_IDS, n > ops.MAX_PARAM_IDS,
                      n > ops.MAX_PARAM_IDS, 2 * n > ops.MAX_PARAM_IDS]


def test_unaligned_pool_view_and_one_layer(fake_card):
    """A pool view whose base is not 16-byte aligned, 1 and 62 layers."""
    for L in (1, 62):
        base = _pool(L * 6 * 5 + 1, torch.float32, L)
        pool = base[1:].view(L, 6, 5)            # 20-byte blocks at +4 B
        assert pool.data_ptr() % 16
        src, dst = np.array([0, 4]), np.array([5, 1])
        want = ref.copy_pool_blocks_ref(pool.clone(), torch.from_numpy(src),
                                        torch.from_numpy(dst))
        assert torch.equal(ops.copy_pool_blocks(pool, src, dst), want)
        assert torch.equal(ops.gather_blocks(pool, dst),
                           ref.gather_blocks_ref(pool, torch.from_numpy(dst)))


def _bad_plan(bad):
    pool = torch.zeros(2, 6, 3)
    if bad == "range_high":
        ops.gather_blocks(pool, [6])
    elif bad == "range_negative":
        ops.scatter_blocks(pool, [-1], torch.zeros(2, 1, 3))
    elif bad == "overlap":
        ops.copy_pool_blocks(pool, [0, 1], [1, 2])
    elif bad == "overlap_unlayered":
        ops.block_copy(pool[0], [3], [3])
    elif bad == "repeated_destination":
        ops.copy_pool_blocks(pool, [0, 1], [2, 2])
    elif bad == "repeated_destination_unlayered":
        ops.block_copy(pool[0], [0, 1], [4, 4])
    elif bad == "lengths":
        ops.copy_pool_blocks(pool, [0, 1], [2])
    elif bad == "repeated_scatter":
        ops.scatter_blocks(pool, [1, 1], torch.zeros(2, 2, 3))
    elif bad == "payload_shape":
        ops.scatter_blocks(pool, [1, 2], torch.zeros(2, 3, 3))
    elif bad == "payload_dtype":
        ops.scatter_blocks(pool, [1, 2], torch.zeros(2, 2, 3,
                                                     dtype=torch.float64))


@pytest.mark.parametrize("bad", [
    "range_high", "range_negative", "overlap", "overlap_unlayered",
    "repeated_destination", "repeated_destination_unlayered", "lengths",
    "repeated_scatter", "payload_shape", "payload_dtype"])
def test_malformed_plans_raise_before_a_launch(fake_card, bad):
    with pytest.raises((ValueError, TypeError)):
        _bad_plan(bad)
    assert fake_card.calls == []
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("bad", ["range_high", "overlap",
                                 "repeated_destination", "payload_dtype"])
def test_malformed_plans_raise_on_the_cpu_too(bad):
    with pytest.raises((ValueError, TypeError)):
        _bad_plan(bad)
