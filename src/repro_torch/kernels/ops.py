"""Public kernel wrappers: dispatch by the tensors' device.

* A tensor on the CPU goes to the plain PyTorch version (``ref.py``).
* A tensor on a CUDA device launches the hand-written kernel of
  ``csrc/`` (built for ``sm_90a`` at first use, see ``build.py``), or
  the call raises -- there is no fallback on failure.
* A tensor on the meta device (a dry run, ``launch/dryrun.py``) gets the
  CUDA kernel's outputs, their shapes and dtypes, and nothing is
  launched or counted.

On the card and on meta each wrapper hands the bill of its launch
(``cost/kernels.py``: bytes moved and FLOPs from the shapes) to the
active cost recorder (``cost/accounting.py``), which cannot see a ctypes
launch.  On the CPU the plain version's ops are visible to the recorder
and are billed as they run; nothing more is added there.  Whatever a
wrapper dispatches (its copies, the plain version) is kept under the
kernel's line of the account (``accounting.kernel_scope``).

Every wrapper checks device, dtype, shape and contiguity before it
hands pointers to a kernel, checks the launch's ``cudaGetLastError``,
and adds one to its launch counter right after a launch, and nowhere
else (``launch_counts()`` / ``reset_launch_counts()`` read and clear
them) so a run can show that its main path went through the kernels;
a thread that called ``reset_thread_launch_counts()`` also keeps its
own (``thread_launch_counts()``: one rank of a thread mesh).
A captured CUDA graph launches its kernels without running the
wrappers: each replay adds the launches its capture counted
(``add_launch_counts``, ``serve/decode_graph.py``).
Kernels run on PyTorch's current stream and allocate nothing: outputs
and workspaces are allocated here with ``torch.empty``.  Pools are
updated in place.

Which TPU kernel each wrapper replaces:

=========================  ==========================================
wrapper                    Pallas kernel in ``repro/kernels``
=========================  ==========================================
paged_attention            ``paged_attention.paged_attention``
paged_attention_append     ``paged_attention.paged_attention_append``
paged_prefill_attention    ``paged_prefill.paged_prefill_attention``
copy_pool_blocks           ``block_copy.copy_pool_blocks``
gather_blocks              ``block_copy.gather_blocks``
scatter_blocks             ``block_copy.scatter_blocks``
block_copy                 ``block_copy.block_copy`` (single layer)
tree_gather                ``tree_gather.tree_gather``
tree_block_sum             ``tree_gather.tree_block_sum``
tree_gather_rows           ``tree_gather.tree_gather_rows``
adamw_update               none: the reference's AdamW update is jnp,
                           one XLA-fused pass a leaf (``csrc/adamw.cu``)
=========================  ==========================================
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.cost import accounting as _acct
from repro_torch.cost import kernels as _bills
from repro_torch.kernels import ref as kref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGS = {
    ("paged_attention", "rt_paged_attention"):
        [_P] * 9 + [_I] * 10 + [_F, _F, _I, _I, _I, _P],
    ("paged_append", "rt_paged_attention_append"):
        [_P] * 9 + [_I] * 9 + [_F, _F, _I, _I, _P],
    ("paged_prefill", "rt_paged_prefill_attention"):
        [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P],
    ("block_copy", "rt_block_move"):
        [_P, _LL, _P, _LL, _I, _I, _LL, _LL, _P, _P, _I, _I, _I, _P],
    ("tree_gather", "rt_tree_gather"): [_P, _P, _P, _I, _LL, _I, _P],
    ("tree_gather", "rt_tree_block_sum"): [_P, _P, _P, _I, _LL, _I, _I, _P],
    ("tree_gather", "rt_tree_gather_rows"):
        [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    ("adamw", "rt_adamw_update"):
        [_P] * 8 + [_LL, _LL, _I, _I] + [_F] * 6 + [_I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most query heads per kv head that the decode append and the
#: suffix prefill take (#1 keeps them in registers)
MAX_ROWS = 16
#: the most query heads per kv head that ``paged_attention`` takes: one
#: CTA holds them all (4 tensor-core row tiles; MLA runs 40)
MAX_DECODE_HEADS = 64
#: streaming multiprocessors of the H100 the decode split is planned for
SM_COUNT = 132
#: fewest key positions that one split of the decode append takes
MIN_SPLIT_TOKENS = 32
#: the most block ids (sources and destinations together) that a block
#: move carries in its launch's parameter block; a larger plan uploads
#: them from pinned memory without blocking
MAX_PARAM_IDS = 960
#: the largest chunk of a block that one CTA of a block move copies
#: (its shared memory), and the smallest that a small plan is cut to
MAX_CHUNK_BYTES = 32768
MIN_CHUNK_BYTES = 512
#: kernel launches per wrapper (only a launch of the CUDA kernel counts)
_LAUNCHES: Dict[str, int] = {
    name: 0 for name in ("paged_attention", "paged_attention_append",
                         "paged_prefill_attention",
                         "copy_pool_blocks", "gather_blocks",
                         "scatter_blocks", "block_copy", "tree_gather",
                         "tree_block_sum", "tree_gather_rows",
                         "adamw_update")}


_LOCK = threading.Lock()
#: this thread's launches since ``reset_thread_launch_counts`` (the
#: ranks of a thread mesh share the process-wide counters)
_LOCAL = threading.local()


def _count(name: str) -> None:
    """One launch of ``name``'s kernel: the process-wide counter and, if
    this thread keeps one, its own."""
    with _LOCK:
        _LAUNCHES[name] += 1
    mine = getattr(_LOCAL, "counts", None)
    if mine is not None:
        mine[name] += 1


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (cudaGetLastError != 0)."""


_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def _fn(lib: str, sym: str):
    """The kernel library's C entry point, typed (built and loaded at
    the first call)."""
    f = _FNS.get((lib, sym))
    if f is None:
        from repro_torch.kernels import build
        f = getattr(build.load(lib), sym)
        f.argtypes = _SIGS[(lib, sym)]
        f.restype = ctypes.c_int
        _FNS[(lib, sym)] = f
    return f


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise ValueError(f"tensors on several CUDA devices: {devs}")
        return True
    raise ValueError(f"kernel inputs must all be on the CPU, all on one "
                     f"CUDA device or all on meta, got {sorted(kinds)}")


def _route(*tensors: torch.Tensor) -> str:
    """``"meta"`` for meta tensors, else ``"cuda"`` or ``"cpu"`` as
    ``_on_cuda`` says (a mix raises)."""
    if all(t.device.type == "meta" for t in tensors):
        return "meta"
    return "cuda" if _on_cuda(*tensors) else "cpu"


def _scoped(fn):
    """Run wrapper ``fn`` inside its kernel's scope of the active cost
    recorder, when one is open."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not _acct._OPEN[0]:
            return fn(*args, **kw)
        with _acct.kernel_scope(name):
            return fn(*args, **kw)

    return wrapper


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{name}: CUDA error {rc} at launch")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _need_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def _dtype_code(name: str, t: torch.Tensor) -> int:
    try:
        return _DTYPES[t.dtype]
    except KeyError:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}; the kernel "
                        f"takes float32 or bfloat16") from None


def _aligned(name: str, **tensors: torch.Tensor) -> None:
    """The attention kernels copy pool rows in 16-byte units."""
    for k, t in tensors.items():
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{name}: {k} must start on a 16-byte boundary "
                             f"and its rows fill whole 16-byte vectors")


def plan_decode_splits(B: int, KVH: int, MB: int, BT: int,
                       G: int = 1) -> Tuple[int, int]:
    """``(S, W)``: the decode kernels (#1, #7) cut each row's ``MB * BT``
    key positions into ``S`` splits of ``W`` consecutive positions (the
    last may be shorter), one CTA per (row, kv head, split).  ``W`` is a
    multiple of ``BT`` or a power-of-two fraction of it, at least
    ``MIN_SPLIT_TOKENS`` (or ``BT`` if that is smaller): the smallest
    such width whose grid ``B * KVH * S`` stays within the CTAs that fit
    on the card at once -- two per SM for up to ``MAX_ROWS`` query heads
    per kv head, one above (a CTA holding more heads takes over half an
    SM's shared memory, and each split's partial, merged afterwards,
    grows with G).  From shapes alone -- reading the lengths would cost
    a host sync per layer.  At gemma-2b's decode (B 4, KVH 1, MB 6, BT
    64) and at MiniCPM3-4B's (the same with G 40) W is half a block:
    12 splits, 48 CTAs."""
    n = max(MB, 1) * BT
    per_sm = 2 if G <= MAX_ROWS else 1
    W = BT
    while W % 2 == 0 and W // 2 >= MIN_SPLIT_TOKENS:
        W //= 2
    while B * KVH * -(-n // W) > per_sm * SM_COUNT and W < n:
        W = 2 * W if W < BT else W + BT
    return -(-n // W), W


def _window(window: Optional[int]) -> int:
    """The kernels' window argument: None or <= 0 means global (0)."""
    return int(window) if window is not None and window > 0 else 0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@_scoped
def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    v_dim: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    self_score: Optional[torch.Tensor] = None,
                    self_v: Optional[torch.Tensor] = None):
    """Decode attention of one query token over ``seq_lens`` cached
    tokens; nothing is written.  Shapes as in ``ref.paged_attention_ref``
    (MLA latent mode: ``v_pool`` is ``k_pool`` and ``v_dim`` the
    kv_lora width).  ``window`` None or <= 0 is global, a positive one
    keeps ``pos >= lens - window``.  The optional self term -- the new
    token of absorbed MLA decode, not in the pool's attended range --
    enters the softmax with the float32 score ``self_score`` (B, KVH, G)
    and value ``self_v`` (B, KVH, VD), as the reference's ``_merge_self``
    merges it.  Returns (B, KVH, G, VD) in ``out_dtype``: q's dtype (the
    default) or float32."""
    name = "paged_attention"
    B, KVH, G, HD = q.shape
    NB, BT, KVH_k, HD_k = k_pool.shape
    VS = v_pool.shape[-1]
    VD = VS if v_dim is None else int(v_dim)
    MB = block_tables.shape[1]
    if (KVH_k, HD_k) != (KVH, HD) or v_pool.shape[:3] != (NB, BT, KVH) \
            or not 0 < VD <= VS or tuple(block_tables.shape) != (B, MB) \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"v_dim {v_dim} tables {tuple(block_tables.shape)} "
                         f"lens {tuple(seq_lens.shape)}")
    if (self_score is None) != (self_v is None) or (
            self_score is not None
            and (tuple(self_score.shape) != (B, KVH, G)
                 or tuple(self_v.shape) != (B, KVH, VD))):
        raise ValueError(f"{name}: the self term takes self_score "
                         f"{(B, KVH, G)} and self_v {(B, KVH, VD)} together")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"{name}: out_dtype {out_dtype} is neither q's dtype "
                        f"nor float32")
    extra = () if self_score is None else (self_score, self_v)
    route = _route(q, k_pool, v_pool, block_tables, seq_lens, *extra)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.paged_attention_ref(
                q, k_pool, v_pool, block_tables, seq_lens, scale=scale,
                softcap=softcap, window=window, v_dim=v_dim,
                out_dtype=out_dtype, self_score=self_score, self_v=self_v)
    if G > MAX_DECODE_HEADS:
        raise ValueError(f"{name}: {G} query heads per kv head > "
                         f"{MAX_DECODE_HEADS}")
    code = _dtype_code(name, k_pool)
    if not q.dtype == k_pool.dtype == v_pool.dtype:
        raise TypeError(f"{name}: q and the pools must share one dtype")
    _need_contiguous(name, k_pool=k_pool, v_pool=v_pool)
    _aligned(name, k_pool=k_pool, v_pool=v_pool)
    if (VD * k_pool.element_size()) % 16:
        raise ValueError(f"{name}: V's width {VD} must fill whole 16-byte "
                         f"vectors")
    q = q.contiguous()
    if q.data_ptr() % 16:           # the kernel loads q in 16-byte vectors
        q = q.clone()
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    if self_score is not None:
        self_score = self_score.to(torch.float32).contiguous()
        self_v = self_v.to(torch.float32).contiguous()
    out = torch.empty((B, KVH, G, VD), dtype=out_dtype, device=q.device)
    S, W = plan_decode_splits(B, KVH, MB, BT, G)
    # per split and row: m, l and the unnormalised acc[VD], for the merge
    part = torch.empty(B * KVH * S * G * (VD + 2), dtype=torch.float32,
                       device=q.device)
    if scale is None:
        scale = HD ** -0.5
    if route == "cuda":
        rc = _fn("paged_attention", "rt_paged_attention")(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(tables), _ptr(lens),
            _ptr(self_score), _ptr(self_v), _ptr(out), _ptr(part),
            B, KVH, G, HD, VD, VS, BT, MB, S, W, float(scale),
            float(softcap or 0.0), _window(window), code,
            _DTYPES[out_dtype], _stream(q))
        _check(rc, name)
        _count("paged_attention")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.paged_attention(
            B, KVH, G, HD, VD, MB, BT, k_pool.element_size(),
            out.element_size(), shared_kv=v_pool is k_pool,
            self_term=self_score is not None))
    return out


@_scoped
def paged_attention_append(q, k_new, v_new, k_pool, v_pool, block_tables,
                           seq_lens, *, scale: Optional[float] = None,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None):
    """Fused append-then-attend decode step for one layer; the pools are
    updated in place.  Shapes as in ``ref.paged_attention_append_ref``.
    Returns ``(o (B, KVH, G, VD), k_pool, v_pool)``."""
    name = "paged_attention_append"
    route = _route(q, k_new, v_new, k_pool, v_pool, block_tables, seq_lens)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.paged_attention_append_ref(
                q, k_new, v_new, k_pool, v_pool, block_tables, seq_lens,
                scale=scale, softcap=softcap, window=window)
    B, KVH, G, HD = q.shape
    NB, BT, KVH_k, HD_k = k_pool.shape
    VD = v_pool.shape[-1]
    MB = block_tables.shape[1]
    if (KVH_k, HD_k) != (KVH, HD) or v_pool.shape[:3] != (NB, BT, KVH) \
            or tuple(k_new.shape) != (B, KVH, HD) \
            or tuple(v_new.shape) != (B, KVH, VD) \
            or tuple(block_tables.shape) != (B, MB) \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)} "
                         f"k_new {tuple(k_new.shape)} v_new "
                         f"{tuple(v_new.shape)} pools {tuple(k_pool.shape)}"
                         f"/{tuple(v_pool.shape)} tables "
                         f"{tuple(block_tables.shape)} lens "
                         f"{tuple(seq_lens.shape)}")
    if G > MAX_ROWS:
        raise ValueError(f"{name}: {G} query heads per kv head > {MAX_ROWS}")
    code = _dtype_code(name, k_pool)
    if not (q.dtype == k_new.dtype == v_new.dtype == k_pool.dtype
            == v_pool.dtype):
        raise TypeError(f"{name}: q, k_new, v_new and the pools must share "
                        f"one dtype")
    _need_contiguous(name, k_pool=k_pool, v_pool=v_pool)
    _aligned(name, k_pool=k_pool, v_pool=v_pool)
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, KVH, G, VD), dtype=q.dtype, device=q.device)
    S, W = plan_decode_splits(B, KVH, MB, BT)
    # per split and row: m, l and the unnormalised acc[VD], for the merge
    part = torch.empty(B * KVH * S * G * (VD + 2) if S > 1 else 0,
                       dtype=torch.float32, device=q.device)
    if scale is None:
        scale = HD ** -0.5
    if route == "cuda":
        rc = _fn("paged_append", "rt_paged_attention_append")(
            _ptr(q), _ptr(k_new), _ptr(v_new), _ptr(k_pool), _ptr(v_pool),
            _ptr(tables), _ptr(lens), _ptr(out), _ptr(part),
            B, KVH, G, HD, VD, BT, MB, S, W, float(scale),
            float(softcap or 0.0), _window(window), code, _stream(q))
        _check(rc, name)
        _count("paged_attention_append")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.paged_attention_append(
            B, KVH, G, HD, VD, MB, BT, k_pool.element_size()))
    return out, k_pool, v_pool


@_scoped
def paged_prefill_attention(q, k_pool, v_pool, block_tables, kv_lens,
                            q_starts, *, scale: Optional[float] = None,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None):
    """Suffix prefill attention through the block table.  Shapes as in
    ``ref.paged_prefill_attention_ref``; returns (B, SQ, KVH, G, VD)."""
    name = "paged_prefill_attention"
    route = _route(q, k_pool, v_pool, block_tables, kv_lens, q_starts)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.paged_prefill_attention_ref(
                q, k_pool, v_pool, block_tables, kv_lens, q_starts,
                scale=scale, softcap=softcap, window=window)
    B, SQ, KVH, G, HD = q.shape
    NB, BT, KVH_k, HD_k = k_pool.shape
    VD = v_pool.shape[-1]
    MB = block_tables.shape[1]
    if (KVH_k, HD_k) != (KVH, HD) or v_pool.shape[:3] != (NB, BT, KVH) \
            or tuple(block_tables.shape) != (B, MB) \
            or tuple(kv_lens.shape) != (B,) \
            or tuple(q_starts.shape) != (B,):
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"tables {tuple(block_tables.shape)}")
    if G > MAX_ROWS:
        raise ValueError(f"{name}: {G} query heads per kv head > {MAX_ROWS}")
    code = _dtype_code(name, k_pool)
    if not q.dtype == k_pool.dtype == v_pool.dtype:
        raise TypeError(f"{name}: q and the pools must share one dtype")
    _need_contiguous(name, k_pool=k_pool, v_pool=v_pool)
    _aligned(name, k_pool=k_pool, v_pool=v_pool)
    if k_pool.dtype == torch.bfloat16 and (HD % 16 or VD % 16 or VD > 512):
        raise ValueError(f"{name}: bfloat16 head widths must be multiples "
                         f"of 16 (tensor-core tiles), V's at most 512, got "
                         f"{HD}/{VD}")
    q = q.contiguous()
    if q.data_ptr() % 16:           # the kernel stages q by 16-byte copies
        q = q.clone()
    tables = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    starts = q_starts.to(torch.int32).contiguous()
    out = torch.empty((B, SQ, KVH, G, VD), dtype=q.dtype, device=q.device)
    if scale is None:
        scale = HD ** -0.5
    if route == "cuda":
        rc = _fn("paged_prefill", "rt_paged_prefill_attention")(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(tables), _ptr(lens),
            _ptr(starts), _ptr(out), B, SQ, KVH, G, HD, VD, BT, MB,
            float(scale), float(softcap or 0.0), _window(window), code,
            _stream(q))
        _check(rc, name)
        _count("paged_prefill_attention")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.paged_prefill_attention(
            B, SQ, KVH, G, HD, VD, MB, BT, k_pool.element_size()))
    return out


# ---------------------------------------------------------------------------
# block movement
# ---------------------------------------------------------------------------
def plan_block_move(n: int, L: int, blk_bytes: int) -> int:
    """The chunk, in bytes, that the block kernel (#3-#6) cuts each of
    ``n`` blocks of ``blk_bytes`` on ``L`` layers into, one CTA per
    (block, chunk, layer): the smallest power of two (at least 16, at
    most ``MAX_CHUNK_BYTES``) that holds a block, halved while the grid
    ``n * L * ceil(blk_bytes / chunk)`` gives fewer CTAs than the card
    has SMs and the chunk stays above ``MIN_CHUNK_BYTES``.  At gemma-2b's
    COW copy (2 blocks of 32 KB on 18 layers) that is 8 KB chunks, 144
    CTAs; a large plan keeps 32 KB chunks."""
    chunk, top = 16, min(blk_bytes, MAX_CHUNK_BYTES)
    while chunk < top:
        chunk *= 2
    while (n * L * -(-blk_bytes // chunk) < SM_COUNT
           and chunk > MIN_CHUNK_BYTES):
        chunk //= 2
    return chunk


def pack_block_ids(src: Optional[np.ndarray], dst: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, int, int]:
    """A block move's ids as one int32 vector, sources first, with the
    offsets of the source and destination ids in it (-1 for a side
    without ids).  Up to ``MAX_PARAM_IDS`` ids travel in the launch's
    parameter block; more are uploaded (``_upload_ids``)."""
    parts = [x for x in (src, dst) if x is not None]
    ids = (np.concatenate(parts) if parts else np.zeros(0)).astype(np.int32)
    s_off = 0 if src is not None else -1
    d_off = -1 if dst is None else (0 if src is None else src.size)
    return ids, s_off, d_off


def _ids(ids, nb: int, name: str) -> np.ndarray:
    """Host copy of a block-id vector, range-checked against the pool
    (block ids from the allocator are never NULL here).  A CUDA tensor
    is copied to the host for the checks, which synchronises with the
    card; the transfer plane passes numpy ids.  A meta tensor has no
    ids to check: a meta pool takes host ids."""
    if isinstance(ids, torch.Tensor):
        if ids.device.type == "meta":
            raise ValueError(f"{name}: block ids on meta have no values; "
                             f"pass host ids (numpy, a list or a CPU "
                             f"tensor)")
        ids = ids.detach().cpu().numpy()
    ids = np.asarray(ids, np.int64).reshape(-1)
    vals = ids.tolist()         # Python's min/max beat numpy's on few ids
    if vals and (min(vals) < 0 or max(vals) >= nb):
        raise ValueError(f"{name}: block ids out of range [0, {nb}): "
                         f"{vals}")
    return ids.astype(np.int32)


def _copy_plan(name: str, s: np.ndarray, d: np.ndarray) -> None:
    if s.size != d.size:
        raise ValueError(f"{name}: {s.size} sources vs {d.size} "
                         f"destinations")
    dsts = set(d.tolist())
    if dsts.intersection(s.tolist()) or len(dsts) != d.size:
        raise ValueError(f"{name}: copy plan must have disjoint sources and "
                         f"destinations and distinct destinations: "
                         f"{s.tolist()} -> {d.tolist()}")


def _upload_ids(ids: np.ndarray, device: torch.device) -> torch.Tensor:
    """``ids`` on ``device`` without blocking: copied into a pinned
    buffer of PyTorch's caching host allocator, which keeps the buffer
    until the upload (queued on the current stream) has run."""
    pinned = torch.empty(ids.size, dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = ids
    return pinned.to(device, non_blocking=True)


def _move(name: str, src: torch.Tensor, src_ids: Optional[np.ndarray],
          dst: torch.Tensor, dst_ids: Optional[np.ndarray], n: int, L: int,
          blk_bytes: int) -> None:
    """One launch of the block kernel on the current stream; nothing
    synchronises.  The ids ride in the launch up to ``MAX_PARAM_IDS``;
    a larger plan uploads them (``_upload_ids``; their device copy is
    freed on the kernel's stream, after the kernel)."""
    ids, s_off, d_off = pack_block_ids(src_ids, dst_ids)
    host, dev = ids, None
    if ids.size > MAX_PARAM_IDS:
        host, dev = None, _upload_ids(ids, dst.device)
    rc = _fn("block_copy", "rt_block_move")(
        _ptr(src), src.stride(0) * src.element_size(), _ptr(dst),
        dst.stride(0) * dst.element_size(), n, L, blk_bytes,
        plan_block_move(n, L, blk_bytes),
        None if host is None else host.ctypes.data, _ptr(dev), ids.size,
        s_off, d_off, _stream(dst))
    _check(rc, name)


def _blk_bytes(pool: torch.Tensor, start: int = 2) -> int:
    return math.prod(pool.shape[start:]) * pool.element_size()


@_scoped
def copy_pool_blocks(pool, src, dst):
    """``pool[:, dst[i]] = pool[:, src[i]]`` on all L layers of an
    ``(L, NB, *blk)`` pool, in place; ``src`` and ``dst`` must be
    disjoint as sets (copy plans guarantee it).  Ids are numpy arrays,
    lists or tensors (a CUDA tensor synchronises, see ``_ids``).
    Returns ``pool``."""
    name = "copy_pool_blocks"
    s = _ids(src, pool.shape[1], name)
    d = _ids(dst, pool.shape[1], name)
    _copy_plan(name, s, d)
    route = _route(pool)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.copy_pool_blocks_ref(pool, torch.from_numpy(s),
                                             torch.from_numpy(d))
    if s.size == 0:
        return pool
    _need_contiguous(name, pool=pool)
    if route == "cuda":
        _move(name, pool, s, pool, d, s.size, pool.shape[0],
              _blk_bytes(pool))
        _count("copy_pool_blocks")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.block_move(
            "copy", s.size, pool.shape[0], _blk_bytes(pool)))
    return pool


@_scoped
def block_copy(pool, src, dst):
    """Unlayered ``(NB, *blk)`` copy plan, in place: the single-layer
    case of ``copy_pool_blocks`` on the same kernel.  Returns ``pool``."""
    name = "block_copy"
    s = _ids(src, pool.shape[0], name)
    d = _ids(dst, pool.shape[0], name)
    _copy_plan(name, s, d)
    route = _route(pool)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.block_copy_ref(pool, torch.from_numpy(s),
                                       torch.from_numpy(d))
    if s.size == 0:
        return pool
    _need_contiguous(name, pool=pool)
    if route == "cuda":
        _move(name, pool, s, pool, d, s.size, 1, _blk_bytes(pool, 1))
        _count("block_copy")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.block_move(
            "copy", s.size, 1, _blk_bytes(pool, 1)))
    return pool


@_scoped
def gather_blocks(pool, idx):
    """Compact ``(L, n, *blk)`` copy of blocks ``idx`` of an
    ``(L, NB, *blk)`` pool (the device half of swap-out)."""
    name = "gather_blocks"
    ids = _ids(idx, pool.shape[1], name)
    route = _route(pool)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.gather_blocks_ref(pool, torch.from_numpy(ids))
    L = pool.shape[0]
    out = torch.empty((L, ids.size, *pool.shape[2:]), dtype=pool.dtype,
                      device=pool.device)
    if ids.size == 0:
        return out
    _need_contiguous(name, pool=pool)
    if route == "cuda":
        _move(name, pool, ids, out, None, ids.size, L, _blk_bytes(pool))
        _count("gather_blocks")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.block_move(
            "gather", ids.size, L, _blk_bytes(pool)))
    return out


@_scoped
def scatter_blocks(pool, idx, payload):
    """``pool[:, idx] = payload`` in place for a compact ``(L, n, *blk)``
    payload of the pool's dtype (the device half of swap-in); ``idx``
    entries must be distinct.  Returns ``pool``."""
    name = "scatter_blocks"
    ids = _ids(idx, pool.shape[1], name)
    if len(set(ids.tolist())) != ids.size:
        raise ValueError(f"{name}: scatter ids must be distinct: "
                         f"{ids.tolist()}")
    want = (pool.shape[0], ids.size, *pool.shape[2:])
    if tuple(payload.shape) != want:
        raise ValueError(f"{name}: payload {tuple(payload.shape)} != {want}")
    if payload.dtype != pool.dtype:
        raise TypeError(f"{name}: payload dtype {payload.dtype} != pool "
                        f"dtype {pool.dtype}")
    route = _route(pool, payload)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.scatter_blocks_ref(pool, torch.from_numpy(ids),
                                           payload)
    if ids.size == 0:
        return pool
    _need_contiguous(name, pool=pool)
    payload = payload.contiguous()
    if route == "cuda":
        _move(name, payload, None, pool, ids, ids.size, pool.shape[0],
              _blk_bytes(pool))
        _count("scatter_blocks")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.block_move(
            "scatter", ids.size, pool.shape[0], _blk_bytes(pool)))
    return pool


# ---------------------------------------------------------------------------
# TreeArray streaming
# ---------------------------------------------------------------------------
def _id_vector(name: str, what: str, ids: torch.Tensor) -> None:
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: {what} must be a 1-D int32/int64 "
                         f"tensor, got {tuple(ids.shape)} {ids.dtype}")


def _int32(ids: torch.Tensor) -> torch.Tensor:
    """Contiguous int32 ids for a kernel (ids and row numbers of this
    package stay below 2^31)."""
    return ids.to(torch.int32).contiguous()


@_scoped
def tree_gather(leaves, leaf_table):
    """A TreeArray's leaves in logical order: ``leaves[leaf_table]``,
    (n, leaf) from an (NB, leaf) pool of any dtype and an (n,) table.
    ``n == 0`` gives an empty output and launches nothing."""
    name = "tree_gather"
    if leaves.dim() != 2:
        raise ValueError(f"{name}: leaves must be (NB, leaf), got "
                         f"{tuple(leaves.shape)}")
    _id_vector(name, "leaf_table", leaf_table)
    route = _route(leaves, leaf_table)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.tree_gather_ref(leaves, leaf_table)
    _need_contiguous(name, leaves=leaves)
    NB, leaf = leaves.shape
    n = leaf_table.shape[0]
    out = torch.empty((n, leaf), dtype=leaves.dtype, device=leaves.device)
    if n == 0:
        return out
    table = _int32(leaf_table)
    if route == "cuda":
        rc = _fn("tree_gather", "rt_tree_gather")(
            _ptr(leaves), _ptr(table), _ptr(out), n,
            leaf * leaves.element_size(), NB, _stream(leaves))
        _check(rc, name)
        _count("tree_gather")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.tree_gather(
            n, leaf, leaves.element_size()))
    return out


@_scoped
def tree_block_sum(leaves, leaf_table):
    """The float32 sum of each logical leaf, (n,) float32, from an
    (NB, leaf) float32 or bfloat16 pool and an (n,) table.  ``n == 0``
    gives an empty output and launches nothing."""
    name = "tree_block_sum"
    if leaves.dim() != 2:
        raise ValueError(f"{name}: leaves must be (NB, leaf), got "
                         f"{tuple(leaves.shape)}")
    _id_vector(name, "leaf_table", leaf_table)
    route = _route(leaves, leaf_table)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.tree_block_sum_ref(leaves, leaf_table)
    code = _dtype_code(name, leaves)
    _need_contiguous(name, leaves=leaves)
    NB, leaf = leaves.shape
    n = leaf_table.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=leaves.device)
    if n == 0:
        return out
    table = _int32(leaf_table)
    if route == "cuda":
        rc = _fn("tree_gather", "rt_tree_block_sum")(
            _ptr(leaves), _ptr(table), _ptr(out), n, leaf, NB, code,
            _stream(leaves))
        _check(rc, name)
        _count("tree_block_sum")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.tree_block_sum(
            n, leaf, leaves.element_size()))
    return out


@_scoped
def tree_gather_rows(pool, row_ids, leaf_table, rows_per_block: int):
    """Rows of a blocked 2-D array through the leaf table (a paged
    embedding lookup): row ``r`` is row ``r % rows_per_block`` of block
    ``leaf_table[r // rows_per_block]`` of the (NB, rows_per_block, W)
    pool.  Returns (n, W) in the pool's dtype; ``n == 0`` gives an empty
    output and launches nothing."""
    name = "tree_gather_rows"
    rpb = int(rows_per_block)
    if pool.dim() != 3 or pool.shape[1] != rpb or rpb <= 0:
        raise ValueError(f"{name}: pool must be (NB, {rpb}, W), got "
                         f"{tuple(pool.shape)}")
    _id_vector(name, "row_ids", row_ids)
    _id_vector(name, "leaf_table", leaf_table)
    route = _route(pool, row_ids, leaf_table)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.tree_gather_rows_ref(pool, row_ids, leaf_table, rpb)
    _need_contiguous(name, pool=pool)
    NB, _, W = pool.shape
    n = row_ids.shape[0]
    out = torch.empty((n, W), dtype=pool.dtype, device=pool.device)
    if n == 0:
        return out
    rows, table = _int32(row_ids), _int32(leaf_table)
    if route == "cuda":
        rc = _fn("tree_gather", "rt_tree_gather_rows")(
            _ptr(pool), _ptr(rows), _ptr(table), _ptr(out), n,
            W * pool.element_size(), rpb, table.shape[0], NB, _stream(pool))
        _check(rc, name)
        _count("tree_gather_rows")
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.tree_gather_rows(
            n, W, pool.element_size()))
    return out


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
#: CTAs an SM that the AdamW update's grid-stride loop launches at most
_ADAMW_CTAS_PER_SM = 8
_ADAMW_THREADS = 256


@_scoped
def adamw_update(p, g, m, v, scale, lr, b1c, b2c, cfg) -> None:
    """One AdamW update of one leaf, in place: ``p`` (float32 or
    bfloat16) from its gradient ``g`` (float32 or bfloat16) and its
    float32 moments ``m`` and ``v``, all of one shape; ``scale`` (the
    clip scale), ``lr`` and the bias corrections ``b1c``, ``b2c`` are
    0-d float32 tensors on the leaf's device (a captured graph reads
    their values at each replay); ``cfg`` gives ``b1``, ``b2``, ``eps``
    and ``weight_decay``.  The arithmetic is ``ref.adamw_update_ref``'s.
    A non-contiguous ``p``, ``m`` or ``v`` (a ZeRO-1 slice, say) is
    updated through a contiguous copy that is written back."""
    name = "adamw_update"
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"{name}: shapes differ: p {tuple(p.shape)} g "
                         f"{tuple(g.shape)} m {tuple(m.shape)} v "
                         f"{tuple(v.shape)}")
    for k, t in (("p", p), ("g", g)):
        _dtype_code(f"{name}: {k}", t)
    for k, t in (("m", m), ("v", v), ("scale", scale), ("lr", lr),
                 ("b1c", b1c), ("b2c", b2c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")
    for k, t in (("scale", scale), ("lr", lr), ("b1c", b1c), ("b2c", b2c)):
        if t.dim() != 0:
            raise ValueError(f"{name}: {k} must be 0-d, got "
                             f"{tuple(t.shape)}")
    route = _route(p, g, m, v, scale, lr, b1c, b2c)
    if route == "cpu":
        with _acct.kernel_scope(name, launch=True):
            return kref.adamw_update_ref(p, g, m, v, scale, lr, b1c, b2c,
                                         cfg)
    n = p.numel()
    if n == 0:
        return None
    work = [t if t.is_contiguous() else t.contiguous() for t in (p, m, v)]
    wp, wm, wv = work
    g = g.contiguous()
    # 4 elements a vector: 16 bytes of m and v, 4 * element size of p, g
    aligned = all(t.data_ptr() % (4 * t.element_size()) == 0
                  for t in (wp, g, wm, wv))
    nvec = n // 4 if aligned else 0
    per = nvec + (n - 4 * nvec)
    grid = max(1, min(-(-per // _ADAMW_THREADS),
                      _ADAMW_CTAS_PER_SM * SM_COUNT))
    if route == "cuda":
        rc = _fn("adamw", "rt_adamw_update")(
            _ptr(wp), _ptr(g), _ptr(wm), _ptr(wv), _ptr(scale), _ptr(lr),
            _ptr(b1c), _ptr(b2c), n, nvec, _DTYPES[wp.dtype],
            _DTYPES[g.dtype], float(cfg.b1), float(1 - cfg.b1),
            float(cfg.b2), float(1 - cfg.b2), float(cfg.eps),
            float(cfg.weight_decay), grid, _stream(wp))
        _check(rc, name)
        _count(name)
    if _acct._OPEN[0]:
        _acct.bill_kernel(name, _bills.adamw_update(
            n, wp.element_size(), g.element_size()))
    for t, w in zip((p, m, v), work):
        if w is not t:
            t.copy_(w)
    return None


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def thread_launch_counts() -> Dict[str, int]:
    """Launches of each kernel by this thread since its
    ``reset_thread_launch_counts`` (empty before one)."""
    return dict(getattr(_LOCAL, "counts", {}))


def reset_thread_launch_counts() -> None:
    """Start (or restart) this thread's own launch counts."""
    _LOCAL.counts = {name: 0 for name in _LAUNCHES}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the launch counters: the launches of one replay
    of a captured CUDA graph, which the wrappers counted once, at the
    capture (a negative count takes a capture's own counts back out)."""
    for name, n in counts.items():
        _LAUNCHES[name] += n
