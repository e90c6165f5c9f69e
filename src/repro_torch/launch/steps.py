"""Train, forward, serve and prefill steps, on one device or on a mesh.

Counterpart of ``repro.launch.steps``.  With ``mesh=None`` the train and
forward steps run on one card: no shardings and no donation.  With a
``Mesh`` (``launch/mesh.py``) a step is one rank's part of an SPMD
program over the mesh: the batch splits over ``("pod", "data")``, paged
pools split with the batch in dp groups, and the optimizer's moments
split over ``data`` under ZeRO-1.

The ``model`` axis (above 1) runs every family's train, forward, serve
and prefill steps -- the decoder LMs (the image-prefixed InternVL2
among them), the encoder-decoder Whisper and the constant-state
families (Mamba2, RWKV6, the Zamba2 hybrid) -- as explicit Megatron
tensor parallelism (over the SSM heads for a recurrent mixer; Mamba2's
serve and prefill steps refuse a ``Mamba2State``, as the reference's
``state_shardings`` does): a rank holds the pieces of the weights that
``param_placements`` gives it (``shard_params``: views for serving, so
thread ranks on one card share one copy of the weights; tensors of its
own for training, which writes them in place) and the KV heads its
query heads read (``shard_state``: the pools, tables and lengths as
tensors of its own; Whisper's cross K/V by the same heads); the models
write out the sums over ``model`` that GSPMD inserts in the reference
(``launch/shardings.py``, each with its adjoint as its backward pass),
the MoE feed-forward goes tensor- or expert-parallel
(``models/moe_sharded.py``), and the prompt's attention goes context-
parallel where the heads do not divide the axis.  A recurrent mixer's
leaves replicate where its heads do not divide the axis.  The train and
forward steps take the default rules, so the residual stream is in
sequence pieces (the reference's sequence parallelism: Whisper's
encoder frames and decoder tokens, an image-prefixed I + S stream, each
split where the axis divides it; ``rules={"seq": None}`` gives plain
Megatron); the serve and prefill steps run with ``seq`` None.  Logits
come back as this rank's rows and vocabulary piece; ``gather_logits``
gives the global (B, V).  An MLA model under ``mla_latent_tp`` serves
and prefills from the split latent pool in the layout of
``latent_layout`` (its lora stream split on its lanes, every head on
every rank), and training over ``model`` on thread ranks that share a
card raises ``RuntimeError`` (one autograd device thread:
``launch.mesh.spawn_ranks`` runs ranks as processes).

Placements come from the reference's rules, as plain ``PartitionSpec``
tuples (``rules_for``, ``batch_shardings``, ``paged_cache_shardings``,
``state_shardings``, ``opt_shardings``, ``param_shardings``,
``param_placements``), and a rank holds the piece of each tensor they
select (``shard_batch``, ``shard_params``, ``shard_state``,
``init_opt_state``); ``gather_rows``, ``gather_logits``,
``gather_params`` and ``gather_opt_state`` put wholes back together.

A train step is the reference's ``jax.value_and_grad(model.loss)`` then
``adamw.apply_updates``: the numpy batch moves to the device, the
parameter leaves are marked ``requires_grad`` for the step,
``loss.backward()`` fills their ``.grad``, AdamW updates them in place
under ``no_grad`` (one ``ops.adamw_update`` launch a leaf on the card),
and the ``.grad`` are dropped again.  On one card that whole step is
captured into one CUDA graph by default and replayed
(``train/step_graph.py``: the counterpart of the reference's jitted,
donated step; ``graph=False`` runs it eagerly, as the CPU and every
mesh step do).  Every op of the loss has a deterministic CUDA backward
pass (the embedding and target gathers are indexing whose CUDA backward
sorts its indices, the stacked layers are split by ``unbind``), so equal
inputs give equal bits and a resumed run equals the uninterrupted one.

On a mesh the train step keeps the reference's global meaning: under
GSPMD ``chunked_lm_loss`` averages over the whole batch, so each rank
weights its loss by its share of the global target count (rows may hold
different numbers of masked targets), and an MoE model's router aux
loss is the mean of the shards' (``models/moe_sharded.py``): each rank's
aux term enters with weight 1/n.  Every model rank of a data shard
computes that shard's whole loss, so each takes 1/tp of it: the ranks'
objectives SUM to the reference's loss.  The objective is formed outside
autograd from all-reduced counts.  The model axis's collectives run
inside the forward and backward passes, each backward pass the adjoint
of its forward (``launch/shardings.py``), so every rank's gradient of a
parameter piece is its share, and the step sums the shares of the ranks
that hold the same piece (``_sum_grads``): over the batch axes for every
leaf, over ``model`` too for a leaf replicated there (among them the
per-head vectors a rank uses only its heads' entries of: Mamba2's
``A_log``, ``dt_bias``, ``D``, RWKV6's ``w0``, ``u``, ``ln_x``, Zamba2's
``lora_b``) and for the whole parts of a ``Packed`` one, and over the
ranks that read one KV head for a ``Shared`` one -- one all-reduce per
dtype and axis set, the ``Shared`` and ``Packed`` leaves one each.  The
clip norm counts each piece once (``grad_norm``).  ZeRO-1 then updates each rank's slice
of the moments and of its parameter pieces (the first replicated,
data-divisible dim of each leaf, ``opt_shardings``) and all-gathers the
pieces over ``data``: the same arithmetic per element as the plain
update, so the two agree bit for bit.

The serve and prefill steps run the model's ``decode_step`` / ``prefill``
under ``torch.no_grad()`` on this rank's rows and its group's pool
range, whose group-local table ids are already pool ids there: every
kernel the one-device path launches (#1, #2, #7) runs on every rank,
over that rank's heads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.device import resolve_or_meta
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.models.rwkv_lm import RWKVState
from repro_torch.models.whisper import WhisperState
from repro_torch.models.zamba2 import ZambaState
from repro_torch.optim import adamw as OPT
from repro_torch.train.step_graph import TrainStepGraphs
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

#: why a train step refuses thread ranks on one card
THREAD_RANKS = ("training over a model axis on thread ranks that share a "
                "card: they share its autograd device thread, where a "
                "collective in one rank's backward pass would wait on a "
                "peer queued behind it; run the ranks as processes "
                "(launch.mesh.spawn_ranks, or torchrun with --device "
                "cuda:0)")


@dataclasses.dataclass
class Step:
    """A step function bound to its device: ``step(*args)``.  A mesh
    step also carries its mesh, rules, the placements of its parameters
    (and optimizer state: ``in_shardings``) and the global sizes of the
    logical axes that ``constrain`` checks (``sizes``); a one-device
    train step its ``TrainStepGraphs`` (``graphs``, read by
    ``stats()``)."""
    fn: Callable
    device: torch.device
    mesh: Optional[Mesh] = None
    rules: Optional[Dict[str, Any]] = None
    in_shardings: Any = None
    sizes: Optional[Dict[str, int]] = None
    graphs: Optional[TrainStepGraphs] = None

    def stats(self) -> Dict[str, object]:
        """A one-device train step's captures, recaptures, replays, eager
        steps and graph pool bytes (``TrainStepGraphs.stats``)."""
        if self.graphs is None:
            raise ValueError("only a one-device train step keeps stats")
        return self.graphs.stats()

    def __call__(self, *args, **kw):
        if self.mesh is None:
            return self.fn(*args, **kw)
        with SH.use_rules(self.mesh, self.rules, self.sizes):
            return self.fn(*args, **kw)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The pipeline's numpy batch as tensors on ``device`` (tensors, the
    dry run's meta batch among them, are moved as they are)."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# placements (the reference's rules, as PartitionSpec tuples)
# ---------------------------------------------------------------------------
def rules_for(cfg: ModelConfig, mesh: Mesh,
              overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Arch-aware rules: attention weights replicate when the heads do
    not divide the model axis, and the vocabulary when it does not."""
    rules: Dict[str, Any] = {}
    tp = mesh.shape.get("model", 1)
    if tp > 1 and cfg.num_heads % tp != 0:
        rules["attn_heads"] = None
    if tp > 1 and cfg.vocab_size % tp != 0:
        rules["vocab"] = None
    if overrides:
        rules.update(overrides)
    return rules


def _tp(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def kv_head_entry(cfg: ModelConfig, mesh: Mesh,
                  rules: Optional[Dict[str, Any]] = None):
    """The placement entry of the KV-head dimension (of ``wk``/``wv``
    columns, in head_dim pieces, and of a GQA pool) on a model axis
    above 1: whole where the attention weights replicate, ``"model"``
    where the KV heads divide the axis, else ``Shared("model", KVH)``:
    each rank holds the KV head its query heads read.  A layout whose
    ranks would read a fraction of a KV head's query group raises."""
    tp = _tp(mesh)
    if rules_for(cfg, mesh, rules).get("attn_heads", "model") is None:
        return None
    H, kvh = cfg.num_heads, cfg.kv_heads
    if kvh % tp == 0:
        return "model"
    if (H // kvh) % (H // tp):
        raise ValueError(
            f"{cfg.name}: {H} query heads over {kvh} KV heads on a model "
            f"axis of {tp}: a rank's {H // tp} query heads would read a "
            f"fraction of a KV head's group of {H // kvh}")
    return SH.Shared("model", kvh)


def _replicate_undivided(mesh: Mesh, spec: Tuple, shape) -> Tuple:
    """``spec`` with every entry whose axes do not divide its dimension
    replaced by None (replicated)."""
    return tuple(None if e is not None and n % mesh.axis_size(e) else e
                 for e, n in zip(spec, shape))


def _ssm_heads(cfg: ModelConfig) -> int:
    """The heads of a recurrent mixer: Mamba2's SSD heads, RWKV6's."""
    s = cfg.ssm
    if s.kind == "mamba2":
        return s.expand * cfg.d_model // s.head_dim
    return cfg.num_heads


def _mamba_packed(cfg: ModelConfig) -> Dict[str, SH.Packed]:
    """The ``Packed`` entries of a Mamba2 mixer's packed dimensions:
    ``in_proj``'s columns ``[z | x | B | C | dt]`` and the conv's
    channels ``[x | B | C]`` (its weights, bias and state), each rank
    holding its heads' ``z``, ``x`` and ``dt`` and ``B``, ``C`` whole."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    xbc = ((di, True), (2 * s.state_dim, False))
    return {"in_proj": SH.Packed("model", ((di, True),) + xbc
                                 + ((di // s.head_dim, True),)),
            "conv_w": SH.Packed("model", xbc),
            "conv_b": SH.Packed("model", xbc)}


def param_placements(model, mesh: Mesh,
                     rules: Optional[Dict[str, Any]] = None):
    """Each parameter's placement as a rank of this package holds it:
    ``param_shardings`` of the model's logical axes under ``rules_for``,
    and, on a model axis above 1, five differences of contract
    (ROADMAP.md §3): a dimension its axes do not divide is
    replicated (the reference's jit refuses it); ``wk``/``wv`` take
    ``kv_head_entry`` (the reference cuts their columns over ``model``
    even through a head); under ``moe.parallel_mode == "ep"`` the
    experts' stacked leaves go ``(None, "model", None, None)``, as
    ``_moe_ep_shardmap``'s ``wspec`` places them inside its shard_map
    (the reference keeps the ``heads`` placement outside it); a
    recurrent mixer's leaves (Mamba2's, RWKV6's time mix) replicate
    where its heads do not divide the axis; Mamba2's packed dimensions
    take ``_mamba_packed``'s entries (the reference cuts them evenly,
    across their parts)."""
    cfg = model.cfg
    rules = rules_for(cfg, mesh, rules)
    shapes, axes = model.param_specs()
    pshard = SH.param_shardings(axes, mesh, rules)
    if _tp(mesh) == 1:
        return pshard
    ep = cfg.moe is not None and cfg.moe.parallel_mode == "ep"
    kv = kv_head_entry(cfg, mesh, rules) if cfg.attention == "gqa" else None
    whole_mixer = cfg.ssm is not None and _ssm_heads(cfg) % _tp(mesh) != 0
    packed = (_mamba_packed(cfg) if cfg.ssm is not None
              and cfg.ssm.kind == "mamba2" else {})

    def walk(spec, shape, parent_keys, key):
        if isinstance(spec, dict):
            return {k: walk(spec[k], shape[k], set(spec), k) for k in spec}
        if parent_keys & {"A_log", "decay_w1"}:         # a mixer's leaf
            if whole_mixer:
                return (None,) * len(spec)
            if key in packed and spec[-1] is not None:
                return spec[:-1] + (packed[key],)
        spec = _replicate_undivided(mesh, spec, shape.shape)
        if kv is not None and key in ("wk", "wv") and "wq" in parent_keys \
                and spec[-1] is not None:
            spec = spec[:-1] + (kv,)
        if ep and key in ("wi", "wg", "wo") and "router" in parent_keys:
            if cfg.moe.num_experts % _tp(mesh):
                raise ValueError(f"{cfg.name}: {cfg.moe.num_experts} "
                                 f"experts do not split over a model axis "
                                 f"of {_tp(mesh)} (ep)")
            spec = (None,) * (len(spec) - 3) + ("model", None, None)
        return spec

    return walk(pshard, shapes, set(), None)


def _div(n: int, mesh: Mesh, axes: Tuple[str, ...]) -> bool:
    prod = mesh.axis_size(axes) if axes else 1
    return n % prod == 0 and n >= prod


def dp_groups_for(mesh: Mesh, global_batch: int) -> int:
    """Pool groups for a batch: the batch shards when they divide it."""
    prod = mesh.axis_size(batch_axes(mesh))
    return prod if global_batch % prod == 0 and global_batch >= prod else 1


def batch_shardings(mesh: Mesh, batch_specs: Dict[str, Any],
                    global_batch: int) -> Dict[str, Tuple]:
    """Each batch leaf's placement: rows over the batch axes when they
    divide ``global_batch``, else replicated."""
    bax = batch_axes(mesh)
    b = bax if _div(global_batch, mesh, bax) else None
    return {k: SH.normalize((b,) + (None,) * (len(v.shape) - 1))
            for k, v in batch_specs.items()}


def _kv_head_axis(mesh: Mesh, kvh: int) -> Optional[str]:
    return "model" if ("model" in mesh.axis_names and kvh >= mesh.shape["model"]
                       and kvh % mesh.shape["model"] == 0) else None


def paged_cache_shardings(mesh: Mesh, cache: PagedKVCache,
                          model_cfg: Optional[ModelConfig] = None
                          ) -> PagedKVCache:
    """A ``PagedKVCache`` of placements: pools split on their block dim
    and tables/lengths on their rows when the cache has dp groups and
    the batch axes divide its rows.  A split latent pool's lora stream
    goes over ``model`` on its last dim where its width divides the axis
    (the reference's ``paged_cache_shardings``), its rope stream whole;
    a one-stream latent pool is whole.  A GQA pool's KV heads go as the
    reference's ``_kv_head_axis`` puts them; given the model's config on
    a model axis above 1, as its ``wk`` columns go (``kv_head_entry``),
    so that each rank holds the KV heads its query heads read."""
    cfg = cache.config
    bax = batch_axes(mesh)
    B = cache.block_tables.shape[0]
    b = SH.normalize([bax if (cfg.dp_groups > 1 and _div(B, mesh, bax))
                      else None])[0]
    if cfg.latent and cfg.latent_rope:
        # the reference's latent TP: the lora stream split over 'model'
        # on its lanes where they divide it, the rope stream whole
        la = ("model" if "model" in mesh.axis_names
              and cfg.head_dim % mesh.shape["model"] == 0 else None)
        kpool, vpool = (None, b, None, la), (None, b, None, None)
    elif cfg.latent:
        kpool, vpool = (None, b, None, None), None
    else:
        ha = (kv_head_entry(model_cfg, mesh)
              if model_cfg is not None and _tp(mesh) > 1
              else _kv_head_axis(mesh, cfg.kv_heads))
        kpool = (None, b, None, ha, None)
        vpool = kpool
    return PagedKVCache(k_pool=kpool, v_pool=vpool, block_tables=(b, None),
                        seq_lens=(b,), config=cfg)


def state_shardings(mesh: Mesh, state, cfg: ModelConfig):
    """Placements of a decode state, of the state's own type: a
    ``PagedKVCache`` (its KV heads as ``paged_cache_shardings`` places
    them for ``cfg``), an ``RWKVState`` (the wkv state by heads, the
    shift vectors whole), a ``ZambaState`` or a ``WhisperState``
    (Mamba2's raises ``TypeError``, as in the reference).  On a model
    axis above 1 a ``ZambaState``'s conv state holds this rank's
    channels (``_mamba_packed``; the reference replicates it) and its
    pool the KV heads its query heads read; a ``WhisperState``'s
    self-attention pool and cross K/V hold the KV heads of the rank's
    ``wk`` columns (``kv_head_entry``: whole where the heads do not
    divide the axis)."""
    bax = batch_axes(mesh)
    if isinstance(state, PagedKVCache):
        return paged_cache_shardings(mesh, state, cfg)
    if isinstance(state, RWKVState):
        b = SH.normalize([bax if _div(state.mix_x.shape[1], mesh, bax)
                          else None])[0]
        ha = _kv_head_axis(mesh, state.wkv.shape[2])
        return RWKVState((None, b, None), (None, b, None),
                         (None, b, ha, None, None))
    if isinstance(state, ZambaState):
        b = SH.normalize([bax if _div(state.conv.shape[2], mesh, bax)
                          else None])[0]
        ha = _kv_head_axis(mesh, state.ssd.shape[3])
        tp = _tp(mesh) > 1
        conv = _mamba_packed(cfg)["conv_b"] if tp and ha else None
        return ZambaState((None, None, b, None, conv),
                          (None, None, b, ha, None, None),
                          paged_cache_shardings(mesh, state.kv,
                                                cfg if tp else None))
    if isinstance(state, WhisperState):
        b = SH.normalize([bax if _div(state.cross_k.shape[1], mesh, bax)
                          else None])[0]
        tp = _tp(mesh) > 1
        ha = (kv_head_entry(cfg, mesh) if tp
              else _kv_head_axis(mesh, state.cross_k.shape[3]))
        cross = (None, b, None, ha, None)
        return WhisperState(paged_cache_shardings(mesh, state.self_kv,
                                                  cfg if tp else None),
                            cross, cross)
    raise TypeError(type(state))


def _walk2(fn, a, b):
    """``fn`` over the leaves of two dict trees of one structure."""
    if isinstance(a, dict):
        return {k: _walk2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def opt_shardings(mesh: Mesh, param_shard, param_shapes,
                  zero1: bool = False) -> OPT.AdamWState:
    """Moments placed like the parameters; ZeRO-1 also splits the first
    replicated, data-divisible dim of each moment over ``data``."""

    def moment(spec, shape):
        spec = list(spec) + [None] * (len(shape.shape) - len(spec))
        if zero1 and "data" in mesh.axis_names:
            n = mesh.shape["data"]
            for i, (s, dim) in enumerate(zip(spec, shape.shape)):
                if s is None and dim % n == 0 and dim >= n:
                    spec[i] = "data"
                    break
        return tuple(spec)

    mu = _walk2(moment, param_shard, param_shapes)
    return OPT.AdamWState(step=(), mu=mu, nu=mu)


# ---------------------------------------------------------------------------
# a rank's pieces
# ---------------------------------------------------------------------------
def shard_rows(mesh: Mesh, x, spec: Tuple):
    """This rank's piece of ``x`` (a tensor or numpy array) under a row
    placement ``spec``."""
    if isinstance(x, torch.Tensor):
        return SH.local_piece(mesh, x, spec)
    return SH.local_piece(mesh, torch.as_tensor(np.asarray(x)),
                          spec).numpy()


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (``batch_shardings``)."""
    B = next(iter(batch.values())).shape[0]
    specs = batch_shardings(mesh, batch, B)
    return {k: shard_rows(mesh, v, specs[k]) for k, v in batch.items()}


def shard_params(mesh: Mesh, params, pshard, *, copy: bool = False):
    """This rank's pieces of whole parameters under ``pshard``
    (``param_placements``): views, so ranks that share a card share one
    copy of the weights (a ``Packed`` leaf's piece, its parts' pieces
    concatenated, is a tensor of the rank's own); with ``copy`` (a train
    step's parameters, which AdamW writes in place and autograd takes as
    leaves) contiguous tensors of the rank's own."""
    if copy:
        return _walk2(lambda t, s: SH.local_piece(mesh, t, s).clone(
            memory_format=torch.contiguous_format), params, pshard)
    return _walk2(lambda t, s: SH.local_piece(mesh, t, s), params, pshard)


def gather_params(mesh: Mesh, params, pshard):
    """Whole parameters from every rank's pieces (a collective)."""
    return _walk2(lambda t, s: SH.gather_piece(mesh, t, s), params, pshard)


def _local_cache(mesh: Mesh, cache: PagedKVCache, spec: PagedKVCache
                 ) -> PagedKVCache:
    cfg = cache.config
    n = (mesh.axis_size(spec.seq_lens[0]) if spec.seq_lens[0] is not None
         else 1)
    if cfg.dp_groups % n:
        raise ValueError(f"{cfg.dp_groups} pool groups do not split over "
                         f"{n} ranks")
    # on a model axis the ranks of a row group would share one view of
    # its pools, tables and lengths, and each appends to the pools and
    # advances the lengths: each gets tensors of its own
    own = ((lambda t: t.clone(memory_format=torch.contiguous_format))
           if _tp(mesh) > 1 else (lambda t: t))
    k = own(SH.local_piece(mesh, cache.k_pool, spec.k_pool))
    local_cfg = dataclasses.replace(
        cfg, num_blocks=cfg.num_blocks // n, dp_groups=cfg.dp_groups // n,
        kv_heads=cfg.kv_heads if cfg.latent else k.shape[-2],
        head_dim=k.shape[-1])
    return PagedKVCache(
        k, (None if cache.v_pool is None
            else own(SH.local_piece(mesh, cache.v_pool, spec.v_pool))),
        own(SH.local_piece(mesh, cache.block_tables, spec.block_tables)),
        own(SH.local_piece(mesh, cache.seq_lens, spec.seq_lens)), local_cfg)


def shard_state(mesh: Mesh, state, cfg: ModelConfig):
    """This rank's piece of a global decode state (``state_shardings``):
    views of the state's tensors; a paged cache's piece holds its
    groups' pool range, rows and group-local tables, and on a model axis
    above 1 the KV heads this rank's query heads read, all as tensors
    of its own (contiguous copies: the kernels write the pools in
    place)."""
    spec = state_shardings(mesh, state, cfg)
    if isinstance(state, PagedKVCache):
        return _local_cache(mesh, state, spec)
    if isinstance(state, ZambaState):
        return ZambaState(SH.local_piece(mesh, state.conv, spec.conv),
                          SH.local_piece(mesh, state.ssd, spec.ssd),
                          _local_cache(mesh, state.kv, spec.kv))
    if isinstance(state, WhisperState):
        return WhisperState(
            _local_cache(mesh, state.self_kv, spec.self_kv),
            SH.local_piece(mesh, state.cross_k, spec.cross_k),
            SH.local_piece(mesh, state.cross_v, spec.cross_v))
    return RWKVState(*(SH.local_piece(mesh, getattr(state, f), getattr(
        spec, f)) for f in ("mix_x", "ffn_x", "wkv")))


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global rows of a per-rank output (logits (B/n, V) -> (B, V)):
    an all-gather over the batch axes, in their row-major order."""
    bax = batch_axes(mesh)
    if mesh.axis_size(bax) == 1:
        return x
    return torch.cat(list(mesh.all_gather(x.contiguous(), bax).unbind(0)))


def gather_logits(mesh: Mesh, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """The global (B, ``vocab``) logits from every rank's piece: the
    vocabulary pieces all-gathered over ``model`` (skipped where ``x``
    already holds all ``vocab`` ids, a replicated vocabulary), then the
    rows over the batch axes (``gather_rows``)."""
    if _tp(mesh) > 1 and x.shape[-1] != vocab:
        with torch.no_grad():
            x = SH.gather_model(x, -1, mesh)
    return gather_rows(mesh, x)


def broadcast_params(mesh: Mesh, params):
    """The first data-parallel rank's parameter pieces on every rank of
    its batch-axes group, in place (model ranks hold different pieces);
    returns ``params``."""
    for t in tree_leaves(params):
        mesh.broadcast(t, batch_axes(mesh), src=0)
    return params


def gather_opt_state(mesh: Mesh, state: OPT.AdamWState,
                     oshard: OPT.AdamWState) -> OPT.AdamWState:
    """Whole moments from every rank's slices (a collective)."""
    glue = (lambda t, s: SH.gather_piece(mesh, t, s))
    return OPT.AdamWState(state.step, _walk2(glue, state.mu, oshard.mu),
                          _walk2(glue, state.nu, oshard.nu))


def _data_only(spec: Tuple) -> Tuple:
    """A placement's entries over the batch axes (ZeRO-1's slices of a
    model piece), the rest replicated."""
    def keep(e):
        axes = SH._entry_axes(e)
        return e if axes and not isinstance(e, SH.Shared) and \
            "model" not in axes else None
    return tuple(keep(e) for e in spec)


def init_opt_state(mesh: Mesh, params, oshard: OPT.AdamWState
                   ) -> OPT.AdamWState:
    """Zero moments as this rank holds them under ``oshard``, for
    ``params`` as this rank holds them (its model pieces)."""
    state = OPT.init_state(params)
    cut = (lambda t, s: SH.local_piece(mesh, t, _data_only(s)).contiguous())
    return OPT.AdamWState(state.step, _walk2(cut, state.mu, oshard.mu),
                          _walk2(cut, state.nu, oshard.nu))


# ---------------------------------------------------------------------------
# the mesh's share of the global loss
# ---------------------------------------------------------------------------
def _train_setup(model, mesh: Mesh, rules: Optional[Dict[str, Any]]):
    """(rules, parameter placements) of a mesh train or forward step,
    after its checks: ``rules_for`` with the default ``seq`` rule
    (sequence parallelism on a model axis above 1)."""
    merged = rules_for(model.cfg, mesh, rules)
    if _tp(mesh) > 1 and mesh.threads_share_card:
        raise RuntimeError(f"mesh {mesh.shape}: {THREAD_RANKS}")
    return merged, param_placements(model, mesh, merged)


def _seq_sizes(mesh: Mesh, batch) -> Optional[Dict[str, int]]:
    """The global sizes ``constrain`` checks a train or forward step's
    activations against, on a model axis above 1: the decoder's
    sequence (an image prefix's I + S), and an encoder's frames."""
    if _tp(mesh) == 1:
        return None
    S = batch["tokens"].shape[1]
    if "image_embeds" in batch:
        S += batch["image_embeds"].shape[1]
    sizes = {"seq": int(S)}
    if "frames" in batch:
        sizes["frames"] = int(batch["frames"].shape[1])
    return sizes


def _serve_rules(model, mesh: Mesh, rules: Optional[Dict[str, Any]]
                 ) -> Dict[str, Any]:
    """The serve and prefill steps' rules: ``rules_for``, and on a model
    axis above 1 the ``seq`` rule off whatever ``rules`` say (the
    residual stream stays whole on every model rank: a decode step holds
    one token a row, and the pools take whole prompts), and under the
    split latent pool's layout (``latent_layout``) the heads whole."""
    merged = rules_for(model.cfg, mesh, rules)
    if _tp(mesh) == 1:
        return merged
    merged["seq"] = None
    if latent_tp(model.cfg, mesh):
        merged["attn_heads"] = None
    return merged


def latent_tp(cfg: ModelConfig, mesh: Mesh) -> bool:
    """Whether a serve or prefill step on ``mesh`` takes the split
    latent pool's layout: an MLA model under ``mla_latent_tp`` on a
    model axis above 1."""
    return (cfg.attention == "mla" and bool(cfg.mla_latent_tp)
            and _tp(mesh) > 1)


def latent_layout(pshard, cfg: ModelConfig, mesh: Mesh):
    """The split latent pool's parameter layout, a difference of
    contract (ROADMAP.md §3): the reference keeps ``wk_b`` and ``wv_b``
    on ``(None, "attn_heads")`` and lets GSPMD reshard them against a
    pool split on its lora lanes, which explicit SPMD cannot do.  Here
    every rank holds every head (the serve rules replicate the attention
    weights) and ``wk_b`` and ``wv_b`` split on their lora rows where
    ``kv_lora_rank`` divides the axis, as the pool's lora stream does:
    a rank's ``q_lat`` is its lora piece, the partial scores are summed
    in one all-reduce, and the un-absorbed output is a row-parallel sum
    in float32, rounded once.  Where the lanes do not divide the axis,
    the stream and the weights stay whole.  The train and forward steps
    keep the Megatron layout: training writes no pool."""
    if cfg.mla.kv_lora_rank % _tp(mesh):
        return pshard

    def walk(spec, key):
        if isinstance(spec, dict):
            return {k: walk(v, k) for k, v in spec.items()}
        if key in ("wk_b", "wv_b"):
            return (None,) * (len(spec) - 2) + ("model", None)
        return spec

    return walk(pshard, None)


def _serve_sizes(model, state_example) -> Dict[str, int]:
    """The global sizes ``constrain`` checks a serve step's activations
    against."""
    cfg = model.cfg
    sizes = {"vocab": cfg.vocab_size, "attn_heads": cfg.num_heads}
    if state_example is not None:
        sizes["batch"] = _state_rows(state_example)
    return sizes


def _aux_term(model, mets) -> Optional[torch.Tensor]:
    """The router aux part of an MoE model's loss (the reference's
    ``router_aux_coef * aux / n_scan``); None for other models."""
    if not getattr(model, "is_moe", False):
        return None
    return model.cfg.moe.router_aux_coef * mets["aux"] / max(1, model.n_scan)


def _objective(model, mesh: Mesh, loss, mets, targets: torch.Tensor):
    """This rank's share of the global loss: its mean NLL weighted by
    its share of the global target count, plus its aux term over the
    number of shards, all over the model axis's size (every model rank
    of a shard holds the same loss).  The shares sum over the mesh to
    the reference's loss over the whole batch, and their gradients to
    its gradient."""
    bax = batch_axes(mesh)
    cnt = (targets >= 0).sum().to(torch.float32).reshape(1)
    total = mesh.all_reduce(cnt.clone(), bax)
    w = (cnt / total.clamp(min=1.0))[0]
    aux = _aux_term(model, mets)
    obj = loss * w if aux is None else \
        (loss - aux) * w + aux / mesh.axis_size(bax)
    return obj / _tp(mesh) if _tp(mesh) > 1 else obj


def _share_axes(mesh: Mesh, spec: Tuple) -> Tuple[str, ...]:
    """The axes over which the ranks' gradient shares of a leaf placed
    by ``spec`` are summed: the batch axes, and ``model`` where the
    leaf is replicated over it (a ``Shared`` leaf's model sum is
    ``_sum_shared``'s)."""
    bax = batch_axes(mesh)
    if _tp(mesh) == 1 or SH.model_split(spec) or SH.shared_entry(spec):
        return bax
    return bax + ("model",)


def _sum_shared(mesh: Mesh, g: torch.Tensor, spec: Tuple) -> None:
    """A ``Shared`` leaf's shares summed over the model ranks that hold
    the same piece, in place: each rank writes its piece into a zero
    whole, the wholes are summed over ``model``, each takes its piece
    back."""
    dim, entry = SH.shared_entry(spec)
    m = mesh.shape["model"]
    j = mesh.axis_index("model") * entry.n // m
    k = g.shape[dim]
    whole = g.new_zeros(g.shape[:dim] + (k * entry.n,) + g.shape[dim + 1:])
    whole.narrow(dim, j * k, k).copy_(g)
    mesh.all_reduce(whole, "model")
    g.copy_(whole.narrow(dim, j * k, k))


def _sum_packed(mesh: Mesh, g: torch.Tensor, spec: Tuple) -> None:
    """A ``Packed`` leaf's whole parts' shares summed over ``model``, in
    place (its split parts are each rank's own)."""
    dim, entry = SH.packed_entry(spec)
    spans = [(lo, n) for lo, n, split in
             entry.piece_spans(mesh.shape["model"]) if not split]
    buf = torch.cat([g.narrow(dim, lo, n) for lo, n in spans], dim=dim)
    mesh.all_reduce(buf, "model")
    off = 0
    for lo, n in spans:
        g.narrow(dim, lo, n).copy_(buf.narrow(dim, off, n))
        off += n


def _sum_grads(mesh: Mesh, grads, pshard, *, batch: bool = True):
    """Every gradient leaf's shares summed, in place (see the module
    docstring): one all-reduce per dtype and axis set over the leaves
    flattened into one buffer, then one per ``Shared`` leaf.  ``batch``
    False sums over ``model`` only (the int8 step syncs the batch axes
    itself)."""
    bax = batch_axes(mesh)
    groups: Dict[Tuple, list] = {}
    shared = []
    for g, spec in zip(tree_leaves(grads), SH.spec_leaves(pshard)):
        axes = _share_axes(mesh, spec)
        if not batch:
            axes = tuple(a for a in axes if a not in bax)
        if SH.shared_entry(spec) or SH.packed_entry(spec):
            shared.append((g, spec))
        if axes and mesh.axis_size(axes) > 1:
            groups.setdefault((g.dtype, axes), []).append(g)
    for (_, axes), gs in groups.items():
        buf = torch.cat([g.reshape(-1) for g in gs])
        mesh.all_reduce(buf, axes)
        off = 0
        for g in gs:
            g.copy_(buf[off:off + g.numel()].view_as(g))
            off += g.numel()
    for g, spec in shared:
        if SH.packed_entry(spec):
            _sum_packed(mesh, g, spec)
        else:
            _sum_shared(mesh, g, spec)
    return grads


def grad_norm(mesh: Mesh, grads, pshard) -> torch.Tensor:
    """The global norm of the summed gradient, each piece counted once:
    the squares of the pieces split over ``model`` (a ``Shared`` piece
    weighted by the share of the ranks holding it; a ``Packed`` one's
    split parts) summed over ``model``, plus the squares of the
    replicated leaves and of the ``Packed`` ones' whole parts.  Equal
    bits on every rank."""
    if _tp(mesh) == 1:
        return OPT.global_norm(grads)
    m = mesh.shape["model"]
    dev = mesh.device
    split = torch.zeros((), dtype=torch.float32, device=dev)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    for g, spec in zip(tree_leaves(grads), SH.spec_leaves(pshard)):
        pk = SH.packed_entry(spec)
        if pk:
            for lo, n, cut in pk[1].piece_spans(m):
                sq = OPT.sum_squares(g.narrow(pk[0], lo, n))
                if cut:
                    split = split + sq
                else:
                    whole = whole + sq
            continue
        sq = OPT.sum_squares(g)
        sh = SH.shared_entry(spec)
        if sh:
            split = split + sq * (sh[1].n / m)
        elif SH.model_split(spec):
            split = split + sq
        else:
            whole = whole + sq
    split = mesh.all_reduce(split.reshape(1), "model")[0]
    return (split + whole).sqrt()


def _metrics(model, mesh: Mesh, objective, mets):
    """The global loss (the shares summed) and, for MoE, the shards'
    mean aux."""
    bax = batch_axes(mesh)
    every = bax + ("model",) if _tp(mesh) > 1 else bax
    loss = mesh.all_reduce(objective.detach().reshape(1).clone(), every)[0]
    out = {"nll": loss}
    if "aux" in mets:
        aux = mets["aux"].detach()
        if _aux_term(model, mets) is not None:
            aux = mesh.all_reduce(aux.reshape(1).clone(), bax)[0] / \
                mesh.axis_size(bax)
        out["aux"] = aux
    return loss, out


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def _grads_of(params, loss_fn):
    """(loss_fn()'s outputs, the gradient tree of ``params``): leaves
    marked for the call, ``.grad`` dropped after."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        out = loss_fn()
        out[0].backward()
        grads = tree_map(lambda t: t.grad if t.grad is not None
                         else torch.zeros_like(t), params)
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
    return out, grads


def _zero1_update(mesh: Mesh, opt_cfg, params, grads, opt_state,
                  oshard: OPT.AdamWState, gnorm: torch.Tensor):
    """ZeRO-1: the AdamW update of this rank's slices of its pieces (the
    norm ``gnorm`` from the whole gradient), then the pieces
    all-gathered over ``data``."""
    specs = [_data_only(s) for s in SH.spec_leaves(oshard.mu)]
    p_all, g_all = tree_leaves(params), tree_leaves(grads)
    p_sl = [SH.local_piece(mesh, p, s) for p, s in zip(p_all, specs)]
    g_sl = [SH.local_piece(mesh, g, s) for g, s in zip(g_all, specs)]
    _, new_state, om = OPT.apply_updates(
        opt_cfg, p_sl, g_sl,
        OPT.AdamWState(opt_state.step, tree_leaves(opt_state.mu),
                       tree_leaves(opt_state.nu)), gnorm=gnorm)
    with torch.no_grad():
        for p, piece, s in zip(p_all, p_sl, specs):
            if SH.is_split(mesh, s):
                p.copy_(SH.gather_piece(mesh, piece.contiguous(), s))
    return params, OPT.AdamWState(new_state.step, opt_state.mu,
                                  opt_state.nu), om


#: why a mesh train step is not captured
MESH_GRAPH = ("a mesh train step is not captured into a CUDA graph: gloo "
              "stages every collective through the host, which a graph "
              "cannot hold (capturing the NCCL mesh step is a sub-item of "
              "ROADMAP.md queue 1 item 1); pass graph=None or False")


def build_train_step(model, opt_cfg: OPT.AdamWConfig, *, remat: bool = True,
                     device="cuda", mesh: Optional[Mesh] = None,
                     zero1: bool = False,
                     rules: Optional[Dict[str, Any]] = None,
                     graph: Optional[bool] = None) -> Step:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    params, moments and the step counter updated in place; metrics hold
    the loss's metrics, ``grad_norm``, ``lr`` and ``loss`` as 0-d device
    tensors.

    ``graph``: capture the one-device step into a CUDA graph and replay
    it (``train/step_graph.py``).  None (the default) captures on a CUDA
    device and runs eagerly on the CPU and on meta; True on the CPU, on
    meta or with ``mesh``, raises.  ``device="meta"`` (or a
    ``placeholder_mesh``) runs the step on meta tensors: the dry run's
    step, recorded by ``repro_torch.cost`` (as are the forward, serve and
    prefill steps there).

    With ``mesh``: ``params`` are this rank's pieces (``shard_params``
    with ``copy=True`` under the step's ``in_shardings[0]``; whole on a
    model axis of 1), ``batch`` is this rank's rows (``shard_batch``),
    ``opt_state`` this rank's moments (``init_opt_state`` with
    ``in_shardings[1]``; slices under ``zero1``), and the loss is the
    global one."""
    if mesh is None:
        if zero1:
            raise ValueError("zero1 shards the moments over a mesh's data "
                             "axis: pass mesh=")
        return _one_device_train_step(model, opt_cfg, remat, device, graph)
    if graph:
        raise ValueError(MESH_GRAPH)
    dev = mesh.device
    rules, pshard = _train_setup(model, mesh, rules)
    pshapes, _ = model.param_specs()
    oshard = opt_shardings(mesh, pshard, pshapes, zero1=zero1)

    def train_step(params, opt_state, batch):
        b = batch_to(batch, dev)

        def loss_fn():
            loss, mets = model.loss(params, b, remat=remat)
            return _objective(model, mesh, loss, mets, b["targets"]), mets

        with SH.use_rules(mesh, rules, _seq_sizes(mesh, b)):
            (obj, mets), grads = _grads_of(params, loss_fn)
        _sum_grads(mesh, grads, pshard)
        gnorm = grad_norm(mesh, grads, pshard)
        if zero1:
            params, opt_state, om = _zero1_update(mesh, opt_cfg, params,
                                                  grads, opt_state, oshard,
                                                  gnorm)
        else:
            params, opt_state, om = OPT.apply_updates(
                opt_cfg, params, grads, opt_state, gnorm=gnorm)
        loss, mets = _metrics(model, mesh, obj, mets)
        return params, opt_state, {**mets, **om, "loss": loss}

    return Step(train_step, dev, mesh, rules, (pshard, oshard))


def _one_device_train_step(model, opt_cfg, remat, device, graph) -> Step:
    dev = resolve_or_meta(device)
    if graph is None:
        graph = dev.type == "cuda"

    def train_step(params, opt_state, b):
        (loss, mets), grads = _grads_of(
            params, lambda: model.loss(params, b, remat=remat))
        params, opt_state, om = OPT.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        mets = {k: v.detach() for k, v in mets.items()}
        return params, opt_state, {**mets, **om, "loss": loss.detach()}

    graphs = TrainStepGraphs(train_step, dev, graph=graph)
    return Step(graphs, dev, graphs=graphs)


def build_forward_step(model, *, remat: bool = False, device="cuda",
                       mesh: Optional[Mesh] = None,
                       rules: Optional[Dict[str, Any]] = None) -> Step:
    """step(params, batch) -> (loss, metrics), no gradient; on a mesh
    ``params`` and ``batch`` are this rank's, as in ``build_train_step``,
    and the loss the global one."""
    if mesh is None:
        dev = resolve_or_meta(device)

        def fwd(params, batch):
            with torch.no_grad():
                return model.loss(params, batch_to(batch, dev), remat=remat)

        return Step(fwd, dev)
    rules, pshard = _train_setup(model, mesh, rules)

    def mesh_fwd(params, batch):
        b = batch_to(batch, mesh.device)
        with torch.no_grad(), SH.use_rules(mesh, rules, _seq_sizes(mesh, b)):
            loss, mets = model.loss(params, b, remat=remat)
            obj = _objective(model, mesh, loss, mets, b["targets"])
            return _metrics(model, mesh, obj, mets)

    return Step(mesh_fwd, mesh.device, mesh, rules, pshard)


def _state_rows(state) -> int:
    if isinstance(state, PagedKVCache):
        return state.block_tables.shape[0]
    if isinstance(state, ZambaState):
        return state.conv.shape[2]
    if isinstance(state, WhisperState):
        return state.cross_k.shape[1]
    return state.mix_x.shape[1]


def _check_state(mesh: Mesh, state_example, cfg: ModelConfig) -> None:
    """The state must have placements (``state_shardings``: a
    ``Mamba2State`` raises ``TypeError`` on every mesh, as in the
    reference), and its batch dims must split as the tokens do: a paged
    pool without dp groups stays whole on every rank, so its rows could
    not follow the tokens'."""
    spec = state_shardings(mesh, state_example, cfg)
    bax = batch_axes(mesh)
    if mesh.axis_size(bax) == 1:
        return
    B = _state_rows(state_example)
    rows = SH.normalize([bax if _div(B, mesh, bax) else None])[0]
    caches = [s for s in (spec, getattr(spec, "kv", None),
                          getattr(spec, "self_kv", None))
              if isinstance(s, PagedKVCache)]
    for c in caches:
        if c.seq_lens[0] != rows:
            raise ValueError(
                f"a paged cache of {B} rows on mesh {mesh.shape} needs "
                f"dp_groups = {dp_groups_for(mesh, B)} (dp_groups_for) so "
                f"its pool splits with the batch; it has "
                f"{c.config.dp_groups}")


def _mesh_serving(model, mesh: Mesh, state_example, rules):
    """(rules, parameter placements, sizes) of a mesh serve or prefill
    step, after its checks."""
    rules = _serve_rules(model, mesh, rules)
    if state_example is not None:
        _check_state(mesh, state_example, model.cfg)
    pshard = param_placements(model, mesh, rules)
    if latent_tp(model.cfg, mesh):
        pshard = latent_layout(pshard, model.cfg, mesh)
    return rules, pshard, _serve_sizes(model, state_example)


def build_serve_step(model, *, device="cuda", mesh: Optional[Mesh] = None,
                     state_example=None,
                     rules: Optional[Dict[str, Any]] = None) -> Step:
    """step(params, tokens, state) -> (logits, state): one decode step,
    ``model.decode_step``.  On a mesh ``params``, ``tokens`` and
    ``state`` are this rank's (``shard_params`` under the step's
    ``in_shardings``, ``shard_rows``, ``shard_state``; ``state_example``
    is the global state, whose placements are checked) and so are the
    logits it returns: its rows, and on a model axis its vocabulary
    piece (``gather_logits`` for the global (B, V))."""
    if mesh is None:
        dev = resolve_or_meta(device)

        def serve_step(params, tokens, state):
            with torch.no_grad():
                return model.decode_step(params, tokens, state)

        return Step(serve_step, dev)
    rules, pshard, sizes = _mesh_serving(model, mesh, state_example, rules)

    def mesh_serve_step(params, tokens, state):
        with torch.no_grad():
            return model.decode_step(params, tokens, state)

    return Step(mesh_serve_step, mesh.device, mesh, rules, pshard, sizes)


def build_prefill_step(model, *, device="cuda", mesh: Optional[Mesh] = None,
                       state_example=None,
                       rules: Optional[Dict[str, Any]] = None) -> Step:
    """step(params, tokens, state, lengths, **kw) -> (last logits,
    state): ``model.prefill`` (``kw``: Whisper's ``frames``, a VLM's
    ``image_embeds``, this rank's rows of them on a mesh).  On a mesh
    every argument and result is this rank's, as in
    ``build_serve_step``."""
    pshard = sizes = None
    if mesh is None:
        dev = resolve_or_meta(device)
    else:
        rules, pshard, sizes = _mesh_serving(model, mesh, state_example,
                                             rules)
        dev = mesh.device

    def prefill_step(params, tokens, state, lengths, **kw):
        with torch.no_grad():
            return model.prefill(params, tokens, state, lengths, **kw)

    return Step(prefill_step, dev, mesh, rules, pshard, sizes)
