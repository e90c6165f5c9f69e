"""Config system: one frozen dataclass tree per architecture.

Every architecture is a ``ModelConfig`` in its own module
(``repro_torch.configs.<id>``); ``get_config(name)`` resolves by id.
Reduced configs for CPU smoke tests come from ``ModelConfig.reduced()``
so tests always exercise the same code path as the full model.

This is the PyTorch package's own copy of ``repro.configs.base``: the
fields and ``reduced()`` are identical (a test holds them field by
field), and ``torch_dtype`` takes the place of the JAX ``jdtype``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    kv_lora_rank: int
    q_lora_rank: Optional[int]      # None => full-rank q projection
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def latent_dim(self) -> int:    # what the paged pool stores per token
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # total shared-expert hidden dim
    first_dense_layers: int = 0     # leading layers with dense MLP
    router_aux_coef: float = 0.001  # load-balance loss weight
    capacity_factor: float = 0.0    # 0 => dropless (sort + ragged_dot)
    parallel_mode: str = "tp"       # "tp" (d_ff sharded) | "ep" (a2a)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Covers Mamba2 (kind='mamba2') and RWKV6 (kind='rwkv6')."""
    kind: str
    state_dim: int = 64             # N (mamba2) / ignored by rwkv6
    head_dim: int = 64
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4             # mamba2 conv1d
    chunk: int = 64                 # chunked-scan length
    subchunk: int = 0               # rwkv6: unrolled inner tiles (0 = off)
    intra_dtype: str = "float32"    # chunk-intra intermediates (bf16 opt)
    decay_lora: int = 64            # rwkv6 low-rank for w
    mix_lora: int = 32              # rwkv6 ddlerp low-rank


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Auxiliary encoder (whisper audio encoder / ViT stub)."""
    num_layers: int
    num_frames: int                 # encoder sequence length (stub frontend)
    frontend: str = "stub"          # embeddings arrive precomputed


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    attention: str = "gqa"          # gqa | mla | none
    mla: Optional[MLAConfig] = None
    # local/global attention pattern: every `local_ratio + 1` layers, the
    # last is global and the rest are local with `local_window`.
    local_window: Optional[int] = None
    local_ratio: int = 0            # gemma2: 1 (alternating); gemma3: 5
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # override head_dim**-0.5
    qk_norm: bool = False           # qwen3-style per-head RMSNorm on q,k
    mlp: str = "swiglu"             # swiglu | geglu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0      # zamba2: shared attn block period
    shared_attn_lora: int = 0       # zamba2: per-group LoRA rank on shared
    encoder: Optional[EncoderConfig] = None  # whisper / internvl frontend
    num_image_tokens: int = 0       # internvl: patch embeds prepended
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None  # gemma3: local layers' theta
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    post_norms: bool = False        # gemma2/3: post-attn/post-mlp norms
    embed_scale: bool = False       # gemma family: x *= sqrt(d_model)
    dtype: str = "bfloat16"
    # serving/paging knobs (the paper's block quantum)
    kv_block_tokens: int = 64
    # beyond-paper: shard the MLA latent KV pool over 'model' on the
    # kv_lora dim (rope stream kept separate+replicated).  See §Perf.
    mla_latent_tp: bool = False

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_is_local(self, layer: int) -> bool:
        if self.local_ratio <= 0 or self.local_window is None:
            return False
        return (layer % (self.local_ratio + 1)) != self.local_ratio

    def param_count(self) -> int:
        """Approximate parameter count N (for 6ND roofline accounting)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == "gqa":
            per_layer += d * self.num_heads * self.hd * 2  # q, o
            per_layer += d * self.kv_heads * self.hd * 2   # k, v
        elif self.attention == "mla":
            m = self.mla
            qdim = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            if m.q_lora_rank:
                per_layer += d * m.q_lora_rank + m.q_lora_rank * qdim
            else:
                per_layer += d * qdim
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        if self.moe is not None:
            e = self.moe
            moe_layer = e.num_experts * 3 * d * e.d_ff_expert + d * e.num_experts
            moe_layer += 3 * d * e.d_ff_shared
            dense_layer = 3 * d * self.d_ff
            per_layer_mlp = moe_layer
            total_mlp = (moe_layer * (L - e.first_dense_layers)
                         + dense_layer * e.first_dense_layers)
        elif self.ssm is not None and self.ssm.kind == "rwkv6":
            di = d  # rwkv6 time-mix operates at d_model
            total_mlp = L * (4 * d * di + 3 * d * self.d_ff // 1)
        else:
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            total_mlp = L * mult * d * self.d_ff
        if self.ssm is not None and self.ssm.kind == "mamba2":
            di = self.ssm.expand * d
            per_layer = 2 * d * di + di * d  # in/out projections (approx)
        total = emb + per_layer * L + total_mlp
        if self.encoder is not None:
            enc_layer = 4 * d * d + 3 * d * self.d_ff
            total += self.encoder.num_layers * enc_layer
        return int(total)

    # -- reduced config for CPU smoke tests -----------------------------
    def reduced(self) -> "ModelConfig":
        rep = dict(
            num_layers=min(self.num_layers, 4 if self.shared_attn_every == 0
                           else 2 * max(1, self.shared_attn_every)),
            d_model=128, num_heads=4,
            kv_heads=min(self.kv_heads, 2) if self.kv_heads < self.num_heads else 4,
            head_dim=32, d_ff=256, vocab_size=512, dtype="float32",
            kv_block_tokens=8,
        )
        if self.mla is not None:
            rep["mla"] = MLAConfig(kv_lora_rank=32,
                                   q_lora_rank=48 if self.mla.q_lora_rank else None,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
        if self.moe is not None:
            rep["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_ff_expert=64,
                d_ff_shared=64 if self.moe.num_shared_experts else 0)
        if self.ssm is not None:
            rep["ssm"] = dataclasses.replace(self.ssm, state_dim=16,
                                             head_dim=16, chunk=8,
                                             decay_lora=8, mix_lora=8)
        if self.local_window is not None:
            rep["local_window"] = 16
        if self.encoder is not None:
            rep["encoder"] = dataclasses.replace(self.encoder, num_layers=2,
                                                 num_frames=16)
        if self.num_image_tokens:
            rep["num_image_tokens"] = 8
        if self.shared_attn_lora:
            rep["shared_attn_lora"] = 8
        return dataclasses.replace(self, **rep)


#: the reference package's assigned architectures, in its order
ARCH_IDS = [
    "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b", "minicpm3_4b",
    "gemma2_27b", "gemma3_27b", "gemma_2b", "internvl2_1b",
    "rwkv6_7b", "zamba2_2p7b", "whisper_tiny",
]

#: every config module of this package: ``ARCH_IDS`` and the pure SSM
#: ``mamba2_370m``, which the reference configures outside that list
CONFIG_IDS = ARCH_IDS + ["mamba2_370m"]


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG
