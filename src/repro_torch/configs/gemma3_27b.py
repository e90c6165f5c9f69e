"""Gemma3-27B: 62L, d=5376, 32H GQA kv=16, head_dim=128, d_ff=21504,
5 local(1024) : 1 global, qk-norm (replaces gemma2's softcap), 128k
context.  [hf:google/gemma-3-27b-pt, the published config]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    mlp="geglu",
    local_window=1024,
    local_ratio=5,            # 5 local then 1 global
    qk_norm=True,
    query_scale=(5376 / 32) ** -0.5,
    rope_theta=1_000_000.0,   # global layers (local use 10k; see models)
    post_norms=True,
    embed_scale=True,
    rope_theta_local=10000.0,
    tie_embeddings=True,
)
