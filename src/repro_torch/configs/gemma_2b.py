"""Gemma-2B: 18L, d=2048, 8H MQA (kv=1), head_dim=256, d_ff=16384 GeGLU,
vocab 256000.  [arXiv:2403.08295]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp="geglu",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
)
