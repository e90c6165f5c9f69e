"""Qwen3-30B-A3B: 48L, d=2048, 32H GQA kv=4, MoE 128 experts top-8,
expert d_ff=768, vocab 151936.  [hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    kv_heads=4,
    head_dim=128,
    d_ff=768,                 # per-expert hidden (dense d_ff unused)
    vocab_size=151936,
    qk_norm=True,             # qwen3 per-head RMSNorm on q,k
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
