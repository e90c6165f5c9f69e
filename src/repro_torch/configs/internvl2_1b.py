"""InternVL2-1B: Qwen2-0.5B LM backbone (24L, d=896, 14H GQA kv=2,
d_ff=4864, vocab 151655) + InternViT frontend (STUB: patch embeddings
arrive precomputed, 256 image tokens).  [arXiv:2404.16821]"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    num_image_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
