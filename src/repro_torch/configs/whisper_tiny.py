"""Whisper-tiny: enc-dec, 4L each, d=384, 6H, d_ff=1536, vocab 51865;
conv audio frontend is a STUB (precomputed 1500-frame embeddings).
[arXiv:2212.04356; pool tag: unverified]"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,             # decoder layers
    d_model=384,
    num_heads=6,
    kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
)
