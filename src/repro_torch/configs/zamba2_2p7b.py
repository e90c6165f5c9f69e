"""Zamba2-2.7B: 54 Mamba2 layers (d=2560, ssm_state=64) + a SHARED
attention/MLP block (32H, d_ff=10240) applied every 6 layers with
per-invocation LoRA.  [arXiv:2411.15242]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  conv_width=4, chunk=64),
    shared_attn_every=6,
    shared_attn_lora=128,
    tie_embeddings=True,
)
