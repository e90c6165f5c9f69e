"""RWKV6-World-7B ("Finch"): 32L, d=4096, attention-free linear attention
with data-dependent decay, head size 64 (64 heads), ffn 14336(x3.5-ish;
assigned d_ff=14336), vocab 65536.  [arXiv:2404.05892]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,             # d_model / head_dim
    kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64,
                  decay_lora=64, mix_lora=32),
    tie_embeddings=False,
)
