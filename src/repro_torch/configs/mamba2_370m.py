"""Mamba2-370M: 48 pure SSD layers (d=1024, ssm_state=128, head 64),
no attention anywhere -- decode state is O(1) per layer, served from
the constant-state pool discipline.  [arXiv:2405.21060]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,
    kv_heads=16,
    head_dim=64,
    d_ff=0,
    vocab_size=50288,
    attention="none",
    ssm=SSMConfig(kind="mamba2", state_dim=128, head_dim=64, expand=2,
                  conv_width=4, chunk=64),
    tie_embeddings=True,
)
