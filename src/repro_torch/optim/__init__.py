from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply_updates,
                                     cosine_lr, global_norm, init_state)

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "cosine_lr",
           "global_norm", "init_state"]
