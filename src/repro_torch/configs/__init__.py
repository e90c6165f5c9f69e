"""Model configurations (one frozen ``ModelConfig`` per architecture)."""
