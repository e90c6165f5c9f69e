"""Training: block checkpoints and the fault-tolerant loop."""
