"""Training data: the step-addressable pipeline."""
