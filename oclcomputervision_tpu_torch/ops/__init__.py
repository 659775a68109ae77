"""Plain PyTorch pipelines around the hand-written kernels."""
