"""Plain tensor ops; the hand-written kernels live in ``ops/cuda``."""
