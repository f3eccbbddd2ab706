"""Layer primitives and the hand-written kernels with their plain versions."""
