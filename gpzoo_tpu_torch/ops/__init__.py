"""Linear-algebra primitives and the hand-written Hopper kernels."""
