"""The lower clamp with the JAX package's gradient at a tie."""

from __future__ import annotations

import torch


def clip_min(x, bound):
    """max(x, bound) elementwise, as ``jnp.maximum(x, bound)`` and
    ``jnp.clip(x, min=bound)`` compute it: the gradient is 1 above the
    bound, 0 below it and ½ at it, where ``torch.clamp`` gives 1. Ties are
    common where the clamped value is a rounding residue, as the expanded
    squared distance of two equal points is."""
    return torch.maximum(x, x.new_full((), bound))
