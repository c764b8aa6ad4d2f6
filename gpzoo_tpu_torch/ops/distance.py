"""Pairwise-distance primitives (port of ``gpzoo_tpu/ops/distance.py``)."""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.ops.clip import clip_min


def squared_dist(x, z):
    """Clamped squared Euclidean distance matrix in the expanded form
    ``‖x‖² − 2xᵀz + ‖z‖²``: x (N, D), z (M, D) → (N, M)."""
    x2 = torch.sum(torch.square(x), dim=-1, keepdim=True)
    z2 = torch.sum(torch.square(z), dim=-1, keepdim=True)
    r2 = x2 - 2.0 * (x @ z.transpose(-2, -1)) + z2.transpose(-2, -1)
    return clip_min(r2, 0.0)


def cdist(x, z):
    """Euclidean distance matrix, ``torch.cdist``'s function in the
    expanded form of :func:`squared_dist`: x (N, D), z (M, D) → (N, M)."""
    return torch.sqrt(squared_dist(x, z))
