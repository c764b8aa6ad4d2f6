"""Positivity / Cholesky bijectors and the MGGP group-difference
conventions (port of ``gpzoo_tpu/bijectors.py``)."""

from __future__ import annotations

import enum

import torch


def softplus(x):
    """Exact ``log(1 + exp(x))`` as ``max(x, 0) + log1p(exp(−|x|))`` — the
    form ``jax.nn.softplus`` evaluates. ``torch.nn.functional.softplus``
    switches to the identity above 20, which departs from it by ~1e-9."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def softplus_inverse(y):
    """Inverse of :func:`softplus`: ``log(exp(y) - 1)``, stable for large y."""
    return y + torch.log(-torch.expm1(-y))


def lower_cholesky(raw):
    """Map an unconstrained square matrix to a lower-Cholesky factor:
    strictly-lower triangle kept, diagonal mapped through ``exp``.

    Writes the diagonal into the ``tril`` result in place, so the
    north-star (20, 3000, 3000) factor costs one 720 MB temporary rather
    than the three of a ``where(eye, exp(raw), tril(raw))``.
    """
    lu = torch.tril(raw, diagonal=-1)
    lu.diagonal(dim1=-2, dim2=-1).copy_(
        torch.exp(raw.diagonal(dim1=-2, dim2=-1)))
    return lu


def lower_cholesky_inverse(chol):
    """Unconstrained matrix whose :func:`lower_cholesky` image is ``chol``."""
    raw = torch.tril(chol, diagonal=-1)
    raw.diagonal(dim1=-2, dim2=-1).copy_(
        torch.log(chol.diagonal(dim1=-2, dim2=-1)))
    return raw


class GroupDiffConvention(enum.Enum):
    """How the MGGP group-difference parameter α enters ``α·g² + 1``:
    ``ABS`` |α| (``BatchedMGGPRBF``), ``RAW`` α (``MGGPRBF``), ``SQUARED``
    α² (``MGGPNSFRBF``)."""

    ABS = "abs"
    RAW = "raw"
    SQUARED = "squared"

    def apply(self, alpha):
        if self is GroupDiffConvention.ABS:
            return torch.abs(alpha)
        if self is GroupDiffConvention.RAW:
            return alpha
        return torch.square(alpha)
