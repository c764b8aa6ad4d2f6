"""Stationary kernels, single and L-batched: RBF and Matérn-3/2 (port of
``gpzoo_tpu/kernels/rbf.py``).

Hyperparameters enter squared (σ², ℓ²). ``sigma``/``lengthscale`` may be
scalars, (L,) vectors or (L, 1, 1); the Gram is (N, M) when both are
scalars and (L, N, M) otherwise. The RBF Gram always goes through
:func:`gpzoo_tpu_torch.ops.gram_cuda.rbf_gram`: the Hopper kernel for CUDA
tensors, the plain expanded-distance form for CPU tensors. The Matérn
Gram has no kernel of its own (nor has it in the JAX package): it is plain
PyTorch over the expanded squared distance.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gpzoo_tpu_torch.ops import gram_cuda
from gpzoo_tpu_torch.ops.distance import squared_dist
from gpzoo_tpu_torch.ops.linalg import sqrt_safe_grad


def _bcast_hparam(p):
    """(L,) → (L, 1, 1); scalars and (L, 1, 1) pass through."""
    return p[:, None, None] if p.ndim == 1 else p


class RBFMath:
    """The RBF's computations over ``self.sigma`` and ``self.lengthscale``,
    shared by the :class:`RBF` module and by :class:`TiedRBF`, a view of
    factor 0 of another kernel's parameters."""

    def batch_shape(self):
        """Leading factor shape of :meth:`gram`'s output: () or (L,)."""
        return torch.broadcast_shapes(_bcast_hparam(self.sigma).shape,
                                      _bcast_hparam(self.lengthscale).shape)[:-2]

    def diag(self, x):
        """k(x, x): σ² expanded to (N,) or (L, N)."""
        n = x.shape[0]
        var = torch.square(self.sigma).reshape(-1)
        if var.shape[0] == 1:
            return var[0].expand(n)
        return var[:, None].expand(var.shape[0], n)

    def gram(self, x, z):
        """(N, M) or (L, N, M) covariance between rows of x and z."""
        sigma = self.sigma.reshape(-1)
        ell = self.lengthscale.reshape(-1)
        l_dim = max(sigma.shape[0], ell.shape[0])
        out = gram_cuda.rbf_gram(x, z, sigma.expand(l_dim).contiguous(),
                                 ell.expand(l_dim).contiguous())
        return out[0] if self.batch_shape() == () else out

    def gram_and_distance(self, x, z):
        """The Gram and the (N, M) Euclidean distance for the VNNGP
        neighbour search. The distance only feeds a top-K, so it carries
        no gradient."""
        with torch.no_grad():
            distance = sqrt_safe_grad(squared_dist(x, z))
        return self.gram(x, z), distance

    def variance_vector(self):
        """σ² shaped (L, 1), or a scalar."""
        var = torch.square(self.sigma).reshape(-1)
        if var.shape[0] == 1:
            return var[0]
        return var[:, None]


class RBF(RBFMath, nn.Module):
    """Squared-exponential kernel σ² exp(−½‖x−z‖²/ℓ²)."""

    def __init__(self, sigma, lengthscale, input_dim=2):
        super().__init__()
        self.sigma = nn.Parameter(torch.as_tensor(sigma))
        self.lengthscale = nn.Parameter(torch.as_tensor(lengthscale))
        self.input_dim = input_dim


class NSFRBF(RBF):
    """L-batched RBF with per-factor (L, 1, 1) σ and ℓ over one shared
    distance."""

    @classmethod
    def create(cls, sigma=1.0, lengthscale=2.0, L=10, input_dim=2,
               dtype=None, device=None):
        ones = torch.ones((L, 1, 1), dtype=dtype, device=device)
        return cls(sigma * ones, lengthscale * ones, input_dim)


class TiedRBF(RBFMath):
    """A scalar RBF whose σ and ℓ are tensors owned elsewhere, held as they
    are: not an ``nn.Module``, so a view of another kernel's parameters is
    not re-wrapped into a new leaf, and its gradient reaches them."""

    def __init__(self, sigma, lengthscale, input_dim=2):
        self.sigma = sigma
        self.lengthscale = lengthscale
        self.input_dim = input_dim


class BatchedRBF(RBF):
    """:class:`RBF` with scalar or (L,)-vector σ and ℓ, the JAX package's
    ``BatchedRBF``: the same Gram, through kernel 3."""


class Matern32(nn.Module):
    """Matérn-3/2 kernel σ²(1 + √3 d/ℓ) exp(−√3 d/ℓ), scalar or (L,)-vector
    hyperparameters. The distance is ``sqrt_safe_grad`` of the squared
    distance: at d = 0 (every Kzz diagonal, any point on an inducing point)
    a plain square root's gradient is 0·inf = NaN, where the kernel's is 0."""

    def __init__(self, sigma, lengthscale, input_dim=2):
        super().__init__()
        self.sigma = nn.Parameter(torch.as_tensor(sigma))
        self.lengthscale = nn.Parameter(torch.as_tensor(lengthscale))
        self.input_dim = input_dim

    diag = RBFMath.diag

    def _from_distance(self, d):
        val = math.sqrt(3.0) * d / _bcast_hparam(self.lengthscale)
        return torch.square(_bcast_hparam(self.sigma)) * (1.0 + val) * torch.exp(-val)

    def gram(self, x, z):
        """(N, M) or (L, N, M) covariance between rows of x and z."""
        return self._from_distance(sqrt_safe_grad(squared_dist(x, z)))

    def gram_and_distance(self, x, z):
        """The Gram and the (N, M) Euclidean distance it was formed from."""
        d = sqrt_safe_grad(squared_dist(x, z))
        return self._from_distance(d), d
