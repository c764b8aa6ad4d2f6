"""Multi-group GP (MGGP) kernels (port of ``gpzoo_tpu/kernels/mggp.py``).

    k(x, z) = σ² · exp(−½ (‖x−z‖²/ℓ²) / (α̃·g² + 1)) / (α̃·g² + 1)^(p/2),

with g² the squared distance between the MDS embeddings of the two
points' groups, p = ``input_dim`` and α̃ the group-difference parameter
under the kernel's :class:`GroupDiffConvention`. The Gram always goes
through :func:`gpzoo_tpu_torch.ops.mggp_cuda.mggp_gram`: the Hopper kernel
for CUDA tensors, the plain expanded-distance form for CPU tensors.

All four leaves are ``nn.Parameter``s named by the JAX paths (``sigma``,
``lengthscale``, ``group_diff_param``, ``embedding``). The JAX package
marks the embedding "not trained", but its MGGP benchmark mask
(``not path.endswith(".Z")``) trains it; the port follows that mask.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import GroupDiffConvention
from gpzoo_tpu_torch.kernels.rbf import _bcast_hparam
from gpzoo_tpu_torch.ops import mggp_cuda
from gpzoo_tpu_torch.ops.distance import squared_dist
from gpzoo_tpu_torch.ops.linalg import embed_distance_matrix, sqrt_safe_grad


def _default_embedding(n_groups, dtype=None, device=None):
    """MDS embedding of the complete-graph group distances 1 − I."""
    d = (torch.ones((n_groups, n_groups), dtype=dtype, device=device)
         - torch.eye(n_groups, dtype=dtype, device=device))
    return embed_distance_matrix(d)


class MGGPRBF(nn.Module):
    """Scalar hyperparameters, RAW α convention (``α·g² + 1``)."""

    default_convention = GroupDiffConvention.RAW

    def __init__(self, sigma, lengthscale, group_diff_param, embedding,
                 input_dim=2, convention=None):
        super().__init__()
        self.sigma = nn.Parameter(torch.as_tensor(sigma))
        self.lengthscale = nn.Parameter(torch.as_tensor(lengthscale))
        self.group_diff_param = nn.Parameter(torch.as_tensor(group_diff_param))
        self.embedding = nn.Parameter(torch.as_tensor(embedding))
        self.input_dim = input_dim
        self.convention = convention or self.default_convention

    @classmethod
    def create(cls, sigma=1.0, lengthscale=2.0, group_diff_param=1.0,
               n_groups=2, input_dim=2, dtype=None, device=None):
        def full(v):
            return torch.tensor(v, dtype=dtype, device=device)

        return cls(full(sigma), full(lengthscale), full(group_diff_param),
                   _default_embedding(n_groups, dtype, device), input_dim)

    def with_group_distances(self, group_distances):
        """A copy whose embedding is the MDS embedding of a user
        group-distance matrix."""
        out = copy.deepcopy(self)
        emb = embed_distance_matrix(torch.as_tensor(
            group_distances, dtype=self.embedding.dtype,
            device=self.embedding.device))
        out.embedding = nn.Parameter(emb)
        return out

    def batch_shape(self):
        """Leading factor shape of :meth:`gram`'s output: () or (L,)."""
        return torch.broadcast_shapes(
            _bcast_hparam(self.sigma).shape, _bcast_hparam(self.lengthscale).shape,
            _bcast_hparam(self.group_diff_param).shape)[:-2]

    def diag(self, x, groups=None):
        """k(x, x): σ² expanded to (N,) or (L, N)."""
        n = x.shape[0]
        var = torch.square(self.sigma).reshape(-1)
        if var.shape[0] == 1:
            return var[0].expand(n)
        return var[:, None].expand(var.shape[0], n)

    def gram(self, x, z, groups_x, groups_z):
        """(N, M) or (L, N, M) covariance between rows of x and z with
        group labels groups_x (N,) and groups_z (M,)."""
        sigma = self.sigma.reshape(-1)
        ell = self.lengthscale.reshape(-1)
        alpha = self.convention.apply(self.group_diff_param).reshape(-1)
        l_dim = max(sigma.shape[0], ell.shape[0], alpha.shape[0])
        out = mggp_cuda.mggp_gram(
            x, z, self.embedding[groups_x], self.embedding[groups_z],
            sigma.expand(l_dim).contiguous(), ell.expand(l_dim).contiguous(),
            alpha.expand(l_dim).contiguous(), self.input_dim)
        return out[0] if self.batch_shape() == () else out

    def gram_and_distance(self, x, z, groups_x, groups_z):
        """The Gram and the (N, M) spatial distance (no gradient: it only
        feeds a neighbour search)."""
        with torch.no_grad():
            distance = sqrt_safe_grad(squared_dist(x, z))
        return self.gram(x, z, groups_x, groups_z), distance


class MGGPNSFRBF(MGGPRBF):
    """(L, 1, 1) hyperparameters, SQUARED α convention (``α²·g² + 1``)."""

    default_convention = GroupDiffConvention.SQUARED

    @classmethod
    def create(cls, sigma=1.0, lengthscale=2.0, group_diff_param=1.0,
               n_groups=2, L=10, input_dim=2, dtype=None, device=None):
        ones = torch.ones((L, 1, 1), dtype=dtype, device=device)
        return cls(sigma * ones, lengthscale * ones, group_diff_param * ones,
                   _default_embedding(n_groups, dtype, device), input_dim)


class BatchedMGGPRBF(MGGPRBF):
    """Scalar hyperparameters, ABS α convention (``|α|·g² + 1``)."""

    default_convention = GroupDiffConvention.ABS

    @classmethod
    def create(cls, sigma=1.0, lengthscale=1.0, group_diff_param=1.0,
               n_groups=10, input_dim=2, dtype=None, device=None):
        return super().create(sigma, lengthscale, group_diff_param, n_groups,
                              input_dim, dtype, device)
