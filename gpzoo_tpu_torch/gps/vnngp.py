"""Variational nearest-neighbour GP (port of ``gpzoo_tpu/gps/vnngp.py``).

Each query point conditions on its K nearest inducing points only. With
S = Lu Luᵀ formed once, the per-point K×K blocks of Kzz and S are gathered
directly, ``(L Lᵀ)[I, I] = Kzz[I, I]`` for any index set I, so no
N×K×M intermediate exists. The per-point K×K conditioning runs through
:func:`gpzoo_tpu_torch.ops.vnngp_cuda.block_conditional`: kernel 5 for
CUDA tensors, the plain batched Cholesky form for CPU tensors.

Neighbours come from one ``torch.topk`` over the negated distances; ties
may be ordered differently from ``lax.top_k``, and the posterior does not
depend on neighbour order.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import lower_cholesky
from gpzoo_tpu_torch.dists import MultivariateNormalTril, Normal
from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.distance import squared_dist
from gpzoo_tpu_torch.ops.linalg import add_jitter, sqrt_safe_grad
from gpzoo_tpu_torch.ops.vnngp_cuda import block_conditional


def gather_blocks(mat, idx):
    """K×K principal blocks: out[..., n, i, j] = mat[..., idx[n, i], idx[n, j]].
    mat (..., M, M), idx (N, K) → (..., N, K, K)."""
    return mat[..., idx[:, :, None], idx[:, None, :]]


def _nearest(distance, k):
    """(N, K) indices of the K smallest entries of each row."""
    return torch.topk(-distance, k, dim=-1).indices


class VNNGP(nn.Module):
    """VNNGP state:

      kernel — an :class:`gpzoo_tpu_torch.kernels.RBF`,
      Z (M, dim) inducing locations,
      mu (M,) or (L, M) inducing mean,
      Lu_raw (M, M) or (L, M, M) unconstrained Cholesky of q(u),
      K — neighbours per point,
      jitter — added to Kzz, and again to each gathered block,
      var_floor — clamp of the marginal posterior variance.
    """

    def __init__(self, kernel, Z, mu, Lu_raw, K=3, jitter=1e-4,
                 var_floor=5e-2):
        super().__init__()
        self.kernel = kernel
        self.Z = nn.Parameter(Z)
        self.mu = nn.Parameter(mu)
        self.Lu_raw = nn.Parameter(Lu_raw)
        self.K = K
        self.jitter = jitter
        self.var_floor = var_floor

    def neighbor_indices(self, x):
        """(N, K) nearest inducing points of each row of x."""
        with torch.no_grad():
            return _nearest(sqrt_safe_grad(squared_dist(x, self.Z)), self.K)

    def forward(self, x, kernel=None):
        """(qf, qu, pu) at the rows of x: qf the marginal ``Normal`` (N,) or
        (L, N), qu = N(mu, Lu Luᵀ), pu = N(0, Kzz). ``kernel`` replaces
        ``self.kernel`` for this call (the shared-kernel collapse)."""
        kernel = self.kernel if kernel is None else kernel
        kxx = kernel.diag(x)  # (N,) or (L, N)
        kxz, distance = kernel.gram_and_distance(x, self.Z)
        kzz = add_jitter(kernel.gram(self.Z, self.Z), self.jitter)
        lzz = torch.linalg.cholesky(kzz)
        lu = lower_cholesky(self.Lu_raw)
        s = lu @ lu.mT

        idx = _nearest(distance, self.K)
        little_kzz = gather_blocks(kzz, idx)
        little_s = gather_blocks(s, idx)
        little_kxz = torch.gather(kxz, -1, idx.expand(kxz.shape[:-1] + idx.shape[-1:]))
        little_mu = self.mu[..., idx]  # (..., N, K)

        mean, cov = self._conditional(little_kzz, little_s, little_kxz,
                                      little_mu, kxx)
        qf = Normal(mean, torch.sqrt(clip_min(cov, self.var_floor)))
        qu = MultivariateNormalTril(self.mu, lu)
        pu = MultivariateNormalTril(torch.zeros_like(self.mu), lzz)
        return qf, qu, pu

    def _conditional(self, little_kzz, little_s, little_kxz, little_mu, kxx):
        """Per-point conditioning with the operands' leading batch dims
        broadcast and folded into one point axis, so one launch of kernel
        5 covers every factor. ``little_kzz`` arrives without the block
        jitter; the kernel adds it."""
        batch = torch.broadcast_shapes(little_kzz.shape[:-3], little_s.shape[:-3],
                                       little_kxz.shape[:-2], little_mu.shape[:-2],
                                       kxx.shape[:-1])
        n, k = little_kzz.shape[-3], little_kzz.shape[-1]

        def fold(a, event):
            return a.expand(batch + a.shape[-event:]).reshape(
                (-1,) + a.shape[-event:][1:]).contiguous()

        mean, cov = block_conditional(
            fold(little_kzz, 3), fold(little_s, 3), fold(little_kxz, 2),
            fold(little_mu, 2), fold(kxx, 1), self.jitter)
        return mean.reshape(batch + (n,)), cov.reshape(batch + (n,))
