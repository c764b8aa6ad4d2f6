"""Precomputed-projection NSF loss: the north-star training step (port of
``NSFProjection``, ``precompute_nsf_projection`` and
``nsf_negative_elbo_precomputed`` from ``gpzoo_tpu/train/fast.py``).

With Z and the kernel frozen, the Cholesky of Kzz, the projection
ã = K⁻¹Kzx over all N spots, K⁻¹ and log|Lzz| are constants: they are
computed once, and a step is then

    mean = μ ãᵀ_b,   cov = σ² − a²_b + colsum((Luᵀ ã_b)²),
    KL   = ½(tr(K⁻¹LuLuᵀ) + μᵀK⁻¹μ − M) + log|Lzz| − log|Lu|  per factor.

Only the unwhitened full-rank SVGP prior with the Poisson NSF head is
ported; the variance term runs through the Hopper kernels of
:mod:`gpzoo_tpu_torch.ops.tri_cuda` on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from gpzoo_tpu_torch.bijectors import lower_cholesky, softplus
from gpzoo_tpu_torch.dists import Poisson
from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.kernels.rbf import TiedRBF
from gpzoo_tpu_torch.models.factorization import NSF
from gpzoo_tpu_torch.ops.linalg import (add_jitter, spd_inverse_from_cholesky,
                                        sqrt_safe_grad, tril_logdet)
from gpzoo_tpu_torch.ops.tri_blocked import tri_kl_trace
from gpzoo_tpu_torch.ops.tri_cuda import tri_sq_colsum


@dataclasses.dataclass
class NSFProjection:
    """Step-invariant GP projection for frozen Z and a frozen shared kernel.

      proj_t — (N, M) spot-major rows of ã = K⁻¹Kzx,
      a2     — (N,) column sums of (Lzz⁻¹Kzx)²,
      kxx    — kernel variance: scalar σ² or (L, 1),
      k_inv  — (M, M) Kzz⁻¹,
      logdet_lzz — Σ log diag Lzz.
    """

    proj_t: torch.Tensor
    a2: torch.Tensor
    kxx: torch.Tensor
    k_inv: torch.Tensor
    logdet_lzz: torch.Tensor


def _matmul_kl(mu, lu, lzz):
    """Σ_l KL(N(μ_l, Lu_l Lu_lᵀ) ‖ N(0, Kzz_l)) in matmul form against K⁻¹:

        KL_l = ½(tr(K_l⁻¹ S_l) + μ_lᵀK_l⁻¹μ_l − M) + log|Lzz_l| − log|Lu_l|,

    with ``lzz`` shared (M, M) or per-factor (L, M, M)."""
    m_dim = lzz.shape[-1]
    k_inv = spd_inverse_from_cholesky(lzz)
    lu_l = lu if lu.ndim == 3 else lu[None]
    mu_l = mu if mu.ndim == 2 else mu[None]
    trace = tri_kl_trace(k_inv, lu_l)
    if k_inv.ndim == 3 and mu_l.shape[0] != k_inv.shape[0]:
        mu_l = mu_l.expand(k_inv.shape[0], m_dim)
    maha = torch.einsum("lm,mk,lk->l" if k_inv.ndim == 2 else "lm,lmk,lk->l",
                        mu_l, k_inv, mu_l)
    return torch.sum(0.5 * (trace + maha - m_dim) + tril_logdet(lzz)
                     - tril_logdet(lu_l))


def _count_py(head, rate):
    """The head's count likelihood at mean ``rate``: Poisson. The negative
    binomial head (a per-gene ``r_raw``) is not ported yet."""
    if getattr(head, "r_raw", None) is not None:
        raise NotImplementedError("the negative binomial head is not ported")
    return Poisson(rate)


def _check_head(model, prior_type=SVGP):
    """The model's prior, if the model is the Poisson NSF head over a
    ``prior_type`` (the unwhitened full-rank SVGP by default)."""
    if type(model) is not NSF or type(getattr(model, "prior", None)) is not prior_type:
        raise NotImplementedError(
            f"only the Poisson NSF head over {prior_type.__name__} is ported "
            f"here; got {type(model).__name__} over "
            f"{type(getattr(model, 'prior', None)).__name__}")
    return model.prior


def _collapse_shared_kernel(kernel):
    """Factor 0's hyperparameters of an L-batched kernel whose factors are
    known to be equal: the Gram and Cholesky are then computed once.

    σ and ℓ stay views of the original parameters, so the whole σ/ℓ
    gradient reaches factor 0 of them and the other factors get 0, as
    with the JAX package's ``kernel.replace``. Only the sum over factors
    is meaningful: train the hyperparameters through the collapse only as
    one tied parameter."""
    return TiedRBF(kernel.sigma.reshape(-1)[0],
                   kernel.lengthscale.reshape(-1)[0], kernel.input_dim)


@torch.no_grad()
def precompute_nsf_projection(model, x):
    """Build :class:`NSFProjection` for ``model`` over all spots ``x``.

    Assumes the kernel's factors share their hyperparameters (the
    north-star init) and collapses them to factor 0.
    """
    gp = _check_head(model)
    kernel = _collapse_shared_kernel(gp.kernel)
    z = gp.Z.contiguous()
    lzz = torch.linalg.cholesky(add_jitter(kernel.gram(z, z), gp.jitter))
    kzx = kernel.gram(z, x.contiguous())  # (M, N)
    a = torch.linalg.solve_triangular(lzz, kzx, upper=False)
    del kzx
    proj_t = torch.linalg.solve_triangular(lzz.mT, a, upper=True).T.contiguous()
    a2 = torch.sum(torch.square(a), dim=0)
    # the ORIGINAL kernel's variance, broadcast to its factor batch: the
    # (L, 1) shape carries the factor count into the loss's KL copy count
    kxx = gp.kernel.variance_vector().detach()
    batch = gp.kernel.batch_shape()
    if batch:
        kxx = kxx.reshape(-1, 1).expand(batch[0], 1)
    return NSFProjection(proj_t=proj_t, a2=a2, kxx=kxx,
                         k_inv=spd_inverse_from_cholesky(lzz),
                         logdet_lzz=tril_logdet(lzz))


def nsf_negative_elbo_precomputed(model, proj, y, idx, eps,
                                  y_transposed=False):
    """Minibatch −ELBO of NSF from a frozen projection.

    idx (B,) spot indices; eps (E, L, B) standard-normal draws of the
    reparameterization (taken as an argument: torch and JAX never draw the
    same numbers). Counts y are (D, N), or (N, D) with ``y_transposed``.
    Unnormalized Poisson log-likelihood, averaged over E, summed over D
    and B; the KL is not scaled by N/B.
    """
    gp = _check_head(model)
    mu_l = gp.mu if gp.mu.ndim == 2 else gp.mu[None]

    at = proj.proj_t[idx].T.contiguous()  # (M, B), the kernel's layout
    mean = mu_l @ at
    lu = lower_cholesky(gp.Lu_raw)
    lu_l = lu if lu.ndim == 3 else lu[None]
    m_dim = lu.shape[-1]
    c2 = tri_sq_colsum(lu_l, at)  # (L, B)
    base = proj.kxx - proj.a2[idx]
    cov = torch.clamp(base + c2, min=gp.var_floor)
    mean, cov = torch.broadcast_tensors(mean, cov)
    scale = sqrt_safe_grad(cov)

    f = mean + scale * eps  # (E, L, B)
    rate = softplus(model.W_raw) @ torch.exp(f)  # (E, D, B)
    rate = softplus(model.V_raw[idx]) * rate
    yb = y[idx].T if y_transposed else y[:, idx]
    lp = Poisson(rate).unnormalized_log_prob(yb)
    ll = torch.sum(torch.mean(lp, dim=0))

    trace = tri_kl_trace(proj.k_inv, lu_l)
    maha = torch.einsum("lm,mk,lk->l", mu_l, proj.k_inv, mu_l)
    # log diag(Lu) = diag(Lu_raw) exactly under the exp-diag bijector
    raw_l = gp.Lu_raw if gp.Lu_raw.ndim == 3 else gp.Lu_raw[None]
    logdet_q = torch.sum(raw_l.diagonal(dim1=-2, dim2=-1), dim=-1)
    kl_terms = 0.5 * (trace + maha - m_dim) + proj.logdet_lzz - logdet_q
    # shared mu/Lu against an L-batched prior still make n_factors KL terms
    n_factors = mean.shape[0]
    kl = torch.sum(kl_terms) * (n_factors // kl_terms.shape[0])
    return -(ll - kl)
