"""Fast paths for NSF over a VNNGP prior (port of
``gpzoo_tpu/train/fast_vnngp.py``).

Two tiers:

* :func:`vnngp_nsf_negative_elbo_batched`: the all-trainable step (Z,
  kernel, mu, Lu, W, V), with the neighbour search, the K×K block gathers
  and the per-point conditioning redone every step (kernel 5 on CUDA).
* :func:`precompute_vnngp_conditioning` +
  :func:`vnngp_nsf_negative_elbo_precomputed`: Z and the kernel frozen.
  The conditioning geometry (Gram, Cholesky, top-K, the per-point solves
  w = blocks⁻¹ little_Kxz, K⁻¹) is computed once; a step is then

      mean = w·mu[nbr],   cov = Kxx − w·little_Kxz + w·(Lu Luᵀ)[nbr, nbr]·wᵀ,

  with the KL in matmul form against the frozen K⁻¹.

Both take the minibatch ``idx`` (B,) and the standard-normal draws
``eps`` (E, L, B) as arguments, and the Poisson or the negative-binomial
NSF head (:class:`NBNSF`), with the unnormalized or the normalized
log-likelihood, and ``factor_group=`` and ``data_group=`` as the NSF
losses (``gpzoo_tpu_torch.parallel``).
"""

from __future__ import annotations

import dataclasses

import torch

from gpzoo_tpu_torch.bijectors import lower_cholesky, softplus
from gpzoo_tpu_torch.dists import Normal
from gpzoo_tpu_torch.gps.vnngp import VNNGP, _nearest, gather_blocks
from gpzoo_tpu_torch.models.factorization import NBNSF, NSF
from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.linalg import (add_jitter, spd_inverse_from_cholesky,
                                        tril_logdet)
from gpzoo_tpu_torch.ops.tri_cuda import tri_kl_trace
from gpzoo_tpu_torch.parallel.collectives import (gather_factors, sum_factors,
                                                  sum_over_data, take_columns)
from gpzoo_tpu_torch.train.fast import (_collapse_shared_kernel, _log_lik,
                                        _matmul_kl, _split_head)


def _vnngp_prior(model):
    """The VNNGP of an NSF or NBNSF head over one."""
    head, gp, hybrid = _split_head(model)
    if hybrid or type(head) not in (NSF, NBNSF) or type(gp) is not VNNGP:
        raise NotImplementedError(
            "the VNNGP losses take NSF or NBNSF over VNNGP; got "
            f"{type(model).__name__} over {type(gp).__name__}")
    return gp


def _solve_kl(mu, lu, lzz):
    """Σ_l KL(N(μ_l, Lu_l Lu_lᵀ) ‖ N(0, Kzz_l)) by triangular solves:
    tr(K⁻¹S) = ‖Lzz⁻¹Lu‖²_F and μᵀK⁻¹μ = ‖Lzz⁻¹μ‖²."""
    m_dim = lzz.shape[-1]
    lu_l = lu if lu.ndim == 3 else lu[None]
    mu_l = mu if mu.ndim == 2 else mu[None]
    if lzz.ndim == 2:
        # one solve covers every factor's Lu columns and mu: (M, l·M + l)
        el = lu_l.shape[0]
        rhs = torch.cat([lu_l.transpose(0, 1).reshape(m_dim, el * m_dim),
                         mu_l.T], dim=-1)
        sol = torch.linalg.solve_triangular(lzz, rhs, upper=False)
        a = sol[:, :el * m_dim].reshape(m_dim, el, m_dim)
        trace = torch.sum(torch.square(a), dim=(0, 2))
        maha = torch.sum(torch.square(sol[:, el * m_dim:]), dim=0)
    else:
        a = torch.linalg.solve_triangular(lzz, lu_l.expand(lzz.shape),
                                          upper=False)
        trace = torch.sum(torch.square(a), dim=(-2, -1))
        mu_b = mu_l.expand(lzz.shape[:-2] + mu_l.shape[-1:])
        b = torch.linalg.solve_triangular(lzz, mu_b[..., None], upper=False)
        maha = torch.sum(torch.square(b[..., 0]), dim=-1)
    return torch.sum(0.5 * (trace + maha - m_dim) + tril_logdet(lzz)
                     - tril_logdet(lu_l))


def _n_copies(*shapes):
    n = 1
    for d in torch.broadcast_shapes(*shapes):
        n *= int(d)
    return n


def _expected_ll(model, f, y, idx, y_transposed, unnormalized, factor_group):
    """Σ over D and B of the E-averaged count log-likelihood at log-rate
    draws f (E, L, B), or this rank's rows of them, gathered over
    ``factor_group`` first."""
    f = gather_factors(f, factor_group)
    rate = softplus(model.V_raw[idx]) * (softplus(model.W_raw) @ torch.exp(f))
    return _log_lik(model, rate, take_columns(y, idx, y_transposed), unnormalized)


def vnngp_nsf_negative_elbo_batched(model, x, y, idx, eps,
                                    shared_kernel=False, y_transposed=False,
                                    kl_form="matmul", unnormalized=True,
                                    factor_group=None, data_group=None):
    """Minibatch −ELBO of NSF over a VNNGP with every leaf trainable.

    x (N, dim) all spots; y counts (D, N), or (N, D) with ``y_transposed``;
    idx (B,); eps (E, L, B). ``shared_kernel=True`` (equal per-factor
    hyperparameters) computes one (M, M) Gram and Cholesky and conditions
    B points instead of L·B; the L factors stay distinct latent functions,
    so the marginal is broadcast back to (L, B) before the draw and the KL
    is counted once per factor. ``kl_form`` is ``"matmul"`` (against K⁻¹)
    or ``"solve"`` (two triangular solves): the same value.
    ``unnormalized=False`` takes the normalized log-likelihood.
    ``data_group``: idx and eps are this rank's block of the minibatch, and
    the log-likelihood is summed over the group (``collectives.
    sum_over_data``), as in the NSF losses. ``factor_group``: the model
    holds this rank's block of the factors and eps its rows; f is gathered
    over the group before the rate, the KL (this rank's factors' terms) is
    summed over it, and the collapse reads global factor 0's σ and ℓ
    (``train.fast._collapse_shared_kernel``).
    """
    if kl_form not in ("matmul", "solve"):
        raise ValueError(f"kl_form={kl_form!r}: expected 'matmul' or 'solve'")
    gp = _vnngp_prior(model)
    kernel_batch = gp.kernel.batch_shape()
    kernel = (_collapse_shared_kernel(gp.kernel, factor_group) if shared_kernel
              else None)

    qf, qu, pu = gp(x[idx], kernel=kernel)
    lu = qu.scale_tril
    qf_batch = torch.broadcast_shapes(kernel_batch, gp.mu.shape[:-1],
                                      lu.shape[:-2])
    marginal = qf_batch + idx.shape if qf_batch else qf.loc.shape
    f = Normal(qf.loc.expand(marginal), qf.scale.expand(marginal)).sample(eps)
    ll = _expected_ll(model, f, y, idx, y_transposed, unnormalized, factor_group)

    if kl_form == "solve":
        kl = _solve_kl(qu.loc, lu, pu.scale_tril)
    else:
        kl = _matmul_kl(qu.loc, lu, pu.scale_tril)
    # the uncollapsed prior is L-batched: shared mu/Lu still make one KL
    # term per factor
    prior_batch = pu.scale_tril.shape[:-2]
    kl = kl * (_n_copies(gp.mu.shape[:-1], lu.shape[:-2], kernel_batch)
               // _n_copies(gp.mu.shape[:-1], lu.shape[:-2], prior_batch))
    return -(sum_over_data(ll, data_group) - sum_factors(kl, factor_group))


# --- the frozen-Z / frozen-kernel tier ---------------------------------------

@dataclasses.dataclass
class VNNGPConditioning:
    """Step-invariant VNNGP conditioning geometry (Z and kernel frozen).

      idx    — (N, K) int64 nearest inducing points,
      w      — (N, K) conditioning weights blocks⁻¹·little_Kxz,
      c0     — (N,) w·little_Kxz, the variance subtrahend,
      kxx    — kernel variance: scalar σ² or (L, 1), carrying the factor
               count of the uncollapsed kernel,
      k_inv  — (M, M) Kzz⁻¹ for the matmul-form KL,
      logdet_lzz — Σ log diag chol(Kzz).
    """

    idx: torch.Tensor
    w: torch.Tensor
    c0: torch.Tensor
    kxx: torch.Tensor
    k_inv: torch.Tensor
    logdet_lzz: torch.Tensor


@torch.no_grad()
def _vnngp_geometry(kernel, z, x, jitter, k):
    kzz = add_jitter(kernel.gram(z, z), jitter)
    lzz = torch.linalg.cholesky(kzz)
    kxz, distance = kernel.gram_and_distance(x, z)
    idx = _nearest(distance, k)
    del distance
    # the all-trainable path's blocks: the jittered Kzz, jittered again
    blocks = add_jitter(gather_blocks(kzz, idx), jitter)
    little_kxz = torch.gather(kxz, -1, idx)
    del kxz
    w = torch.cholesky_solve(little_kxz[..., None],
                             torch.linalg.cholesky(blocks))[..., 0]
    c0 = torch.sum(w * little_kxz, dim=-1)
    return idx, w, c0, spd_inverse_from_cholesky(lzz), tril_logdet(lzz)


def precompute_vnngp_conditioning(model, x):
    """Build :class:`VNNGPConditioning` for ``model`` over all spots x.

    The kernel's factors must share σ and ℓ (the :class:`VNNGPConfig`
    init): they are collapsed to factor 0, and unequal values raise,
    since a frozen geometry from diverged per-factor hyperparameters would
    be silently wrong for every later step. For the factor-split loss,
    build it from the split model: its ``kxx`` is then this rank's rows."""
    gp = _vnngp_prior(model)
    for name in ("sigma", "lengthscale"):
        v = getattr(gp.kernel, name).detach().reshape(-1)
        if v.numel() > 1 and not bool(torch.all(v == v[0])):
            raise ValueError(
                f"precompute_vnngp_conditioning: per-factor kernel {name} "
                f"values are not equal ({v[:4].tolist()}…); the frozen "
                "conditioning geometry requires a shared kernel")
    idx, w, c0, k_inv, logdet = _vnngp_geometry(
        _collapse_shared_kernel(gp.kernel), gp.Z.detach(), x, gp.jitter, gp.K)
    # the ORIGINAL kernel's variance, broadcast to its factor batch
    kxx = gp.kernel.variance_vector().detach()
    batch = gp.kernel.batch_shape()
    if batch:
        kxx = kxx.reshape(-1, 1).expand(batch[0], 1)
    return VNNGPConditioning(idx=idx, w=w, c0=c0, kxx=kxx, k_inv=k_inv,
                             logdet_lzz=logdet)


def vnngp_nsf_negative_elbo_precomputed(model, cond, y, idx, eps,
                                        y_transposed=False, unnormalized=True,
                                        factor_group=None, data_group=None):
    """Minibatch −ELBO of NSF over a VNNGP from frozen conditioning
    geometry; the same value as the all-trainable loss when Z and the
    kernel do not train. idx (B,), eps (E, L, B); ``factor_group`` and
    ``data_group`` as in :func:`vnngp_nsf_negative_elbo_batched`, with
    ``cond`` made from the factor-split model."""
    gp = _vnngp_prior(model)
    lu = lower_cholesky(gp.Lu_raw)
    lu_l = lu if lu.ndim == 3 else lu[None]
    mu_l = gp.mu if gp.mu.ndim == 2 else gp.mu[None]
    m_dim = lu.shape[-1]

    nb = cond.idx[idx]  # (B, K)
    w = cond.w[idx]  # (B, K)
    little_s = gather_blocks(lu_l @ lu_l.mT, nb)  # (l, B, K, K)
    mean = torch.einsum("lbk,bk->lb", mu_l[..., nb], w)
    quad = torch.einsum("lbij,bi,bj->lb", little_s, w, w)
    cov = cond.kxx - cond.c0[idx] + quad
    mean, cov = torch.broadcast_tensors(mean, cov)
    scale = torch.sqrt(clip_min(cov, gp.var_floor))
    ll = _expected_ll(model, Normal(mean, scale).sample(eps), y, idx,
                      y_transposed, unnormalized, factor_group)

    trace = tri_kl_trace(cond.k_inv, lu_l)
    maha = torch.einsum("lm,mk,lk->l", mu_l, cond.k_inv, mu_l)
    # log diag(Lu) = diag(Lu_raw) exactly under the exp-diag bijector
    raw_l = gp.Lu_raw if gp.Lu_raw.ndim == 3 else gp.Lu_raw[None]
    logdet_q = torch.sum(raw_l.diagonal(dim1=-2, dim2=-1), dim=-1)
    kl_terms = 0.5 * (trace + maha - m_dim) + cond.logdet_lzz - logdet_q
    # shared mu/Lu against an L-batched prior still make one term per factor
    kl = torch.sum(kl_terms) * (mean.shape[0] // kl_terms.shape[0])
    return -(sum_over_data(ll, data_group) - sum_factors(kl, factor_group))
