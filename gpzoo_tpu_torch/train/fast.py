"""The NSF fast losses (port of ``NSFProjection``,
``precompute_nsf_projection``, ``nsf_negative_elbo_precomputed`` and the
W-form branch of ``nsf_negative_elbo_batched`` from
``gpzoo_tpu/train/fast.py``).

The precomputed projection is the north-star training step.

With Z and the kernel frozen, the Cholesky of Kzz, the projection
ã = K⁻¹Kzx over all N spots, K⁻¹ and log|Lzz| are constants: they are
computed once, and a step is then

    mean = μ ãᵀ_b,   cov = σ² − a²_b + colsum((Luᵀ ã_b)²),
    KL   = ½(tr(K⁻¹LuLuᵀ) + μᵀK⁻¹μ − M) + log|Lzz| − log|Lu|  per factor.

Only the unwhitened full-rank SVGP prior with the Poisson NSF head is
ported; the variance term runs through the Hopper kernels of
:mod:`gpzoo_tpu_torch.ops.tri_cuda` on the card.

:func:`nsf_negative_elbo_batched` is the blockwise loss with trainable Z
and kernel, for a per-factor prior Cholesky (MGGP-NSF over an MGGP SVGP,
or NSF over an SVGP with per-factor kernels): the W-form branch, where
per step Lzz, W = Lzz⁻¹, C = W·Lu and Wμ are formed once and each chunk
of the minibatch takes a = W·Kzx and

    mean = (WᵀWμ)ᵀKzx,   cov = Kxx − colsum(a²) + colsum((Cᵀa)²),
    KL   = ½(‖C‖²_F + ‖Wμ‖² − M) + log|Lzz| − log|Lu|  per factor.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from gpzoo_tpu_torch.bijectors import lower_cholesky, softplus
from gpzoo_tpu_torch.dists import Poisson
from gpzoo_tpu_torch.gps.mggp import MGGPSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.kernels.rbf import TiedRBF
from gpzoo_tpu_torch.models.factorization import MGGPNSF, NSF
from gpzoo_tpu_torch.ops.linalg import (add_jitter, cholesky_inverse_mm,
                                        spd_inverse_from_cholesky,
                                        sqrt_safe_grad, tril_logdet)
from gpzoo_tpu_torch.ops.tri_blocked import (tri_kl_trace, tri_matmul,
                                             tri_tri_matmul)
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


def _blockwise_prior(model):
    """The GP of the heads the blockwise loss takes: ``NSF`` over an
    ``SVGP`` (its ``prior``) or ``MGGPNSF`` over an ``MGGPSVGP`` (its
    ``gp``)."""
    gp = getattr(model, "gp_prior", None)
    if (type(model), type(gp)) not in ((NSF, SVGP), (MGGPNSF, MGGPSVGP)):
        raise NotImplementedError(
            "the blockwise loss takes NSF over SVGP or MGGPNSF over MGGPSVGP; "
            f"got {type(model).__name__} over {type(gp).__name__} (whitened, "
            "low-rank, hybrid and legacy heads: ROADMAP §1 items 11-12)")
    return gp


def _kernel_call(kernel, method, *args, groups):
    """kernel.diag / kernel.gram with the group labels appended for an
    MGGP kernel (``groups`` a tuple of labels, or None)."""
    return getattr(kernel, method)(*args, *(groups or ()))


def nsf_negative_elbo_batched(model, x, y, idx, eps, E=1, microbatch=1024,
                              factored=False, y_transposed=False,
                              shared_kernel=False, groups=None, remat=True):
    """Blockwise minibatch −ELBO with trainable Z and kernel: the W-form
    branch (``factored=True`` over a per-factor (L, M, M) prior Cholesky).

    idx (B,) spot indices, B a multiple of ``microbatch``; eps (E, L, B)
    standard-normal draws; counts y (D, N), or (N, D) with
    ``y_transposed``; ``groups`` (N,) labels for an MGGP model. The
    minibatch runs in B / microbatch chunks, a Python loop. ``remat=True``
    recomputes each chunk in the backward under ``torch.utils.checkpoint``;
    ``remat=False`` keeps the chunk's a and Kzx for the backward, which is
    what the JAX package's "save_proj" and "save_proj_kzx" policies save.
    Every product runs in the tensor's dtype: the JAX package's TPU
    precision switches are not taken.

    Raises ``NotImplementedError`` for the branches not ported (ROADMAP §1
    item 9): ``factored=False`` (the cho_solve branch), ``shared_kernel``
    (the collapse and its shared-Cholesky K⁻¹ branch) and any prior whose
    Cholesky is shared; item 11-12 heads via :func:`_blockwise_prior`.
    """
    gp = _blockwise_prior(model)
    if not factored:
        raise NotImplementedError("the non-factored (cho_solve) branch of the "
                                  "blockwise loss is not ported (ROADMAP §1 item 9)")
    if shared_kernel:
        raise NotImplementedError("the shared-kernel collapse of the blockwise "
                                  "loss is not ported (ROADMAP §1 item 9)")
    if not isinstance(remat, bool):
        raise ValueError(f"remat={remat!r}: expected True or False (False keeps "
                         "what the JAX package's 'save_proj' policies save)")
    groups_z = getattr(gp, "groupsZ", None)
    if (groups is None) != (groups_z is None):
        raise ValueError("groups= is needed exactly for a multi-group GP")
    b = idx.shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} not divisible by microbatch {microbatch}")
    n_axis = 0 if y_transposed else y.ndim - 1
    if y.shape[n_axis] != x.shape[0]:
        raise ValueError(f"y spot axis has {y.shape[n_axis]} entries but x has "
                         f"{x.shape[0]} (y_transposed={y_transposed})")

    kernel = gp.kernel
    zg = None if groups_z is None else (groups_z, groups_z)
    kzz = add_jitter(_kernel_call(kernel, "gram", gp.Z, gp.Z, groups=zg),
                     gp.jitter)
    if kzz.ndim != 3:
        raise NotImplementedError("only the W-form branch (a per-factor prior "
                                  "Cholesky) is ported; the shared-Cholesky K⁻¹ "
                                  "branch is ROADMAP §1 item 9")
    lzz, w_inv = cholesky_inverse_mm(kzz)
    lu = lower_cholesky(gp.Lu_raw)
    m_dim = lzz.shape[-1]
    lu_l = lu if lu.ndim == 3 else lu[None]
    mu_l = (gp.mu if gp.mu.ndim == 2 else gp.mu[None]).expand(lzz.shape[0], m_dim)
    c_wlu = tri_tri_matmul(w_inv, lu_l)  # C = W·Lu, lower-triangular
    wmu = torch.einsum("lij,lj->li", w_inv, mu_l)
    m_fac = torch.einsum("lij,li->lj", w_inv, wmu)  # K⁻¹μ = Wᵀ(Wμ)
    trace = torch.sum(torch.square(c_wlu), dim=(-2, -1))
    maha = torch.sum(torch.square(wmu), dim=-1)
    # Every term is broadcast to the prior's factor batch, which is the
    # kernel's: without the collapse the JAX package's KL-copies
    # correction (train/fast.py:403-419) is 1 here.
    kl = torch.sum(0.5 * (trace + maha - m_dim) + tril_logdet(lzz)
                   - tril_logdet(lu_l))

    qf_batch = torch.broadcast_shapes(kernel.batch_shape(), gp.mu.shape[:-1],
                                      lu.shape[:-2])
    if tuple(eps.shape) != (E,) + tuple(qf_batch) + (b,):
        raise ValueError(f"eps must be {(E,) + tuple(qf_batch) + (b,)}, "
                         f"got {tuple(eps.shape)}")
    w_sp = softplus(model.W_raw)  # (D, L)
    v_sp = softplus(model.V_raw[idx])  # (B,)
    y_batch = y[idx].T if y_transposed else y[:, idx]  # (D, B)
    x_batch = x[idx]
    g_batch = None if groups is None else groups[idx]

    def chunk_ll(xc, epsc, vc, yc, gc):
        kxx = _kernel_call(kernel, "diag", xc,
                           groups=None if gc is None else (gc,))
        kzx = _kernel_call(kernel, "gram", gp.Z, xc,
                           groups=None if gc is None else (groups_z, gc))
        a = tri_matmul(w_inv, kzx)  # (L, M, mb)
        mean = torch.einsum("lm,lmb->lb", m_fac, kzx)
        cov = kxx - torch.sum(torch.square(a), dim=-2) + tri_sq_colsum(c_wlu, a)
        scale = torch.sqrt(torch.clamp(cov, min=gp.var_floor))
        rate = vc * (w_sp @ torch.exp(mean + scale * epsc))  # (E, D, mb)
        return torch.sum(torch.mean(
            _count_py(model, rate).unnormalized_log_prob(yc), dim=0))

    chunk_fn = (functools.partial(checkpoint, chunk_ll, use_reentrant=False)
                if remat else chunk_ll)
    ll = 0.0
    for s in range(0, b, microbatch):
        c = slice(s, s + microbatch)
        ll = ll + chunk_fn(x_batch[c], eps[..., c], v_sp[c], y_batch[:, c],
                           None if g_batch is None else g_batch[c])
    return -(ll - kl)


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
