"""The NSF fast losses (port of ``NSFProjection``,
``precompute_nsf_projection``, ``nsf_negative_elbo_precomputed`` and
``nsf_negative_elbo_batched`` from ``gpzoo_tpu/train/fast.py``).

The precomputed projection is the north-star training step.

With Z and the kernel frozen, the Cholesky of Kzz, the projection
ã = K⁻¹Kzx over all N spots, K⁻¹ and log|Lzz| are constants: they are
computed once, and a step is then

    mean = μ ãᵀ_b,   cov = σ² − a²_b + colsum((Luᵀ ã_b)²),
    KL   = ½(tr(K⁻¹LuLuᵀ) + μᵀK⁻¹μ − M) + log|Lzz| − log|Lu|  per factor.

The precomputed loss takes every head and prior the JAX one takes: the
Poisson (unnormalized or normalized) and negative-binomial NSF heads and
the hybrids (:class:`HybridNSF`, with its mean-field half's own draws,
and the draw-free :class:`HybridNSFExact`), over the unwhitened
:class:`SVGP`, the whitened :class:`WSVGP` (ã is then a = Lzz⁻¹Kzx and the
KL is against N(0, I)) or :class:`LowRankWSVGP` (the variance term is two
thin products, d²·ã² + colsum((Vᵀã)²)). The full-rank variance term runs
through the Hopper kernels of :mod:`gpzoo_tpu_torch.ops.tri_cuda` on the
card.

:func:`nsf_negative_elbo_batched` is the blockwise loss, where Z and the
kernel may train: the Gram, its Cholesky and the KL are formed once a
step, and the minibatch runs in chunks, each projecting its Kzx by
products against the hoisted factors (or by the library's solves when
not ``factored``). It takes the same heads over SVGP, WSVGP, MGGPSVGP and
MGGPWSVGP priors; its branches are listed in its docstring.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpzoo_tpu_torch.bijectors import lower_cholesky, softplus
from gpzoo_tpu_torch.dists import (NegativeBinomial, Normal, Poisson,
                                   kl_normal_normal)
from gpzoo_tpu_torch.gps.mggp import MGGPSVGP, MGGPWSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP, WSVGP, LowRankWSVGP
from gpzoo_tpu_torch.kernels.mggp import MGGPMath, TiedMGGPRBF
from gpzoo_tpu_torch.kernels.rbf import TiedRBF
from gpzoo_tpu_torch.models.factorization import HybridNSFExact
from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.linalg import (add_jitter, cholesky_inverse_mm,
                                        cholesky_mm, lowrank_whitened_kl,
                                        spd_inverse_from_cholesky,
                                        sqrt_safe_grad, tri_inverse,
                                        tril_logdet, whitened_kl)
from gpzoo_tpu_torch.ops.precision import matmul
from gpzoo_tpu_torch.ops.tri_blocked import tri_matmul, tri_tri_matmul
from gpzoo_tpu_torch.ops.tri_cuda import tri_kl_trace, tri_sq_colsum
from gpzoo_tpu_torch.parallel.collectives import (factor_block, first_factor,
                                                  gather_factors, sum_factors,
                                                  sum_over_data, take_columns)
# WELL_JITTERED is re-exported: the gate's constant lives in train/policy.py
from gpzoo_tpu_torch.train.policy import WELL_JITTERED, resolve_policy  # noqa: F401


@dataclasses.dataclass
class NSFProjection:
    """Step-invariant GP projection for frozen Z and a frozen shared kernel.

      proj_t — (N, M) spot-major rows of ã = K⁻¹Kzx (unwhitened) or of
               a = Lzz⁻¹Kzx (whitened),
      a2     — (N,) column sums of (Lzz⁻¹Kzx)²,
      kxx    — kernel variance: scalar σ² or (L, 1),
      k_inv  — (M, M) Kzz⁻¹ (None when whitened),
      logdet_lzz — Σ log diag Lzz (None when whitened),
      whitened — whether the prior is whitened.
    """

    proj_t: torch.Tensor
    a2: torch.Tensor
    kxx: torch.Tensor
    k_inv: torch.Tensor | None = None
    logdet_lzz: torch.Tensor | None = None
    whitened: bool = False


def _matmul_kl(mu, lu, lzz, k_inv=None):
    """Σ_l KL(N(μ_l, Lu_l Lu_lᵀ) ‖ N(0, Kzz_l)) in matmul form against K⁻¹:

        KL_l = ½(tr(K_l⁻¹ S_l) + μ_lᵀK_l⁻¹μ_l − M) + log|Lzz_l| − log|Lu_l|,

    with ``lzz`` shared (M, M) or per-factor (L, M, M), and K⁻¹ passed by
    a caller that already holds it, else formed from ``lzz``."""
    m_dim = lzz.shape[-1]
    if k_inv is None:
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


def _mvn_kl(mu, lu, lzz):
    """Σ KL(N(μ, Lu Luᵀ) ‖ N(0, Lzz Lzzᵀ)) by triangular solves, batched
    over the broadcast leading dims of μ, Lu and Lzz:
    ½(‖Lzz⁻¹Lu‖²_F + ‖Lzz⁻¹μ‖² − M) + log|Lzz| − log|Lu|."""
    batch = torch.broadcast_shapes(mu.shape[:-1], lu.shape[:-2], lzz.shape[:-2])
    m_dim = lu.shape[-1]
    lu, lzz = lu.expand(batch + (m_dim, m_dim)), lzz.expand(batch + (m_dim, m_dim))
    a = torch.linalg.solve_triangular(lzz, lu, upper=False)
    mu = mu.expand(batch + (m_dim,))
    b = torch.linalg.solve_triangular(lzz, mu[..., None], upper=False)[..., 0]
    return torch.sum(0.5 * (torch.sum(a * a, dim=(-2, -1))
                            + torch.sum(b * b, dim=-1) - m_dim)
                     + tril_logdet(lzz) - tril_logdet(lu))


def _split_head(model):
    """(head, gp, hybrid) of a factorization head: ``head`` owns the
    spatial loadings ``W_raw`` (and ``r_raw`` for the negative binomial),
    ``gp`` is the spatial prior. A :class:`HybridNSF` (or
    :class:`HybridNSFExact`) gives its spatial half ``model.sf`` and
    hybrid True; the mean-field half is read off ``model.cf`` by the
    caller. The JAX package's ``LegacyHybridNSF`` (raw, un-softplus'd
    concatenated loadings ``W2_raw``) is refused, as there: its rate
    does not fit the softplus-rate losses."""
    if hasattr(model, "W2_raw"):
        raise NotImplementedError(
            "LegacyHybridNSF's raw-loadings rate is not supported by the fast "
            "losses; use train.elbo.negative_elbo_hybrid_batched")
    if hasattr(model, "sf") and hasattr(model, "cf"):
        return model.sf, model.sf.prior, True
    return model, getattr(model, "gp_prior", None), False


def _require_prior(gp, types, where):
    """``gp`` if it is exactly one of ``types``, else NotImplementedError."""
    if type(gp) not in types:
        raise NotImplementedError(
            f"{where} takes a prior of type "
            f"{' or '.join(t.__name__ for t in types)}; got {type(gp).__name__}")
    return gp


def _count_py(head, rate):
    """The head's count likelihood at mean ``rate``: Poisson, or negative
    binomial when the head carries the per-gene dispersion ``r_raw`` of
    :class:`NBNSF`. Both have the unnormalized and the normalized log-prob."""
    r_raw = getattr(head, "r_raw", None)
    if r_raw is None:
        return Poisson(rate)
    return NegativeBinomial(softplus(r_raw)[:, None], rate)


def _log_lik(head, rate, y_batch, unnormalized):
    """Σ over genes and spots of the draw-averaged log-likelihood of
    counts y_batch (D, B) at rate (E, D, B). For a draw-free rate (D, B)
    the mean runs over D instead: the JAX package's quirk on the exact
    hybrid head, kept."""
    py = _count_py(head, rate)
    lp = py.unnormalized_log_prob(y_batch) if unnormalized else py.log_prob(y_batch)
    return torch.sum(torch.mean(lp, dim=0))


def _exact_f(mean, scale):
    """:class:`HybridNSFExact`'s draw-free log-rate μ + ½σ², so that the
    rate is the lognormal mean E[e^F] = exp(μ + ½σ²)."""
    return mean + 0.5 * torch.square(scale)


def _meanfield_kl(mean2, scale2, scale_pf):
    """Σ KL(N(m, s²) ‖ N(0, scale_pf²)) over a (T, B) mean-field slice:
    the hybrid head's second KL term."""
    return torch.sum(kl_normal_normal(
        Normal(mean2, scale2),
        Normal(torch.zeros_like(mean2), scale_pf * torch.ones_like(scale2))))


def _collapse_shared_kernel(kernel, factor_group=None):
    """Factor 0's σ and ℓ of an L-batched kernel whose factors are known
    to be equal: the Gram and Cholesky are then computed once. An MGGP
    kernel keeps its group parameter (batched or not) and embedding, so
    its collapsed Gram may stay (L, M, M), as in the JAX package.

    σ and ℓ stay views of the original parameters, so the whole σ/ℓ
    gradient reaches factor 0 of them and the other factors get 0, as
    with the JAX package's ``kernel.replace``. Only the sum over factors
    is meaningful: train the hyperparameters through the collapse only as
    one tied parameter.

    Under ``factor_group`` (``kernel`` this rank's, from
    :func:`_factor_kernel`) factor 0 is global factor 0, which only the
    group's rank 0 holds: :func:`~gpzoo_tpu_torch.parallel.collectives.
    first_factor` brings it to every rank and records the leaf; each
    rank's σ/ℓ gradient lands in its own first row, and the sharded step
    sums the recorded leaves' first rows into factor 0
    (``collectives.route_first_rows_``)."""
    sigma = first_factor(kernel.sigma, factor_group)
    ell = first_factor(kernel.lengthscale, factor_group)
    if isinstance(kernel, MGGPMath):
        return TiedMGGPRBF(sigma, ell, kernel.group_diff_param, kernel.embedding,
                           kernel.input_dim, kernel.convention)
    return TiedRBF(sigma, ell, kernel.input_dim)


def _factor_kernel(kernel, factor_group):
    """This rank's view of a kernel whose σ and ℓ are split over
    ``factor_group``: an MGGP kernel's group parameter is not split (it is
    not a per-factor leaf of the sharding), so the view takes this rank's
    rows of it (``collectives.factor_block``; a scalar passes whole). The
    kernel itself without a group, or for an RBF."""
    if factor_group is None or not isinstance(kernel, MGGPMath):
        return kernel
    return TiedMGGPRBF(kernel.sigma, kernel.lengthscale,
                       factor_block(kernel.group_diff_param, factor_group),
                       kernel.embedding, kernel.input_dim, kernel.convention)


#: The priors of the blockwise loss: unwhitened and whitened.
_UNWHITENED = (SVGP, MGGPSVGP)
_WHITENED = (WSVGP, MGGPWSVGP)


def _blockwise_prior(model):
    """(head, gp, hybrid) of a model the blockwise loss takes: a head of
    :func:`_split_head` over an SVGP, WSVGP, MGGPSVGP or MGGPWSVGP. As in
    the JAX package, :class:`LowRankWSVGP` is refused (its loss is the
    precomputed one), and so is any other prior (a VNNGP has its own)."""
    head, gp, hybrid = _split_head(model)
    if type(gp) is LowRankWSVGP:
        raise NotImplementedError(
            "LowRankWSVGP is supported by nsf_negative_elbo_precomputed; the "
            "blockwise loss is built around the full Cholesky factor")
    _require_prior(gp, _UNWHITENED + _WHITENED, "nsf_negative_elbo_batched")
    return head, gp, hybrid


def _kernel_call(kernel, method, *args, groups):
    """kernel.diag / kernel.gram with the group labels appended for an
    MGGP kernel (``groups`` a tuple of labels, or None)."""
    return getattr(kernel, method)(*args, *(groups or ()))


def nsf_negative_elbo_batched(model, x, y, idx, eps=None, eps2=None, E=1,
                              microbatch=1024, factored=False,
                              y_transposed=False, shared_kernel=False,
                              groups=None, remat=True, stable_projection=None,
                              unnormalized=True, factor_group=None,
                              data_group=None, grad_precision=None,
                              proj_precision=None, chol_precision=None):
    """Blockwise minibatch −ELBO with trainable Z and kernel, for the heads
    of :func:`_split_head` (NSF, NBNSF, MGGPNSF, HybridNSF, HybridNSFExact)
    over an SVGP, WSVGP, MGGPSVGP or MGGPWSVGP.

    idx (B,) spot indices, B a multiple of ``microbatch``; eps (E, *qf, B)
    standard-normal draws of the GP half (qf the broadcast of the
    kernel's factor batch and μ's and Lu's leading dims, (L,) in every
    configuration), and for a :class:`HybridNSF` eps2 (E, T, B) those of
    its mean-field half (the JAX loss splits its key into the two);
    :class:`HybridNSFExact` takes neither. Counts y (D, N), or (N, D) with
    ``y_transposed``; ``groups`` (N,) labels for a multi-group prior. The
    minibatch runs in B / microbatch chunks, a Python loop. ``remat``, as in
    the JAX package (``train.policy``): True recomputes each chunk in the
    backward under ``torch.utils.checkpoint``; "save_proj" recomputes it
    but keeps the chunk's projection a (and ã); "save_proj_kzx" keeps its
    Gram columns Kzx too; False (or None) recomputes nothing.
    ``unnormalized=False`` takes the normalized log-likelihood.

    The branches, in the JAX package's order of dispatch:
      * ``shared_kernel``: the kernel collapses to factor 0's σ and ℓ
        (:func:`_collapse_shared_kernel`); the KL is then scaled by the
        number of copies the uncollapsed prior would have made;
      * ``factored`` over an unwhitened per-factor (L, M, M) Cholesky: the
        W-form, with Lzz, W = Lzz⁻¹, C = W·Lu, Wμ and K⁻¹μ = Wᵀ(Wμ) formed
        once and, per chunk, a = W·Kzx, mean = (K⁻¹μ)ᵀKzx,
        cov = Kxx − colsum(a²) + colsum((Cᵀa)²);
      * ``factored`` over a shared (M, M) unwhitened Cholesky: the KL in
        matmul form against K⁻¹, and per chunk ã = K⁻¹Kzx with
        cov = Kxx − colsum(Kzx ⊙ ã) + colsum((Luᵀã)²), or, in the stable
        form, a = W·Kzx, ã = Wᵀa and cov = Kxx − colsum(a²) + …;
      * ``factored`` over a whitened prior: a = W·Kzx,
        cov = max(Kxx − colsum(a²), 0) + colsum((Luᵀa)²), mean = (Wᵀμ)ᵀKzx
        and the KL against N(0, I);
      * not ``factored``: per chunk the library's triangular solves
        (``cholesky_solve`` unwhitened, ``solve_triangular`` whitened).
    ``stable_projection`` picks the form of the shared-Cholesky branch;
    by default it is stable below a jitter of 1e-2, and always for a
    whitened prior. ``grad_precision``, ``proj_precision`` and
    ``chol_precision`` are the JAX package's precision knobs, resolved by
    :func:`~gpzoo_tpu_torch.train.policy.resolve_policy` (None: its auto
    rule from the jitter), each string a Hopper math mode of
    :mod:`gpzoo_tpu_torch.ops.precision` that holds in the backward and in
    a recompute too: ``grad_precision`` the W-form's Cholesky-and-inverse
    backward (panel-blocked at "highest"), ``proj_precision`` its a = W·Kzx
    and C = W·Lu, ``chol_precision`` the products that build W and K⁻¹ on
    every factored branch. The mean's products stay at "highest". On float64
    or CPU tensors no mode changes a number. colsum((Luᵀa)²) runs through
    the Hopper kernels of :mod:`gpzoo_tpu_torch.ops.tri_cuda` on the card.

    ``factor_group`` and ``data_group`` shard the loss as in
    :func:`nsf_negative_elbo_precomputed`: each chunk's f is gathered over
    the factor group before the rate. Under a factor group an MGGP
    kernel's whole group parameter enters by this rank's rows
    (:func:`_factor_kernel`), the collapse takes global factor 0's σ and ℓ
    (:func:`_collapse_shared_kernel`), and the KL's copy count is this
    rank's share of the factors.
    """
    head, gp, hybrid = _blockwise_prior(model)
    exact = isinstance(model, HybridNSFExact)
    whitened = type(gp) in _WHITENED
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

    kernel = _factor_kernel(gp.kernel, factor_group)
    kernel_batch = kernel.batch_shape()  # before the collapse
    if shared_kernel:
        kernel = _collapse_shared_kernel(kernel, factor_group)
    zg = None if groups_z is None else (groups_z, groups_z)
    kzz = add_jitter(_kernel_call(kernel, "gram", gp.Z, gp.Z, groups=zg),
                     gp.jitter)
    pol = resolve_policy(gp.jitter, whitened=whitened, factored=factored,
                         per_factor_chol=kzz.ndim == 3,
                         stable_projection=stable_projection,
                         grad_precision=grad_precision,
                         proj_precision=proj_precision, remat=remat,
                         chol_precision=chol_precision)
    w_form, stable, chol = pol.w_form, pol.stable_projection, pol.chol_precision
    mu = gp.mu
    if w_form:
        lzz, w_inv = cholesky_inverse_mm(kzz, pol.grad_precision, pol.bwd_blocked,
                                         chol)
    else:
        lzz = cholesky_mm(kzz)
    lu = lower_cholesky(gp.Lu_raw)
    m_dim = lzz.shape[-1]

    k_inv = s_cov = c_wlu = m_fac = None
    if factored and not w_form:
        w_inv = tri_inverse(lzz, precision=chol) if stable else None
        if whitened:
            m_fac = matmul(mu[..., None, :], w_inv, "highest")[..., 0, :]  # Wᵀμ
        else:
            k_inv = (spd_inverse_from_cholesky(lzz, precision=chol) if w_inv is None
                     else matmul(w_inv.mT, w_inv, chol))
            m_fac = matmul(k_inv, mu[..., None], "highest")[..., 0]  # K⁻¹μ
    elif not factored:
        w_inv = None

    if whitened:
        kl = torch.sum(whitened_kl(mu, lu))
    elif w_form:
        lu_l = lu if lu.ndim == 3 else lu[None]
        mu_l = (mu if mu.ndim == 2 else mu[None]).expand(lzz.shape[0], m_dim)
        c_wlu = tri_tri_matmul(w_inv, lu_l, pol.proj_precision)  # lower-triangular
        wmu = matmul(w_inv, mu_l[..., None], "highest")[..., 0]
        m_fac = matmul(wmu[:, None, :], w_inv, "highest")[:, 0, :]  # K⁻¹μ = Wᵀ(Wμ)
        kl = torch.sum(0.5 * (torch.sum(torch.square(c_wlu), dim=(-2, -1))
                              + torch.sum(torch.square(wmu), dim=-1) - m_dim)
                       + tril_logdet(lzz) - tril_logdet(lu_l))
    elif factored:
        kl = _matmul_kl(mu, lu, lzz, k_inv)
    else:
        kl = _mvn_kl(mu, lu, lzz)
        s_cov = lu @ lu.mT  # S = Lu Luᵀ, read by every chunk
    post_batch = kzz.shape[:-2]
    if not whitened and post_batch != kernel_batch:
        # the uncollapsed prior broadcasts q(u) against its L factors, so
        # with shared μ and Lu it sums L equal KL terms; the collapsed
        # branches computed broadcast(μ, Lu, collapsed Lzz) of them
        def copies(kb):
            return math.prod(torch.broadcast_shapes(mu.shape[:-1], lu.shape[:-2], kb))
        kl = kl * (copies(kernel_batch) // copies(post_batch))

    mean2 = scale2 = w2_sp = None
    kl2 = 0.0
    if hybrid:
        prior2 = model.cf.prior
        mean2 = prior2.mean[:, idx]  # (T, B)
        scale2 = softplus(prior2.scale_raw[:, idx])
        w2_sp = softplus(model.cf.W_raw)  # (D, T)
        # apart from the copies correction: the mean-field KL has no kernel
        kl2 = _meanfield_kl(mean2, scale2, prior2.scale_pf)

    qf_batch = tuple(torch.broadcast_shapes(kernel_batch, mu.shape[:-1],
                                            lu.shape[:-2]))
    if exact:
        if eps is not None or eps2 is not None:
            raise ValueError("HybridNSFExact takes no draws (eps, eps2)")
    else:
        if eps is None or tuple(eps.shape) != (E,) + qf_batch + (b,):
            raise ValueError(f"eps must be {(E,) + qf_batch + (b,)}, got "
                             f"{None if eps is None else tuple(eps.shape)}")
        if hybrid:
            _check_draws("eps2", eps2, mean2.shape)
            if eps2.shape[0] != E:
                raise ValueError("eps and eps2 must have the same number of draws")
        elif eps2 is not None:
            raise ValueError("eps2 is the draws of a HybridNSF's mean-field half")
    w_sp = softplus(head.W_raw)  # (D, L)
    v_sp = softplus(model.V_raw[idx])  # (B,)
    y_batch = take_columns(y, idx, y_transposed)  # (D, B)
    x_batch = x[idx]
    g_batch = None if groups is None else groups[idx]
    lu_l = lu if lu.ndim == 3 else lu[None]

    def sq_colsum(a):
        """colsum((Luᵀa)²) through kernel 1, shaped as the JAX package's
        broadcast of Lu against a."""
        if a.ndim == 3 and lu_l.shape[0] != a.shape[0]:
            return tri_sq_colsum(lu_l.expand(a.shape[0], -1, -1).contiguous(), a)
        out = tri_sq_colsum(lu_l, a)
        return out if lu.ndim == 3 else out[0]

    def gram_fn(xc, epsc, gc, *rest):
        """The chunk's Gram columns Kzx (L, M, mb) or (M, mb)."""
        return _kernel_call(kernel, "gram", gp.Z, xc,
                            groups=None if gc is None else (groups_z, gc))

    def chunk_f(xc, epsc, gc, kzx=None, keep=None):
        """The chunk's f; ``kzx`` if the remat policy keeps it, and ``keep``
        its record of the projection products it keeps (train.policy)."""
        kxx = _kernel_call(kernel, "diag", xc,
                           groups=None if gc is None else (gc,))
        if kzx is None:
            kzx = gram_fn(xc, epsc, gc)
        if w_form:
            a = tri_matmul(w_inv, kzx, pol.proj_precision, keep)  # (L, M, mb)
            mean = matmul(m_fac[:, None, :], kzx, "highest")[:, 0, :]
            cov = (kxx - torch.sum(torch.square(a), dim=-2)
                   + tri_sq_colsum(c_wlu, a))
            scale = torch.sqrt(clip_min(cov, gp.var_floor))
        elif factored:
            mean = matmul(m_fac[..., None, :], kzx, "highest")[..., 0, :]
            if stable:
                a = matmul(w_inv, kzx, "highest", keep)
                cov = kxx - torch.sum(torch.square(a), dim=-2)
                if whitened:
                    cov = clip_min(cov, 0.0)
                else:
                    a = matmul(w_inv.mT, a, "highest", keep)  # ã = Wᵀa = K⁻¹Kzx
            else:
                a = matmul(k_inv, kzx, "highest", keep)
                cov = kxx - torch.sum(kzx * a, dim=-2)
            cov = cov + sq_colsum(a.contiguous())
            scale = (sqrt_safe_grad(cov) if whitened
                     else torch.sqrt(clip_min(cov, gp.var_floor)))
        elif whitened:
            w = torch.linalg.solve_triangular(lzz, kzx, upper=False).mT
            cov = clip_min(kxx - torch.sum(torch.square(w), dim=-1), 0.0)
            cov = cov + torch.sum(torch.square(w @ lu), dim=-1)
            mean = torch.einsum("...nm,...m->...n", w, mu)
            scale = sqrt_safe_grad(cov)
        else:
            w = torch.cholesky_solve(kzx, lzz).mT
            mean = torch.einsum("...nm,...m->...n", w, mu)
            cov = kxx + torch.sum((w @ (s_cov - kzz)) * w, dim=-1)
            scale = torch.sqrt(clip_min(cov, gp.var_floor))
        if exact:
            f = _exact_f(mean, scale)
            return f.expand(qf_batch + f.shape[-1:])
        return mean + scale * epsc  # (E, L, mb)

    def chunk_rate_ll(f, vc, yc, m2c, s2c, e2c):
        rate = w_sp @ torch.exp(f)  # (E, D, mb) or (D, mb)
        if hybrid:
            f2 = _exact_f(m2c, s2c) if exact else m2c + s2c * e2c
            rate = rate + w2_sp @ torch.exp(f2)
        return _log_lik(head, vc * rate, yc, unnormalized)

    def chunk_ll(xc, epsc, gc, vc, yc, m2c, s2c, e2c, kzx=None, keep=None):
        return chunk_rate_ll(chunk_f(xc, epsc, gc, kzx, keep), vc, yc, m2c, s2c, e2c)

    if factor_group is None:
        chunk_fn = pol.wrap_remat(chunk_ll, gram_fn)
    else:
        # the gather's all-reduce stays outside the recomputed regions, so
        # that no collective runs in the backward
        f_fn = pol.wrap_remat(chunk_f, gram_fn)
        ll_fn = dataclasses.replace(pol, remat=bool(pol.remat)).wrap_remat(chunk_rate_ll)

        def chunk_fn(xc, epsc, gc, *rest):
            return ll_fn(gather_factors(f_fn(xc, epsc, gc), factor_group), *rest)
    ll = 0.0
    for s in range(0, b, microbatch):
        c = slice(s, s + microbatch)
        ll = ll + chunk_fn(
            x_batch[c], None if exact else eps[..., c],
            None if g_batch is None else g_batch[c], v_sp[c], y_batch[:, c],
            *((mean2[:, c], scale2[:, c],
               None if exact else eps2[..., c]) if hybrid else (None,) * 3))
    batch_term = sum_over_data(ll - kl2, data_group)
    return -(batch_term - sum_factors(kl, factor_group))


_PRECOMPUTED_PRIORS = (SVGP, WSVGP, LowRankWSVGP)


@torch.no_grad()
def precompute_nsf_projection(model, x, block=None):
    """Build :class:`NSFProjection` for ``model`` over all spots ``x``.

    Assumes the kernel's factors share their hyperparameters (the
    north-star init) and collapses them to factor 0. A whitened prior
    (:class:`WSVGP`, :class:`LowRankWSVGP`) keeps a = Lzz⁻¹Kzx with no
    second solve, no K⁻¹ and no log|Lzz|. ``block`` solves the spots in
    blocks of that many, bounding the (M, block) working set (default:
    all N at once); the values do not depend on it.
    """
    _, gp, _ = _split_head(model)
    _require_prior(gp, _PRECOMPUTED_PRIORS, "precompute_nsf_projection")
    whitened = type(gp) is not SVGP
    kernel = _collapse_shared_kernel(gp.kernel)
    z = gp.Z.contiguous()
    lzz = torch.linalg.cholesky(add_jitter(kernel.gram(z, z), gp.jitter))
    n = x.shape[0]
    block = n if block is None else block
    rows, a2s = [], []
    for s in range(0, n, block):
        a = torch.linalg.solve_triangular(
            lzz, kernel.gram(z, x[s:s + block].contiguous()), upper=False)
        a2s.append(torch.sum(torch.square(a), dim=0))
        rows.append((a if whitened else
                     torch.linalg.solve_triangular(lzz.mT, a, upper=True)).T)
        del a
    proj_t = (torch.cat(rows) if len(rows) > 1 else rows[0]).contiguous()
    a2 = torch.cat(a2s) if len(a2s) > 1 else a2s[0]
    # the ORIGINAL kernel's variance, broadcast to its factor batch: the
    # (L, 1) shape carries the factor count into the loss's KL copy count
    kxx = gp.kernel.variance_vector().detach()
    batch = gp.kernel.batch_shape()
    if batch:
        kxx = kxx.reshape(-1, 1).expand(batch[0], 1)
    if whitened:
        return NSFProjection(proj_t=proj_t, a2=a2, kxx=kxx, whitened=True)
    return NSFProjection(proj_t=proj_t, a2=a2, kxx=kxx,
                         k_inv=spd_inverse_from_cholesky(lzz),
                         logdet_lzz=tril_logdet(lzz))


def _check_draws(name, draws, batch):
    """Draws of shape (E, *batch), else ValueError."""
    if draws is None or draws.ndim != len(batch) + 1 or draws.shape[1:] != batch:
        raise ValueError(f"{name} must be (E, {', '.join(map(str, batch))}), got "
                         f"{None if draws is None else tuple(draws.shape)}")


def nsf_negative_elbo_precomputed(model, proj, y, idx, eps=None, eps2=None,
                                  y_transposed=False, unnormalized=True,
                                  factor_group=None, data_group=None):
    """Minibatch −ELBO of an NSF-family head from a frozen projection.

    idx (B,) spot indices; eps (E, L, B) standard-normal draws of the
    reparameterization of the GP half, and for a :class:`HybridNSF` eps2
    (E, T, B) those of its mean-field half (taken as arguments: torch and
    JAX never draw the same numbers; the JAX loss splits its key into
    the two). :class:`HybridNSFExact` takes neither: its rate is the
    lognormal mean. Counts y are (D, N), or (N, D) with ``y_transposed``.
    Log-likelihood (unnormalized unless ``unnormalized=False``) averaged
    over E, summed over D and B; the KL is not scaled by N/B.

    Sharded (``gpzoo_tpu_torch.parallel``): with ``factor_group`` the
    model and ``proj`` hold this rank's block of the factors and eps its
    rows; f is gathered over the group before the rate, and the GP's KL is
    summed over it. With ``data_group``, idx and the draws are this rank's
    block of the minibatch, and the minibatch terms (the log-likelihood and
    a hybrid's mean-field KL) are summed over the group, so that the value
    is the global −ELBO on every rank (``collectives.sum_over_data``).
    """
    head, gp, hybrid = _split_head(model)
    _require_prior(gp, _PRECOMPUTED_PRIORS, "nsf_negative_elbo_precomputed")
    exact = isinstance(model, HybridNSFExact)
    lowrank = type(gp) is LowRankWSVGP
    if proj.whitened != (type(gp) is not SVGP):
        raise ValueError("the projection's whitened flag does not match the prior")
    mu_l = gp.mu if gp.mu.ndim == 2 else gp.mu[None]

    at = proj.proj_t[idx].T.contiguous()  # (M, B), the kernel's layout
    mean = mu_l @ at
    if lowrank:
        # colsum(ãᵀ(D + VVᵀ)ã) = d²·ã² + colsum((Vᵀã)²): two thin
        # products, no (L, M, M) tensor
        d2 = torch.square(softplus(gp.d_raw))
        d2_l = d2 if d2.ndim == 2 else d2[None]
        v_l = gp.V if gp.V.ndim == 3 else gp.V[None]
        c2 = d2_l @ torch.square(at) + torch.sum(torch.square(v_l.mT @ at), dim=-2)
    else:
        lu = lower_cholesky(gp.Lu_raw)
        lu_l = lu if lu.ndim == 3 else lu[None]
        m_dim = lu.shape[-1]
        c2 = tri_sq_colsum(lu_l, at)  # (L, B)
    base = proj.kxx - proj.a2[idx]
    if proj.whitened:
        cov = clip_min(base, 0.0) + c2
    else:
        cov = clip_min(base + c2, gp.var_floor)
    mean, cov = torch.broadcast_tensors(mean, cov)
    scale = sqrt_safe_grad(cov)

    if exact:
        if eps is not None or eps2 is not None:
            raise ValueError("HybridNSFExact takes no draws (eps, eps2)")
        f = _exact_f(mean, scale)  # (L, B)
    else:
        _check_draws("eps", eps, mean.shape)
        f = mean + scale * eps  # (E, L, B)
    f = gather_factors(f, factor_group)
    rate = softplus(head.W_raw) @ torch.exp(f)  # (E, D, B) or (D, B)
    kl2 = 0.0
    if hybrid:
        prior2 = model.cf.prior
        mean2 = prior2.mean[:, idx]  # (T, B)
        scale2 = softplus(prior2.scale_raw[:, idx])
        if exact:
            f2 = _exact_f(mean2, scale2)
        else:
            _check_draws("eps2", eps2, mean2.shape)
            if eps2.shape[0] != eps.shape[0]:
                raise ValueError("eps and eps2 must have the same number of draws")
            f2 = mean2 + scale2 * eps2
        rate = rate + softplus(model.cf.W_raw) @ torch.exp(f2)
        kl2 = _meanfield_kl(mean2, scale2, prior2.scale_pf)
    elif eps2 is not None:
        raise ValueError("eps2 is the draws of a HybridNSF's mean-field half")
    rate = softplus(model.V_raw[idx]) * rate
    ll = _log_lik(head, rate, take_columns(y, idx, y_transposed), unnormalized)
    batch_term = sum_over_data(ll - kl2, data_group)

    if lowrank:
        kl = torch.sum(lowrank_whitened_kl(gp.mu, gp.V, d2))
    elif proj.whitened:
        kl = torch.sum(whitened_kl(gp.mu, lu))
    else:
        trace = tri_kl_trace(proj.k_inv, lu_l)
        maha = torch.einsum("lm,mk,lk->l", mu_l, proj.k_inv, mu_l)
        # log diag(Lu) = diag(Lu_raw) exactly under the exp-diag bijector
        raw_l = gp.Lu_raw if gp.Lu_raw.ndim == 3 else gp.Lu_raw[None]
        logdet_q = torch.sum(raw_l.diagonal(dim1=-2, dim2=-1), dim=-1)
        kl_terms = 0.5 * (trace + maha - m_dim) + proj.logdet_lzz - logdet_q
        # shared mu/Lu against an L-batched prior still make n_factors KL terms
        n_factors = mean.shape[0]
        kl = torch.sum(kl_terms) * (n_factors // kl_terms.shape[0])
    return -(batch_term - sum_factors(kl, factor_group))
