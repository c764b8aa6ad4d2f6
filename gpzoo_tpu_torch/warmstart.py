"""The Slideseq Hybrid-MGGP warm start (port of ``gpzoo_tpu/warmstart.py``):

1. a trained :class:`~gpzoo_tpu_torch.models.PNMF`'s factors are ranked by
   Moran's I (:func:`gpzoo_tpu_torch.data.dims_autocorr`, its KNN graph
   built on x's device);
2. the top ``L_spatial`` become the GP half: an MGGP SVGP whose ``mu`` is
   their PNMF posterior mean at a random inducing subset and whose ``Lu``
   is the diagonal of their PNMF posterior scales there;
3. the rest become the mean-field half as they are;
4. the two halves' loadings are the matching PNMF loading columns.

The hybrid is then fine-tuned with
:func:`gpzoo_tpu_torch.train.elbo.negative_elbo_hybrid_batched` and the
kernel frozen (``freeze_(model, lambda p: ".kernel." not in p)``).
"""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.bijectors import lower_cholesky_inverse, softplus
from gpzoo_tpu_torch.data.metrics import dims_autocorr
from gpzoo_tpu_torch.gps.gaussian_prior import GaussianPrior
from gpzoo_tpu_torch.gps.mggp import MGGPSVGP
from gpzoo_tpu_torch.kernels.mggp import MGGPNSFRBF
from gpzoo_tpu_torch.models.factorization import HybridNSF, PoissonFactorization


@torch.no_grad()
def hybrid_mggp_from_pnmf(generator, pnmf, x, groups_x, *, L_spatial, m_per_group,
                          n_groups, sigma=1.0, lengthscale=4.0, group_diff_param=0.7,
                          jitter=1e-2, n_neighs=6):
    """A warm-started Hybrid-MGGP :class:`HybridNSF` from a trained PNMF,
    on the PNMF's device and dtype.

    * inducing subset: ``n_groups * m_per_group`` distinct spots drawn
      uniformly from ``generator`` (on x's device), not stratified by group;
    * ``mu`` = the Moran-ranked top ``L_spatial`` PNMF posterior means at
      those spots, ``Lu`` = diag(softplus(PNMF scale_raw)) there;
    * the mean-field half = the remaining PNMF factors, scale_pf 1;
    * the loadings = the matching PNMF loading columns, V = 1;
    * the kernel ``MGGPNSFRBF(σ, ℓ, α)`` over ``n_groups`` groups.

    Returns ``(model, moran_idx, moran_i)``, the ranking as numpy arrays.
    """
    n, m_total = x.shape[0], n_groups * m_per_group
    qf, _ = pnmf.prior()
    # rank by Moran's I of the softmax-normalized posterior means
    factors = torch.softmax(qf.mean, dim=-1)
    moran_idx, moran_i = dims_autocorr(factors.T, x, n_neighs=n_neighs)
    order = torch.as_tensor(moran_idx, device=x.device)
    mean_ranked = pnmf.prior.mean[order]  # (L_total, N)
    scale_raw_ranked = pnmf.prior.scale_raw[order]
    w_ranked = pnmf.W_raw[:, order]  # (D, L_total)
    if mean_ranked.shape[0] <= L_spatial:
        raise ValueError(f"PNMF has {mean_ranked.shape[0]} factors; need more than "
                         f"L_spatial={L_spatial} to keep a non-spatial half")

    idx = torch.randperm(n, generator=generator, device=generator.device)[:m_total]
    idx = idx.to(x.device)
    kernel = MGGPNSFRBF.create(sigma=sigma, lengthscale=lengthscale,
                               group_diff_param=group_diff_param, n_groups=n_groups,
                               L=L_spatial, input_dim=x.shape[1], dtype=x.dtype,
                               device=x.device)
    lu = torch.diag_embed(softplus(scale_raw_ranked[:L_spatial][:, idx]))  # (L, M, M)
    gp = MGGPSVGP(kernel, Z=x[idx].clone(), groupsZ=torch.as_tensor(groups_x)[idx],
                  mu=mean_ranked[:L_spatial][:, idx].clone(),
                  Lu_raw=lower_cholesky_inverse(lu), jitter=jitter)
    prior2 = GaussianPrior(mean_ranked[L_spatial:].clone(),
                           scale_raw_ranked[L_spatial:].clone())
    model = HybridNSF(PoissonFactorization(gp, w_ranked[:, :L_spatial].clone()),
                      PoissonFactorization(prior2, w_ranked[:, L_spatial:].clone()),
                      torch.ones((n,), dtype=x.dtype, device=x.device))
    return model, moran_idx, moran_i
