"""NMF warm-start utilities (utilities.py:158-170, 253-375, 50-68; a copy
of ``gpzoo_tpu/data/nmf_init.py``: host numpy and sklearn, no torch).

Like the reference block it mirrors, this is adapted from the original
NSF paper's code (Townes & Engelhardt,
https://github.com/willtownes/nsf-paper — the attribution the reference
carries at utilities.py:46-48); the math is pinned by parity tests.

Used to initialize NSF factor means from a regularized sklearn NMF
(``NSF_Hybrid_benchmark.ipynb (cell 7)``) and to smooth factors onto
inducing locations. Host-side numpy/sklearn code — runs once before
training, never inside a step.
"""

from __future__ import annotations

from math import ceil

import numpy as np


def lnormal_approx_dirichlet(L):
    """Moment-matched lognormal approximation of a flat Dirichlet(α=L)
    (utilities.py:158-170)."""
    sigma2 = np.log(2 * L) - np.log(L + 1)
    mu = -np.log(L) - sigma2 / 2.0
    return mu, np.sqrt(sigma2)


def shrink_factors(f, shrinkage=0.2):
    a = shrinkage
    if 0 < a < 1:
        fsum = f.sum(axis=1, keepdims=True)
        f = f * (1 - a) + a * fsum / float(f.shape[1])
    return f


def shrink_loadings(w, shrinkage=0.2):
    a = shrinkage
    if 0 < a < 1:
        wsum = w.sum(axis=0)
        w = w * (1 - a) + a * wsum / float(w.shape[0])
    return w


def regularized_nmf(y, L, sz=1, pseudocount=1e-2, factors=None,
                    loadings=None, shrinkage=0.2, **kwargs):
    """NMF init shrunk toward a symmetric Dirichlet; returns log-scale
    factors and nonnegative loadings (utilities.py:253-299)."""
    ef = factors
    w = loadings
    if ef is None or w is None:
        from sklearn.decomposition import NMF

        nmf = NMF(L, **kwargs)
        ef = nmf.fit_transform(y)
        w = nmf.components_.T
    w = shrink_loadings(w, shrinkage=shrinkage)
    wsum = w.sum(axis=0)
    ef = shrink_factors(ef * wsum, shrinkage=shrinkage)
    f = np.log(pseudocount + ef) - np.log(sz)
    prior_mu, _ = lnormal_approx_dirichlet(max(L, 1.1))
    beta0 = prior_mu * np.ones(L)
    wt_to_w = f.mean(axis=0) - beta0
    f -= wt_to_w
    w *= np.exp(wt_to_w - np.log(wsum))
    return f, w


def smooth_spatial_factors(f, z, x=None):
    """Regress factors onto space and predict at inducing locations
    (utilities.py:50-68): LinearRegression trend + KNN regression values."""
    m = z.shape[0]
    if x is None:
        beta0 = f.mean(axis=0)
        u = np.tile(beta0, [m, 1])
        beta = None
    else:
        from sklearn.linear_model import LinearRegression
        from sklearn.neighbors import KNeighborsRegressor

        lr = LinearRegression().fit(x, f)
        beta0 = lr.intercept_
        beta = lr.coef_
        nn = max(2, ceil(x.shape[0] / m))
        knn = KNeighborsRegressor(n_neighbors=nn).fit(x, f)
        u = knn.predict(z)
    return u, beta0, beta
