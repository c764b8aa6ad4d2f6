"""Synthetic data generators (a host-numpy copy of ``gpzoo_tpu/data/sim.py``:
the port cannot import ``gpzoo_tpu.data``, whose package imports JAX).

Multi-factor GP-smooth spatial patterns pushed through the NSF observation
model, the 1-D ``2·sin(2x)`` regression toy and the shape-image NMF toy;
every generator draws from ``np.random.default_rng(seed)`` in the JAX
package's order, so the same seed gives the same arrays to the bit.
"""

from __future__ import annotations

import numpy as np


def simulate_1d_regression(key_or_seed=0, n=10_000, noise=0.5, xmax=6.0):
    """The SVGP notebook's toy: x ~ U(0, xmax), y = 2 sin(2x) + ε."""
    rng = np.random.default_rng(key_or_seed)
    x = rng.uniform(0.0, xmax, size=(n, 1)).astype(np.float32)
    y = (2.0 * np.sin(2.0 * x[:, 0]) +
         noise * rng.standard_normal(n)).astype(np.float32)
    return x, y


def _ggblocks_factors(coords, L):
    """Deterministic spatial patterns over [-2,2]²: quadrant blocks,
    rings, and stripes — an nsf-paper-style 'ggblocks' stand-in that gives
    each factor a distinct, highly autocorrelated spatial footprint."""
    x, y = coords[:, 0], coords[:, 1]
    r = np.sqrt(x**2 + y**2)
    patterns = [
        (x > 0) & (y > 0),
        (x < 0) & (y > 0),
        (x < 0) & (y < 0),
        (x > 0) & (y < 0),
        r < 1.0,
        (r > 1.0) & (r < 1.8),
        np.sin(2.0 * x) > 0,
        np.sin(2.0 * y) > 0,
    ]
    out = []
    for l in range(L):
        out.append(patterns[l % len(patterns)].astype(np.float64))
    return np.stack(out, axis=0)  # (L, N)


def _nsf_rate(rng, coords, D, L, mean_counts):
    """Shared NSF ground-truth rate: block factors × Dirichlet loadings.
    Consumes rng draws in the exact order ``simulate_nsf_counts`` always
    did (dirichlet only), so existing seeded fixtures stay bit-identical."""
    fac = _ggblocks_factors(coords, L)  # (L, N) in {0,1}
    log_f = np.log(0.2 + 2.0 * fac)  # active ≈ 2.2, background 0.2
    w = rng.dirichlet(np.ones(L) * 0.5, size=D)  # (D, L) sparse-ish loadings
    rate = w @ np.exp(log_f)  # (D, N)
    rate *= mean_counts / rate.mean()
    return rate, log_f


def simulate_nsf_counts(seed=0, N=2000, D=80, L=4, mean_counts=10.0):
    """Counts from the NSF generative model over block spatial factors.

    Returns (coords (N,2) float32, counts (D,N) float32, true log-factors
    (L,N)). Matches the shape conventions of the reference benchmarks
    (genes × spots, PNMF_benchmarks.ipynb / NSF_benchmarks.ipynb).
    """
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-2.0, 2.0, size=(N, 2))
    rate, log_f = _nsf_rate(rng, coords, D, L, mean_counts)
    counts = rng.poisson(rate).astype(np.float32)
    return coords.astype(np.float32), counts, log_f


def simulate_nb_counts(seed=0, N=2000, D=80, L=4, mean_counts=10.0,
                       total_count=2.0):
    """Overdispersed counts: the same NSF ground-truth rate, observed
    through a negative binomial — counts ~ NB(r=total_count, mean=rate)
    via the gamma-Poisson mixture. The workload for
    :class:`gpzoo_tpu.models.NBNSF` (beyond-reference; Poisson is the
    total_count → ∞ limit). Returns (coords, counts, true log-factors)
    like :func:`simulate_nsf_counts`."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-2.0, 2.0, size=(N, 2))
    rate, log_f = _nsf_rate(rng, coords, D, L, mean_counts)
    lam = rng.gamma(shape=total_count, scale=rate / total_count)
    counts = rng.poisson(lam).astype(np.float32)
    return coords.astype(np.float32), counts, log_f


def simulate_shape_images(seed=0, D=80, side=16, mean_counts=6.0):
    """Count images mixing a dictionary of binary shape components —
    the toy-image NMF workload (reference ``Fake_nmf.ipynb``: PNMF on
    synthetic shape images; pixels play the role of spots).

    Three part-shapes on a ``side × side`` canvas: a filled square
    (top-left), a cross (center), and a diagonal stripe. Each of the D
    images activates a random nonnegative mix of the parts; pixels are
    Poisson counts around the mixed intensity.

    Returns (coords (side², 2) float32 pixel grid coordinates, counts
    (D, side²) float32, parts (3, side²) float64 binary dictionary) —
    same (samples × pixels) orientation as the reference notebook's
    data matrix.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    q = side // 4
    square = (xx < 2 * q) & (yy < 2 * q)
    cross = ((np.abs(xx - side // 2) <= 1) | (np.abs(yy - side // 2) <= 1))
    stripe = np.abs(xx - yy) <= 1
    parts = np.stack([square, cross, stripe]).reshape(3, -1).astype(
        np.float64)  # (3, side²)
    w = rng.gamma(0.5, 1.0, size=(D, 3))  # nonnegative mixes
    rate = w @ (0.1 + parts)  # (D, side²)
    rate *= mean_counts / rate.mean()
    counts = rng.poisson(rate).astype(np.float32)
    coords = np.stack([xx.reshape(-1), yy.reshape(-1)],
                      axis=1).astype(np.float32)
    return coords, counts, parts
