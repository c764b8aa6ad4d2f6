"""Nonnegative Spatial Factorization head (port of
``gpzoo_tpu/models/factorization.py`` NSF).

Counts y (D genes, N spots) are Poisson with rate
``softplus(V) · softplus(W) @ exp(F)``, F from a multi-factor SVGP.
"""

from __future__ import annotations

from torch import nn


class NSF(nn.Module):
    """NSF state: ``prior`` (an SVGP), loadings ``W_raw`` (D, L) and
    per-spot size factors ``V_raw`` (N,), both softplus'd in the rate."""

    def __init__(self, prior, W_raw, V_raw):
        super().__init__()
        self.prior = prior
        self.W_raw = nn.Parameter(W_raw)
        self.V_raw = nn.Parameter(V_raw)
