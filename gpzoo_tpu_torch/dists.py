"""Count distributions (port of the Poisson subset of ``gpzoo_tpu/dists.py``)."""

from __future__ import annotations

import torch


class Poisson:
    """Poisson with mean ``rate``."""

    def __init__(self, rate):
        self.rate = rate

    def unnormalized_log_prob(self, x):
        """``y·log(rate) − rate``, dropping the data-only ``log y!``.
        ``xlogy`` gives the limit 0 at y = rate = 0."""
        return torch.xlogy(x, self.rate) - self.rate
