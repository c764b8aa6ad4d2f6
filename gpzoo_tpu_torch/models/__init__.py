"""Factorization heads."""

from gpzoo_tpu_torch.models.factorization import (MGGPNSF, NBNSF, NSF,
                                                  HybridNSF, HybridNSFExact,
                                                  PoissonFactorization)

__all__ = ["NSF", "NBNSF", "MGGPNSF", "PoissonFactorization", "HybridNSF",
           "HybridNSFExact"]
