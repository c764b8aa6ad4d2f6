"""Factorization heads and the Gaussian likelihoods."""

from gpzoo_tpu_torch.models.factorization import (MGGPNSF, NBNSF, NSF, PNMF,
                                                  HybridNSF, HybridNSFExact,
                                                  LegacyHybridNSF, LegacyNSF,
                                                  PoissonFactorization)
from gpzoo_tpu_torch.models.likelihoods import ExactLikelihood, GaussianLikelihood

__all__ = ["NSF", "NBNSF", "MGGPNSF", "PNMF", "PoissonFactorization", "HybridNSF",
           "HybridNSFExact", "LegacyNSF", "LegacyHybridNSF", "GaussianLikelihood",
           "ExactLikelihood"]
