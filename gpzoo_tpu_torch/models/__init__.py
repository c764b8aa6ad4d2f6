"""Factorization heads and the Gaussian likelihoods."""

from gpzoo_tpu_torch.models.factorization import (MGGPNSF, NBNSF, NSF, PNMF,
                                                  HybridNSF, HybridNSFExact,
                                                  LegacyHybridNSF, LegacyNSF,
                                                  PoissonFactorization)
from gpzoo_tpu_torch.models.likelihoods import ExactLikelihood, GaussianLikelihood

# the reference's names
NSF2 = NSF
Hybrid_NSF2 = HybridNSF
Hybrid_NSF_Exact = HybridNSFExact
Hybrid_NSF = LegacyHybridNSF
MGGP_NSF = MGGPNSF

__all__ = ["NSF", "NBNSF", "MGGPNSF", "PNMF", "PoissonFactorization", "HybridNSF",
           "HybridNSFExact", "LegacyNSF", "LegacyHybridNSF", "GaussianLikelihood",
           "ExactLikelihood", "NSF2", "Hybrid_NSF2", "Hybrid_NSF_Exact", "Hybrid_NSF",
           "MGGP_NSF"]
