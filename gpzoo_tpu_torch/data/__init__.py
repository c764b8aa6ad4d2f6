"""Quality metrics (held-out deviances; spatial autocorrelation, factor
recovery) and the synthetic data generators."""

from gpzoo_tpu_torch.data.metrics import (best_match_correlation, dims_autocorr,
                                          held_out_deviance,
                                          hybrid_posterior_deviance, morans_i,
                                          poisson_deviance, posterior_deviance)
from gpzoo_tpu_torch.data.sim import (simulate_1d_regression,
                                      simulate_nb_counts, simulate_nsf_counts,
                                      simulate_shape_images)

__all__ = ["poisson_deviance", "held_out_deviance", "posterior_deviance",
           "hybrid_posterior_deviance", "morans_i", "dims_autocorr",
           "best_match_correlation", "simulate_nsf_counts", "simulate_nb_counts",
           "simulate_1d_regression", "simulate_shape_images"]
