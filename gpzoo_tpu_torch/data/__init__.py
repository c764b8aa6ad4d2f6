"""Quality metrics (held-out deviances; spatial autocorrelation, factor
recovery), the synthetic data generators and the host data helpers
(preparation, NMF initialization, ``.h5ad`` reading, factor plots)."""

from gpzoo_tpu_torch.data.io import load_train_val, read_h5ad
from gpzoo_tpu_torch.data.metrics import (best_match_correlation, dims_autocorr,
                                          held_out_deviance,
                                          hybrid_posterior_deviance, morans_i,
                                          poisson_deviance, posterior_deviance)
from gpzoo_tpu_torch.data.nmf_init import (lnormal_approx_dirichlet,
                                           regularized_nmf, shrink_factors,
                                           shrink_loadings,
                                           smooth_spatial_factors)
from gpzoo_tpu_torch.data.preprocess import (anndata_to_train_val,
                                             arrays_to_train_val,
                                             rescale_spatial_coords,
                                             scanpy_sizefactors)
from gpzoo_tpu_torch.data.sim import (simulate_1d_regression,
                                      simulate_nb_counts, simulate_nsf_counts,
                                      simulate_shape_images)

__all__ = ["poisson_deviance", "held_out_deviance", "posterior_deviance",
           "hybrid_posterior_deviance", "morans_i", "dims_autocorr",
           "best_match_correlation", "simulate_nsf_counts", "simulate_nb_counts",
           "simulate_1d_regression", "simulate_shape_images",
           "rescale_spatial_coords", "scanpy_sizefactors", "anndata_to_train_val",
           "arrays_to_train_val", "regularized_nmf", "shrink_factors",
           "shrink_loadings", "lnormal_approx_dirichlet", "smooth_spatial_factors",
           "read_h5ad", "load_train_val"]
