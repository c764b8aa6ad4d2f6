"""Linear-algebra primitives and the hand-written Hopper kernels."""

from gpzoo_tpu_torch.ops.distance import cdist, squared_dist
from gpzoo_tpu_torch.ops.linalg import (add_jitter, cholesky_mm,
                                        embed_distance_matrix, reshape_param,
                                        safe_sqrt, spd_inverse_from_cholesky,
                                        sqrt_safe_grad, svgp_forward,
                                        tri_inverse, tril_logdet, whitened_kl)
from gpzoo_tpu_torch.ops.tri_blocked import tri_kl_trace, tri_sq_colsum

__all__ = ["squared_dist", "cdist", "add_jitter", "cholesky_mm", "svgp_forward",
           "whitened_kl", "safe_sqrt", "spd_inverse_from_cholesky",
           "sqrt_safe_grad", "embed_distance_matrix", "reshape_param",
           "tri_inverse", "tril_logdet", "tri_kl_trace", "tri_sq_colsum"]
