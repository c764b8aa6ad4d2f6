"""PyTorch/CUDA port of gpzoo_tpu for NVIDIA Hopper.

This slice holds the north-star training path: NSF over an unwhitened SVGP
with frozen Z and kernel, trained by Adam on the precomputed projection.
Its three kernels (the triangular variance contraction, forward and
backward, and the RBF Gram) are written by hand in CUDA C++ for sm_90a
(``ops/csrc``); each has a plain PyTorch version used for CPU tensors.
The package imports torch and never JAX.
"""

from gpzoo_tpu_torch.configs import SlideseqNSFConfig, freeze_
from gpzoo_tpu_torch.gps import SVGP
from gpzoo_tpu_torch.kernels import NSFRBF, RBF
from gpzoo_tpu_torch.models import NSF
from gpzoo_tpu_torch.train import (NSFProjection, make_batched_train_step,
                                   nsf_negative_elbo_precomputed,
                                   precompute_nsf_projection, run_steps)

__all__ = ["SlideseqNSFConfig", "freeze_", "SVGP", "RBF", "NSFRBF", "NSF",
           "NSFProjection", "precompute_nsf_projection",
           "nsf_negative_elbo_precomputed", "make_batched_train_step",
           "run_steps"]
