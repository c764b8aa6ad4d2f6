"""PyTorch/CUDA port of gpzoo_tpu for NVIDIA Hopper.

Two slices so far:

* the north-star training path: NSF over an unwhitened SVGP with frozen Z
  and kernel, trained by Adam on the precomputed projection;
* NSF over a VNNGP prior: the all-trainable step, the frozen-geometry
  tier and the full posterior (``predict.latent_posterior``).

Their four kernels (the triangular variance contraction, forward and
backward, the RBF Gram and VNNGP's per-point K×K conditioning) are
written by hand in CUDA C++ for sm_90a (``ops/csrc``); each has a plain
PyTorch version used for CPU tensors. The package imports torch and never
JAX.
"""

from gpzoo_tpu_torch.configs import (VNNGP_SHAPES, SlideseqNSFConfig,
                                     VNNGPConfig, freeze_)
from gpzoo_tpu_torch.gps import SVGP, VNNGP
from gpzoo_tpu_torch.kernels import NSFRBF, RBF
from gpzoo_tpu_torch.models import NSF
from gpzoo_tpu_torch.predict import latent_posterior
from gpzoo_tpu_torch.train import (NSFProjection, VNNGPConditioning,
                                   make_batched_train_step,
                                   nsf_negative_elbo_precomputed,
                                   precompute_nsf_projection,
                                   precompute_vnngp_conditioning, run_steps,
                                   vnngp_nsf_negative_elbo_batched,
                                   vnngp_nsf_negative_elbo_precomputed)

__all__ = ["SlideseqNSFConfig", "VNNGPConfig", "VNNGP_SHAPES", "freeze_",
           "SVGP", "VNNGP", "RBF", "NSFRBF", "NSF", "latent_posterior",
           "NSFProjection", "precompute_nsf_projection",
           "nsf_negative_elbo_precomputed", "VNNGPConditioning",
           "precompute_vnngp_conditioning", "vnngp_nsf_negative_elbo_batched",
           "vnngp_nsf_negative_elbo_precomputed", "make_batched_train_step",
           "run_steps"]
