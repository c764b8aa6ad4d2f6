"""PyTorch/CUDA port of gpzoo_tpu for NVIDIA Hopper.

The slices so far:

* the north-star training path: NSF over an unwhitened SVGP with frozen Z
  and kernel, trained by Adam on the precomputed projection;
* NSF over a VNNGP prior: the all-trainable step, the frozen-geometry
  tier and the full posterior (``predict.latent_posterior``);
* MGGP-NSF: trainable multi-group kernels over an MGGP SVGP, trained by
  the blockwise W-form loss (``nsf_negative_elbo_batched``);
* the other heads of the precomputed loss: the negative-binomial
  ``NBNSF``, the whitened ``WSVGP`` and low-rank ``LowRankWSVGP`` priors,
  the normalized Poisson log-likelihood and the hybrid heads
  (``HybridNSF``, ``HybridNSFExact``); NBNSF also over a VNNGP and through
  the blockwise W-form loss;
* every branch of the blockwise loss;
* the generic ELBO path: ``train.elbo`` over the heads' generic forwards
  (``PNMF``, ``LegacyNSF``, ``LegacyHybridNSF`` and the Gaussian
  likelihoods too), ``BatchedRBF``/``Matern32``, the configurations
  ``NSFConfig``, ``PNMFConfig`` and ``SVGPRegressionConfig``, the training
  loops and the PNMF warm start of the Hybrid-MGGP model;
* natural-gradient VI on the north-star step (``train.ngd``), the train
  states and their chunk runner, checkpoints with bit-identical resume
  (``train.checkpoint``), posterior snapshots, factor extraction
  (``predict.extract_factors``), ``utils`` and the host data helpers.

Their five kernels (the triangular variance contraction, forward and
backward, the RBF Gram, VNNGP's per-point K×K conditioning and the
multi-group Gram) are written by hand in CUDA C++ for sm_90a
(``ops/csrc``); each has a plain PyTorch version used for CPU tensors.
The package imports torch and never JAX.
"""

from gpzoo_tpu_torch import utils, warmstart
from gpzoo_tpu_torch.configs import (VNNGP_SHAPES, HybridNSFConfig,
                                     MGGPNSFConfig, NSFConfig, PNMFConfig,
                                     SlideseqHybridMGGPConfig,
                                     SlideseqNSFConfig, SVGPRegressionConfig,
                                     VNNGPConfig, freeze_)
from gpzoo_tpu_torch.dists import NegativeBinomial, Poisson
from gpzoo_tpu_torch.gps import (MGGPSVGP, MGGPWSVGP, SVGP, VNNGP, WSVGP,
                                 GaussianPrior, LowRankWSVGP)
from gpzoo_tpu_torch.kernels import (NSFRBF, RBF, BatchedMGGPRBF, BatchedRBF,
                                     Matern32, MGGPNSFRBF, MGGPRBF)
from gpzoo_tpu_torch.models import (MGGPNSF, NBNSF, NSF, PNMF, ExactLikelihood,
                                    GaussianLikelihood, HybridNSF,
                                    HybridNSFExact, LegacyHybridNSF, LegacyNSF,
                                    PoissonFactorization)
from gpzoo_tpu_torch.predict import extract_factors, latent_posterior
from gpzoo_tpu_torch.train import (AsyncCheckpointer, CheckpointHook, HeadAdam,
                                   NGDTrainState, NSFProjection,
                                   PosteriorSnapshotter, TrainState,
                                   VNNGPConditioning, clamp_nonnegative,
                                   gaussian_exact_negative_elbo,
                                   make_batched_train_step,
                                   make_ngd_train_step, make_restore_template,
                                   make_scan_runner, make_train_step,
                                   negative_elbo, negative_elbo_batched,
                                   negative_elbo_hybrid,
                                   negative_elbo_hybrid_batched, ngd_create,
                                   ngd_to_model, nsf_negative_elbo_batched,
                                   nsf_negative_elbo_precomputed,
                                   pnmf_negative_elbo,
                                   pnmf_negative_elbo_batched, posterior_nll,
                                   precompute_nsf_projection,
                                   precompute_vnngp_conditioning,
                                   restore_checkpoint, run_steps,
                                   save_checkpoint, train, train_batched,
                                   train_closure_batched, train_hybrid,
                                   train_hybrid_batched,
                                   trainable_parameters,
                                   vnngp_nsf_negative_elbo_batched,
                                   vnngp_nsf_negative_elbo_precomputed,
                                   whitened_negative_elbo)

__all__ = ["SlideseqNSFConfig", "VNNGPConfig", "VNNGP_SHAPES",
           "MGGPNSFConfig", "HybridNSFConfig", "SlideseqHybridMGGPConfig",
           "NSFConfig", "PNMFConfig", "SVGPRegressionConfig",
           "freeze_", "Poisson", "NegativeBinomial", "SVGP", "WSVGP",
           "LowRankWSVGP", "MGGPSVGP", "MGGPWSVGP", "VNNGP", "GaussianPrior",
           "RBF", "NSFRBF", "BatchedRBF", "Matern32", "MGGPRBF", "MGGPNSFRBF",
           "BatchedMGGPRBF", "NSF", "NBNSF", "MGGPNSF", "PNMF",
           "PoissonFactorization", "HybridNSF", "HybridNSFExact", "LegacyNSF",
           "LegacyHybridNSF", "GaussianLikelihood", "ExactLikelihood",
           "latent_posterior", "NSFProjection",
           "precompute_nsf_projection", "nsf_negative_elbo_precomputed",
           "nsf_negative_elbo_batched", "VNNGPConditioning",
           "precompute_vnngp_conditioning", "vnngp_nsf_negative_elbo_batched",
           "vnngp_nsf_negative_elbo_precomputed", "negative_elbo",
           "negative_elbo_batched", "negative_elbo_hybrid",
           "negative_elbo_hybrid_batched", "pnmf_negative_elbo",
           "pnmf_negative_elbo_batched", "gaussian_exact_negative_elbo",
           "whitened_negative_elbo", "posterior_nll", "make_train_step",
           "make_batched_train_step", "clamp_nonnegative", "run_steps", "train",
           "train_batched", "train_closure_batched", "train_hybrid",
           "train_hybrid_batched", "warmstart", "utils", "extract_factors",
           "TrainState", "trainable_parameters", "make_scan_runner", "HeadAdam",
           "NGDTrainState", "ngd_create", "make_ngd_train_step", "ngd_to_model",
           "save_checkpoint", "restore_checkpoint", "make_restore_template",
           "AsyncCheckpointer", "CheckpointHook", "PosteriorSnapshotter"]
