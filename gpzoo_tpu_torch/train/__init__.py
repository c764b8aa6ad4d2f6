"""The generic ELBOs, the fast NSF losses (precomputed projection; the
blockwise loss; VNNGP, both tiers), the training steps (minibatch and full
batch), natural-gradient VI, the loops and their chunk runner, checkpoints
and posterior snapshots."""

from gpzoo_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                              CheckpointHook,
                                              make_restore_template,
                                              restore_checkpoint,
                                              save_checkpoint)
from gpzoo_tpu_torch.train.elbo import (gaussian_exact_negative_elbo,
                                        negative_elbo, negative_elbo_batched,
                                        negative_elbo_hybrid,
                                        negative_elbo_hybrid_batched,
                                        pnmf_negative_elbo,
                                        pnmf_negative_elbo_batched,
                                        posterior_nll, whitened_negative_elbo)
from gpzoo_tpu_torch.train.fast import (NSFProjection,
                                        nsf_negative_elbo_batched,
                                        nsf_negative_elbo_precomputed,
                                        precompute_nsf_projection)
from gpzoo_tpu_torch.train.fast_vnngp import (
    VNNGPConditioning, precompute_vnngp_conditioning,
    vnngp_nsf_negative_elbo_batched, vnngp_nsf_negative_elbo_precomputed)
from gpzoo_tpu_torch.train.loop import (TrainState, clamp_nonnegative,
                                        make_batched_train_step,
                                        make_scan_runner, make_train_step,
                                        run_steps, train, train_batched,
                                        train_closure_batched, train_hybrid,
                                        train_hybrid_batched,
                                        trainable_parameters)
from gpzoo_tpu_torch.train.ngd import (HeadAdam, NGDTrainState,
                                       make_ngd_train_step, natural_update,
                                       natural_update_guarded, ngd_create,
                                       ngd_step, ngd_to_model)
from gpzoo_tpu_torch.train.snapshot import PosteriorSnapshotter

__all__ = ["negative_elbo", "negative_elbo_batched", "negative_elbo_hybrid",
           "negative_elbo_hybrid_batched", "pnmf_negative_elbo",
           "pnmf_negative_elbo_batched", "gaussian_exact_negative_elbo",
           "whitened_negative_elbo", "posterior_nll", "NSFProjection",
           "precompute_nsf_projection", "nsf_negative_elbo_precomputed",
           "nsf_negative_elbo_batched", "VNNGPConditioning",
           "precompute_vnngp_conditioning", "vnngp_nsf_negative_elbo_batched",
           "vnngp_nsf_negative_elbo_precomputed", "make_train_step",
           "make_batched_train_step", "clamp_nonnegative", "run_steps", "train",
           "train_batched", "train_closure_batched", "train_hybrid",
           "train_hybrid_batched", "TrainState", "trainable_parameters",
           "make_scan_runner", "HeadAdam", "NGDTrainState", "ngd_create",
           "ngd_step", "make_ngd_train_step", "natural_update",
           "natural_update_guarded", "ngd_to_model", "save_checkpoint",
           "restore_checkpoint", "make_restore_template", "AsyncCheckpointer",
           "CheckpointHook", "PosteriorSnapshotter"]
