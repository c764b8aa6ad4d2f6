"""The fast NSF losses (precomputed projection; the blockwise loss; VNNGP,
both tiers) and the training steps (minibatch and full batch)."""

from gpzoo_tpu_torch.train.fast import (NSFProjection,
                                        nsf_negative_elbo_batched,
                                        nsf_negative_elbo_precomputed,
                                        precompute_nsf_projection)
from gpzoo_tpu_torch.train.fast_vnngp import (
    VNNGPConditioning, precompute_vnngp_conditioning,
    vnngp_nsf_negative_elbo_batched, vnngp_nsf_negative_elbo_precomputed)
from gpzoo_tpu_torch.train.loop import (clamp_nonnegative,
                                        make_batched_train_step,
                                        make_train_step, run_steps)

__all__ = ["NSFProjection", "precompute_nsf_projection",
           "nsf_negative_elbo_precomputed", "nsf_negative_elbo_batched",
           "VNNGPConditioning",
           "precompute_vnngp_conditioning", "vnngp_nsf_negative_elbo_batched",
           "vnngp_nsf_negative_elbo_precomputed", "make_train_step",
           "make_batched_train_step", "clamp_nonnegative", "run_steps"]
